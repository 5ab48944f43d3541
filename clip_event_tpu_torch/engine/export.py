"""Serving bundle: the trained encoders as `torch.export` programs
(counterpart of `clip_event_tpu/engine/export.py`).

A server loads the bundle and encodes images and texts without the model
code: the exported program is the model. `save_serving_bundle` writes

    <dir>/image_encode.pt2   ExportedProgram, inputs (weights, images [b, R, R, 3] fp32)
    <dir>/text_encode.pt2    ExportedProgram, inputs (weights, tokens [b, S] int32)
    <dir>/params.npz         the weights in the flat OpenAI state-dict naming,
                             written by `models/convert.py` as the JAX package
                             writes them; swappable without a re-export
    <dir>/params_int8.npz    instead, for an int8 bundle: the JAX package's
                             `<i>.q/.scale/.act/.w` leaves
    <dir>/meta.json          the JAX package's keys, `torch_version` in place
                             of `jax_version`

Both programs return L2-normalised fp32 features. Their batch is a
symbolic dimension (b >= 1), so one artifact serves every batch size.
`weights` is the list of the param tree's tensors in the JAX package's
flatten order (dict keys sorted, lists in order; an int8 `QuantWeight` is
one leaf there and gives q, scale and, if set, act_scale here): the
weights stay out of the `.pt2` files, as they stay out of JAX's modules.
The leaf index `i` of `params_int8.npz` is that order's, so the file and
the `params_tree` manifest in meta.json equal the JAX package's for the
same weights. The file holds the JAX tree's layouts: q [..., in, out]
(the loader makes it K-major, as `QuantWeight` does) and a ResNet conv
weight HWIO (the only 4-D leaf of either tree).

The attention core and the int8 products are the custom ops of
`ops/library.py`: a program serves on the CPU through the plain versions
and on the card through K1, K2 and K5, which advance the wrappers' launch
counts as the live model does. The export takes the plain LayerNorm (the
JAX export takes XLA's), so K4 is not in a bundle; a ResNet tower is
exported with its BatchNorm "frozen". A program holds the device it was
traced on in some nodes (the causal mask, `arange`), so the loader moves
it to the serving device (`torch.export.passes.move_to_device_pass`): a
bundle exported on the CPU serves on the card, and the other way round.

Loading imports torch, `ops/library.py`, the int8 weight and the weight
converter, not the model code (`models.clip`, the layers); only a
quantized bundle without a manifest (written before the manifest existed)
takes the model package for its tree's skeleton.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from clip_event_tpu_torch.ops.quant import QuantWeight
from clip_event_tpu_torch.platform import resolve_device

log = logging.getLogger(__name__)

IMAGE_MODULE = "image_encode.pt2"
TEXT_MODULE = "text_encode.pt2"
PARAMS_FILE = "params.npz"
QUANT_PARAMS_FILE = "params_int8.npz"
META_FILE = "meta.json"
PLATFORMS = ("cpu", "cuda")
QUANTIZE_MODES = ("int8", "int8_static")
# the example batch of the trace: 0 and 1 would be specialised
_TRACE_BATCH = 2


def _leaves(tree) -> list:
    """The leaves of a param tree in the JAX package's flatten order: dict
    keys sorted, lists in order, a QuantWeight one leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _unflatten(structure, leaves: Iterator):
    """A tree shaped as `structure` (a param tree or a manifest) whose
    leaves are the next values of `leaves`, in `_leaves` order."""
    if isinstance(structure, dict):
        return {k: _unflatten(structure[k], leaves) for k in sorted(structure)}
    if isinstance(structure, list):
        return [_unflatten(v, leaves) for v in structure]
    return next(leaves)


def program_inputs(params) -> List[torch.Tensor]:
    """The programs' `weights` argument: the tree's tensors in `_leaves`
    order, a QuantWeight as q, scale and its act_scale if set."""
    out = []
    for leaf in _leaves(params):
        if isinstance(leaf, QuantWeight):
            out += [leaf.q, leaf.scale] + ([] if leaf.act_scale is None else [leaf.act_scale])
        else:
            out.append(leaf)
    return out


def _from_program_inputs(template, weights: List[torch.Tensor]):
    """The inverse of `program_inputs`: the tree of `template`'s shape
    holding `weights`."""
    it = iter(weights)

    def leaf(t):
        if isinstance(t, QuantWeight):
            return QuantWeight(next(it), next(it), None if t.act_scale is None else next(it))
        return next(it)

    return _unflatten(template, iter([leaf(t) for t in _leaves(template)]))


def _tree_manifest(qparams):
    """The tree with each leaf replaced by its kind, "quant" or "array": the
    meta.json `params_tree` that rebuilds the tree without the model code."""
    kinds = ["quant" if isinstance(leaf, QuantWeight) else "array" for leaf in _leaves(qparams)]
    return _unflatten(qparams, iter(kinds))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as C-ordered numpy in the JAX tree's layout (a 4-D ResNet
    conv weight OIHW → HWIO)."""
    a = t.detach().cpu().numpy()
    return np.array(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a, order="C")


def _save_quant_params(path: str, qparams) -> None:
    """Quantized tree → npz: leaf i's QuantWeight under `<i>.q/.scale/.act`,
    a float leaf under `<i>.w` (the JAX package's file)."""
    blob = {}
    for i, leaf in enumerate(_leaves(qparams)):
        if isinstance(leaf, QuantWeight):
            blob[f"{i}.q"] = _numpy(leaf.q)
            blob[f"{i}.scale"] = _numpy(leaf.scale)
            if leaf.act_scale is not None:
                blob[f"{i}.act"] = _numpy(leaf.act_scale)
        else:
            blob[f"{i}.w"] = _numpy(leaf)
    np.savez(path, **blob)


class _NpQuant(NamedTuple):
    """A QuantWeight's three arrays as the JAX tree holds them, for
    `models.convert.params_from_jax`."""

    q: np.ndarray
    scale: np.ndarray
    act_scale: Optional[np.ndarray]


def _load_quant_params_from_manifest(path: str, manifest):
    """The quantized tree in the JAX package's layout (numpy leaves) from
    the npz and the manifest alone."""
    with np.load(path) as npz:
        leaves = []
        for i, kind in enumerate(_leaves(manifest)):
            if kind == "quant":
                act = npz[f"{i}.act"] if f"{i}.act" in npz.files else None
                leaves.append(_NpQuant(npz[f"{i}.q"], npz[f"{i}.scale"], act))
            else:
                leaves.append(npz[f"{i}.w"])
    return _unflatten(manifest, iter(leaves))


def _load_quant_params(path: str, cfg, towers):
    """Legacy path (a bundle written before the meta.json manifest): the
    manifest of a seeded skeleton of the same config quantized the same way
    (init and quantization fix the structure), then every value from the
    npz. Needs the model package."""
    from clip_event_tpu_torch.models.clip import init_params
    from clip_event_tpu_torch.ops.quant import quantize_params

    skeleton = quantize_params(init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
                               towers=tuple(towers) if towers else None)
    return _load_quant_params_from_manifest(path, _tree_manifest(skeleton))


class _Encoder(torch.nn.Module):
    """One tower as the program traces it: (weights, x) → L2-normalised
    fp32 features; `template` gives the tree the weights fill."""

    def __init__(self, encode, template, cfg, compute_dtype):
        super().__init__()
        self._encode, self._template = encode, template
        self._cfg, self._compute_dtype = cfg, compute_dtype

    def forward(self, weights: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        from clip_event_tpu_torch.models.clip import l2_normalize

        params = _from_program_inputs(self._template, weights)
        return l2_normalize(self._encode(params, self._cfg, x, compute_dtype=self._compute_dtype)).float()


def _drop_no_ops(program) -> None:
    """Remove the nodes that do nothing at the traced input dtypes, which
    `ServingModel` always feeds (fp32 images, int32 tokens, the weights'
    own dtypes): the trace's `_assert_tensor_metadata` checks of those
    dtypes, and casts to the dtype a tensor already has (`w.to(x.dtype)` in
    fp32). Each costs a dispatch on the host at every call; in fp32 they
    are 40 % of a program's nodes."""
    graph = program.graph_module.graph
    aten = torch.ops.aten
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target == aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target == aten.to.dtype and len(node.args) == 2 and not node.kwargs
              and node.args[0].meta["val"].dtype == node.args[1]
              and all(user.op != "output" for user in node.users)):  # the signature names outputs
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()


def export_encoders(params, cfg, compute_dtype=None, context=None):
    """Returns (image ExportedProgram, text ExportedProgram), traced on the
    params' device with a symbolic batch (min 1).

    `context`: export the text encoder at this static token width instead
    of the model's (2 <= context <= context_length); exact for texts whose
    EOT fits. The server tokenizes to that width.

    The export runs the attention core and the int8 products as the custom
    ops of `ops/library.py`, the plain LayerNorm and the frozen BatchNorm,
    and puts the session's choices back after."""
    from torch.export import Dim

    from clip_event_tpu_torch.models import clip as clip_model
    from clip_event_tpu_torch.models import layers, resnet

    compute_dtype = compute_dtype or torch.float32
    seq = int(context) if context else cfg.context_length
    if not 2 <= seq <= cfg.context_length:
        raise ValueError(f"context must be in [2, {cfg.context_length}] (got {context})")
    weights = program_inputs(params)
    device = params["logit_scale"].device
    res = cfg.image_resolution
    images = torch.zeros((_TRACE_BATCH, res, res, 3), dtype=torch.float32, device=device)
    tokens = torch.zeros((_TRACE_BATCH, seq), dtype=torch.int32, device=device)
    shapes = ([None] * len(weights), {0: Dim("b", min=1)})
    programs = []
    with torch.no_grad(), layers.attention_impl("kernel"), layers.ln_impl("xla"), resnet.bn_mode("frozen"):
        for encode, x in ((clip_model.encode_image, images), (clip_model.encode_text, tokens)):
            program = torch.export.export(_Encoder(encode, params, cfg, compute_dtype), (weights, x),
                                          dynamic_shapes=shapes)
            # the example inputs hold the weights: keep them out of the file
            program.example_inputs = None
            _drop_no_ops(program)
            programs.append(program)
    return tuple(programs)


def save_serving_bundle(
    out_dir: str, params, cfg, compute_dtype=None, context=None, quantize=None,
    quantize_towers=None, act_stats=None,
) -> str:
    """Export both encoders, the weights and the metadata into `out_dir`.

    `quantize`: None (float bundle), "int8" (dynamic activation scales) or
    "int8_static" (pass `act_stats` from `ops.quant.calibrate_act_scales`);
    the programs are traced on the quantized tree and the weights ship as
    `params_int8.npz`. `quantize_towers`: e.g. ("visual",)."""
    os.makedirs(out_dir, exist_ok=True)
    if quantize:
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"quantize={quantize!r}: 'int8' or 'int8_static'")
        if quantize == "int8_static" and act_stats is None:
            raise ValueError("quantize='int8_static' needs act_stats (ops.quant.calibrate_act_scales)")
        from clip_event_tpu_torch.ops.quant import quantize_params

        export_params = quantize_params(
            params, act_stats=act_stats if quantize == "int8_static" else None,
            towers=tuple(quantize_towers) if quantize_towers else None,
        )
    else:
        export_params = params

    image, text = export_encoders(export_params, cfg, compute_dtype, context)
    torch.export.save(image, os.path.join(out_dir, IMAGE_MODULE))
    torch.export.save(text, os.path.join(out_dir, TEXT_MODULE))

    if quantize:
        _save_quant_params(os.path.join(out_dir, QUANT_PARAMS_FILE), export_params)
    else:
        from clip_event_tpu_torch.models.convert import state_dict_from_params

        np.savez(os.path.join(out_dir, PARAMS_FILE), **state_dict_from_params(params, cfg))

    meta = {
        "model_config": dataclasses.asdict(cfg),
        "compute_dtype": str(compute_dtype or torch.float32).replace("torch.", ""),
        "platforms": list(PLATFORMS),
        "torch_version": torch.__version__,
        "embed_dim": cfg.embed_dim,
        "image_resolution": cfg.image_resolution,
        # the width the text program was exported at: the server tokenizes
        # to exactly this many tokens
        "context_length": int(context) if context else cfg.context_length,
        "quantize": quantize,
        "quantize_towers": list(quantize_towers) if quantize_towers else None,
        "params_tree": _tree_manifest(export_params) if quantize else None,
    }
    with open(os.path.join(out_dir, META_FILE), "w") as fh:
        json.dump(meta, fh, indent=2)
    log.info("=> serving bundle written to %s%s", out_dir, f" (quantize={quantize})" if quantize else "")
    return out_dir


class ServingModel:
    """A loaded bundle: `encode_image` / `encode_text` at any batch, on
    `device`. Each takes an array or a tensor and returns the fp32 features
    as a tensor on `device` (the JAX package's returns numpy)."""

    def __init__(self, image_program, text_program, params, meta: dict, device: torch.device):
        self._image = image_program.module()
        self._text = text_program.module()
        self.params = params
        self.meta = meta
        self.device = device
        self._weights = program_inputs(params)

    def encode_image(self, images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self._image(self._weights, x)

    def encode_text(self, tokens) -> torch.Tensor:
        t = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            return self._text(self._weights, t)


def load_serving_bundle(bundle_dir: str, device="cuda") -> ServingModel:
    """Load a bundle to serve on `device` (the card unless the caller asks
    for the CPU). A float bundle's weights come from params.npz through the
    weight converter; a quantized bundle's tree is rebuilt from the
    meta.json `params_tree` manifest, or, for a bundle without one, from a
    skeleton of the model package."""
    from torch.export.passes import move_to_device_pass

    from clip_event_tpu_torch.models.clip_config import CLIPConfig
    from clip_event_tpu_torch.models.convert import params_from_jax, params_from_state_dict
    from clip_event_tpu_torch.ops import library  # noqa: F401  (the ops the programs hold)

    dev = resolve_device(device)
    with open(os.path.join(bundle_dir, META_FILE)) as fh:
        meta = json.load(fh)
    mcfg = meta["model_config"]
    cfg = CLIPConfig(**{**mcfg, "vision_layers": _vision_layers(mcfg)})
    image, text = (move_to_device_pass(torch.export.load(os.path.join(bundle_dir, name)), dev)
                   for name in (IMAGE_MODULE, TEXT_MODULE))
    if meta.get("quantize"):
        qpath = os.path.join(bundle_dir, QUANT_PARAMS_FILE)
        if meta.get("params_tree") is not None:
            np_params = _load_quant_params_from_manifest(qpath, meta["params_tree"])
        else:
            np_params = _load_quant_params(qpath, cfg, meta.get("quantize_towers"))
    else:
        with np.load(os.path.join(bundle_dir, PARAMS_FILE)) as npz:
            sd = {k: npz[k] for k in npz.files}
        np_params, _ = params_from_state_dict(sd, cfg)
    params = params_from_jax(np_params, cfg, dev)
    return ServingModel(image, text, params, meta, dev)


def _vision_layers(mcfg: dict):
    vl = mcfg["vision_layers"]
    return tuple(vl) if isinstance(vl, list) else vl
