"""OpenAI CLIP `state_dict` ⇄ the port's param dict (ViT and ResNet towers).

Own copy of `clip_event_tpu/models/convert.py`. The architecture is read
from the tensors' shapes (reference `build_model` rules), and the same
layout rules hold:

  * torch Linear weights `[out, in]` → input-major `[in, out]` (`x @ w`),
  * the ViT patch conv `[width, 3, p, p]` → `[p*p*3, width]` in (kh, kw, C)
    order for the matmul patch embed,
  * per-layer transformer weights → stacked `[L, ...]` arrays,
  * the ResNet stages → lists of block dicts.

One layout differs between the packages: a ResNet conv weight is HWIO in
the JAX tree and OIHW (PyTorch's, and the state dict's) in the port's.
`params_from_state_dict` returns the JAX package's numpy tree (HWIO), and
`params_from_jax` turns such a tree into the port's tensors (OIHW).
`state_dict_from_params` is the exact inverse of both: it reads a tree of
tensors as the port's (OIHW) and a tree of numpy arrays as the JAX
package's (HWIO), so checkpoints round-trip.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from clip_event_tpu_torch.models.clip import TEXT_KEYS, CLIPConfig, tree_to
from clip_event_tpu_torch.ops.quant import QuantWeight
from clip_event_tpu_torch.platform import resolve_device

Array = np.ndarray
StateDict = Dict[str, Array]

_META_KEYS = ("input_resolution", "context_length", "vocab_size")


def _np(x) -> Array:
    """Accept torch tensors or arrays; return float32/int numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.float16, torch.bfloat16):
            x = x.float()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == np.float16:
        x = x.astype(np.float32)
    return x


def config_from_state_dict(sd: StateDict) -> CLIPConfig:
    """Architecture from tensor shapes (reference `build_model` rules)."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len(
            [k for k in sd if re.fullmatch(r"visual\.transformer\.resblocks\.\d+\.attn\.in_proj_weight", k)]
        )
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4)
        )
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size = None
        image_resolution = out_width * 32
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len(
            {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}
        ),
    )


def _convert_transformer(sd: StateDict, prefix: str, num_layers: int) -> dict:
    """Per-layer torch blocks → stacked arrays."""

    def stack(fmt, transform=lambda a: a):
        return np.stack([transform(_np(sd[fmt.format(i)])) for i in range(num_layers)])

    T = np.transpose
    return {
        "attn": {
            "qkv_w": stack(prefix + ".resblocks.{}.attn.in_proj_weight", T),
            "qkv_b": stack(prefix + ".resblocks.{}.attn.in_proj_bias"),
            "out_w": stack(prefix + ".resblocks.{}.attn.out_proj.weight", T),
            "out_b": stack(prefix + ".resblocks.{}.attn.out_proj.bias"),
        },
        "ln_1": {
            "scale": stack(prefix + ".resblocks.{}.ln_1.weight"),
            "bias": stack(prefix + ".resblocks.{}.ln_1.bias"),
        },
        "mlp": {
            "fc_w": stack(prefix + ".resblocks.{}.mlp.c_fc.weight", T),
            "fc_b": stack(prefix + ".resblocks.{}.mlp.c_fc.bias"),
            "proj_w": stack(prefix + ".resblocks.{}.mlp.c_proj.weight", T),
            "proj_b": stack(prefix + ".resblocks.{}.mlp.c_proj.bias"),
        },
        "ln_2": {
            "scale": stack(prefix + ".resblocks.{}.ln_2.weight"),
            "bias": stack(prefix + ".resblocks.{}.ln_2.bias"),
        },
    }


def _ln(sd: StateDict, prefix: str) -> dict:
    return {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}


def _bn(sd: StateDict, prefix: str) -> dict:
    return {
        "scale": _np(sd[prefix + ".weight"]),
        "bias": _np(sd[prefix + ".bias"]),
        "mean": _np(sd[prefix + ".running_mean"]),
        "var": _np(sd[prefix + ".running_var"]),
    }


def _conv_hwio(sd: StateDict, key: str) -> Array:
    return _np(sd[key]).transpose(2, 3, 1, 0)  # OIHW → HWIO


def _convert_vit_visual(sd: StateDict, cfg: CLIPConfig) -> dict:
    conv = _np(sd["visual.conv1.weight"])  # [W, 3, p, p]
    width = conv.shape[0]
    patch_w = conv.transpose(2, 3, 1, 0).reshape(-1, width)  # (kh, kw, C) flat
    return {
        "patch_embed_w": patch_w,
        "class_embedding": _np(sd["visual.class_embedding"]),
        "positional_embedding": _np(sd["visual.positional_embedding"]),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "transformer": _convert_transformer(sd, "visual.transformer", cfg.vision_layers),
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _np(sd["visual.proj"]),
    }


def _convert_resnet_visual(sd: StateDict, cfg: CLIPConfig) -> dict:
    params = {
        "stem": {
            "conv1_w": _conv_hwio(sd, "visual.conv1.weight"),
            "bn1": _bn(sd, "visual.bn1"),
            "conv2_w": _conv_hwio(sd, "visual.conv2.weight"),
            "bn2": _bn(sd, "visual.bn2"),
            "conv3_w": _conv_hwio(sd, "visual.conv3.weight"),
            "bn3": _bn(sd, "visual.bn3"),
        }
    }
    for stage_idx, num_blocks in enumerate(cfg.vision_layers):
        blocks = []
        for b in range(num_blocks):
            p = f"visual.layer{stage_idx + 1}.{b}"
            block = {
                "conv1_w": _conv_hwio(sd, p + ".conv1.weight"),
                "bn1": _bn(sd, p + ".bn1"),
                "conv2_w": _conv_hwio(sd, p + ".conv2.weight"),
                "bn2": _bn(sd, p + ".bn2"),
                "conv3_w": _conv_hwio(sd, p + ".conv3.weight"),
                "bn3": _bn(sd, p + ".bn3"),
            }
            if p + ".downsample.0.weight" in sd:
                block["downsample"] = {
                    "conv_w": _conv_hwio(sd, p + ".downsample.0.weight"),
                    "bn": _bn(sd, p + ".downsample.1"),
                }
            blocks.append(block)
        params[f"layer{stage_idx + 1}"] = blocks
    ap = {"positional_embedding": _np(sd["visual.attnpool.positional_embedding"])}
    for name in ("q", "k", "v", "c"):
        ap[f"{name}_w"] = _np(sd[f"visual.attnpool.{name}_proj.weight"]).T
        ap[f"{name}_b"] = _np(sd[f"visual.attnpool.{name}_proj.bias"])
    params["attnpool"] = ap
    return params


def params_from_state_dict(sd: StateDict, cfg: CLIPConfig | None = None) -> tuple:
    """Returns (numpy param dict in the JAX package's layout, cfg). Accepts
    torch tensors or numpy values."""
    sd = {k: v for k, v in sd.items() if k not in _META_KEYS}
    cfg = cfg or config_from_state_dict(sd)
    visual = _convert_vit_visual(sd, cfg) if cfg.is_vit else _convert_resnet_visual(sd, cfg)
    params = {
        "visual": visual,
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "text_transformer": _convert_transformer(sd, "transformer", cfg.transformer_layers),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _np(sd["text_projection"]),
        "logit_scale": _np(sd["logit_scale"]),
    }
    return params, cfg


def _conv_oihw(w) -> Array:
    """A ResNet conv weight of a param tree → the state dict's OIHW: a
    tensor (the port's tree) is OIHW already, a numpy array (the JAX
    package's tree) HWIO."""
    return _np(w) if isinstance(w, torch.Tensor) else np.asarray(w).transpose(3, 2, 0, 1)


def state_dict_from_params(params: dict, cfg: CLIPConfig) -> StateDict:
    """Inverse of `params_from_state_dict` and `params_from_jax` (OpenAI
    naming/layout), numpy out."""
    sd: StateDict = {}

    def unstack_transformer(t: dict, prefix: str):
        n_layers = _np(t["attn"]["qkv_w"]).shape[0]
        for i in range(n_layers):
            p = f"{prefix}.resblocks.{i}"
            sd[p + ".attn.in_proj_weight"] = _np(t["attn"]["qkv_w"][i]).T
            sd[p + ".attn.in_proj_bias"] = _np(t["attn"]["qkv_b"][i])
            sd[p + ".attn.out_proj.weight"] = _np(t["attn"]["out_w"][i]).T
            sd[p + ".attn.out_proj.bias"] = _np(t["attn"]["out_b"][i])
            sd[p + ".ln_1.weight"] = _np(t["ln_1"]["scale"][i])
            sd[p + ".ln_1.bias"] = _np(t["ln_1"]["bias"][i])
            sd[p + ".mlp.c_fc.weight"] = _np(t["mlp"]["fc_w"][i]).T
            sd[p + ".mlp.c_fc.bias"] = _np(t["mlp"]["fc_b"][i])
            sd[p + ".mlp.c_proj.weight"] = _np(t["mlp"]["proj_w"][i]).T
            sd[p + ".mlp.c_proj.bias"] = _np(t["mlp"]["proj_b"][i])
            sd[p + ".ln_2.weight"] = _np(t["ln_2"]["scale"][i])
            sd[p + ".ln_2.bias"] = _np(t["ln_2"]["bias"][i])

    vis = params["visual"]
    if cfg.is_vit:
        p = cfg.vision_patch_size
        w = _np(vis["patch_embed_w"])
        sd["visual.conv1.weight"] = w.reshape(p, p, 3, -1).transpose(3, 2, 0, 1)
        sd["visual.class_embedding"] = _np(vis["class_embedding"])
        sd["visual.positional_embedding"] = _np(vis["positional_embedding"])
        sd["visual.ln_pre.weight"] = _np(vis["ln_pre"]["scale"])
        sd["visual.ln_pre.bias"] = _np(vis["ln_pre"]["bias"])
        unstack_transformer(vis["transformer"], "visual.transformer")
        sd["visual.ln_post.weight"] = _np(vis["ln_post"]["scale"])
        sd["visual.ln_post.bias"] = _np(vis["ln_post"]["bias"])
        sd["visual.proj"] = _np(vis["proj"])
    else:
        def put_bn(prefix, bn):
            sd[prefix + ".weight"] = _np(bn["scale"])
            sd[prefix + ".bias"] = _np(bn["bias"])
            sd[prefix + ".running_mean"] = _np(bn["mean"])
            sd[prefix + ".running_var"] = _np(bn["var"])

        for i in (1, 2, 3):
            sd[f"visual.conv{i}.weight"] = _conv_oihw(vis["stem"][f"conv{i}_w"])
            put_bn(f"visual.bn{i}", vis["stem"][f"bn{i}"])
        for stage_idx, num_blocks in enumerate(cfg.vision_layers):
            for b in range(num_blocks):
                blk = vis[f"layer{stage_idx + 1}"][b]
                p = f"visual.layer{stage_idx + 1}.{b}"
                for i in (1, 2, 3):
                    sd[p + f".conv{i}.weight"] = _conv_oihw(blk[f"conv{i}_w"])
                    put_bn(p + f".bn{i}", blk[f"bn{i}"])
                if "downsample" in blk:
                    sd[p + ".downsample.0.weight"] = _conv_oihw(blk["downsample"]["conv_w"])
                    put_bn(p + ".downsample.1", blk["downsample"]["bn"])
        ap = vis["attnpool"]
        sd["visual.attnpool.positional_embedding"] = _np(ap["positional_embedding"])
        for name in ("q", "k", "v", "c"):
            sd[f"visual.attnpool.{name}_proj.weight"] = _np(ap[f"{name}_w"]).T
            sd[f"visual.attnpool.{name}_proj.bias"] = _np(ap[f"{name}_b"])

    sd["token_embedding.weight"] = _np(params["token_embedding"])
    sd["positional_embedding"] = _np(params["positional_embedding"])
    unstack_transformer(params["text_transformer"], "transformer")
    sd["ln_final.weight"] = _np(params["ln_final"]["scale"])
    sd["ln_final.bias"] = _np(params["ln_final"]["bias"])
    sd["text_projection"] = _np(params["text_projection"])
    sd["logit_scale"] = _np(params["logit_scale"])
    return sd


def params_from_jax(np_params: dict, cfg: CLIPConfig, device="cuda") -> dict:
    """The JAX package's param pytree (numpy leaves, e.g. via
    `jax.tree.map(np.asarray, params)`) → the port's param dict on
    `device`. Each leaf converts as it is, keeping its dtype, but for a
    ResNet conv weight (a 4-D `*_w` under `visual`), HWIO there and OIHW
    here. A ResNet stage stays a list of block dicts. A quantized tree's
    QuantWeight leaves (any object with `q`, `scale` and `act_scale`)
    become the port's `QuantWeight`."""
    want = {"visual", "logit_scale", *TEXT_KEYS}
    if set(np_params) != want:
        raise ValueError(f"param tree keys {sorted(np_params)} are not {sorted(want)}")

    def tensor(v):
        return None if v is None else torch.from_numpy(np.array(v))

    def leaf(v):
        if all(hasattr(v, a) for a in ("q", "scale", "act_scale")):
            return QuantWeight(tensor(v.q), tensor(v.scale), tensor(v.act_scale))
        return tensor(v)

    def to_tensors(tree, conv):
        if isinstance(tree, list):
            return [to_tensors(v, conv) for v in tree]
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = to_tensors(v, conv or (k == "visual" and not cfg.is_vit))
            elif conv and k.endswith("_w") and np.ndim(v) == 4:
                out[k] = torch.from_numpy(np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1))))  # HWIO → OIHW
            else:
                out[k] = leaf(v)
        return out

    return tree_to(to_tensors(np_params, False), resolve_device(device))


def load_torch_checkpoint(path: str) -> StateDict:
    """Read an OpenAI JIT archive / torch `state_dict` / reference training
    checkpoint (`{epoch, model, state_dict, perf, optimizer}`) into a numpy
    state_dict."""
    try:
        model = torch.jit.load(path, map_location="cpu")
        sd = model.state_dict()
    except RuntimeError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj.state_dict()
    return {k: _np(v) for k, v in sd.items() if k not in _META_KEYS}
