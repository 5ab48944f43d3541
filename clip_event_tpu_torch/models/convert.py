"""OpenAI CLIP `state_dict` ⇄ the port's param dict (ViT towers).

Own copy of the ViT half of `clip_event_tpu/models/convert.py`. The port's
param dict has the JAX package's names and layouts, so the same rules hold:

  * torch Linear weights `[out, in]` → input-major `[in, out]` (`x @ w`),
  * the ViT patch conv `[width, 3, p, p]` → `[p*p*3, width]` in (kh, kw, C)
    order for the matmul patch embed,
  * per-layer transformer weights → stacked `[L, ...]` arrays.

`state_dict_from_params` is the exact inverse, so checkpoints round-trip.
`params_from_jax` turns the JAX package's param pytree, given as numpy
arrays, into the port's tensors.
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
    if "visual.proj" not in sd:
        raise NotImplementedError("ResNet checkpoints are not ported yet (ViT only)")
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len(
        [k for k in sd if re.fullmatch(r"visual\.transformer\.resblocks\.\d+\.attn\.in_proj_weight", k)]
    )
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid,
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


def params_from_state_dict(sd: StateDict, cfg: CLIPConfig | None = None) -> tuple:
    """Returns (numpy param dict, cfg). Accepts torch tensors or numpy values."""
    sd = {k: v for k, v in sd.items() if k not in _META_KEYS}
    cfg = cfg or config_from_state_dict(sd)
    if not cfg.is_vit:
        raise NotImplementedError("ResNet checkpoints are not ported yet (ViT only)")
    params = {
        "visual": _convert_vit_visual(sd, cfg),
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "text_transformer": _convert_transformer(sd, "transformer", cfg.transformer_layers),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _np(sd["text_projection"]),
        "logit_scale": _np(sd["logit_scale"]),
    }
    return params, cfg


def state_dict_from_params(params: dict, cfg: CLIPConfig) -> StateDict:
    """Inverse of `params_from_state_dict` (OpenAI naming/layout), numpy out."""
    if not cfg.is_vit:
        raise NotImplementedError("ResNet checkpoints are not ported yet (ViT only)")
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
    `device`. The layouts are the same, so each leaf converts as it is,
    keeping its dtype. A quantized tree's QuantWeight leaves (any object
    with `q`, `scale` and `act_scale`) become the port's `QuantWeight`."""
    if not cfg.is_vit:
        raise NotImplementedError("the ResNet towers are not ported yet (ViT only)")
    want = {"visual", "logit_scale", *TEXT_KEYS}
    if set(np_params) != want:
        raise ValueError(f"param tree keys {sorted(np_params)} are not {sorted(want)}")

    def tensor(v):
        return None if v is None else torch.from_numpy(np.array(v))

    def leaf(v):
        if all(hasattr(v, a) for a in ("q", "scale", "act_scale")):
            return QuantWeight(tensor(v.q), tensor(v.scale), tensor(v.act_scale))
        return tensor(v)

    def to_tensors(tree):
        return {k: to_tensors(v) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}

    return tree_to(to_tensors(np_params), resolve_device(device))


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
