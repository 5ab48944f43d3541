"""CLIP dual encoder (counterpart of `clip_event_tpu/models/clip.py`): a
ViT or ModifiedResNet vision tower and the causal text tower.

The functional core mirrors the JAX package: `encode_image(params, cfg,
images)`, `encode_text`, `forward`, on a nested dict of tensors with the
JAX pytree's names and layouts, a ResNet stage being a list of block
dicts as in JAX (its conv weights OIHW, `models/resnet.py`). `VisionTower`,
`TextTower` and `CLIP` are `nn.Module`s holding those tensors as
registered parameters and calling the same functions.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clip_event_tpu_torch.data.transform import CLIP_MEAN, CLIP_STD
from clip_event_tpu_torch.models import layers as L
from clip_event_tpu_torch.models.clip_config import (  # noqa: F401
    RN50,
    RN50X4,
    RN101,
    TEXT_KEYS,
    VIT_B16,
    VIT_B32,
    VIT_L14,
    CLIPConfig,
)
from clip_event_tpu_torch.models.resnet import init_resnet, resnet_encode
from clip_event_tpu_torch.models.vit import init_vit, vit_encode
from clip_event_tpu_torch.ops.quant import QuantWeight
from clip_event_tpu_torch.parallel import collectives
from clip_event_tpu_torch.parallel.sharding import full
from clip_event_tpu_torch.platform import resolve_device


def tree_to(tree, device=None, dtype=None):
    """Move (and optionally cast) every tensor of a nested param dict (a
    list of a ResNet stage's blocks too); a QuantWeight moves and keeps its
    int8 and fp32 tensors."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


def init_params(gen: torch.Generator, cfg: CLIPConfig, device="cuda") -> dict:
    """Random init following the JAX package's scheme (reference
    `model_clip.py:348-375`), drawn on the CPU from `gen`, then moved to
    `device`. The numbers differ from JAX's for the same seed."""
    dev = resolve_device(device)
    W, E = cfg.transformer_width, cfg.embed_dim
    if cfg.is_vit:
        visual = init_vit(
            gen, cfg.image_resolution, cfg.vision_patch_size, cfg.vision_width,
            cfg.vision_layers, E,
        )
    else:
        visual = init_resnet(gen, cfg.vision_layers, cfg.vision_width, cfg.image_resolution, E)
    params = {
        "visual": visual,
        "token_embedding": 0.02 * torch.randn((cfg.vocab_size, W), generator=gen),
        "positional_embedding": 0.01 * torch.randn((cfg.context_length, W), generator=gen),
        "text_transformer": L.init_transformer(gen, cfg.transformer_layers, W),
        "ln_final": L.init_layer_norm(W),
        "text_projection": W**-0.5 * torch.randn((W, E), generator=gen),
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32),
    }
    return tree_to(params, dev)


def cast_params(params: dict, dtype=torch.bfloat16) -> dict:
    """Cast the matmul weights to `dtype`, keeping the LayerNorm/BatchNorm
    params and logit_scale in float32 (reference `convert_weights`, with
    bf16 instead of fp16); an int8 QuantWeight stays as it is."""

    def cast(tree, in_norm):
        if isinstance(tree, list):
            return [cast(v, in_norm) for v in tree]
        out = {}
        for k, v in tree.items():
            norm = in_norm or k.startswith("ln") or k.startswith("bn")
            if isinstance(v, (dict, list)):
                out[k] = cast(v, norm)
            elif norm or k == "logit_scale" or "mean" in k or "var" in k or isinstance(v, QuantWeight):
                out[k] = v
            else:
                out[k] = v.to(dtype)
        return out

    return cast(params, False)


_NORMALIZE_CONSTANTS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _normalize_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLIP's mean and std on `device`, copied there once: a train step
    makes no tensor from host data, so a CUDA graph can capture it."""
    consts = _NORMALIZE_CONSTANTS.get(device)
    if consts is None:
        consts = _NORMALIZE_CONSTANTS[device] = (
            torch.as_tensor(CLIP_MEAN, device=device), torch.as_tensor(CLIP_STD, device=device))
    return consts


def encode_image(
    params: dict,
    cfg: CLIPConfig,
    images: torch.Tensor,
    use_grid: bool = False,
    compute_dtype=torch.float32,
    impl: Optional[str] = None,
    remat=False,
) -> torch.Tensor:
    """[B, H, W, 3] → [B, E], or [B, grid²+1, E] when use_grid (ViT only).

    uint8 inputs are CLIP-normalized on the device, `(x/255 - mean)/std` in
    fp32, the exact ops of `data.transform.normalize`. The ResNet tower
    takes no `impl` (it has no attention kernel) and no `remat`, as in
    JAX."""
    if images.dtype == torch.uint8:
        mean, std = _normalize_constants(images.device)
        images = (images.float() / 255.0 - mean) / std
    if cfg.is_vit:
        return vit_encode(
            params["visual"], images, cfg.vision_patch_size, cfg.vision_heads,
            use_grid=use_grid, compute_dtype=compute_dtype, impl=impl, remat=remat,
            depth=cfg.vision_layers,
        )
    if use_grid:
        raise ValueError("grid features require the ViT tower")
    return resnet_encode(
        params["visual"], images, cfg.vision_layers, cfg.vision_heads, compute_dtype=compute_dtype
    )


def encode_text(
    params: dict,
    cfg: CLIPConfig,
    tokens: torch.Tensor,
    compute_dtype=torch.float32,
    impl: Optional[str] = None,
    remat=False,
) -> torch.Tensor:
    """[B, S] int tokens → [B, E]; EOT pooling via argmax token id.

    S may be any width up to cfg.context_length: the text tower is causal
    and the padding after EOT is zeros, so a caption that fits in S pools
    to the same feature as in the full 77-token layout."""
    tokens = tokens.long()
    seq = tokens.shape[-1]
    x = embed_tokens(full(params["token_embedding"]), tokens, cfg.vocab_size).to(compute_dtype)
    x = x + full(params["positional_embedding"])[:seq].to(compute_dtype)
    bias = L.causal_mask(seq, device=x.device)
    x = L.transformer(x, params["text_transformer"], cfg.transformer_heads, bias, impl, remat,
                      depth=cfg.transformer_layers)
    x = L.layer_norm(x, params["ln_final"])
    eot_idx = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_idx]
    return L.linear(pooled, params["text_projection"])


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The token embeddings of `tokens`. A table of V/tp rows is a tp
    rank's vocab-parallel slice (`parallel/sharding.py`): the rows outside
    its range give zeros, and the sum over the tp group
    (`collectives.tp_sum`) is the whole lookup, bit for bit (one rank holds
    each row)."""
    if table.shape[0] == vocab_size:
        return table[tokens]
    tp = L.resolve_tensor_parallel()
    if tp is None or table.shape[0] * tp.world_size != vocab_size:
        raise ValueError(f"a token embedding of {table.shape[0]} rows for a vocabulary of {vocab_size}: "
                         "a tp rank's slice needs the tp group (layers.set_tensor_parallel)")
    local = tokens - tp.rank * table.shape[0]
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)].masked_fill(~mine.unsqueeze(-1), 0.0)
    return collectives.tp_sum(rows, tp)


def text_act_stats(params: dict, cfg: CLIPConfig, tokens: torch.Tensor,
                   compute_dtype=torch.float32) -> dict:
    """Dense-input abs-max stats of the text tower (static int8 activation
    calibration, `ops/quant.py`): `encode_text`'s path, returning
    {"text_transformer": {...[L]...}, "text_projection"}."""
    tokens = tokens.long()
    seq = tokens.shape[-1]
    x = embed_tokens(params["token_embedding"], tokens, cfg.vocab_size).to(compute_dtype)
    x = x + params["positional_embedding"][:seq].to(compute_dtype)
    bias = L.causal_mask(seq, device=x.device)
    x, tstats = L.transformer_with_act_stats(x, params["text_transformer"], cfg.transformer_heads, bias)
    x = L.layer_norm(x, params["ln_final"])
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return {"text_transformer": tstats, "text_projection": L._absmax(pooled)}


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def contrastive_logits(
    params: dict,
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    overbatch: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled cosine-sim logits from normalized features, in fp32 (the JAX
    dots ask for fp32 results)."""
    scale = params["logit_scale"].exp().to(image_features.dtype).float()
    img, txt = image_features.float(), text_features.float()
    logits_per_text = scale * (txt @ img.T)
    if overbatch:
        logits_per_image = scale * (img @ txt.T)
    else:
        per_inst = txt.reshape(img.shape[0], -1, txt.shape[-1])
        logits_per_image = scale * torch.einsum("be,bde->bd", img, per_inst)
    return logits_per_image, logits_per_text


def forward(
    params: dict,
    cfg: CLIPConfig,
    images: torch.Tensor,
    tokens: torch.Tensor,
    overbatch: bool = True,
    compute_dtype=torch.float32,
    impl: Optional[str] = None,
    remat=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contrastive logits (reference `CLIP.forward`).

    images: [B, H, W, 3]; tokens: [B*D, context] (D descriptions per image).
    Returns (logits_per_image, logits_per_text):
      overbatch:  [B, B*D] and [B*D, B]
      instance:   [B, D]   and [B*D, B]
    """
    image_features = l2_normalize(
        encode_image(params, cfg, images, compute_dtype=compute_dtype, impl=impl, remat=remat)
    )
    text_features = l2_normalize(
        encode_text(params, cfg, tokens, compute_dtype=compute_dtype, impl=impl, remat=remat)
    )
    return contrastive_logits(params, image_features, text_features, overbatch)


def sim_entity(
    params: dict,
    cfg: CLIPConfig,
    object_images: torch.Tensor,
    entity_tokens: torch.Tensor,
    compute_dtype=torch.float32,
    impl: Optional[str] = None,
    remat=False,
    chunks: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode object crops and entity mentions for the OT alignment loss
    (JAX `clip.py:258-325`; reference `model_clip.py:531-552`).

    object_images: [B, N, H, W, 3]; entity_tokens: [B, M, context]. Returns
    the unnormalized ([B, N, E], [B, M, E]); the OT cost normalizes.

    `chunks > 1` encodes the node axis (not the flat B·K batch) in that many
    sequential slices, the effective count being the smallest divisor of the
    node axis ≥ `chunks` (e.g. 11 slots with chunks=4 → 11 slices). When
    autograd records, each slice runs under `torch.utils.checkpoint` (JAX's
    `jax.checkpoint(one)`), so only the slice inputs are kept for the
    backward and each slice's forward re-runs during its own backward; the
    per-block recompute of `remat` stays inside."""
    B, N = object_images.shape[:2]
    M = entity_tokens.shape[1]
    recompute = torch.is_grad_enabled()
    # resolved once: a chunk's recompute in the backward pass must take the
    # attention its forward took
    impl = L._resolve_attention(impl)

    def encode_chunked(encode_fn, x, node_axis_len):
        c = 1
        if chunks > 1:
            c = next(
                d for d in range(min(chunks, node_axis_len), node_axis_len + 1)
                if node_axis_len % d == 0
            )
        k = node_axis_len // c
        if c == 1:
            flat = x.reshape((B * node_axis_len,) + tuple(x.shape[2:]))
            return encode_fn(flat).reshape(B, node_axis_len, -1)
        outs = []
        for i in range(c):
            xc = x[:, i * k : (i + 1) * k].reshape((B * k,) + tuple(x.shape[2:]))
            outs.append(checkpoint(encode_fn, xc, use_reentrant=False, preserve_rng_state=False)
                        if recompute else encode_fn(xc))
        out = torch.stack(outs).reshape(c, B, k, -1)  # [c, B, k, E]
        return out.transpose(0, 1).reshape(B, node_axis_len, -1)

    kw = dict(compute_dtype=compute_dtype, impl=impl, remat=remat)
    img = encode_chunked(lambda x: encode_image(params, cfg, x, **kw), object_images, N)
    txt = encode_chunked(lambda t: encode_text(params, cfg, t, **kw), entity_tokens, M)
    return img, txt


# ------------------------------------------------------------------ modules


class _QuantLeaf(nn.Module):
    """An int8 QuantWeight held as buffers (`q`, `scale`, `act_scale`). `q`
    keeps the QuantWeight's K-major strides: `.to()` and `load_state_dict`
    (which copies into the buffer) preserve them, as K5 needs."""

    def __init__(self, w: QuantWeight):
        super().__init__()
        self.register_buffer("q", w.q)
        self.register_buffer("scale", w.scale)
        self.register_buffer("act_scale", w.act_scale)

    def tree(self) -> QuantWeight:
        return QuantWeight(self.q, self.scale, self.act_scale)


def _subtree(v) -> nn.Module:
    if isinstance(v, dict):
        return _ParamTree(v)
    if isinstance(v, list):
        return _ParamList(v)
    return _QuantLeaf(v)


class _ParamTree(nn.Module):
    """A nested param dict held as frozen registered parameters whose names
    mirror the JAX pytree (`visual.transformer.attn.qkv_w`, ...); a list (a
    ResNet stage's blocks) becomes a `_ParamList` (`visual.layer1.0.conv1_w`)
    and a QuantWeight leaf a `_QuantLeaf` of buffers."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, (dict, list, QuantWeight)):
                self.add_module(k, _subtree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


class _ParamList(nn.ModuleList):
    """A list of param subtrees; `tree()` gives the list back."""

    def __init__(self, items: list):
        super().__init__([_subtree(v) for v in items])

    def tree(self) -> list:
        return [m.tree() for m in self]


class VisionTower(_ParamTree):
    def __init__(self, cfg: CLIPConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, images, use_grid=False, compute_dtype=torch.float32, impl=None):
        return encode_image(
            {"visual": self.tree()}, self.cfg, images, use_grid, compute_dtype, impl
        )


class TextTower(_ParamTree):
    def __init__(self, cfg: CLIPConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens, compute_dtype=torch.float32, impl=None):
        return encode_text(self.tree(), self.cfg, tokens, compute_dtype, impl)


class CLIP(nn.Module):
    """The dual encoder over one param dict (see `params`)."""

    def __init__(self, cfg: CLIPConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg, params["visual"])
        self.text = TextTower(cfg, {k: params[k] for k in TEXT_KEYS})
        self.logit_scale = nn.Parameter(params["logit_scale"], requires_grad=False)

    def params(self) -> dict:
        """The JAX-layout param dict (the module's own tensors, not copies)."""
        return {"visual": self.visual.tree(), **self.text.tree(), "logit_scale": self.logit_scale}

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def encode_image(self, images, use_grid=False, compute_dtype=torch.float32, impl=None):
        return self.visual(images, use_grid, compute_dtype, impl)

    def encode_text(self, tokens, compute_dtype=torch.float32, impl=None):
        return self.text(tokens, compute_dtype, impl)

    def forward(self, images, tokens, overbatch=True, compute_dtype=torch.float32, impl=None):
        return forward(self.params(), self.cfg, images, tokens, overbatch, compute_dtype, impl)
