"""ModifiedResNet vision tower (counterpart of `clip_event_tpu/models/resnet.py`;
reference `model_clip.py:14-154`).

What sets it apart from a torchvision ResNet, kept as in the reference: a
3-conv stem with an average pool, anti-aliased strided blocks (an average
pool before the stride-2 work), and a QKV attention pool in place of the
global average pool. The attention pool computes the mean token's query
row only, which equals the reference's full attention followed by `x[0]`.

Activations are NHWC, as in the JAX package: the images arrive
`[B, H, W, 3]` and every block takes and returns `[B, H, W, C]`.
`conv2d` runs `F.conv2d` on the NCHW view `x.permute(0, 3, 1, 2)`, which
is channels_last in memory, so no activation is copied to change layout.
Conv weights are stored OIHW, PyTorch's and the OpenAI state dict's layout
(the JAX tree holds them HWIO: `models/convert.py::params_from_jax` and the
state-dict converters transpose them).

BatchNorm is "frozen" (the running statistics, CLIP fine-tuning's default)
or "batch" (the current batch's statistics, population variance), set
process-wide by `set_bn_mode` or `with bn_mode(...)`; the train loop
switches "batch" on for `sync_bn`. With a data-parallel mesh of more than
one rank (`set_bn_mode("batch", mesh)`) the statistics are the global
batch's, as under the JAX package's dp mesh: the per-rank sums, then the
sums of squared deviations from the global mean (JAX's two-pass variance),
are all-reduced, and each all-reduce's backward sums the ranks'
cotangents. In both modes the scale and offset are
folded in fp32 and cast to the activations' dtype, and the normalization
is `x * scale + offset` in that dtype, the JAX package's numerics. No hand
kernel runs here: the convolutions go to cuDNN, the pools and the
attention pool's einsums to PyTorch's own kernels. Under bf16 the average
pool sums in fp32 (`F.avg_pool2d`) where XLA's `reduce_window` sums in the
activations' type: the two agree in fp32 and differ by bf16 rounding.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from clip_event_tpu_torch.models import layers as L
from clip_event_tpu_torch.parallel.sharding import full_tree

BN_MODES = ("frozen", "batch")
_BN_MODE = "frozen"
_BN_MESH = None  # the data-parallel mesh of "batch" statistics, or None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NHWC convolution with an OIHW weight cast to x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def set_bn_mode(mode: str, mesh=None) -> None:
    """The BatchNorm statistics of every later call: "frozen" (running
    statistics) or "batch" (the batch's own; with a data-parallel `mesh`,
    the global batch's over its ranks)."""
    global _BN_MODE, _BN_MESH
    if mode not in BN_MODES:
        raise ValueError("bn mode must be 'frozen' or 'batch'")
    _BN_MODE, _BN_MESH = mode, mesh


def get_bn_mode() -> str:
    return _BN_MODE


def get_bn_mesh():
    return _BN_MESH


@contextlib.contextmanager
def bn_mode(mode: str, mesh=None):
    """`with bn_mode("batch"):` sets the BatchNorm mode (and mesh) inside
    and puts the previous ones back after."""
    old = (_BN_MODE, _BN_MESH)
    set_bn_mode(mode, mesh)
    try:
        yield
    finally:
        set_bn_mode(*old)


def batch_norm(x: torch.Tensor, params: dict, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the channels of NHWC x, statistics by the BN mode."""
    if _BN_MODE == "batch" and _BN_MESH is not None and _BN_MESH.world_size > 1:
        from clip_event_tpu_torch.parallel.collectives import all_reduce_sum

        x32 = x.float()
        n = x32.shape[0] * x32.shape[1] * x32.shape[2] * _BN_MESH.world_size
        mean = all_reduce_sum(x32.sum(dim=(0, 1, 2)), _BN_MESH) / n
        var = all_reduce_sum(((x32 - mean) ** 2).sum(dim=(0, 1, 2)), _BN_MESH) / n
    elif _BN_MODE == "batch":
        x32 = x.float()
        mean = x32.mean(dim=(0, 1, 2))
        var = x32.var(dim=(0, 1, 2), correction=0)
    else:
        mean = params["mean"].float()
        var = params["var"].float()
    inv = torch.rsqrt(var + eps)
    s32 = params["scale"].float()
    scale = (s32 * inv).to(x.dtype)
    offset = (params["bias"].float() - mean * s32 * inv).to(x.dtype)
    return x * scale + offset


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Non-overlapping window mean of NHWC x (VALID: a remainder is dropped)."""
    if window == 1:
        return x
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window, window).permute(0, 2, 3, 1)


def bottleneck(x: torch.Tensor, params: dict, stride: int) -> torch.Tensor:
    params = full_tree(params)  # FSDP: the block's leaves gathered at once
    out = torch.relu(batch_norm(conv2d(x, params["conv1_w"]), params["bn1"]))
    out = torch.relu(batch_norm(conv2d(out, params["conv2_w"], padding=1), params["bn2"]))
    out = avg_pool(out, stride)
    out = batch_norm(conv2d(out, params["conv3_w"]), params["bn3"])
    if "downsample" in params:
        identity = avg_pool(x, stride)
        identity = batch_norm(
            conv2d(identity, params["downsample"]["conv_w"]), params["downsample"]["bn"]
        )
    else:
        identity = x
    return torch.relu(out + identity)


def attention_pool(x: torch.Tensor, params: dict, num_heads: int) -> torch.Tensor:
    """QKV pooling head, [B, H, W, C] → [B, out_dim]. Keys and values cover
    the mean token and the grid tokens with the positional embedding; only
    the mean token's query row is computed. The products accumulate in
    fp32, the softmax is fp32 and cast to x's dtype, as in JAX."""
    params = full_tree(params)
    B, H, W, C = x.shape
    tokens = x.reshape(B, H * W, C)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + params["positional_embedding"].to(tokens.dtype)

    q = L.linear(tokens[:, 0], params["q_w"], params["q_b"])  # [B, C]
    k = L.linear(tokens, params["k_w"], params["k_b"])  # [B, S, C]
    v = L.linear(tokens, params["v_w"], params["v_b"])

    head_dim = C // num_heads
    S = tokens.shape[1]
    qh = (q * head_dim**-0.5).reshape(B, num_heads, head_dim)
    kh = k.reshape(B, S, num_heads, head_dim)
    vh = v.reshape(B, S, num_heads, head_dim)
    logits = torch.einsum("bhd,bshd->bhs", qh.float(), kh.float())
    weights = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhs,bshd->bhd", weights.float(), vh.float()).to(x.dtype).reshape(B, C)
    return L.linear(out, params["c_w"], params["c_b"])


def resnet_encode(
    params: dict,
    images: torch.Tensor,
    layers_cfg: tuple,
    num_heads: int,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """ModifiedResNet forward: [B, H, W, 3] → [B, E]. No block is
    recomputed in the backward pass (the JAX package passes no remat to
    this tower)."""
    x = images.to(compute_dtype)
    stem = full_tree(params["stem"])
    x = torch.relu(batch_norm(conv2d(x, stem["conv1_w"], stride=2, padding=1), stem["bn1"]))
    x = torch.relu(batch_norm(conv2d(x, stem["conv2_w"], padding=1), stem["bn2"]))
    x = torch.relu(batch_norm(conv2d(x, stem["conv3_w"], padding=1), stem["bn3"]))
    x = avg_pool(x, 2)
    for stage_idx, num_blocks in enumerate(layers_cfg):
        stage = params[f"layer{stage_idx + 1}"]
        stride = 1 if stage_idx == 0 else 2
        for block_idx in range(num_blocks):
            x = bottleneck(x, stage[block_idx], stride if block_idx == 0 else 1)
    return attention_pool(x, params["attnpool"], num_heads)


# ----------------------------------------------------------------- init


def _init_bn(ch: int, zero_scale: bool = False) -> dict:
    return {
        "scale": torch.zeros(ch) if zero_scale else torch.ones(ch),
        "bias": torch.zeros(ch),
        "mean": torch.zeros(ch),
        "var": torch.ones(ch),
    }


def _init_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
    """He-normal OIHW weight."""
    return torch.randn((cout, cin, kh, kw), generator=gen) * math.sqrt(2.0 / (kh * kw * cin))


def init_resnet(
    gen: torch.Generator,
    layers_cfg: tuple,
    width: int,
    input_resolution: int,
    output_dim: int,
) -> dict:
    """Random init of the reference's structure (the JAX package's scheme,
    the zero-init `bn3` scale included), drawn from `gen`; each stage is a
    list of block dicts, as in the JAX tree."""
    params = {
        "stem": {
            "conv1_w": _init_conv(gen, 3, 3, 3, width // 2),
            "bn1": _init_bn(width // 2),
            "conv2_w": _init_conv(gen, 3, 3, width // 2, width // 2),
            "bn2": _init_bn(width // 2),
            "conv3_w": _init_conv(gen, 3, 3, width // 2, width),
            "bn3": _init_bn(width),
        }
    }
    inplanes = width
    for stage_idx, num_blocks in enumerate(layers_cfg):
        planes = width * (2**stage_idx)
        stride = 1 if stage_idx == 0 else 2
        blocks = []
        for block_idx in range(num_blocks):
            block = {
                "conv1_w": _init_conv(gen, 1, 1, inplanes, planes),
                "bn1": _init_bn(planes),
                "conv2_w": _init_conv(gen, 3, 3, planes, planes),
                "bn2": _init_bn(planes),
                "conv3_w": _init_conv(gen, 1, 1, planes, planes * 4),
                "bn3": _init_bn(planes * 4, zero_scale=True),
            }
            s = stride if block_idx == 0 else 1
            if s > 1 or inplanes != planes * 4:
                block["downsample"] = {
                    "conv_w": _init_conv(gen, 1, 1, inplanes, planes * 4),
                    "bn": _init_bn(planes * 4),
                }
            blocks.append(block)
            inplanes = planes * 4
        params[f"layer{stage_idx + 1}"] = blocks

    embed_dim = width * 32
    spatial = input_resolution // 32
    std = embed_dim**-0.5

    def normal(*shape):
        return std * torch.randn(shape, generator=gen)

    params["attnpool"] = {
        "positional_embedding": normal(spatial * spatial + 1, embed_dim),
        "q_w": normal(embed_dim, embed_dim),
        "q_b": torch.zeros(embed_dim),
        "k_w": normal(embed_dim, embed_dim),
        "k_b": torch.zeros(embed_dim),
        "v_w": normal(embed_dim, embed_dim),
        "v_b": torch.zeros(embed_dim),
        "c_w": normal(embed_dim, output_dim),
        "c_b": torch.zeros(output_dim),
    }
    return params
