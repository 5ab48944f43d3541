"""Int8 (W8A8) inference for the encode paths (counterpart of
`clip_event_tpu/ops/quant.py` and `ops/quant_pallas.py`).

* `QuantWeight`: {q: int8 [..., in, out], scale: fp32 [..., out],
  act_scale: optional fp32 [...] (a scalar per weight, [L] on stacked
  transformer weights)}, from symmetric per-output-channel quantization.
  It slices like a tensor (`w[i]` gives layer i's weight) and moves like
  one (`w.to(device)`), so the stacked layer loop and the param-tree
  helpers carry it where a float weight goes. `q` is stored K-major, as
  the transposed view of a contiguous [..., out, in] buffer (`k_major`),
  the layout K5's tensor-core GEMM reads; every route that builds a
  QuantWeight gets it, and slicing, `.to()`, `torch.save` and
  `load_state_dict` keep it.
* `quantized_linear`: activations quantized per row by their abs-max
  (dynamic), or by the static per-tensor `act_scale` of offline
  calibration; s8 x s8 products summed exactly; float rescale and bias.
  `models.layers.linear` calls it for a `QuantWeight`.
* `quantized_matmul` launches K5, the hand-written kernel of
  `csrc/quant_matmul.cu` (a row-quantise launch, then an int8 GEMM
  launch), on a CUDA tensor, in the dynamic and the static mode alike, and
  raises if it cannot take the input. On a CPU tensor it runs
  `quantized_matmul_plain`, the same steps in plain PyTorch:
  `quantize_rows_plain`, then `quantized_gemm_plain`. `quantize_rows` and
  `quantized_gemm` launch each of K5's two kernels alone.
* `quantize_params` turns every dense weight of the chosen towers into a
  `QuantWeight`; `calibrate_act_scales` runs the act-stat forwards over
  sample batches for the static scales.

`set_gemm_impl`: "auto" and "pallas" (the JAX package's names) mean K5 on
a CUDA tensor and the plain version on a CPU tensor; "xla" means the plain
composition on every device, which a run on the card is held against.
Inference only: nothing here has a gradient.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Any, Optional

import torch

from clip_event_tpu_torch.ops import _build

KERNEL = "quant_matmul"
# each call launches the row pass and the GEMM
LAUNCHES_PER_CALL = 2
# the GEMM's k tile (bytes of K a stage): the int8 activation scratch is
# padded with zeros to it
K_TILE = 128
# TMA reads a row only from a 16-byte aligned start: a weight whose rows
# are not (K % 16 != 0) is padded with zeros to K_TILE for the call
TMA_ALIGN = 16
GEMM_IMPLS = ("auto", "pallas", "xla")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, one ulp off at times."""
    return t / t.new_tensor(127.0)


def is_k_major(q: torch.Tensor) -> bool:
    """q [..., in, out] is the transposed view of a contiguous [..., out, in]
    buffer: each output column's `in` values lie together."""
    return q.transpose(-1, -2).is_contiguous()


def k_major(q: torch.Tensor) -> torch.Tensor:
    """q [..., in, out] with the same values, stored K-major (`is_k_major`);
    q itself if it already is (or is no matrix: a slice of one row)."""
    if q.dim() < 2 or is_k_major(q):
        return q
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


@dataclasses.dataclass
class QuantWeight:
    """Symmetric per-output-channel int8 weight: w ≈ q * scale; with
    `act_scale`, the static per-tensor activation scale of calibration.
    `q` is made K-major here, once, whichever route built the weight."""

    q: torch.Tensor  # int8 [..., in, out], K-major
    scale: torch.Tensor  # float32 [..., out]
    act_scale: Optional[torch.Tensor] = None  # float32 [...]

    def __post_init__(self):
        self.q = k_major(self.q)

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, i) -> "QuantWeight":
        act = None if self.act_scale is None else self.act_scale[i]
        return QuantWeight(self.q[i], self.scale[i], act)

    def to(self, device=None, dtype=None) -> "QuantWeight":
        """Moves the three tensors; `dtype` is ignored (q stays int8, the
        scales fp32), so a cast of a whole param tree leaves them as they are."""
        act = None if self.act_scale is None else self.act_scale.to(device)
        return QuantWeight(self.q.to(device), self.scale.to(device), act)


def quantize_weight(w: torch.Tensor, act_absmax: Optional[torch.Tensor] = None) -> QuantWeight:
    """[..., in, out] float → QuantWeight (per-output-channel abs-max).
    `act_absmax`: calibrated input abs-max ([] or [L]) → static act_scale."""
    w32 = w.float()
    scale = _div127(w32.abs().amax(dim=-2)).clamp_min(1e-12)
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127).to(torch.int8)
    act_scale = None
    if act_absmax is not None:
        act_absmax = torch.as_tensor(act_absmax, dtype=torch.float32, device=w.device)
        act_scale = _div127(act_absmax).clamp_min(1e-12)
    return QuantWeight(q=q, scale=scale, act_scale=act_scale)


_GEMM_IMPL = "auto"


def set_gemm_impl(impl: str) -> None:
    global _GEMM_IMPL
    if impl not in GEMM_IMPLS:
        raise ValueError(f"unknown quant GEMM impl {impl!r}; options: {GEMM_IMPLS}")
    _GEMM_IMPL = impl


@contextlib.contextmanager
def gemm_impl(impl: str):
    """`with gemm_impl("xla"):` selects the int8 GEMM of the
    `quantized_linear` calls inside (`set_gemm_impl`) and puts the previous
    choice back after."""
    old = _GEMM_IMPL
    set_gemm_impl(impl)
    try:
        yield
    finally:
        set_gemm_impl(old)


# ---------------------------------------------------------------- plain


def quantize_rows_plain(x: torch.Tensor, act_scale: Optional[torch.Tensor] = None):
    """x [M, K] → (x_q int8 [M, K], row scale fp32 [M]): dynamic
    s = max(absmax_row / 127, 1e-12), or the static scale for every row;
    x_q = clip(round_half_even(x / s), -127, 127)."""
    x32 = x.float()
    if act_scale is None:
        s = _div127(x32.abs().amax(dim=-1, keepdim=True)).clamp_min(1e-12)
    else:
        s = act_scale.float().reshape(1, 1).expand(x.shape[0], 1)
    xq = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return xq, s.reshape(-1).contiguous()


def quantized_gemm_plain(
    xq: torch.Tensor, row_scale: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K5's GEMM in plain PyTorch on pre-quantised rows xq int8 [M, K] (or
    the row pass's [M, Kp], whose columns past K are zeros): the integer
    product computed exactly in float64 (|sum| <= 127² K < 2⁵³; int32
    matmul has no CUDA implementation and fp32 is exact only to 2²⁴), then
    acc * (row_scale ⊗ scale) + bias in fp32, cast to `dtype`."""
    acc = torch.matmul(xq[:, : q.shape[0]].double(), q.double())
    y = acc.float() * (row_scale[:, None] * scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def quantized_matmul_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, act_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5's steps in plain PyTorch: row quantisation, then the GEMM."""
    xq, s = quantize_rows_plain(x, act_scale)
    return quantized_gemm_plain(xq, s, q, scale, bias, x.dtype)


# ---------------------------------------------------------------- kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_MATMUL_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_GEMM_ARGS = [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]
_ROWS_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]


def padded_k(k: int) -> int:
    return -(-k // K_TILE) * K_TILE


def _check(x: torch.Tensor, act_scale: Optional[torch.Tensor]) -> torch.Tensor:
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"K5 takes x as [M, K] with M, K >= 1, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"K5 takes float32 or bfloat16 activations, got {x.dtype}")
    _check_device(x)
    if act_scale is not None:
        if act_scale.numel() != 1 or act_scale.device != x.device:
            raise ValueError("the static act_scale must be one value on x's device")
        act_scale = act_scale.to(torch.float32).reshape(1).contiguous()
    return act_scale


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K5 needs a CUDA tensor, got {x.device}")


def _check_k_major(q: torch.Tensor) -> None:
    """K5 refuses a q that is not K-major: it makes no hidden transposed copy
    of a weight (`k_major` makes one, once). `is_k_major` for a matrix, read
    from the strides alone (no view: this runs on every call)."""
    if q.dim() != 2:
        return
    K, N = q.shape
    if not ((q.stride(0) == 1 or K == 1) and (q.stride(1) == K or N == 1)):
        raise ValueError(f"K5 takes q K-major (a transposed view of a contiguous [N, K] "
                         f"buffer, as QuantWeight stores it), got strides {q.stride()}")


def _check_weight(q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], K: int,
                  device: torch.device) -> int:
    """N, after checking q int8 [K, N] and scale / bias [N] on `device`."""
    if q.dim() != 2 or q.shape[0] != K or q.dtype != torch.int8 or q.device != device:
        raise ValueError(f"K5 takes q as int8 [K={K}, N] on x's device, got {q.dtype} "
                         f"{tuple(q.shape)} on {q.device}")
    N = q.shape[1]
    if tuple(scale.shape) != (N,) or (bias is not None and tuple(bias.shape) != (N,)):
        raise ValueError(f"K5 takes scale and bias as [N={N}]")
    return N


def weight_operand(q: torch.Tensor):
    """(a tensor holding the [N, K'] int8 rows the GEMM reads, their row
    stride in bytes) for a K-major q [K, N]: q itself, whose buffer is those
    rows, where they start 16-byte aligned; else a copy padded with zeros to
    [N, padded_k(K)] (K = 588, 3, 100, ...; the zero columns add nothing to
    the sums)."""
    K, N = q.shape
    ld = q.stride(1) if N > 1 else K
    if ld % TMA_ALIGN == 0 and q.data_ptr() % TMA_ALIGN == 0:
        return q, ld
    padded = q.new_zeros((N, padded_k(K)))
    padded[:, :K] = q.t()
    return padded, padded.shape[1]


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def quantize_rows(x: torch.Tensor, act_scale: Optional[torch.Tensor] = None):
    """K5's row pass alone: (x_q int8 [M, Kp], row scale fp32 [M]), the
    columns past K zero. CPU tensors take `quantize_rows_plain` (unpadded)."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, act_scale)
    act_scale = _check(x, act_scale)
    x = x.contiguous()
    M, K = x.shape
    Kp = padded_k(K)
    xq = torch.empty((M, Kp), dtype=torch.int8, device=x.device)
    rs = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib, fn = _build.entry(KERNEL, "clip_quant_rows", _ROWS_ARGS)
    with _build.on_device(x.device):
        code = fn(x.data_ptr(), None if act_scale is None else act_scale.data_ptr(),
                  xq.data_ptr(), rs.data_ptr(), M, K, Kp, _DTYPES[x.dtype], _stream(x))
    _build.check(lib, code, f"{KERNEL} row pass")
    quantize_rows.launches += 1
    return xq, rs


def quantized_gemm(
    xq: torch.Tensor, row_scale: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K5's GEMM alone on pre-quantised rows: (xq · q) · (row_scale ⊗ scale)
    + bias, [M, N] in `dtype`. xq int8 [M, K'] with K' >= K = q.shape[0]
    (the row pass's [M, padded_k(K)], or [M, K]) whose rows start 16-byte
    aligned; row_scale fp32 [M]; q int8 [K, N], K-major. CPU tensors take
    `quantized_gemm_plain`; any other device must be a CUDA tensor the
    kernel takes, else this raises."""
    if xq.device.type == "cpu":
        return quantized_gemm_plain(xq, row_scale, q, scale, bias, dtype)
    if xq.dim() != 2 or xq.dtype != torch.int8 or xq.stride(-1) != 1:
        raise ValueError(f"K5's GEMM takes xq as int8 [M, K'] rows, got {xq.dtype} "
                         f"{tuple(xq.shape)} with strides {xq.stride()}")
    if dtype not in _DTYPES:
        raise ValueError(f"K5's GEMM writes float32 or bfloat16, not {dtype}")
    _check_k_major(q)
    _check_device(xq)
    M = xq.shape[0]
    K = q.shape[0] if q.dim() == 2 else -1
    N = _check_weight(q, scale, bias, K, xq.device)
    lda = xq.stride(0) if M > 1 else xq.shape[1]
    if xq.shape[1] < K or lda % TMA_ALIGN or xq.data_ptr() % TMA_ALIGN:
        raise ValueError(f"K5's GEMM takes xq [M, K' >= {K}] with 16-byte aligned rows "
                         f"(the row pass's [M, {padded_k(K)}]), got {tuple(xq.shape)}")
    if tuple(row_scale.shape) != (M,):
        raise ValueError(f"K5's GEMM takes row_scale as [M={M}]")
    rows, ldq = weight_operand(q)
    row_scale = row_scale.to(device=xq.device, dtype=torch.float32).contiguous()
    scale = scale.to(device=xq.device, dtype=torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(device=xq.device, dtype=torch.float32).contiguous()
    y = torch.empty((M, N), dtype=dtype, device=xq.device)
    lib, fn = _build.entry(KERNEL, "clip_quant_gemm", _GEMM_ARGS)
    with _build.on_device(xq.device):
        code = fn(xq.data_ptr(), lda, row_scale.data_ptr(), rows.data_ptr(), ldq, scale.data_ptr(),
                  None if bias is None else bias.data_ptr(), y.data_ptr(), M, K, N, _DTYPES[dtype],
                  _stream(xq))
    _build.check(lib, code, f"{KERNEL} GEMM")
    quantized_gemm.launches += 1
    return y


def quantized_matmul(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, act_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = (rowquant(x) · q) · (row_scale ⊗ scale) + bias, [M, N] in x's
    dtype (K5). x [M, K] fp32 or bf16; q int8 [K, N], K-major; scale fp32
    [N]; bias [N] or None; act_scale None (dynamic per-row scales) or the
    static per-tensor scale. CPU tensors take `quantized_matmul_plain`; any
    other device must be a CUDA tensor the kernel takes, else this raises."""
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, scale, bias, act_scale)
    _check_k_major(q)
    act_scale = _check(x, act_scale)
    M, K = x.shape
    N = _check_weight(q, scale, bias, K, x.device)
    x = x.contiguous()
    rows, ldq = weight_operand(q)
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    Kp = padded_k(K)
    xq = torch.empty((M, Kp), dtype=torch.int8, device=x.device)
    rs = torch.empty((M,), dtype=torch.float32, device=x.device)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib, fn = _build.entry(KERNEL, "clip_quant_matmul", _MATMUL_ARGS)
    with _build.on_device(x.device):
        code = fn(
            x.data_ptr(), None if act_scale is None else act_scale.data_ptr(), xq.data_ptr(),
            rs.data_ptr(), rows.data_ptr(), ldq, scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            M, K, N, Kp, _DTYPES[x.dtype], _stream(x),
        )
    _build.check(lib, code, f"{KERNEL} launch")
    quantized_matmul.launches += LAUNCHES_PER_CALL
    return y


# kernel launches since the last reset (chip_smoke.py reads and resets
# them): LAUNCHES_PER_CALL per `quantized_matmul` call on a CUDA tensor, one
# per call of either kernel alone
quantized_matmul.launches = 0
quantize_rows.launches = 0
quantized_gemm.launches = 0


def quantized_linear(x: torch.Tensor, w: QuantWeight, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = dequant(quant(x) @ w.q) (+ b). x: [..., in]; returns [..., out]
    in x's dtype. Static per-tensor activation scale when `w.act_scale` is
    set, dynamic per-row abs-max otherwise. K5 on the card unless
    `set_gemm_impl("xla")` asked for the plain composition. While
    `torch.export` traces, the custom op `ops.library.quantized_linear`
    (K5 on the card, the plain composition on the CPU, whatever
    `set_gemm_impl` says)."""
    if w.q.dim() != 2:
        raise ValueError(f"quantized_linear takes one layer's [in, out] weight, got {tuple(w.q.shape)}")
    k, n = w.q.shape
    x2 = x.reshape(-1, k)
    if torch.compiler.is_exporting():
        from clip_event_tpu_torch.ops import library

        y = library.quantized_linear(x2, w.q, w.scale, w.act_scale, b)
    elif _GEMM_IMPL == "xla":
        y = quantized_matmul_plain(x2, w.q, w.scale, b, w.act_scale)
    else:
        y = quantized_matmul(x2, w.q, w.scale, b, w.act_scale)
    return y.reshape(*x.shape[:-1], n)


# ---------------------------------------------------------------- trees

# Param-tree leaf names that hold dense matmul weights ([..., in, out]).
_DENSE_KEYS = frozenset(
    {"qkv_w", "out_w", "fc_w", "proj_w", "patch_embed_w", "proj", "text_projection"}
)
_TOWER_KEYS = {
    "visual": ("visual",),
    "text": ("text_transformer", "text_projection", "token_embedding"),
}


def quantize_params(params: Any, act_stats: Any = None, towers=None) -> Any:
    """CLIP param dict → the same dict with its dense weights as
    QuantWeight. Biases, LayerNorms, embeddings and logit_scale pass through.

    `act_stats`: a calibration tree from `calibrate_act_scales` (the
    nesting of `params`, an abs-max per dense input); weights with a stat
    get a static activation scale, the rest stay dynamic. `towers`: None
    (both) or a subset of {"visual", "text"}."""
    allowed = None
    if towers is not None:
        unknown = set(towers) - set(_TOWER_KEYS)
        if unknown:
            raise ValueError(f"unknown towers {sorted(unknown)}; options: visual, text")
        allowed = {k for t in towers for k in _TOWER_KEYS[t]}

    def walk(node, stats, active):
        # `active` is None only at the root, where the tower filter applies
        # per top-level key; below that it propagates as it is. A list (a
        # ResNet stage) holds conv blocks, which stay float
        if isinstance(node, list):
            return [walk(v, None, active) for v in node]
        out = {}
        for k, v in node.items():
            act = (allowed is None or k in allowed) if active is None else active
            s = stats.get(k) if isinstance(stats, dict) else None
            if isinstance(v, (dict, list)):
                out[k] = walk(v, s, act)
            elif act and k in _DENSE_KEYS and isinstance(v, torch.Tensor) and v.dim() >= 2:
                out[k] = quantize_weight(v, act_absmax=s)
            else:
                out[k] = v
        return out

    return walk(params, act_stats, None)


def _tree_max(a: dict, b: dict) -> dict:
    return {k: _tree_max(v, b[k]) if isinstance(v, dict) else torch.maximum(v, b[k])
            for k, v in a.items()}


def calibrate_act_scales(params: dict, cfg, image_batches, token_batches,
                         compute_dtype=torch.float32) -> dict:
    """Static-activation calibration: the act-stat forwards
    (`models.vit.vit_act_stats`, `models.clip.text_act_stats`) over sample
    batches (numpy), and the element-wise max abs-max tree, shaped for
    `quantize_params(params, act_stats=...)`. Runs on the params' device."""
    from clip_event_tpu_torch.models.clip import text_act_stats
    from clip_event_tpu_torch.models.vit import vit_act_stats

    device = params["logit_scale"].device
    stats = None
    with torch.no_grad():
        if cfg.is_vit:
            for imgs in image_batches:
                x = torch.as_tensor(imgs, device=device)
                s = {"visual": vit_act_stats(params["visual"], x, cfg.vision_patch_size,
                                             cfg.vision_heads, compute_dtype=compute_dtype)}
                stats = s if stats is None else _tree_max(stats, s)
        tstats = None
        for toks in token_batches:
            t = torch.as_tensor(toks, device=device)
            s = text_act_stats(params, cfg, t, compute_dtype=compute_dtype)
            tstats = s if tstats is None else _tree_max(tstats, s)
    if tstats is not None:
        stats = dict(stats or {}, **tstats)
    return stats


def is_quantized(params: Any) -> bool:
    if isinstance(params, QuantWeight):
        return True
    if isinstance(params, dict):
        return any(is_quantized(v) for v in params.values())
    if isinstance(params, list):
        return any(is_quantized(v) for v in params)
    return False
