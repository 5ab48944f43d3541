"""Multi-head attention over the packed QKV projection: K1 and K2, each
forward and backward, and K6, the LayerNorm → QKV → attention megakernel.

Counterpart of `clip_event_tpu/ops/attention_pallas.py::fused_attention_qkv`
(K1) and `fused_attention_qkv_headgrid` (K2) with their custom VJPs. Both
have one contract: the attention core reads the raw [B, S, 3W] output of
the fused QKV matmul (torch/CLIP lane layout: q in [0, W), k in [W, 2W), v
in [2W, 3W), head h at h·D in each) and returns the head outputs
concatenated as [B, S, W], ready for the out-projection. Its gradient is
written packed as [B, S, 3W] from qkv and the output's cotangent alone (P
is recomputed, never saved); the bias gets none.

`fused_attention_qkv` is a `torch.autograd.Function`. On a CUDA tensor its
forward launches the hand-written kernel of `csrc/attention_fwd.cu` and
its backward the one of `csrc/attention_bwd.cu`, or they raise if the
kernel cannot take the input. Those kernels stage a whole head's K and V
(the backward also Q and dO) in shared memory, so they take S <= 128.
`fused_attention_qkv_headgrid`
is the same function for the longer sequences of the ViT-B/16 and ViT-L/14
vision towers (S = 197, 257): its kernels, `csrc/attention_hg_fwd.cu` and
`csrc/attention_hg_bwd.cu`, walk K and V in tiles with an online softmax,
so any S runs; they take the head-grid shapes of the JAX kernel
(`head_grid_supported`). On a CPU tensor both run
`fused_attention_qkv_plain` and `fused_attention_qkv_bwd_plain`, the same
function in plain PyTorch. Nothing falls back from a kernel to its plain
version. `attend(..., impl="plain")` runs the plain pair on any device: the
reference a run on the card is held against; `impl="rounded"` runs it with
the roundings of the kernels' tensor-core variants (below) where an input
takes that variant.

K1 and K2 each have three hand-written variants, chosen by dtype and
head_dim alone before anything launches, by one rule for both pairs
(`headgrid_variant`, alias `k1_variant`; `clip_attention_variant` and
`clip_attention_hg_variant` in the libraries): "mma" (bf16 with head_dim
16, 32, 64 or 128) runs every product on the tensor cores with bf16
operands and fp32 accumulators, which rounds P to bf16 before P·V and
Pᵀ·dO and dS to bf16 before dS·K and dSᵀ·Q; "tf32x3" (fp32 with those
head dims) runs every product on the tensor cores in split TF32: each
fp32 operand x is split as hi = tf32(x), lo = tf32(x − hi) and a·b is
summed as lo·hi′ + hi·lo′ + hi·hi′ in fp32, within the fp32 gate; "simt"
(the head dims no tensor-core tile fits) keeps every product in fp32 on
the CUDA cores. None gives way to another or to the plain version. The
tensor-core forwards also write each row's log-sum-exp [B, H, S];
`_FusedAttention` and `_HeadGridAttention` save it and the output beside
qkv and bias (the out-projection saves the output anyway), so their
backwards recompute nothing of the forward but the scores. Called directly without them,
`fused_attention_qkv_bwd` and `fused_attention_qkv_headgrid_bwd` run the
forward kernel first. `mma_rounding=True` on the plain versions rounds
where the mma variant rounds and `tf32x3=True` splits where the tf32x3
variant splits: each is its variant's plain version proper, which tests
and `chip_smoke.py` hold it against; nothing on a main path calls them.

`fused_ln_qkv_attention` (K6, the counterpart of the JAX function of the
same name) computes LayerNorm → the packed QKV projection → K1's attention
core in one kernel, `csrc/ln_qkv_attention.cu`, forward only: neither the
normalized rows nor the [B, S, 3W] projection reach device memory. It is a
measurement vehicle (`tools/bench_components.py megakernel`), not on the
train path. Its three hand-written variants follow K1's rule
(`mega_variant`): "mma" (bf16) and "tf32x3" (fp32) run the projection on
the tensor cores (bf16 products, or split TF32) and K1's tf32x3 core on
the fp32 q, k and v, one block an item; "simt" (head dims other than 16,
32 and 64) is the first, CUDA-core kernel. `mega_layout` picks how the
tensor-core variants hold the normalized rows: staged once an item
("resident", bf16 where they fit) or streamed with the weight ("stream").
`fused_ln_qkv_attention_plain` is the same function in plain PyTorch,
with the kernel's roundings.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from clip_event_tpu_torch.ops import _build

MAX_SEQ = 128
MAX_HEAD_DIM = 128
KERNEL = "attention_fwd"
BWD_KERNEL = "attention_bwd"
HG_KERNEL = "attention_hg_fwd"
HG_BWD_KERNEL = "attention_hg_bwd"
# kernels a K2 backward call launches, in every variant (dq pass, dk/dv
# pass); K1's: `bwd_launches_per_call`
HG_BWD_LAUNCHES_PER_CALL = 2
# the tensor-core variants of K1 and K2 (bf16 and fp32) take one of these
# head dims
MMA_HEAD_DIMS = (16, 32, 64, 128)
VARIANTS = ("mma", "tf32x3", "simt")  # of K1 and of K2
# K1's tf32x3 backward is one launch while the four fp32 tiles of a head
# fit one block (270 KB at S = D = 128 do not): up to this head_dim
TF32X3_ONE_LAUNCH_MAX_HEAD_DIM = 64
# the libraries' variant codes (`clip_attention_variant` and
# `clip_attention_hg_variant` return 0, 1 or 2)
_VARIANT_CODES = {0: "simt", 1: "mma", 2: "tf32x3"}
_VARIANT_NUMBERS = {name: code for code, name in _VARIANT_CODES.items()}
# the tensor-core variants read and write 16 bytes at a time (cp.async and
# ldmatrix; the mma forwards by TMA, whose tensor maps also need each row's
# pitch, 6W bytes of qkv and 2W of out in bf16, a multiple of 16 bytes:
# every head_dim the rule sends to "mma", 16 to 128, gives one)
TENSOR_CORE_VARIANTS = ("mma", "tf32x3")
MMA_ALIGN = 16
# K2 takes heads in 128-lane groups, as the TPU kernel's lane blocks do
HG_LANES = 128
MEGA_KERNEL = "ln_qkv_attention"
# K6 keeps a head's q, k and v in shared memory beside its tiles, and the
# simt variant's threads own 4 neighbouring columns of the projection
MEGA_MAX_SEQ = 128
MEGA_MAX_HEAD_DIM = 64
# K6's tensor-core layouts of the A operand (`mega_layout`) and what a block
# may hold; the stages of `csrc/ln_qkv_attention.cu` (its `layout` region)
MEGA_LAYOUTS = ("resident", "stream")
MEGA_SMEM_LIMIT = 232_448
# weight k-rows (and stream x columns) a stage of the ring, by element size:
# four k-steps of the product between barriers in either dtype
MEGA_TILE_ROWS = {2: 64, 4: 32}
MEGA_MAX_STAGES = 6  # the ring takes as many stages as fit, up to this
_MEGA_LAYOUT_CODES = {"resident": 0, "stream": 1, "simt": 0}
# resident items of at most this many tile rows (16·ceil(S/16)) run with 16
# warps: 8 on the next head's projection while 8 run the attention core
# (`split_warps` in the kernel)
MEGA_SPLIT_MAX_ROWS = 80
IMPLS = ("kernel", "plain", "rounded")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _wide(t: torch.Tensor) -> torch.Tensor:
    """fp32 for fp32 and narrower types; float64 stays float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _split_scores(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float):
    """q, k, v as [B, H, S, D] fp32 views, the unnormalized probabilities
    e = exp(q·scale·kᵀ + bias − rowmax) and their row sums, in fp32
    (`_split_heads` / `_probs`)."""
    B, S, W3 = qkv.shape
    x = _wide(qkv).view(B, S, 3, num_heads, W3 // 3 // num_heads)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + _wide(bias)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    return q, k, v, e, e.sum(dim=-1, keepdim=True)


def _split_probs(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float):
    """q, k, v as [B, H, S, D] fp32 views and P = softmax(q·scale·kᵀ + bias)
    in fp32."""
    q, k, v, e, l = _split_scores(qkv, bias, num_heads, scale)
    return q, k, v, e / l


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to `dtype` and widened again: the value a tensor-core
    operand of that type carries."""
    return _wide(t.to(dtype))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as `cvt.rna.tf32.f32` does: the low 13 bits become 0.
    Infinities and NaNs pass unchanged; a value that rounds past the
    largest finite one becomes infinite."""
    if t.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    sign = bits & -(2 ** 31)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -(2 ** 13)
    return torch.where(torch.isfinite(t), (sign | mag).view(torch.float32), t)


def tf32_split(t: torch.Tensor):
    """(hi, lo) = (tf32(t), tf32(t − hi)): the two TF32 halves the tf32x3
    variant splits each fp32 operand into; t − hi is exact in fp32."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b as the tf32x3 variant forms it: lo·hi′ + hi·lo′ + hi·hi′ over
    the TF32 halves, each a product of TF32 values (exact in fp32) summed
    in fp32; lo·lo′ is dropped."""
    (ah, al), (bh, bl) = tf32_split(a.float()), tf32_split(b.float())
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def _tf32x3_scores(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float):
    """`_split_scores` with q·kᵀ in split TF32 and the scale applied after
    the product, as the tf32x3 variant applies it on its accumulators."""
    B, S, W3 = qkv.shape
    x = qkv.float().view(B, S, 3, num_heads, W3 // 3 // num_heads)
    q, k, v = (t.transpose(1, 2) for t in x.unbind(2))
    logits = tf32x3_matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return q, k, v, e, e.sum(dim=-1, keepdim=True)


def fused_attention_qkv_plain(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    mma_rounding: bool = False, tf32x3: bool = False,
) -> torch.Tensor:
    """softmax(q·scale·kᵀ + bias)·v per head in fp32, output in qkv.dtype
    (the math of `_fwd_kernel` / `_probs`). With `mma_rounding` the
    unnormalized probabilities are rounded to qkv.dtype before they
    multiply v and the row sum (of the unrounded values) divides after, as
    K2's tensor-core variant does; scores, softmax and sums stay fp32. With
    `tf32x3` (fp32 inputs), as the tf32x3 variants of K1 and K2: q·kᵀ
    (scaled after) and the unnormalized probabilities times v in split
    TF32 (`tf32x3_matmul`), the row sum dividing after."""
    if mma_rounding and tf32x3:
        raise ValueError("mma_rounding and tf32x3 are two variants' roundings: pick one")
    B, S, W3 = qkv.shape
    if tf32x3:
        _, _, v, e, l = _tf32x3_scores(qkv, bias, num_heads, scale)
        out = tf32x3_matmul(e, v) / l
    elif mma_rounding:
        _, _, v, e, l = _split_scores(qkv, bias, num_heads, scale)
        out = torch.matmul(_rounded(e, qkv.dtype), v) / l
    else:
        _, _, v, p = _split_probs(qkv, bias, num_heads, scale)
        out = torch.matmul(p, v)
    return out.transpose(1, 2).reshape(B, S, W3 // 3).to(qkv.dtype)


def fused_attention_qkv_bwd_plain(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], do: torch.Tensor, num_heads: int,
    scale: float, mma_rounding: bool = False, tf32x3: bool = False,
) -> torch.Tensor:
    """dqkv [B, S, 3W] in qkv.dtype from qkv and the output's cotangent `do`
    [B, S, W], in fp32 ops (the formulas of `_bwd_kernel`): recompute P,
    dv = Pᵀ·do, dp = do·vᵀ, ds = P∘(dp − rowsum(dp∘P)), dq = ds·k·scale,
    dk = dsᵀ·q·scale. With `mma_rounding`, as K2's tensor-core variant: P is
    rounded to qkv.dtype before Pᵀ·do, ds before ds·k and dsᵀ·q, and the row
    term is rowsum(do∘out) over the forward's rounded output (equal to
    rowsum(dp∘P) before rounding); P, dp, ds and every sum stay fp32. With
    `tf32x3` (fp32 inputs), as the tf32x3 variants of K1 and K2: the
    scores, dp, dv, dq and dk products in split TF32 (`tf32x3_matmul`), the
    row term rowsum(do∘out) over the `tf32x3` forward's output."""
    if mma_rounding and tf32x3:
        raise ValueError("mma_rounding and tf32x3 are two variants' roundings: pick one")
    B, S, W3 = qkv.shape
    if tf32x3:
        q, k, v, e, l = _tf32x3_scores(qkv, bias, num_heads, scale)
        p = e / l
        g = do.float().view(B, S, num_heads, -1).transpose(1, 2)
        out = fused_attention_qkv_plain(qkv, bias, num_heads, scale, tf32x3=True)
        out = out.float().view(B, S, num_heads, -1).transpose(1, 2)
        ds = p * (tf32x3_matmul(g, v.transpose(-1, -2)) - (g * out).sum(dim=-1, keepdim=True))
        grads = (tf32x3_matmul(ds, k) * scale, tf32x3_matmul(ds.transpose(-1, -2), q) * scale,
                 tf32x3_matmul(p.transpose(-1, -2), g))
        dqkv = torch.stack([t.transpose(1, 2) for t in grads], dim=2)  # [B, S, 3, H, D]
        return dqkv.reshape(B, S, W3).to(qkv.dtype)
    q, k, v, p = _split_probs(qkv, bias, num_heads, scale)
    g = _wide(do).view(B, S, num_heads, -1).transpose(1, 2)
    dp = torch.matmul(g, v.transpose(-1, -2))
    if mma_rounding:
        out = fused_attention_qkv_plain(qkv, bias, num_heads, scale, mma_rounding=True)
        out = _wide(out).view(B, S, num_heads, -1).transpose(1, 2)
        ds = _rounded(p * (dp - (g * out).sum(dim=-1, keepdim=True)), qkv.dtype)
        p = _rounded(p, qkv.dtype)
    else:
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dv = torch.matmul(p.transpose(-1, -2), g)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dqkv = torch.stack([t.transpose(1, 2) for t in (dq, dk, dv)], dim=2)  # [B, S, 3, H, D]
    return dqkv.reshape(B, S, W3).to(qkv.dtype)


def head_grid_supported(seq_len: int, width: int, num_heads: int) -> bool:
    """The shapes K2 takes (the JAX `head_grid_supported` without its TPU
    VMEM byte model): W a multiple of 128 and head_dim dividing 128. Any
    sequence length runs."""
    if seq_len < 1 or width % num_heads or width % HG_LANES:
        return False
    return HG_LANES % (width // num_heads) == 0


def headgrid_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which of the three hand-written variants of K2, and of K1, takes an
    input, by dtype and head_dim alone: with head_dim 16, 32, 64 or 128,
    "mma" for bf16 and "tf32x3" for fp32 (tensor cores); "simt" (CUDA
    cores) for every other input. The libraries' `clip_attention_hg_variant`
    and `clip_attention_variant` are the same rule."""
    if head_dim in MMA_HEAD_DIMS:
        if dtype == torch.bfloat16:
            return "mma"
        if dtype == torch.float32:
            return "tf32x3"
    return "simt"


# K1 takes K2's rule: one function serves both pairs
k1_variant = headgrid_variant


def bwd_launches_per_call(variant: str, head_dim: int) -> int:
    """Kernels one K1 backward call launches: one on a tensor-core variant
    (every tile of a head fits one block: dq, then dk/dv, in one launch),
    except tf32x3 above TF32X3_ONE_LAUNCH_MAX_HEAD_DIM, and two on simt
    (dq pass, dk/dv pass)."""
    if variant == "simt" or (variant == "tf32x3" and head_dim > TF32X3_ONE_LAUNCH_MAX_HEAD_DIM):
        return 2
    return 1


def _check_aligned(variant: str, **tensors) -> None:
    """The tensor-core variants copy 16 bytes at a time: every tensor they
    read or write must start on a 16-byte boundary (a contiguous view with
    a storage offset need not)."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % MMA_ALIGN:
            raise ValueError(
                f"attention kernel ({variant} variant) needs {name} aligned to {MMA_ALIGN} "
                f"bytes, got data_ptr() % {MMA_ALIGN} == {t.data_ptr() % MMA_ALIGN} (a view with "
                "a storage offset? pass a .clone())"
            )


def _check_kernel_input(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int,
    do: Optional[torch.Tensor] = None, head_grid: bool = False,
) -> str:
    """Raise unless a kernel of K1 (K2 with `head_grid`) takes these CUDA
    tensors; return the variant it takes them in."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, S, 3W], got {tuple(qkv.shape)}")
    B, S, W3 = qkv.shape
    W = W3 // 3
    if W % num_heads:
        raise ValueError(f"width {W} not divisible by num_heads {num_heads}")
    D = W // num_heads
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("attention kernel needs a contiguous qkv")
    if head_grid:
        if not head_grid_supported(S, W, num_heads):
            raise ValueError(
                f"head-grid attention kernel takes W % {HG_LANES} == 0 and head_dim "
                f"dividing {HG_LANES}, got S={S} W={W} H={num_heads}"
            )
    else:
        if not 1 <= S <= MAX_SEQ:
            raise ValueError(f"attention kernel takes 1 <= S <= {MAX_SEQ}, got S={S}")
        if not 1 <= D <= MAX_HEAD_DIM:
            raise ValueError(f"attention kernel takes head_dim <= {MAX_HEAD_DIM}, got {D}")
    variant = headgrid_variant(qkv.dtype, D)
    if variant in TENSOR_CORE_VARIANTS:
        _check_aligned(variant, qkv=qkv, do=do)
    if B < 1:
        raise ValueError("attention kernel needs B >= 1")
    if bias is not None:
        if tuple(bias.shape) != (S, S):
            raise ValueError(f"bias must be [S, S] = [{S}, {S}], got {tuple(bias.shape)}")
        if bias.is_cuda != qkv.is_cuda or bias.get_device() != qkv.get_device():
            raise ValueError("bias must be on qkv's device")
    if do is not None and (
        tuple(do.shape) != (B, S, W) or do.dtype != qkv.dtype or do.device != qkv.device
    ):
        raise ValueError(
            f"do must be [B, S, W] = {(B, S, W)} in {qkv.dtype} on {qkv.device}, "
            f"got {tuple(do.shape)} in {do.dtype} on {do.device}"
        )
    if not qkv.is_cuda:
        raise ValueError(f"attention kernel needs a CUDA tensor, got {qkv.device}")
    return variant


_P, _I = ctypes.c_void_p, ctypes.c_int
# K1 and K2 alike: the forward takes lse; the backward the forward's out and
# lse, and the simt variant's [3, B, H, S] scratch
_FWD_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P]
# (library, C entry point) of each kernel, by `head_grid`: K1 or K2
_FWD_ENTRY = {False: (KERNEL, "clip_attention_fwd"), True: (HG_KERNEL, "clip_attention_hg_fwd")}
_BWD_ENTRY = {False: (BWD_KERNEL, "clip_attention_bwd"), True: (HG_BWD_KERNEL, "clip_attention_hg_bwd")}
_VARIANT_SYMBOL = {KERNEL: "clip_attention_variant", BWD_KERNEL: "clip_attention_variant",
                   HG_KERNEL: "clip_attention_hg_variant", HG_BWD_KERNEL: "clip_attention_hg_variant"}


def _kernel_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    # the JAX wrapper casts the bias to fp32 too
    return None if bias is None else bias.to(torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def library_variant(name: str, dtype: torch.dtype, head_dim: int) -> str:
    """`k1_variant` / `headgrid_variant` as the built library `name` (K1's
    or K2's forward or backward) decides it: `chip_smoke.py` checks that
    the two agree. The C rule returns 0 ("simt"), 1 ("mma") or 2
    ("tf32x3")."""
    lib = _build.load(name)
    fn = getattr(lib, _VARIANT_SYMBOL[name])
    fn.argtypes, fn.restype = [_I, _I], _I
    code = fn(_DTYPES[dtype], head_dim)
    if code not in _VARIANT_CODES:
        raise RuntimeError(f"{name}: {_VARIANT_SYMBOL[name]} returned {code}")
    return _VARIANT_CODES[code]


def _launch_fwd(qkv, bias, num_heads, scale, with_lse: bool, head_grid: bool):
    """Check and launch K1's (K2's with `head_grid`) forward kernel on a
    CUDA tensor. Returns (out, lse): lse is the [B, H, S] fp32 row
    log-sum-exp when `with_lse` and the input takes a tensor-core variant,
    else None. The mma variant encodes its TMA tensor maps on the host at
    every launch (in the C entry point), which this call's host time
    includes."""
    variant = _check_kernel_input(qkv, bias, num_heads, head_grid=head_grid)
    B, S, W3 = qkv.shape
    W = W3 // 3
    bias = _kernel_bias(bias)
    name, symbol = _FWD_ENTRY[head_grid]
    lib, fn = _build.entry(name, symbol, _FWD_ARGS)
    out = qkv.new_empty((B, S, W))
    lse = None
    if variant in TENSOR_CORE_VARIANTS:
        _check_aligned(variant, out=out)
        if with_lse:
            lse = qkv.new_empty((B, num_heads, S), dtype=torch.float32)
    index = qkv.get_device()
    with _build.on_device(index):
        code = fn(
            qkv.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(lse),
            B, S, num_heads, W // num_heads, float(scale), _DTYPES[qkv.dtype], _build.stream(index),
        )
    _build.check(lib, code, f"{name} launch")
    return out, lse


def _launch_bwd(qkv, bias, do, out, lse, num_heads, scale, head_grid: bool) -> torch.Tensor:
    """Check and launch K1's (K2's with `head_grid`) backward kernels on a
    CUDA tensor. The tensor-core variants read the forward's `out` and
    `lse` (they run the forward kernel for them when the caller has none);
    K2's keep delta in the [3, B, H, S] fp32 scratch, K1's need none. The
    simt variants keep m, l and delta there and ignore out and lse."""
    do = do.contiguous()
    _check_kernel_input(qkv, bias, num_heads, do, head_grid=head_grid)
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // num_heads
    bias = _kernel_bias(bias)
    name, symbol = _BWD_ENTRY[head_grid]
    lib, fn = _build.entry(name, symbol, _BWD_ARGS)
    dqkv = torch.empty_like(qkv)
    variant = headgrid_variant(qkv.dtype, D)
    tensor_cores = variant in TENSOR_CORE_VARIANTS
    stats = None
    if head_grid or not tensor_cores:
        stats = torch.empty((3, B, num_heads, S), dtype=torch.float32, device=qkv.device)
    if tensor_cores:
        if out is None or lse is None:
            fwd = fused_attention_qkv_headgrid_fwd if head_grid else fused_attention_qkv_fwd
            out, lse = fwd(qkv, bias, num_heads, scale, with_lse=True)
        if tuple(out.shape) != (B, S, W) or out.dtype != qkv.dtype or tuple(lse.shape) != (B, num_heads, S) \
                or lse.dtype != torch.float32 or out.device != qkv.device or lse.device != qkv.device:
            raise ValueError(
                f"out must be {(B, S, W)} in {qkv.dtype} and lse {(B, num_heads, S)} in float32 on "
                f"{qkv.device}, got {tuple(out.shape)} in {out.dtype}, {tuple(lse.shape)} in {lse.dtype}"
            )
        out, lse = out.contiguous(), lse.contiguous()
        _check_aligned(variant, out=out, dqkv=dqkv)
    else:
        out = lse = None
    index = qkv.get_device()
    with _build.on_device(index):
        code = fn(
            qkv.data_ptr(), _ptr(bias), do.data_ptr(), _ptr(out), _ptr(lse), dqkv.data_ptr(),
            _ptr(stats), B, S, num_heads, D, float(scale), _DTYPES[qkv.dtype], _build.stream(index),
        )
    _build.check(lib, code, f"{name} launch")
    return dqkv


def fused_attention_qkv_fwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    with_lse: bool = False,
):
    """K1's forward as (out, lse), outside autograd: the plain version on a
    CPU tensor (lse None), the kernel on a CUDA tensor it takes, else raise.
    `with_lse` asks the tensor-core variants ("mma", "tf32x3") for the
    [B, H, S] row log-sum-exp that `fused_attention_qkv_bwd` reads beside
    `out`."""
    if qkv.is_cpu:
        return fused_attention_qkv_plain(qkv, bias, num_heads, scale), None
    out, lse = _launch_fwd(qkv, bias, num_heads, scale, with_lse, head_grid=False)
    fused_attention_qkv.launches += 1
    return out, lse


def fused_attention_qkv_bwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], do: torch.Tensor, num_heads: int,
    scale: float, out: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dqkv [B, S, 3W] in qkv.dtype from qkv [B, S, 3W] and the output's
    cotangent do [B, S, W]. CPU tensors take the plain version; any other
    device must be a CUDA tensor the kernel takes (the forward's domain, with
    do of qkv's dtype), else this raises. `out` and `lse` are the forward's
    output and row log-sum-exp, which the tensor-core variants ("mma",
    "tf32x3") read (`_FusedAttention` saves them); without them they run the
    forward kernel first, counted as a forward launch. The simt variant
    recomputes both and ignores them."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_bwd_plain(qkv, bias, do, num_heads, scale)
    dqkv = _launch_bwd(qkv, bias, do, out, lse, num_heads, scale, head_grid=False)
    head_dim = qkv.shape[-1] // 3 // num_heads
    fused_attention_qkv_bwd.launches += bwd_launches_per_call(k1_variant(qkv.dtype, head_dim), head_dim)
    return dqkv


def fused_attention_qkv_headgrid_fwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    with_lse: bool = False,
):
    """K2's forward as (out, lse), outside autograd: the plain version on a
    CPU tensor (lse None), the kernel on a CUDA tensor it takes, else raise.
    `with_lse` asks the tensor-core variants ("mma", "tf32x3") for the
    [B, H, S] row log-sum-exp that `fused_attention_qkv_headgrid_bwd` reads
    beside `out`."""
    if qkv.is_cpu:
        return fused_attention_qkv_plain(qkv, bias, num_heads, scale), None
    out, lse = _launch_fwd(qkv, bias, num_heads, scale, with_lse, head_grid=True)
    fused_attention_qkv_headgrid.launches += 1
    return out, lse


def fused_attention_qkv_headgrid_bwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], do: torch.Tensor, num_heads: int,
    scale: float, out: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2's backward: dqkv [B, S, 3W] packed as JAX's
    `concatenate([dq, dk, dv], -1)` lays it out. CPU tensors take the plain
    version; any other device must be a CUDA tensor K2 takes, else raise.
    `out` and `lse` are the forward's output and row log-sum-exp, which the
    tensor-core variants ("mma", "tf32x3") read (`_HeadGridAttention` saves
    them); without them they run the forward kernel first, counted as a
    forward launch. The simt variant recomputes both inside its dq pass and
    ignores them."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_bwd_plain(qkv, bias, do, num_heads, scale)
    dqkv = _launch_bwd(qkv, bias, do, out, lse, num_heads, scale, head_grid=True)
    fused_attention_qkv_headgrid_bwd.launches += HG_BWD_LAUNCHES_PER_CALL
    return dqkv


def _plain_rounding(impl: str, qkv: torch.Tensor, num_heads: int) -> bool:
    """Whether impl "rounded" applies the mma variants' roundings to this
    input: only where the kernels would take that variant (bf16; the
    tf32x3 variant's splits are not rounded there)."""
    return impl == "rounded" and k1_variant(qkv.dtype, qkv.shape[-1] // 3 // num_heads) == "mma"


class _FusedAttention(torch.autograd.Function):
    """K1 with its gradient ("kernel"), or the plain pair at any shape
    ("plain", "rounded"): saves qkv and bias (the residuals of
    `_fused_qkv_fwd`), not the probabilities, so it composes with
    `torch.utils.checkpoint`; on the kernels' tensor-core variants ("mma",
    "tf32x3") also the output (which the out-projection saves anyway) and
    the [B, H, S] row log-sum-exp, where the JAX VJP recomputes both. No gradient for the
    bias, num_heads, scale or the impl (`_fused_qkv_bwd` returns None)."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale, impl):
        ctx.num_heads, ctx.scale, ctx.impl = num_heads, scale, impl
        if impl != "kernel":
            ctx.save_for_backward(qkv, bias)
            return fused_attention_qkv_plain(qkv, bias, num_heads, scale,
                                             mma_rounding=_plain_rounding(impl, qkv, num_heads))
        out, lse = fused_attention_qkv_fwd(qkv, bias, num_heads, scale, with_lse=ctx.needs_input_grad[0])
        ctx.save_for_backward(*((qkv, bias) if lse is None else (qkv, bias, out, lse)))
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, bias, *residuals = ctx.saved_tensors
        if ctx.impl != "kernel":
            dqkv = fused_attention_qkv_bwd_plain(qkv, bias, do, ctx.num_heads, ctx.scale,
                                                 mma_rounding=_plain_rounding(ctx.impl, qkv, ctx.num_heads))
            return dqkv, None, None, None, None
        out, lse = residuals or (None, None)
        dqkv = fused_attention_qkv_bwd(qkv, bias, do, ctx.num_heads, ctx.scale, out, lse)
        return dqkv, None, None, None, None


class _HeadGridAttention(torch.autograd.Function):
    """K2 with its gradient, the counterpart of `_hg_fwd` / `_hg_bwd`: saves
    qkv and bias, not the probabilities, so it composes with
    `torch.utils.checkpoint`; on the tensor-core variants ("mma",
    "tf32x3") also the output (which the out-projection saves anyway) and
    the [B, H, S] row log-sum-exp, where the JAX VJP recomputes both. No
    gradient for the bias."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        out, lse = fused_attention_qkv_headgrid_fwd(
            qkv, bias, num_heads, scale, with_lse=ctx.needs_input_grad[0])
        ctx.save_for_backward(*((qkv, bias) if lse is None else (qkv, bias, out, lse)))
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, bias, *residuals = ctx.saved_tensors
        out, lse = residuals or (None, None)
        dqkv = fused_attention_qkv_headgrid_bwd(qkv, bias, do, ctx.num_heads, ctx.scale, out, lse)
        return dqkv, None, None, None


def fused_attention_qkv(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """Multi-head softmax attention over a packed QKV projection, with its
    gradient (K1).

    qkv: [B, S, 3W]; bias: additive [S, S] float mask or None. Returns
    [B, S, W] in qkv.dtype. CPU tensors take the plain versions; any other
    device must be a CUDA tensor the kernels take (fp32 or bf16, contiguous,
    S <= 128, head_dim <= 128), else this raises. Where no gradient is
    wanted (grad mode off, or qkv not requiring one) the forward runs
    without `autograd.Function` and saves nothing: the same launch, the
    same bits."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedAttention.apply(qkv, bias, num_heads, float(scale), "kernel")
    return fused_attention_qkv_fwd(qkv, bias, num_heads, scale)[0]


def fused_attention_qkv_headgrid(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float
) -> torch.Tensor:
    """`fused_attention_qkv`'s function and contract for any sequence length
    (K2, JAX `attention_pallas.py:490-496`): packed [B, S, 3W] in, [B, S, W]
    out, the gradient as packed dqkv, none for the bias. CPU tensors take
    the plain versions; any other device must be a CUDA tensor K2 takes
    (fp32 or bf16, contiguous, `head_grid_supported`), else this raises.
    Without a gradient wanted, as `fused_attention_qkv`: no
    `autograd.Function`."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _HeadGridAttention.apply(qkv, bias, num_heads, float(scale))
    return fused_attention_qkv_headgrid_fwd(qkv, bias, num_heads, scale)[0]


def core_kernel(seq_len: int, width: int, num_heads: int) -> str:
    """Which kernel pair takes the attention core at this shape, by shape
    alone (JAX `layers.py:285-311`): "k1" where S <= 128 and head_dim <=
    128, else "k2" where `head_grid_supported`, else a ValueError naming
    the shape. The JAX package sends that last case to its einsum path;
    here it raises on every device, so a CPU run shows what a card run
    would do. No CLIP preset reaches it."""
    if seq_len <= MAX_SEQ and width // num_heads <= MAX_HEAD_DIM:
        return "k1"
    if head_grid_supported(seq_len, width, num_heads):
        return "k2"
    raise ValueError(
        f"no attention kernel takes S={seq_len}, W={width}, H={num_heads}: K1 needs S <= {MAX_SEQ} "
        f"and head_dim <= {MAX_HEAD_DIM}; K2 needs W % {HG_LANES} == 0 and head_dim "
        f"dividing {HG_LANES} (impl='plain' runs any shape)"
    )


def attention_core_fwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    impl: str = "kernel",
):
    """The attention core's forward outside autograd, as (out, lse): with
    impl "kernel" the forward of the pair `core_kernel` picks, asked for
    its lse (`fused_attention_qkv_fwd` / `fused_attention_qkv_headgrid_fwd`
    with `with_lse`); with "plain" or "rounded" the plain version (lse
    None). `attention_core_bwd` takes both back: the split of remat "attn"
    (`models.layers`), which keeps them across the block's recompute."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; options: {IMPLS}")
    if impl != "kernel":
        return fused_attention_qkv_plain(
            qkv, bias, num_heads, scale, mma_rounding=_plain_rounding(impl, qkv, num_heads)), None
    fwd = fused_attention_qkv_fwd if core_kernel(qkv.shape[1], qkv.shape[2] // 3, num_heads) == "k1" \
        else fused_attention_qkv_headgrid_fwd
    return fwd(qkv, bias, num_heads, scale, with_lse=True)


def attention_core_bwd(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], do: torch.Tensor, num_heads: int,
    scale: float, out: torch.Tensor, lse: Optional[torch.Tensor], impl: str = "kernel",
) -> torch.Tensor:
    """dqkv of the attention core from `attention_core_fwd`'s (out, lse):
    the backward of the same pair, which reads them on its tensor-core
    variants (`fused_attention_qkv_bwd` / `fused_attention_qkv_headgrid_bwd`),
    or the plain backward for "plain" and "rounded"."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; options: {IMPLS}")
    if impl != "kernel":
        return fused_attention_qkv_bwd_plain(
            qkv, bias, do, num_heads, scale, mma_rounding=_plain_rounding(impl, qkv, num_heads))
    bwd = fused_attention_qkv_bwd if core_kernel(qkv.shape[1], qkv.shape[2] // 3, num_heads) == "k1" \
        else fused_attention_qkv_headgrid_bwd
    return bwd(qkv, bias, do, num_heads, scale, out, lse)


def attend(
    qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    impl: str = "kernel",
) -> torch.Tensor:
    """`fused_attention_qkv` ("kernel"), or its plain forward and backward on
    any device and at any shape: as they are ("plain"), or with the
    roundings of the kernels' tensor-core variants where an input takes
    that variant ("rounded": P and dS rounded to bf16; the whole-model
    reference of the mma kernels, which no CLI selects)."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}; options: {IMPLS}")
    return _FusedAttention.apply(qkv, bias, num_heads, float(scale), impl)


def megakernel_supported(seq_len: int, width: int, num_heads: int) -> bool:
    """The shapes K6 takes: S <= 128 and a head_dim <= 64 that is a multiple
    of 4 (the kernel's shared-memory layout; the JAX function's gate is its
    VMEM byte model). Any width with such heads runs."""
    if seq_len < 1 or num_heads < 1 or width < 1 or width % num_heads:
        return False
    d = width // num_heads
    return seq_len <= MEGA_MAX_SEQ and d <= MEGA_MAX_HEAD_DIM and d % 4 == 0


def mega_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which of K6's three hand-written variants takes an input: K1's rule
    (`headgrid_variant`) on the head dims K6 takes. With head_dim 16, 32 or
    64, "mma" for bf16 (the projection on bf16 tensor cores) and "tf32x3"
    for fp32 (split TF32), each with the tf32x3 attention core; "simt" (the
    CUDA-core kernel) for the other multiples of 4 up to 64."""
    return headgrid_variant(dtype, head_dim)


def mega_smem_bytes(dtype: torch.dtype, seq_len: int, width: int, num_heads: int,
                    layout: str) -> int:
    """Dynamic shared memory of a K6 launch, as the kernel's `smem_bytes`
    counts it (the simt variant has one layout and ignores `layout`): the
    tensor-core variants hold q, k, v as fp32 tiles of R = 16·ceil(S/16)
    rows by D + 4, each row's mean and rstd, and a ring of as many stages as
    fit (up to `MEGA_MAX_STAGES`) of the weight tile, MEGA_TILE_ROWS[elt] by
    3D + 8 ("stream": and the x tile, R by that + 16 bytes);
    "resident" adds the item's normalized rows, R by W + 8 in bf16. Where two
    stages do not fit, the count with two (over `MEGA_SMEM_LIMIT`)."""
    S, D = seq_len, width // num_heads
    R = -(-S // 16) * 16
    if mega_variant(dtype, D) == "simt":
        return 4 * (32 * D + 32 * (R + 1) + 2 * S * D + S * (D | 1) + 8 * S + 2 * S)
    if layout not in MEGA_LAYOUTS:
        raise ValueError(f"K6 layout {layout!r}; options: {MEGA_LAYOUTS}")
    elt = torch.tensor([], dtype=dtype).element_size()
    fixed = 3 * R * (D + 4) * 4 + 2 * R * 4
    k = MEGA_TILE_ROWS[elt]
    stage = k * (3 * D + 8)
    if layout == "resident":
        fixed += R * (width + 8) * elt
    else:
        stage += R * (k + 16 // elt)
    stage *= elt
    stages = min(MEGA_MAX_STAGES, (MEGA_SMEM_LIMIT - fixed) // stage)
    return fixed + max(stages, 2) * stage


def mega_layout(dtype: torch.dtype, seq_len: int, width: int, num_heads: int) -> str:
    """How K6's tensor-core variants hold the A operand: "resident" (bf16
    whose normalized rows fit beside the rest, `MEGA_SMEM_LIMIT`: staged
    once an item, only the weight streams) or "stream" (fp32, and larger
    bf16 items: x streams beside the weight, normalized once a tile a
    head); "simt" for the simt variant."""
    if mega_variant(dtype, width // num_heads) == "simt":
        return "simt"
    if dtype == torch.bfloat16 and mega_smem_bytes(
            dtype, seq_len, width, num_heads, "resident") <= MEGA_SMEM_LIMIT:
        return "resident"
    return "stream"


def fused_ln_qkv_attention_plain(
    x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor, qkv_w: torch.Tensor,
    qkv_b: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K6 in plain PyTorch, with the roundings of `_mega_fwd_kernel`: γ, β,
    the weight and its bias are cast to x's dtype first; the LayerNorm runs
    in fp32 and is rounded to x's dtype; the projection multiplies those
    rounded operands in fp32 (upcast first: a bf16 matmul would round its
    result) and is not rounded before the attention core; the probabilities
    stay fp32; the output is rounded to x's dtype. `bias=None` is no mask.
    On the card an fp32 input needs
    `torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default)."""
    dt = x.dtype
    g, b, w, wb = (_wide(t.to(dt)) for t in (ln_scale, ln_bias, qkv_w, qkv_b))
    x32 = _wide(x)
    c = x32 - x32.mean(dim=-1, keepdim=True)
    ln = c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    ln = _wide((ln * g + b).to(dt))
    qkv = torch.matmul(ln, w) + wb
    return fused_attention_qkv_plain(qkv, bias, num_heads, scale).to(dt)


_MEGA_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I, _I, _I,
              _P]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it at a 16-byte boundary (the tensor-core variants
    read x, the weight, gamma and beta 16 bytes at a time)."""
    return t if t.data_ptr() % MMA_ALIGN == 0 else t.clone()


def _launch_mega(x, ln_scale, ln_bias, qkv_w, qkv_b, bias, num_heads, scale, eps,
                 layout=None) -> torch.Tensor:
    """Check and launch K6 on a CUDA tensor, in the variant `mega_variant`
    and the layout `mega_layout` choose (`layout` names another one the
    variant takes: `chip_smoke.py` times both)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, W], got {tuple(x.shape)}")
    B, S, W = x.shape
    if not megakernel_supported(S, W, num_heads):
        raise ValueError(
            f"the megakernel takes S <= {MEGA_MAX_SEQ} and head_dim <= {MEGA_MAX_HEAD_DIM}, a "
            f"multiple of 4; got S={S} W={W} H={num_heads}"
        )
    if x.dtype not in _DTYPES:
        raise ValueError(f"the megakernel takes float32 or bfloat16, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"the megakernel needs a CUDA tensor, got {x.device}")
    if B < 1:
        raise ValueError("the megakernel needs B >= 1")
    shapes = {"ln_scale": (ln_scale, (W,)), "ln_bias": (ln_bias, (W,)),
              "qkv_w": (qkv_w, (W, 3 * W)), "qkv_b": (qkv_b, (3 * W,))}
    if bias is not None:
        shapes["bias"] = (bias, (S, S))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, got {tuple(t.shape)} on {t.device}")
    variant = mega_variant(x.dtype, W // num_heads)
    layout = layout or mega_layout(x.dtype, S, W, num_heads)
    takes = {"simt": ("simt",), "tf32x3": ("stream",), "mma": MEGA_LAYOUTS}[variant]
    if layout not in takes or mega_smem_bytes(x.dtype, S, W, num_heads, layout) > MEGA_SMEM_LIMIT:
        raise ValueError(f"K6's {variant} variant does not take the {layout} layout at S={S} W={W} "
                         f"H={num_heads}")
    x = _aligned(x.contiguous())
    # the JAX wrapper casts these to x's dtype before its kernel too
    g, b, w, wb = (t.detach().to(x.dtype).contiguous() for t in (ln_scale, ln_bias, qkv_w, qkv_b))
    g, b, w = _aligned(g), _aligned(b), _aligned(w)
    bias = _kernel_bias(bias)
    lib, fn = _build.entry(MEGA_KERNEL, "clip_ln_qkv_attention", _MEGA_ARGS)
    out = torch.empty_like(x)
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), wb.data_ptr(), _ptr(bias),
            out.data_ptr(), B, S, num_heads, W // num_heads, float(scale), float(eps),
            _DTYPES[x.dtype], _VARIANT_NUMBERS[variant], _MEGA_LAYOUT_CODES[layout], stream,
        )
    _build.check(lib, code, f"{MEGA_KERNEL} launch")
    return out


def fused_ln_qkv_attention(
    x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor, qkv_w: torch.Tensor,
    qkv_b: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int, scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm → packed QKV projection → attention core, one kernel (K6).

    x: [B, S, W]; ln_scale, ln_bias: [W]; qkv_w: [W, 3W]; qkv_b: [3W]; bias:
    additive [S, S] mask or None. Returns [B, S, W] in x.dtype, the contract
    of `fused_attention_qkv` (before the out-projection). Forward only, as
    in the JAX package: it runs outside autograd, so where autograd records
    the result does not require grad. CPU tensors take the plain version;
    any other device must be a CUDA tensor the kernel takes (fp32 or bf16,
    `megakernel_supported`), else this raises."""
    if x.shape[-1] % num_heads:
        raise ValueError(f"width {x.shape[-1]} not divisible by num_heads {num_heads}")
    with torch.no_grad():
        if x.device.type == "cpu":
            return fused_ln_qkv_attention_plain(
                x, ln_scale, ln_bias, qkv_w, qkv_b, bias, num_heads, scale, eps)
        out = _launch_mega(x, ln_scale, ln_bias, qkv_w, qkv_b, bias, num_heads, scale, eps)
    fused_ln_qkv_attention.launches += 1
    return out


# kernel launches since the last reset (chip_smoke.py reads and resets them):
# one per forward call, bwd_launches_per_call(variant, head_dim) (K2:
# HG_BWD_LAUNCHES_PER_CALL) per backward call
fused_attention_qkv.launches = 0
fused_attention_qkv_bwd.launches = 0
fused_attention_qkv_headgrid.launches = 0
fused_attention_qkv_headgrid_bwd.launches = 0
fused_ln_qkv_attention.launches = 0
