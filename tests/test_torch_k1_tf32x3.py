"""K1's fp32 tensor-core variant, "tf32x3" (split TF32, S <= 128), on the
CPU. The kernels run on the card only (`chip_smoke.py --only k1` and
`tests/test_torch_card.py` hold them there); here:

(a) the plain version that splits where the kernel splits (`tf32x3=True`),
    forward and gradient, against the JAX K1 Pallas kernel in interpret
    mode at 1e-5, on numpy-seeded inputs: the B/32 text tower's causal
    S = 77 (W = 512, H = 8) and the vision tower's S = 50 (W = 768,
    H = 12) at B = 2, the tile edges S = 1, 16, 17 and 128, and head_dim
    16, 32 and 128; and within the card's fp32 gates of the unsplit plain
    version;
(b) the rule: K1 takes K2's three-way rule for every dtype and head_dim,
    and so do both K1 libraries' `clip_attention_variant` (the C function,
    compiled here by the host's C++ compiler, read through
    `library_variant`);
(c) the backward's launches per call: one on the tensor-core variants,
    two on tf32x3 at head_dim 128 and on simt;
(d) the wrapper refuses an fp32 qkv (or do) that is not 16-byte aligned on
    the tf32x3 variant, and takes any alignment on fp32 simt (head_dim
    40); `_FusedAttention` on the CPU saves (qkv, bias) alone for fp32."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.ops.attention_pallas import fused_attention_qkv as jax_fused  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

ATOL = 1e-5
# the card's fp32 gates (PERF.md §2): forward max abs, backward relative to
# max|plain|
FWD_GATE, BWD_GATE = 1e-5, 1e-5
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "clip_event_tpu_torch", "csrc")


def _inputs(B, S, W, causal, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    do = rng.normal(size=(B, S, W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    return qkv, do, bias


# (B, S, W, H, causal): the B/32 towers' shapes, then the tile edges of the
# variant (one row; one warp of 16 rows; a row past it; eight warps) and the
# other head dims it takes (128: the two-launch backward)
SHAPES = [
    (2, 77, 512, 8, True), (2, 50, 768, 12, False),
    (2, 1, 128, 2, False), (2, 16, 128, 2, True), (2, 17, 128, 2, False), (1, 128, 128, 2, True),
    (2, 40, 64, 4, True), (2, 33, 128, 4, False), (1, 77, 256, 2, True),
]
IDS = [f"S{S}_W{W}_D{W // H}_{'causal' if c else 'nobias'}" for _, S, W, H, c in SHAPES]


@pytest.mark.parametrize("B,S,W,H,causal", SHAPES, ids=IDS)
def test_split_plain_version_matches_pallas_interpret(B, S, W, H, causal):
    qkv, do, bias = _inputs(B, S, W, causal, seed=S + W // H)
    assert TA.k1_variant(torch.float32, W // H) == "tf32x3"
    scale = (W // H) ** -0.5
    jb = None if bias is None else jnp.asarray(bias)
    ref, vjp = jax.vjp(lambda x: jax_fused(x, jb, H, scale, True), jnp.asarray(qkv))
    (ref_grad,) = vjp(jnp.asarray(do))
    tq, tdo = torch.from_numpy(qkv), torch.from_numpy(do)
    tb = None if bias is None else torch.from_numpy(bias)
    out = TA.fused_attention_qkv_plain(tq, tb, H, scale, tf32x3=True)
    grad = TA.fused_attention_qkv_bwd_plain(tq, tb, tdo, H, scale, tf32x3=True)
    assert out.dtype == grad.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=ATOL, rtol=0)
    # the card's gates against the unsplit plain version hold for the split
    # arithmetic itself
    plain = TA.fused_attention_qkv_plain(tq, tb, H, scale)
    assert (out - plain).abs().max().item() <= FWD_GATE
    plain = TA.fused_attention_qkv_bwd_plain(tq, tb, tdo, H, scale)
    assert ((grad - plain).abs().max() / plain.abs().max()).item() <= BWD_GATE


def test_k1_takes_the_three_way_rule_for_every_dtype_and_head_dim():
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in range(1, TA.MAX_HEAD_DIM + 1):
            want = "simt"
            if D in TA.MMA_HEAD_DIMS and dtype != torch.float16:
                want = "mma" if dtype == torch.bfloat16 else "tf32x3"
            assert TA.k1_variant(dtype, D) == want == TA.headgrid_variant(dtype, D), (dtype, D)
    assert TA.VARIANTS == ("mma", "tf32x3", "simt")
    # the B/32 towers (512 / 8, 768 / 12) and the L/14 text tower (768 / 12)
    # take the tensor cores in fp32 as in bf16
    for W, H in ((512, 8), (768, 12)):
        assert TA.k1_variant(torch.float32, W // H) == "tf32x3"
        assert TA.k1_variant(torch.bfloat16, W // H) == "mma"


def _c_rule(source, symbol, tmp_path):
    """`symbol` (a plain C function of two ints) cut out of csrc/`source`
    and built by the host's C++ compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler builds the variant rule"
    with open(os.path.join(CSRC, source)) as fh:
        text = fh.read()
    m = re.search(r'extern "C" int ' + symbol + r"\(int dtype, int D\) \{\n.*?\n\}\n", text, re.S)
    assert m, f"{symbol} in {source}"
    src, lib = tmp_path / f"{source}.cc", tmp_path / f"{source}.so"
    src.write_text(m.group(0))
    subprocess.run([cxx, "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    return getattr(ctypes.CDLL(str(lib)), symbol)


@pytest.mark.parametrize("name,source", [(TA.KERNEL, "attention_fwd.cu"), (TA.BWD_KERNEL, "attention_bwd.cu")])
def test_both_k1_libraries_decide_as_python(monkeypatch, tmp_path, name, source):
    fn = _c_rule(source, "clip_attention_variant", tmp_path)
    lib = type("Lib", (), {"clip_attention_variant": fn})()
    monkeypatch.setattr(TA._build, "load", lambda n: lib)
    assert TA.library_variant(name, torch.float32, 64) == "tf32x3"
    for dtype in (torch.float32, torch.bfloat16):
        for D in range(1, TA.MAX_HEAD_DIM + 1):
            assert TA.library_variant(name, dtype, D) == TA.k1_variant(dtype, D), (dtype, D)


def test_backward_launches_per_call():
    for D in (16, 32, 64):
        assert TA.bwd_launches_per_call("tf32x3", D) == 1
        assert TA.bwd_launches_per_call("mma", D) == 1
    # at head_dim 128 the four fp32 tiles of a head do not fit one block
    assert TA.bwd_launches_per_call("tf32x3", 128) == 2
    assert TA.bwd_launches_per_call("mma", 128) == 1
    assert TA.TF32X3_ONE_LAUNCH_MAX_HEAD_DIM == 64
    for D in (8, 40, 127):
        assert TA.bwd_launches_per_call("simt", D) == 2


def _misaligned(shape):
    n = int(np.prod(shape))
    t = torch.zeros(n + 1, dtype=torch.float32)[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("which", ["qkv", "do"])
def test_tf32x3_refuses_a_misaligned_fp32_input(which):
    B, S, W, H = 2, 77, 512, 8  # the B/32 text tower: head_dim 64
    qkv, do = torch.zeros((B, S, 3 * W)), torch.zeros((B, S, W))
    if which == "qkv":
        qkv = _misaligned((B, S, 3 * W))
    else:
        do = _misaligned((B, S, W))
    with pytest.raises(ValueError, match=f"tf32x3 variant\\) needs {which} aligned to 16 bytes"):
        TA._check_kernel_input(qkv, None, H, do)
    # aligned tensors pass the alignment check and stop at the device check
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(qkv.clone(), None, H, do.clone())
    # fp32 with a head_dim no tensor-core tile takes (40): simt, any alignment
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        TA._check_kernel_input(_misaligned((1, 13, 240)), None, 2)


def test_fp32_function_on_the_cpu_saves_no_residuals():
    """On a CPU tensor K1 runs its plain versions for fp32 too, saves qkv
    and bias alone, launches nothing, and impl "rounded" (bf16 only) leaves
    fp32 as the plain pair."""
    qkv, do, bias = _inputs(2, 77, 128, True, seed=1)
    qkv, do, bias = torch.from_numpy(qkv), torch.from_numpy(do), torch.from_numpy(bias)
    before = (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_bwd.launches)
    x = qkv.clone().requires_grad_(True)
    out = TA.fused_attention_qkv(x, bias, 2, 0.125)
    assert len(out.grad_fn.saved_tensors) == 2
    (grad,) = torch.autograd.grad(out, x, do)
    assert torch.equal(grad, TA.fused_attention_qkv_bwd(qkv, bias, do, 2, 0.125))
    assert torch.equal(TA.attend(qkv, bias, 2, 0.125, impl="rounded"), TA.attend(qkv, bias, 2, 0.125, impl="plain"))
    assert (TA.fused_attention_qkv.launches, TA.fused_attention_qkv_bwd.launches) == before
