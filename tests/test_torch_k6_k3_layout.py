"""The Python that decides K6's and K3's variants and layouts, and the
arithmetic of their tensor-core and warp variants, on the CPU. The kernels
themselves run on the card only (`chip_smoke.py --only k3 k6` and
`tests/test_torch_card.py` hold them there); here:

(a) K3's variant rule (`ops.ot.ipot_variant`) at its boundaries: "warp" up
    to 32 entities and 32 objects, "block" one past either;
(b) K6's variant rule (`ops.attention.mega_variant`, K1's rule on the head
    dims K6 takes) and layout rule (`mega_layout`): the component bench's
    bf16 shapes stay "resident" (225,920 / 228,864 bytes with three stages
    of the ring), fp32 and the bf16 items too wide to stay resident "stream";
(c) for every (S, W, H) that `megakernel_supported` accepts at the CLIP
    widths (512, 768, 1024) and at `chip_smoke.py`'s edge shapes, the chosen
    layout fits in the 232,448 bytes a block may use, in both dtypes, and
    `megakernel_supported` accepts exactly what it accepted before;
(d) the shared-memory count of `csrc/ln_qkv_attention.cu` (its `layout`
    region, built here by the host's C++ compiler) equals
    `mega_smem_bytes` at every variant and layout it takes, and is 0 where
    the kernel refuses;
(e) the warp variant's order of sums (one term a lane, a butterfly over 32
    lanes, n in order) against the JAX solver at 1e-5, and the tensor-core
    variants' arithmetic (the projection in split TF32 for fp32, exact bf16
    products for bf16; K1's tf32x3 core) against the JAX megakernel in
    interpret mode, within the card's gates (1e-4 / 2e-2)."""

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

from clip_event_tpu.ops import ot as JOT  # noqa: E402
from clip_event_tpu.ops.attention_pallas import fused_ln_qkv_attention as jax_mega  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402
from clip_event_tpu_torch.ops import ot as TOT  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "clip_event_tpu_torch", "csrc")
SMEM_LIMIT = 232_448
DTYPES = (torch.float32, torch.bfloat16)
# chip_smoke.py's K6 shapes (tag, B, S, W, H, causal)
MEGA_SHAPES = [("mega_text", 768, 77, 512, 8, True), ("mega_vision", 256, 50, 768, 12, False)]
MEGA_EDGE_SHAPES = [
    ("mega_edge_b1", 1, 13, 128, 2, True), ("mega_edge_s1", 2, 1, 128, 2, False),
    ("mega_edge_s128", 2, 128, 128, 2, True), ("mega_edge_d32", 3, 40, 256, 8, False),
    ("mega_edge_w60_d20", 2, 19, 60, 3, True), ("mega_edge_d16", 2, 33, 128, 8, True),
    ("mega_edge_w1024", 2, 77, 1024, 16, True), ("mega_edge_s128_w768", 2, 128, 768, 12, False),
]


@pytest.mark.parametrize("M,N,variant", [
    (1, 1, "warp"), (16, 7, "warp"), (16, 10, "warp"), (32, 32, "warp"), (33, 32, "block"),
    (32, 33, "block"), (33, 33, "block"), (128, 128, "block"), (1, 128, "block"), (128, 1, "block"),
])
def test_ipot_variant_boundary(M, N, variant):
    assert TOT.ipot_variant(M, N) == variant
    assert variant in TOT.IPOT_VARIANTS
    assert TOT.WARP_MAX_ENTITIES == TOT.WARP_MAX_OBJECTS == 32 and TOT.MAX_NODES == 128


def test_mega_variant_is_k1s_rule_on_k6s_head_dims():
    for D in range(4, TA.MEGA_MAX_HEAD_DIM + 1, 4):
        for dtype in DTYPES:
            assert TA.mega_variant(dtype, D) == TA.k1_variant(dtype, D)
        tc = D in (16, 32, 64)
        assert TA.mega_variant(torch.bfloat16, D) == ("mma" if tc else "simt")
        assert TA.mega_variant(torch.float32, D) == ("tf32x3" if tc else "simt")


@pytest.mark.parametrize("dtype,S,W,H,layout,nbytes", [
    # the ring takes 3 stages of 64 weight rows beside the resident rows
    (torch.bfloat16, 77, 512, 8, "resident", 225_920),
    (torch.bfloat16, 50, 768, 12, "resident", 228_864),
    (torch.float32, 77, 512, 8, "stream", 214_400),
    (torch.float32, 50, 768, 12, "stream", 226_816),
    # the L/14 text width and S = 128 at 768: bf16 rows too wide to stay
    (torch.bfloat16, 77, 1024, 16, "stream", 214_400),
    (torch.bfloat16, 128, 768, 12, "stream", 193_536),
    # fp32 at S = 128: two stages
    (torch.float32, 128, 1024, 16, "stream", 193_536),
])
def test_mega_layout_at_path_and_edge_shapes(dtype, S, W, H, layout, nbytes):
    assert TA.mega_layout(dtype, S, W, H) == layout
    assert TA.mega_smem_bytes(dtype, S, W, H, layout) == nbytes <= SMEM_LIMIT


def test_simt_layout_for_other_head_dims():
    # head_dim 20 (the edge shape W = 60, H = 3): the CUDA-core kernel, its bytes
    assert TA.mega_layout(torch.float32, 19, 60, 3) == TA.mega_layout(torch.bfloat16, 19, 60, 3) == "simt"
    S, D = 19, 20
    assert TA.mega_smem_bytes(torch.float32, S, 60, 3, "simt") == 4 * (
        32 * D + 32 * 33 + 2 * S * D + S * 21 + 8 * S + 2 * S)


def _accepted(widths):
    for W in widths:
        for H in range(1, W + 1):
            if W % H:
                continue
            for S in range(1, TA.MEGA_MAX_SEQ + 1):
                if TA.megakernel_supported(S, W, H):
                    yield S, W, H


@pytest.mark.parametrize("W", [512, 768, 1024])
def test_chosen_layout_fits_every_accepted_shape_at_clip_widths(W):
    n = 0
    for S, W_, H in _accepted([W]):
        for dtype in DTYPES:
            layout = TA.mega_layout(dtype, S, W_, H)
            assert TA.mega_smem_bytes(dtype, S, W_, H, layout) <= SMEM_LIMIT, (dtype, S, W_, H, layout)
            if layout != "simt":  # the stream layout fits whatever the width
                assert TA.mega_smem_bytes(dtype, S, W_, H, "stream") <= SMEM_LIMIT
            n += 1
    assert n > 0


def test_chosen_layout_fits_the_edge_shapes_and_every_variant_runs():
    taken = set()
    for _, _, S, W, H, _ in MEGA_SHAPES + MEGA_EDGE_SHAPES:
        assert TA.megakernel_supported(S, W, H)
        for dtype in DTYPES:
            layout = TA.mega_layout(dtype, S, W, H)
            assert TA.mega_smem_bytes(dtype, S, W, H, layout) <= SMEM_LIMIT
            taken.add((TA.mega_variant(dtype, W // H), layout))
    assert taken == {("mma", "resident"), ("mma", "stream"), ("tf32x3", "stream"), ("simt", "simt")}


def test_megakernel_supported_is_unchanged():
    # S <= 128, head_dim <= 64 and a multiple of 4, any width
    for S in (1, 77, 128, 129):
        for W, H in ((512, 8), (60, 3), (768, 12), (4096, 64), (64, 1), (100, 5), (96, 1),
                     (48, 4), (62, 2)):
            D = W // H
            assert TA.megakernel_supported(S, W, H) == (S <= 128 and D <= 64 and D % 4 == 0), (S, W, H)
    assert not TA.megakernel_supported(10, 64, 3) and not TA.megakernel_supported(0, 64, 1)


def _c_layout(tmp_path):
    """The `layout` region of csrc/ln_qkv_attention.cu and its extern "C"
    count, built by the host's C++ compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler builds the layout region"
    with open(os.path.join(CSRC, "ln_qkv_attention.cu")) as fh:
        text = fh.read()
    m = re.search(r"// layout \{.*?// \} layout\n", text, re.S)
    assert m, "the layout region of ln_qkv_attention.cu"
    src, lib = tmp_path / "mega_layout.cc", tmp_path / "mega_layout.so"
    src.write_text(
        "#include <stddef.h>\n#define __host__\n#define __device__\n#define __forceinline__ inline\n"
        "namespace {\n" + m.group(0) + "}\n"
        'extern "C" long long smem(int S, int H, int D, int dtype, int variant, int layout) {\n'
        "  return smem_bytes(S, H, D, dtype, variant, layout);\n}\n")
    subprocess.run([cxx, "-std=c++17", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).smem
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn


def test_c_layout_region_counts_as_python(tmp_path):
    smem = _c_layout(tmp_path)
    codes = {"simt": 0, "mma": 1, "tf32x3": 2}
    shapes = [(S, W, H) for _, _, S, W, H, _ in MEGA_SHAPES + MEGA_EDGE_SHAPES]
    shapes += [(S, W, W // D) for S in (1, 16, 17, 50, 77, 80, 127, 128) for W in (512, 768, 1024)
               for D in (4, 8, 16, 32, 64)]
    for S, W, H in shapes:
        D = W // H
        for dtype in DTYPES:
            variant = TA.mega_variant(dtype, D)
            bf16 = int(dtype == torch.bfloat16)
            layouts = ("simt",) if variant == "simt" else TA.MEGA_LAYOUTS
            for layout in layouts:
                py = TA.mega_smem_bytes(dtype, S, W, H, layout)
                c = smem(S, H, D, bf16, codes[variant], int(layout == "stream"))
                if layout == "resident" and dtype == torch.float32:
                    assert c == 0  # fp32 never stays resident
                elif py > SMEM_LIMIT:
                    assert c == 0, (S, W, H, dtype, layout)
                else:
                    assert c == py, (S, W, H, dtype, layout, c, py)
            # a tensor-core variant that does not match the dtype or the
            # head_dim is refused
            wrong = {"simt": 1 + (1 - bf16), "mma": 2, "tf32x3": 1}[variant]
            assert smem(S, H, D, bf16, wrong, 1) == 0
    assert smem(129, 2, 64, 1, 1, 1) == 0 and smem(77, 8, 66, 1, 0, 0) == 0


def _ipot_warp_order(cost, x_len, x_pad, y_len, y_pad, beta, iterations, k):
    """The warp variant's arithmetic in torch, fp32: lane m holds entity m's
    column (32 lanes, lanes past M idle); delta_n sums Q[n, m] sigma_m
    (each product rounded) by a butterfly over the lanes (the kernel's
    reduce-scatter adds the same pairs), sigma_m sums delta_n Q[n, m] over
    n in order."""
    B, M, N = cost.shape
    lanes = 32
    xp = torch.zeros(B, lanes, dtype=torch.bool)
    xp[:, :M] = x_pad
    real_lane = torch.zeros(B, lanes, dtype=torch.bool)
    real_lane[:, :M] = True
    c = torch.zeros(B, lanes, N)
    c[:, :M] = cost
    real = real_lane[:, :, None] & ~xp[:, :, None] & ~y_pad[:, None, :]
    zero = torch.zeros(())
    A = torch.where(real, torch.exp(-c / beta), zero)  # [B, lane, n]
    T = torch.where(real, torch.ones(()), zero)
    sigma = torch.where(real_lane & ~xp, 1.0 / x_len[:, None], zero)
    xm = torch.where(xp, 1e4, 0.0)
    ym = torch.where(y_pad, 1e4, 0.0)
    lane = torch.arange(lanes)
    for _ in range(iterations):
        T = A * T
        for _ in range(k):
            part = T * sigma[:, :, None]
            for o in (16, 8, 4, 2, 1):
                part = part + part[:, lane ^ o]
            delta = 1.0 / (y_len[:, None] * part[:, 0] + ym)  # [B, n], every lane alike
            s = torch.zeros(B, lanes)
            for n in range(N):
                s = s + delta[:, n, None] * T[:, :, n]
            sigma = torch.where(real_lane, 1.0 / (x_len[:, None] * s + xm), zero)
        T = delta[:, None, :] * T * sigma[:, :, None]
    pad = xp[:, :, None] | y_pad[:, None, :]
    return torch.where(pad, zero, T)[:, :M].transpose(1, 2)  # [B, N, M]


@pytest.mark.parametrize("B,M,N,k", [(4, 16, 7, 1), (3, 32, 32, 1), (2, 9, 5, 2), (2, 1, 1, 1)])
def test_warp_order_matches_the_jax_solver(B, M, N, k):
    rng = np.random.default_rng(M * 100 + N)
    txt = rng.normal(size=(B, M, 16)).astype(np.float32)
    img = rng.normal(size=(B, N, 16)).astype(np.float32)
    x_n = rng.integers(1, M + 1, size=B)
    y_n = rng.integers(1, N + 1, size=B)
    x_pad = np.arange(M)[None] >= x_n[:, None]
    y_pad = np.arange(N)[None] >= y_n[:, None]
    joint = x_pad[:, :, None] | y_pad[:, None, :]
    cost = np.where(joint, 0.0, np.asarray(JOT.cost_matrix_cosine(jnp.asarray(txt), jnp.asarray(img))))
    cost = cost.astype(np.float32)
    x_len, y_len = x_n.astype(np.float32), y_n.astype(np.float32)
    ref = np.asarray(JOT.ipot(jnp.asarray(cost), x_len, x_pad, y_len, y_pad, joint, 0.5, 50, k))
    ours = _ipot_warp_order(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (cost, x_len, x_pad, y_len, y_pad)), 0.5, 50, k)
    assert TOT.ipot_variant(M, N) == "warp"
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def _mega_tc_arithmetic(x, g, b, w, wb, bias, H, scale, eps=1e-5):
    """K6's tensor-core variants in torch: the LayerNorm in fp32 rounded to
    x's dtype, the projection in split TF32 (fp32) or as exact bf16
    products summed in fp32 (bf16), never rounded, then K1's tf32x3 core,
    the output rounded once."""
    dt = x.dtype
    g, b, w, wb = (t.to(dt).float() for t in (g, b, w, wb))
    x32 = x.float()
    c = x32 - x32.mean(dim=-1, keepdim=True)
    ln = (c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps) * g + b).to(dt).float()
    qkv = (TA.tf32x3_matmul(ln, w) if dt == torch.float32 else torch.matmul(ln, w)) + wb
    return TA.fused_attention_qkv_plain(qkv, bias, H, scale, tf32x3=True).to(dt)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,W,H,causal", [(2, 77, 128, 2, True), (2, 50, 192, 3, False),
                                            (1, 17, 128, 4, True), (2, 33, 128, 8, False)])
def test_tensor_core_arithmetic_matches_the_jax_megakernel(B, S, W, H, causal, dtype, tol):
    rng = np.random.default_rng(S + W)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=W)).astype(np.float32)
    beta = (0.1 * rng.normal(size=W)).astype(np.float32)
    w = (rng.normal(size=(W, 3 * W)) * W ** -0.5).astype(np.float32)
    wb = (0.1 * rng.normal(size=3 * W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    scale = (W // H) ** -0.5
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_mega(jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w),
                   jnp.asarray(wb), None if bias is None else jnp.asarray(bias), H, scale,
                   interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tb = None if bias is None else torch.from_numpy(bias)
    ours = _mega_tc_arithmetic(torch.from_numpy(x).to(dtype), *map(torch.from_numpy, (gamma, beta, w, wb)),
                               tb, H, scale)
    assert TA.mega_variant(dtype, W // H) in TA.TENSOR_CORE_VARIANTS
    assert np.abs(ours.float().numpy() - ref).max() <= tol
    plain = TA.fused_ln_qkv_attention_plain(torch.from_numpy(x).to(dtype),
                                            *map(torch.from_numpy, (gamma, beta, w, wb)), tb, H, scale)
    assert (ours.float() - plain.float()).abs().max().item() <= tol
