"""The fused LayerNorm's two ways in and two paths (clip_event_tpu_torch.ops.ln,
K4), on the CPU.

Ways in: with grad mode off, or with no input that requires a gradient,
`fused_layer_norm` and `fused_add_layer_norm` call the forward directly
instead of through `torch.autograd.Function`; the result must be the same
bits as the autograd path's, and both are held against the JAX package's
Pallas kernels in interpret mode (`ops/ln_pallas.py`) at 1e-6 in fp32 (the
numerics tests/test_torch_ln.py holds the port to).

Paths: `register_path` picks, from the width and the operands' addresses,
the kernels that hold a row in registers or the generic ones; the rule is
pinned here because on the CPU no kernel runs to show it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.ops import ln_pallas as JLN  # noqa: E402
from clip_event_tpu_torch.ops import ln as TLN  # noqa: E402


def _inputs(shape, seed, n=1):
    rng = np.random.default_rng(seed)
    w = shape[-1]
    xs = [rng.normal(size=shape).astype(np.float32) for _ in range(n)]
    scale = (1.0 + 0.1 * rng.normal(size=w)).astype(np.float32)
    bias = (0.1 * rng.normal(size=w)).astype(np.float32)
    return xs, scale, bias


SHAPES = [(4, 7, 128), (5, 640), (2, 3, 768), (3, 100)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_no_grad_path_equals_autograd_path_and_jax(shape):
    (x,), scale, bias = _inputs(shape, 21)
    ref = np.asarray(JLN.layer_norm_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                           interpret=True))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    graded = TLN.fused_layer_norm(*leaves)
    assert graded.grad_fn is not None
    with torch.no_grad():
        off = TLN.fused_layer_norm(*leaves)
    # no input that requires a gradient, grad mode on
    plain_in = TLN.fused_layer_norm(*(t.detach() for t in leaves))
    assert off.grad_fn is None and plain_in.grad_fn is None
    assert torch.equal(off, graded.detach()) and torch.equal(plain_in, graded.detach())
    np.testing.assert_allclose(off.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_add_no_grad_path_equals_autograd_path_and_jax(shape):
    (res, delta), scale, bias = _inputs(shape, 22, n=2)
    jx, jy = JLN.add_layer_norm_pallas(*map(jnp.asarray, (res, delta, scale, bias)), interpret=True)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (res, delta, scale, bias)]
    graded = [t.detach() for t in TLN.fused_add_layer_norm(*leaves)]
    with torch.inference_mode():
        off = TLN.fused_add_layer_norm(*leaves)
    plain_in = TLN.fused_add_layer_norm(*(t.detach() for t in leaves))
    for got in (off, plain_in):
        assert all(t.grad_fn is None for t in got)
        assert all(torch.equal(a, b) for a, b in zip(got, graded))
    np.testing.assert_array_equal(off[0].numpy(), np.asarray(jx))
    np.testing.assert_allclose(off[1].numpy(), np.asarray(jy), atol=1e-6, rtol=0)


def test_no_grad_path_skips_the_autograd_function(monkeypatch):
    """Without a gradient to track the forwards never enter
    `autograd.Function.apply`; with one they do."""
    def refuse(*args):
        raise AssertionError("autograd.Function.apply called")

    monkeypatch.setattr(TLN._FusedLayerNorm, "apply", refuse)
    monkeypatch.setattr(TLN._FusedAddLayerNorm, "apply", refuse)
    x, v = torch.randn(3, 64), torch.ones(64)
    TLN.fused_layer_norm(x, v, v)
    TLN.fused_add_layer_norm(x, x, v, v)
    w = v.clone().requires_grad_(True)
    with torch.no_grad():
        TLN.fused_layer_norm(x, w, v)
        TLN.fused_add_layer_norm(x, x, v, w)
    for call in (lambda: TLN.fused_layer_norm(x, w, v), lambda: TLN.fused_add_layer_norm(x, x, v, w)):
        with pytest.raises(AssertionError, match="apply called"):
            call()


def test_register_path_rule():
    """W a multiple of 8 up to 1280 (every CLIP preset's width) with every
    address 16-byte aligned takes the register path; anything else the
    generic kernels."""
    assert TLN.REGISTER_MAX_WIDTH == 1280 <= TLN.MAX_WIDTH
    for w in (512, 640, 768, 1024, 1280, 8, 136, 1272):
        assert TLN.register_path(w, 0, 256, 4096), w
    for w in (100, 516, 1, 1288, 1536, 2048, 3072):
        assert not TLN.register_path(w, 0, 256), w
    # one misaligned operand (a view that starts 2 or 4 bytes in) sends the
    # call to the generic kernels, whatever the width
    assert not TLN.register_path(512, 0, 2, 4096)
    assert not TLN.register_path(768, 4, 256)
    assert TLN.register_path(768, 16, 48)


def test_lean_checks_keep_their_messages():
    """The checks compare device indices; what they refuse and say is as
    before: dtype, empty input, γ/β shape, operands' shape and dtype, and a
    device that is no CUDA device (here the meta device)."""
    v = torch.ones(64)
    cases = [
        (lambda: TLN._check_kernel_input(torch.zeros(2, 64, dtype=torch.float16), v, v),
         "float32 or bfloat16"),
        (lambda: TLN._check_kernel_input(torch.zeros(0, 64), v, v), "at least one row"),
        (lambda: TLN._check_kernel_input(torch.zeros(2, 64), torch.ones(32), v), r"scale and bias must be \[64\]"),
        (lambda: TLN._check_kernel_input(torch.zeros(2, 64), v, None, torch.zeros(3, 64)), "must share x's"),
        (lambda: TLN._check_kernel_input(torch.zeros(2, 64), v, None, torch.zeros(2, 64, dtype=torch.bfloat16)),
         "must share x's"),
        (lambda: TLN._check_kernel_input(torch.zeros(2, 64), v, v), "needs a CUDA tensor, got cpu"),
        (lambda: TLN.fused_layer_norm(torch.zeros(2, 64, device="meta"), v.to("meta"), v.to("meta")),
         "needs a CUDA tensor, got meta"),
        (lambda: TLN.fused_layer_norm_bwd(torch.zeros(2, 64, device="meta"), v.to("meta"),
                                          torch.zeros(2, 64, device="meta")), "needs a CUDA tensor, got meta"),
        (lambda: TLN.fused_layer_norm(torch.zeros(2, 64, device="meta"), v, v.to("meta")),
         r"scale and bias must be \[64\] on meta, got \(64,\) on cpu"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
