"""The port's attention core (clip_event_tpu_torch.ops.attention) against the
JAX package: its plain version vs the Pallas kernel run in interpret mode and
vs the einsum path of `multi_head_attention`, on the same numpy inputs, at
fp32 atol 1e-5. Plus the dispatcher's refusals: a non-CPU tensor the kernel
cannot take raises, and the public entry points raise when asked for a card
that is not there."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.models import layers as JL  # noqa: E402
from clip_event_tpu.ops.attention_pallas import fused_attention_qkv as jax_fused  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

SHAPES = [(3, 77, 128, 2, True), (2, 50, 192, 3, False), (5, 13, 64, 1, False)]
ATOL = 1e-5  # fp32: both sides accumulate in fp32, only the sum order differs


def _inputs(B, S, W, causal, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    bias = np.triu(np.full((S, S), -np.inf, np.float32), 1) if causal else None
    return qkv, bias


@pytest.mark.parametrize("B,S,W,H,causal", SHAPES)
def test_plain_matches_pallas_interpret(B, S, W, H, causal):
    qkv, bias = _inputs(B, S, W, causal)
    scale = (W // H) ** -0.5
    ref = np.asarray(jax_fused(
        jnp.asarray(qkv), None if bias is None else jnp.asarray(bias), H, scale, True
    ))
    ours = TA.fused_attention_qkv(
        torch.from_numpy(qkv), None if bias is None else torch.from_numpy(bias), H, scale
    )
    assert ours.dtype == torch.float32 and ours.shape == (B, S, W)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,S,W,H,causal", SHAPES)
def test_mha_paths_match_jax_einsum(B, S, W, H, causal):
    """Both attention impls of the port's multi_head_attention (kernel path
    → plain version on CPU, and the einsum reference) vs the JAX einsum
    path, projections included."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    p = {
        "qkv_w": (rng.normal(size=(W, 3 * W)) * W**-0.5).astype(np.float32),
        "qkv_b": rng.normal(size=(3 * W,)).astype(np.float32) * 0.1,
        "out_w": (rng.normal(size=(W, W)) * W**-0.5).astype(np.float32),
        "out_b": rng.normal(size=(W,)).astype(np.float32) * 0.1,
    }
    _, bias = _inputs(B, S, W, causal)
    ref = np.asarray(JL.multi_head_attention(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, H,
        None if bias is None else jnp.asarray(bias), impl="xla",
    ))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tb = None if bias is None else torch.from_numpy(bias)
    for impl in TL.IMPLS:
        ours = TL.multi_head_attention(torch.from_numpy(x), tp, H, tb, impl=impl)
        np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0, err_msg=impl)


def test_plain_bf16_keeps_dtype_and_fp32_softmax():
    qkv, bias = _inputs(2, 13, 64, True, seed=3)
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    out = TA.fused_attention_qkv_plain(t, torch.from_numpy(bias), 2, 0.125)
    assert out.dtype == torch.bfloat16
    ref = TA.fused_attention_qkv_plain(t.float(), torch.from_numpy(bias), 2, 0.125)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2, rtol=0)


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(
        TL.causal_mask(9, device="cpu").numpy(), np.asarray(JL.causal_mask(9))
    )


@pytest.mark.parametrize(
    "make, match",
    [
        (lambda: torch.empty(2, 13, 192, dtype=torch.float16, device="meta"), "float32 or bfloat16"),
        (lambda: torch.empty(2, 129, 192, device="meta"), "S <= 128"),
        (lambda: torch.empty(2, 13, 3 * 258, device="meta"), "head_dim <= 128"),
        (lambda: torch.empty(2, 192, 13, device="meta").transpose(1, 2), "contiguous"),
        (lambda: torch.empty(2, 13, 192, device="meta"), "needs a CUDA tensor"),
    ],
)
def test_dispatcher_refuses_what_the_kernel_cannot_take(make, match):
    """A tensor off the CPU goes to the kernel or raises: never the plain
    version (the meta device stands in for a CUDA tensor here)."""
    before = TA.fused_attention_qkv.launches
    with pytest.raises(ValueError, match=match):
        TA.fused_attention_qkv(make(), None, 2, 0.125)
    assert TA.fused_attention_qkv.launches == before


def test_bias_shape_is_checked():
    qkv = torch.empty(2, 13, 192, device="meta")
    with pytest.raises(ValueError, match=r"bias must be \[S, S\]"):
        TA.fused_attention_qkv(qkv, torch.empty(12, 12, device="meta"), 2, 0.125)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from clip_event_tpu_torch.evals.common import Encoders
    from clip_event_tpu_torch.evals.cli import load_model_from_cfg
    from clip_event_tpu_torch.models import VIT_B32, init_params

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator().manual_seed(0), VIT_B32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_from_cfg({"model": "ViT-B/32"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoders({}, VIT_B32)
