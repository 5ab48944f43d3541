"""The port's OT alignment ops (`clip_event_tpu_torch.ops.ot`) against the
JAX package's `ops/ot.py` and its IPOT Pallas kernel run in interpret mode,
on the CPU in fp32, on the same numpy inputs: the cosine cost, the IPOT
plan (ragged pads, k = 2, 10 iterations), the OT distance in safe and
unsafe mode with an empty graph, and `alignment_loss` with its gradients
with respect to both embeddings. Tolerance 1e-5 throughout (fp32 on both
sides; only the reduction order differs). Plus the kernel wrapper's
behaviour off the card: the plain solver on a CPU tensor whatever
`use_pallas` says, and refusals of what the kernel cannot take."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.ops import ot as JOT  # noqa: E402
from clip_event_tpu.ops.ot_pallas import ipot_pallas  # noqa: E402
from clip_event_tpu_torch.ops import ot as TOT  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

TOL = 1e-5


def _inputs(B=4, M=7, N=5, D=16, seed=0, with_empty=False):
    rng = np.random.default_rng(seed)
    txt = rng.normal(size=(B, M, D)).astype(np.float32)
    img = rng.normal(size=(B, N, D)).astype(np.float32)
    txt_len = rng.integers(1, M + 1, size=B)
    img_len = rng.integers(1, N + 1, size=B)
    if with_empty:
        txt_len[0] = 0
    txt_pad = np.arange(M)[None, :] >= txt_len[:, None]
    img_pad = np.arange(N)[None, :] >= img_len[:, None]
    return txt, img, txt_pad, img_pad


def _solver_inputs(B, M, N, seed):
    txt, img, txt_pad, img_pad = _inputs(B=B, M=M, N=N, seed=seed)
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = np.where(joint_pad, 0.0, np.asarray(JOT.cost_matrix_cosine(jnp.asarray(txt),
                                                                       jnp.asarray(img))))
    x_len = (M - txt_pad.sum(1)).astype(np.float32)
    y_len = (N - img_pad.sum(1)).astype(np.float32)
    return cost.astype(np.float32), x_len, txt_pad, y_len, img_pad, joint_pad


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_cost_matrix_cosine_matches():
    txt, img, _, _ = _inputs(seed=1)
    txt[0, 0] = 0.0  # a zero row: the max(norm, eps) denominator
    ours = TOT.cost_matrix_cosine(*_t(txt, img))
    ref = np.asarray(JOT.cost_matrix_cosine(jnp.asarray(txt), jnp.asarray(img)))
    assert ours.shape == (4, 7, 5)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("B,M,N,iterations,k", [(4, 7, 5, 50, 1), (2, 6, 4, 10, 2),
                                                (3, 16, 7, 50, 1)])
def test_ipot_matches_jax_solver_and_pallas_kernel(B, M, N, iterations, k):
    cost, x_len, x_pad, y_len, y_pad, joint_pad = _solver_inputs(B, M, N, seed=42)
    ref = np.asarray(JOT.ipot(jnp.asarray(cost), x_len, x_pad, y_len, y_pad, joint_pad, 0.5,
                              iterations, k))
    kernel_ref = np.asarray(ipot_pallas(jnp.asarray(cost), x_len, x_pad, y_len, y_pad,
                                        iterations=iterations, k=k, interpret=True))
    ours = TOT.ipot(*_t(cost, x_len, x_pad, y_len, y_pad, joint_pad), 0.5, iterations, k)
    assert ours.shape == (B, N, M) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ours.numpy(), kernel_ref, atol=TOL, rtol=TOL)
    # the kernel's wrapper on a CPU tensor is the plain solver
    via = TOT.ipot_kernel(*_t(cost, x_len, x_pad, y_len, y_pad), iterations=iterations, k=k)
    np.testing.assert_array_equal(via.numpy(), ours.numpy())


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("safe", [False, True])
def test_ot_distance_matches(safe, use_pallas):
    txt, img, txt_pad, img_pad = _inputs(seed=3, with_empty=safe)
    ref = np.asarray(JOT.optimal_transport_dist(jnp.asarray(txt), jnp.asarray(img),
                                                jnp.asarray(txt_pad), jnp.asarray(img_pad),
                                                safe=safe))
    ours = TOT.optimal_transport_dist(*_t(txt, img, txt_pad, img_pad), safe=safe,
                                      use_pallas=use_pallas)
    assert ours.shape == (4,)
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=TOL)
    if safe:
        assert ours[0].item() == 0.0 and np.isfinite(ours.numpy()).all()


@pytest.mark.parametrize("use_pallas", [False, True, "auto"])
def test_alignment_loss_and_gradients_match(use_pallas):
    """The loss (slot 0 dropped, masks 1 at real nodes, scale 0.01, summed
    over the batch, safe mode with one empty entity graph) and its
    gradients with respect to both embeddings, against `jax.grad`."""
    rng = np.random.default_rng(5)
    B, M, N, E = 3, 6, 5, 12
    ent = rng.normal(size=(B, M, E)).astype(np.float32)
    obj = rng.normal(size=(B, N, E)).astype(np.float32)
    ent_mask = (np.arange(M)[None] < np.array([4, 0, 6])[:, None]).astype(np.int32)
    obj_mask = (np.arange(N)[None] < np.array([5, 3, 2])[:, None]).astype(np.int32)

    (ref, (g_ent, g_obj)) = jax.value_and_grad(
        lambda a, b: JOT.alignment_loss(a, b, jnp.asarray(ent_mask), jnp.asarray(obj_mask)),
        argnums=(0, 1))(jnp.asarray(ent), jnp.asarray(obj))
    te, to = (torch.from_numpy(x).requires_grad_(True) for x in (ent, obj))
    loss = TOT.alignment_loss(te, to, *_t(ent_mask, obj_mask), use_pallas=use_pallas)
    grads = torch.autograd.grad(loss, (te, to))
    np.testing.assert_allclose(loss.item(), float(ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(g_ent), atol=TOL, rtol=0)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(g_obj), atol=TOL, rtol=0)
    assert float(grads[1][:, 0].abs().max()) == 0.0  # the whole-image slot carries no loss


def test_auto_takes_the_plain_solver_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(TOT, "ipot_kernel", lambda *a, **k: calls.append(a) or None)
    rng = np.random.default_rng(6)
    big = rng.normal(size=(2, 40, 8)).astype(np.float32)  # 40 and 39 nodes: ≥ any threshold
    mask = np.ones((2, 40), np.int32)
    loss = TOT.alignment_loss(*_t(big, big, mask, mask), use_pallas="auto")
    assert calls == [] and np.isfinite(loss.item())


@pytest.mark.parametrize(
    "shape, match",
    [((2, 129, 7), "M, N <= 128"), ((2, 16, 200), "M, N <= 128"), ((2, 16, 7), "needs a CUDA tensor")],
)
def test_kernel_refuses_what_it_cannot_take(shape, match):
    """A tensor off the CPU goes to K3 or raises (meta stands in for CUDA)."""
    B, M, N = shape
    meta = dict(device="meta")
    before = TOT.ipot_kernel.launches
    with pytest.raises(ValueError, match=match):
        TOT.ipot_kernel(torch.empty(B, M, N, **meta), torch.empty(B, **meta),
                        torch.empty(B, M, dtype=torch.bool, **meta), torch.empty(B, **meta),
                        torch.empty(B, N, dtype=torch.bool, **meta))
    assert TOT.ipot_kernel.launches == before
