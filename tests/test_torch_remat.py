"""The remat policies of the port (`models.layers.REMAT_POLICIES`: "full",
"dots", "dots_nobatch", "attn") on the CPU, in fp32: two train steps under
each against the JAX package's step under the same policy (its
`_REMAT_POLICIES`), what each recomputes, and the refusal of an unknown
name.

Both sides start from the JAX init carried over by `params_from_jax` and
take the same numpy batches; the JAX side runs its einsum attention, the
port its plain attention (the kernels' plain versions on the CPU).
Tolerances: loss and params atol 1e-5, grad_norm rtol 1e-5 (fp32 on both
sides, only reduction orders differ; a policy changes what is kept, not
the arithmetic). SGD with momentum, linear in the gradient (see
tests/test_torch_train_step.py's docstring on Adam).

Model: ViT towers of 2 layers, vision width 128 (2 heads), patch 16, image
32; text width 64, 2 heads, 77 tokens, vocab 512; 4 images × 3
descriptions."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.data.labels import build_label_layout  # noqa: E402
from clip_event_tpu_torch.engine import optim as TO  # noqa: E402
from clip_event_tpu_torch.engine import train_step as TT  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as L  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.ops import attention as A  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=512,
    transformer_width=64, transformer_heads=2, transformer_layers=2,
)
JCFG, TCFG = J.CLIPConfig(**CFG_KW), T.CLIPConfig(**CFG_KW)
B, NPOS, NNEG = 4, 1, 2
LR = 1e-2
POLICIES = ("full", "dots", "dots_nobatch", "attn")
BLOCKS = CFG_KW["vision_layers"] + CFG_KW["transformer_layers"]


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), JCFG))


def _batch(seed):
    rng = np.random.default_rng(seed)
    layout = build_label_layout(B, NPOS, NNEG)
    V = CFG_KW["vocab_size"]
    text = np.zeros((B * (NPOS + NNEG), 77), np.int32)
    for i in range(len(text)):
        eot = int(rng.integers(2, 40))
        text[i, 0], text[i, eot] = V - 2, V - 1
        text[i, 1:eot] = rng.integers(1, V - 2, eot - 1)
    return {
        "image": rng.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8),
        "text": text,
        "labels_per_image": layout.labels_per_image,
        "labels_per_text": layout.labels_per_text,
        "index_pos": layout.index_pos,
    }


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _port_step(np_params, remat, impl="kernel"):
    opt = TO.build_optimizer("sgd", TO.build_schedule("none", LR, 30), momentum=0.9)
    step = TT.make_train_step(TCFG, opt, compute_dtype=torch.float32, remat=remat, impl=impl)
    return step, TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"), opt)


@pytest.mark.parametrize("policy", POLICIES)
def test_train_steps_match_jax_under_policy(np_params, policy):
    jopt = JO.build_optimizer("sgd", JO.build_schedule("none", LR, 30), momentum=0.9)
    jstep = JT.make_train_step(JCFG, jopt, donate=False, compute_dtype=jnp.float32, remat=policy)
    js = JT.create_train_state(jax.tree.map(jnp.asarray, np_params), jopt)
    tstep, ts = _port_step(np_params, policy)
    for i in range(2):
        batch = _batch(60 + i)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, _t(batch))
        for k in ("loss", "loss_i", "loss_t"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        a, b = _flat(ts.params), _flat(js.params)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0, err_msg=k)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_what_each_policy_recomputes(np_params, policy, monkeypatch):
    """On the plain path (impl "plain"): the attention forward runs twice a
    block a step under "full" (the forward, the recompute) and once under
    "attn", which recomputes only ln_1 and the projection there; "dots"
    recomputes no matmul (the aten.mm and aten.bmm counts of a step without
    remat), "dots_nobatch" the batched ones only (the attention's bmm),
    "full" and "attn" the projections too."""
    calls = []
    plain = A.fused_attention_qkv_plain
    monkeypatch.setattr(A, "fused_attention_qkv_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    batch = _t(_batch(70))
    counts = {}
    for remat in (False, policy):
        step, state = _port_step(np_params, remat, impl="plain")
        calls.clear()
        with _OpCount() as ops:
            step(state, batch)
        counts[remat] = (len(calls), ops.counts.get(torch.ops.aten.mm.default, 0),
                         ops.counts.get(torch.ops.aten.bmm.default, 0))
    (fwd0, mm0, bmm0), (fwd, mm, bmm) = counts[False], counts[policy]
    assert fwd0 == BLOCKS
    assert fwd == (BLOCKS if policy == "attn" else 2 * BLOCKS)
    assert mm == mm0 if policy in ("dots", "dots_nobatch") else mm > mm0
    assert bmm == bmm0 if policy in ("dots", "attn") else bmm > bmm0


def test_unknown_policy_raises(np_params):
    step, state = _port_step(np_params, "offload")
    with pytest.raises(ValueError, match=r"remat mode 'offload'; options: \['full', 'dots', "
                                         r"'dots_nobatch', 'attn'\]"):
        step(state, _t(_batch(80)))
    x = torch.zeros(1, 3, 64)
    with pytest.raises(ValueError, match="remat mode 'offload'"):
        L.transformer(x, L.init_transformer(torch.Generator().manual_seed(0), 1, 64), 2, remat="offload")
    assert L.remat_policy(True) == "full" and L.remat_policy(False) is None
