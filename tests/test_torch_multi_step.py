"""K training steps in one dispatch (`engine.train_step.make_multi_step`) on
the CPU, in fp32: `many` over a stack of 3 batches with the alignment
branch equals 3 single steps of the port exactly (params, optimizer state
and every metric), and matches the JAX package's `make_multi_step`; so
does `many_fixed` over 4 steps on one batch. A step is safe to capture in
a CUDA graph as far as the CPU can show it: no host read of a device value
(`aten._local_scalar_dense`, `aten.nonzero`), no tensor made from host
data (`aten.lift_fresh`), and every params and optimizer-state leaf keeps
its storage across a step. The config takes `steps_per_dispatch` and the
remat policy names and keeps JAX's two exclusivity rules in JAX's words;
the train loop with `steps_per_dispatch: 3` ends where the one with 1
does.

Tolerances against JAX, those of tests/test_train_step.py's multi-step
cases: loss, loss_i, loss_t, loss_ot, grad_norm and finite per step at rtol
1e-5, params at atol 1e-6. SGD with momentum, whose update is linear in
the gradient (Adam divides each gradient element by its own running scale,
so an element at the level of rounding noise moves by up to lr whatever
the noise: tests/test_torch_train_step.py's docstring).

Model: ViT towers of 2 layers, width 64 (1 head), patch 16, image 32; text
width 64, 1 head, 77 tokens, the real vocab; 3 images × 3 descriptions,
4 object crops and 6 entity rows an image (tests/test_torch_ot_train.py's
alignment batch)."""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu import config as JC  # noqa: E402
from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch import config as TC  # noqa: E402
from clip_event_tpu_torch.data.labels import build_label_layout  # noqa: E402
from clip_event_tpu_torch.engine import checkpoint as CK  # noqa: E402
from clip_event_tpu_torch.engine import optim as TO  # noqa: E402
from clip_event_tpu_torch.engine import train_step as TT  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.train import main  # noqa: E402
from tests.fixtures import make_voa_fixture  # noqa: E402

MODEL = {
    "embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
    "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2,
}
JCFG, TCFG = J.CLIPConfig(**MODEL), T.CLIPConfig(**MODEL)
B, NPOS, NNEG, NOBJ, NENT = 3, 1, 2, 4, 6
LR = 1e-2
KW = dict(alignment=True, alignment_chunks=2, remat=True)
METRICS = ("loss", "loss_i", "loss_t", "loss_ot", "grad_norm", "finite")


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for one test: on the CPU the
    gradient of the token-embedding gather (`index_put_` with accumulate)
    sums repeated token ids in an order that varies from call to call
    without them, so two equal steps would differ in the last bits."""
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(old)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(1), JCFG))


def _tokens(rng, shape):
    out = np.zeros(shape + (77,), np.int32)
    for idx in np.ndindex(*shape):
        eot = int(rng.integers(2, 30))
        out[idx][0] = 49406
        out[idx][1:eot] = rng.integers(1, 49000, eot - 1)
        out[idx][eot] = 49407
    return out


def _batch(seed, uint8=False):
    """The alignment workload (float32 crops, slot 0 the whole image; ragged
    object and entity masks), or with `uint8` the contrastive batch alone
    with uint8 images, which the model normalizes on the device."""
    rng = np.random.default_rng(seed)
    layout = build_label_layout(B, NPOS, NNEG)
    out = {
        "text": _tokens(rng, (B * (NPOS + NNEG),)),
        "labels_per_image": layout.labels_per_image,
        "labels_per_text": layout.labels_per_text,
        "index_pos": layout.index_pos,
    }
    if uint8:
        out["image"] = rng.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)
        return out
    crops = rng.normal(size=(B, NOBJ, 32, 32, 3)).astype(np.float32)
    obj_n, ent_n = np.array([4, 2, 3]), np.array([6, 0, 3])
    crops[np.arange(NOBJ)[None] >= obj_n[:, None]] = 0.0
    out.update({
        "image": crops[:, 0].copy(),
        "object_image": crops,
        "object_mask": (np.arange(NOBJ)[None] < obj_n[:, None]).astype(np.int32),
        "entity_text": _tokens(rng, (B, NENT)),
        "entity_mask": (np.arange(NENT)[None] < ent_n[:, None]).astype(np.int32),
    })
    return out


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _port_state(np_params, opt):
    return TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"), opt)


def _equal_trees(a, b):
    a, b = _flat(a), _flat(b)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_many_equals_single_steps_exactly(np_params, deterministic):
    """`many` over a 3-batch stack (Adam, the alignment branch, remat) and 3
    calls of `make_train_step`'s step from equal states: equal params,
    optimizer state and metrics, and the step count 3 on the host."""
    opt = TO.build_optimizer("adam", TO.build_schedule("warmup", 1e-3, 4, warmup_epochs=2))
    batches = [_batch(20 + i) for i in range(3)]
    step = TT.make_train_step(TCFG, opt, compute_dtype=torch.float32, **KW)
    single = _port_state(np_params, opt)
    rows = []
    for b in batches:
        single, m = step(single, _t(b))
        rows.append(m)
    many, _ = TT.make_multi_step(TCFG, opt, 3, compute_dtype=torch.float32, **KW)
    fused, metrics = many(_port_state(np_params, opt), _t(_stack(batches)))
    assert fused.step == single.step == 3 and int(fused.opt_state["count"]) == 3
    _equal_trees(fused.params, single.params)
    _equal_trees(fused.opt_state, single.opt_state)
    assert set(metrics) == set(rows[0]) == set(METRICS)
    for k in METRICS:
        assert metrics[k].shape == (3,), k
        assert torch.equal(metrics[k], torch.stack([m[k] for m in rows])), k


def _jax_sgd():
    return JO.build_optimizer("sgd", JO.build_schedule("none", LR, 30), momentum=0.9)


def _port_sgd():
    return TO.build_optimizer("sgd", TO.build_schedule("none", LR, 30), momentum=0.9)


def _check_against_jax(ts, tm, js, jm, steps):
    for k in METRICS:
        ours, ref = tm[k].numpy().astype(np.float64), np.asarray(jm[k], np.float64)
        assert ours.shape == ref.shape == (steps,), k
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=0, err_msg=k)
    assert tm["finite"].all() and (tm["loss_ot"] > 0).all()
    a, b = _flat(ts.params), _flat(jax.tree.map(np.asarray, js.params))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].detach().numpy(), b[k], atol=1e-6, rtol=0, err_msg=k)
    assert ts.step == steps and int(ts.opt_state["count"]) == steps


def test_many_matches_jax_make_multi_step(np_params):
    batches = _stack([_batch(30 + i) for i in range(3)])
    jmany, _ = JT.make_multi_step(JCFG, _jax_sgd(), 3, donate=False, compute_dtype=jnp.float32,
                                  use_pallas_ot=False, **KW)
    js, jm = jmany(JT.create_train_state(jax.tree.map(jnp.asarray, np_params), _jax_sgd()),
                   jax.tree.map(jnp.asarray, batches))
    many, _ = TT.make_multi_step(TCFG, _port_sgd(), 3, compute_dtype=torch.float32, **KW)
    ts, tm = many(_port_state(np_params, _port_sgd()), _t(batches))
    _check_against_jax(ts, tm, js, jm, 3)


def test_many_fixed_matches_jax(np_params, deterministic):
    """4 steps on one batch; `many` given that single batch (no [K] axis)
    takes it for every step, as JAX's `stacked` check decides."""
    batch = _batch(40)
    _, jfixed = JT.make_multi_step(JCFG, _jax_sgd(), 4, donate=False, compute_dtype=jnp.float32,
                                   use_pallas_ot=False, **KW)
    js, jm = jfixed(JT.create_train_state(jax.tree.map(jnp.asarray, np_params), _jax_sgd()),
                    jax.tree.map(jnp.asarray, batch))
    many, fixed = TT.make_multi_step(TCFG, _port_sgd(), 4, compute_dtype=torch.float32, **KW)
    ts, tm = fixed(_port_state(np_params, _port_sgd()), _t(batch))
    _check_against_jax(ts, tm, js, jm, 4)
    ts2, tm2 = many(_port_state(np_params, _port_sgd()), _t(batch))
    _equal_trees(ts2.params, ts.params)
    for k in METRICS:
        assert torch.equal(tm2[k], tm[k]), k
    with pytest.raises(ValueError, match="batch stack or a single batch"):
        many(ts2, None)


class _HostTraffic(TorchDispatchMode):
    """Records the aten ops that read a device value on the host or make a
    tensor from host data: what a CUDA graph capture cannot take."""

    FORBIDDEN = ("aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.FORBIDDEN):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["full", "attn"])
@pytest.mark.parametrize("workload", ["contrastive_uint8", "alignment"])
def test_step_is_capture_safe(np_params, workload, policy):
    """One step after a first one (which makes the per-device constants
    once) under a dispatch mode: no host sync, no tensor from host data, and
    every leaf of the params and the optimizer state (Adam, bf16 first
    moment, a multistep schedule) written in place."""
    uint8 = workload == "contrastive_uint8"
    kw = dict(KW, remat=policy, alignment=not uint8)
    opt = TO.build_optimizer("adam", TO.build_schedule("multisteplr", 1e-3, 4, lr_steps=[1]),
                             weight_decay=0.01, moment_dtype="bfloat16")
    step = TT.make_train_step(TCFG, opt, compute_dtype=torch.float32, **kw)
    state = _port_state(np_params, opt)
    state, _ = step(state, _t(_batch(50, uint8)))
    leaves = TO.tree_leaves(state.params) + TO.tree_leaves(state.opt_state)
    ptrs = [t.data_ptr() for t in leaves]
    batch = _t(_batch(51, uint8))
    with _HostTraffic() as mode:
        state, m = step(state, batch)
    assert mode.seen == []
    after = TO.tree_leaves(state.params) + TO.tree_leaves(state.opt_state)
    assert [t.data_ptr() for t in after] == ptrs
    assert all(a is b for a, b in zip(after, leaves))
    assert int(state.opt_state["count"]) == 2 and bool(m["finite"])


def test_config_takes_dispatch_and_remat_policies():
    base = {"task": "t", "constrastive_loss": "ce", "batch_size": 2, "lr": 1e-4,
            "optimizer": "adam", "max_epoch": 1}
    assert TC.validate_config(dict(base, steps_per_dispatch=4))["steps_per_dispatch"] == 4
    for remat in (True, False, "full", "dots", "dots_nobatch", "attn"):
        assert TC.validate_config(dict(base, remat=remat))["remat"] == remat
    with pytest.raises(TC.ConfigError, match="remat mode 'offload'"):
        TC.validate_config(dict(base, remat="offload"))
    for bad in ({"steps_per_dispatch": 2, "length_buckets": [16]},
                {"steps_per_dispatch": 2, "grad_accum_steps": 2}):
        with pytest.raises(TC.ConfigError) as ours:
            TC.validate_config(dict(base, **bad))
        with pytest.raises(JC.ConfigError) as ref:
            JC.validate_config(dict(base, **bad))
        assert str(ours.value) == str(ref.value)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_step_cli")
    voa = make_voa_fixture(str(root / "voa"))
    base = {
        "task": "cli", "constrastive_loss": "ce",
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "max_epoch": 2, "batch_size": 2, "lr": 1e-4, "optimizer": "adam",
        "lr_scheduler": "warmup", "warmup_epoch": 2, "compute_dtype": "float32",
        "remat": "attn", "num_workers": 2, "seed": 3, "model": MODEL,
    }
    return root, base


def _cli(root, base, name, **extra):
    cfg = dict(base, ckpt_dir=str(root / f"ckpt_{name}"), tb_log_dir=str(root / f"logs_{name}"),
               **extra)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    main(["--cfg", str(path), "--device", "cpu"])
    ckpt = CK.latest_checkpoint(str(root / f"ckpt_{name}"), "cli")
    params, opt_state, meta, _ = CK.restore_checkpoint(ckpt, "cpu")
    return params, opt_state, meta


def test_train_cli_steps_per_dispatch(corpus, deterministic):
    """The train CLI on the fixture corpus (3 batches an epoch, 2 epochs):
    `steps_per_dispatch: 3` (one dispatch an epoch) ends with the params,
    optimizer state and step count of `steps_per_dispatch: 1`; with 2 the
    trailing batch of each epoch is dropped, as in the JAX CLI."""
    root, base = corpus
    one = _cli(root, base, "one", steps_per_dispatch=1)
    three = _cli(root, base, "three", steps_per_dispatch=3)
    assert one[2]["step"] == three[2]["step"] == 6
    _equal_trees(three[0], one[0])
    _equal_trees(three[1], one[1])
    two = _cli(root, base, "two", steps_per_dispatch=2)
    assert two[2]["step"] == 4 and int(two[1]["count"]) == 4
