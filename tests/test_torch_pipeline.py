"""The port's pipeline parallelism (`clip_event_tpu_torch/parallel/pipeline.py`)
against the JAX package's (`clip_event_tpu/parallel/pipeline.py`), in one
process on the CPU: the in-process driver (every stage in tick order)
against JAX's `pipelined_transformer` on the 8-device virtual CPU mesh of
tests/conftest.py, forward and backward; the stage-leaf rule against
`pipeline_param_shardings`; `_pick_microbatches`; the config's pp rules
against `validate_config`. The multi-rank schedule over gloo is held in
tests/test_torch_tp_ranks.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu import config as JC  # noqa: E402
from clip_event_tpu.models import init_params as j_init_params  # noqa: E402
from clip_event_tpu.models import layers as JL  # noqa: E402
from clip_event_tpu.parallel import pipeline as JP  # noqa: E402
from clip_event_tpu_torch import config as TC  # noqa: E402
from clip_event_tpu_torch.engine.optim import tree_leaves, tree_unflatten  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.parallel import pipeline as TP  # noqa: E402
from clip_event_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from tests.test_model_parity import TINY_VIT  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

LAYERS, W, H, S, B = 4, 64, 2, 16, 12
PP = 2
TOL = 1e-5


def _mesh(stage: int, pp: int = PP) -> Mesh:
    """A hand-made mesh of one stage (no process group: the layouts and
    the in-process driver need only the coordinates)."""
    return Mesh(stage, pp, torch.device("cpu"), pp=pp)


@pytest.fixture(scope="module")
def stack():
    """A 4-layer causal stack (JAX's init), an input, and a cotangent whose
    gradients are O(1)."""
    params = JL.init_transformer(jax.random.PRNGKey(0), LAYERS, W)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    dy = (rng.normal(size=(B, S, W)) / np.sqrt(B * S)).astype(np.float32)
    return jax.tree.map(np.array, params), x, dy


def _jax_pipelined(params, x, dy, microbatches, remat):
    """JAX's GPipe over (dp=4, pp=2): the output, and the gradients of x and
    of every stack leaf, of <tanh(y), dy>."""
    mesh = JP.make_mesh_pp(pp=PP)
    bias = JL.causal_mask(S)

    def loss(p, x):
        y = JP.pipelined_transformer(x, p, H, bias, mesh, microbatches=microbatches, remat=remat)
        return jnp.sum(jnp.tanh(y) * dy), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        JP.shard_params_pp(jax.tree.map(jnp.asarray, params), mesh), jnp.asarray(x))
    return np.asarray(y), np.asarray(gx), jax.tree.map(np.asarray, gp)


def _port_pipelined(params, x, dy, microbatches, remat):
    """The port's in-process driver over the stages `PPLayout` cuts."""
    full = {"transformer": {k: jax.tree.map(torch.from_numpy, v) for k, v in params.items()}}
    leaves = tree_leaves(full)
    stages = []
    for s in range(PP):
        cut = TP.PPLayout(full, _mesh(s)).shard_leaves(leaves)
        stages.append(tree_unflatten(full, [t.clone().requires_grad_(True) for t in cut])["transformer"])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TP.run_in_process(xt, stages, H, TL.causal_mask(S, device="cpu"), microbatches, remat)
    grads = torch.autograd.grad((torch.tanh(y) * torch.from_numpy(dy)).sum(),
                                [xt] + [t for st in stages for t in tree_leaves(st)])
    n = len(leaves)
    per_stage = [grads[1 + s * n:1 + (s + 1) * n] for s in range(PP)]
    laid = [torch.cat(parts).numpy() for parts in zip(*per_stage)]
    return y.detach().numpy(), grads[0].numpy(), tree_unflatten(full, laid)["transformer"]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("microbatches", [1, 3, 4])
def test_in_process_pipeline_matches_jax(stack, microbatches, remat):
    """The output, dx and every stack leaf's gradient within 1e-5 of JAX's
    pipelined stack at pp = 2 (the parameters' gradients are sums over the
    microbatches, in another order than JAX's: not bit for bit)."""
    params, x, dy = stack
    want_y, want_dx, want_g = _jax_pipelined(params, x, dy, microbatches, remat)
    got_y, got_dx, got_g = _port_pipelined(params, x, dy, microbatches, remat)
    np.testing.assert_allclose(got_y, want_y, atol=TOL, rtol=0)
    np.testing.assert_allclose(got_dx, want_dx, atol=TOL, rtol=0)
    flat_want = jax.tree_util.tree_flatten_with_path(want_g)[0]
    got_by_path = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got_g)[0]}
    assert len(flat_want) == 12
    for path, want in flat_want:
        np.testing.assert_allclose(got_by_path[jax.tree_util.keystr(path)], want, atol=TOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    assert max(np.abs(w).max() for _, w in flat_want) > 1e-2


@pytest.mark.parametrize("remat", [False, "full", "attn"])
def test_in_process_pipeline_equals_the_plain_stack_on_the_cpu(stack, remat):
    """Against the port's own stack on the whole batch: the forward and dx
    bit for bit on the CPU (the same layers, row by row), every leaf's
    gradient within 1e-5 (summed over 4 microbatches)."""
    params, x, dy = stack
    full = {k: jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(True), v) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TL.transformer(xt, full, H, TL.causal_mask(S, device="cpu"), remat=remat)
    want = torch.autograd.grad((torch.tanh(y) * torch.from_numpy(dy)).sum(), [xt] + tree_leaves(full))
    got_y, got_dx, got_g = _port_pipelined(params, x, dy, 4, remat)
    assert np.array_equal(got_y, y.detach().numpy()) and np.array_equal(got_dx, want[0].numpy())
    for g, w in zip(tree_leaves(got_g), want[1:]):
        np.testing.assert_allclose(g, w.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("layers", [(2, 2), (2, 4)])
def test_stage_leaf_rule_matches_pipeline_param_shardings(pp, layers):
    """`stage_leaves` against JAX's `pipeline_param_shardings` on the same
    tree, leaf by leaf: P('pp') where the port splits a leaf into stages,
    P() where it keeps it whole (a stack whose depth does not divide pp,
    the embeddings, the projections, the final norms)."""
    kw = {f.name: getattr(TINY_VIT, f.name) for f in TINY_VIT.__dataclass_fields__.values()}
    kw.update(vision_layers=layers[0], transformer_layers=layers[1])
    jparams = j_init_params(jax.random.PRNGKey(0), type(TINY_VIT)(**kw))
    shardings = JP.pipeline_param_shardings(jparams, JP.make_mesh_pp(pp=pp))
    want = {jax.tree_util.keystr(p): s.spec == jax.sharding.PartitionSpec("pp")
            for p, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}
    tparams = T.init_params(torch.Generator().manual_seed(0), T.CLIPConfig(**kw), "cpu")
    paths = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                paths.append("".join(f"['{p}']" for p in path + (k,)))

    walk(tparams, ())
    got = dict(zip(paths, TP.stage_leaves(tparams, pp)))
    assert got == want
    split = [k for k, v in got.items() if v]
    assert len(split) == 12 * sum(n % pp == 0 for n in layers)
    specs = TP.PPLayout(tparams, _mesh(0, pp)).specs
    assert [s.kind == "stage" for s in specs] == TP.stage_leaves(tparams, pp)


def test_pick_microbatches_matches_jax():
    for batch in range(1, 40):
        for requested in (1, 2, 3, 4, 5, 8, 16, 64):
            assert TP._pick_microbatches(batch, requested) == JP._pick_microbatches(batch, requested)
    # B/32's train step at pp_microbatches 4: 384 image rows, 1,152 text rows
    assert TP._pick_microbatches(384, 4) == TP._pick_microbatches(1152, 4) == 4


def test_schedules_cover_every_microbatch_once():
    """Each stage computes its M microbatches once in M + pp − 1 ticks (no
    bubble work); at each tick a stage receives what its neighbour sends
    that tick, forward and backward; the backward walks the microbatches in
    reverse."""
    for pp, M in ((2, 1), (2, 4), (4, 3), (4, 4)):
        fwd = {s: list(TP.forward_ticks(s, pp, M)) for s in range(pp)}
        bwd = {s: list(TP.backward_ticks(s, pp, M)) for s in range(pp)}
        for plans, order in ((fwd, list(range(M))), (bwd, list(range(M))[::-1])):
            for s in range(pp):
                assert len(plans[s]) == M + pp - 1
                assert [m for _, m in plans[s] if m is not None] == order
        for t in range(M + pp - 1):
            for s in range(pp - 1):
                assert fwd[s][t][0] == fwd[s + 1][t][1]
                assert bwd[s + 1][t][0] == bwd[s][t][1]
        assert all(fwd[pp - 1][t][0] is None and bwd[0][t][0] is None for t in range(M + pp - 1))


def test_a_stage_slice_needs_the_pipeline(stack):
    """A stack that holds fewer layers than its tower's depth runs only
    under `set_pipeline` with the matching pp; a whole stack runs as it
    is under the pipeline; the setter refuses what JAX refuses."""
    params, x, _ = stack
    full = {k: jax.tree.map(torch.from_numpy, v) for k, v in params.items()}
    half = jax.tree.map(lambda t: t[:2], full)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="needs the pipeline"):
        TL.transformer(xt, half, H, depth=LAYERS)
    with TL.pipeline(_mesh(0, 4)):
        with pytest.raises(ValueError, match="of 2 stages"):
            TL.transformer(xt, half, H, depth=LAYERS)
        assert TL.resolve_pipeline()[0].world_size == 4
        with torch.no_grad():
            assert torch.equal(TL.transformer(xt, full, H, depth=LAYERS), TL.transformer(xt, full, H))
    assert TL.resolve_pipeline() is None
    with pytest.raises(ValueError, match="pp_microbatches"):
        TL.set_pipeline(_mesh(0), 0)
    with pytest.raises(TypeError, match="Mesh"):
        TL.set_pipeline(object())


def test_the_model_runs_a_list_of_stages_in_one_process():
    """A stack given as the list of its stages (`PPLayout`'s cuts) runs
    every stage in this process under a pipeline of as many stages
    (`run_in_process`, what `chip_smoke.py` drives on the card): the image
    and text features of the whole model's forward, bit for bit on the CPU,
    and a stage's gradient the matching layers' of the whole stack's
    within 1e-5; without the pipeline it is refused."""
    cfg = T.CLIPConfig(**{f.name: getattr(TINY_VIT, f.name) for f in TINY_VIT.__dataclass_fields__.values()})
    params = T.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8))
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, size=(6, cfg.context_length)))
    leaves = tree_leaves(params)
    cuts = [TP.PPLayout(params, _mesh(st)).shard_leaves(leaves) for st in range(PP)]
    staged = tree_unflatten(params, cuts[0])
    staged["text_transformer"] = [tree_unflatten(params, c)["text_transformer"] for c in cuts]
    staged["visual"]["transformer"] = [tree_unflatten(params, c)["visual"]["transformer"] for c in cuts]
    with pytest.raises(ValueError, match="needs the pipeline"):
        T.encode_text(staged, cfg, tokens)
    with TL.pipeline(_mesh(0), 3):
        got = (T.encode_image(staged, cfg, images), T.encode_text(staged, cfg, tokens))
        w = staged["text_transformer"][1]["mlp"]["fc_w"].requires_grad_(True)
        g_stage = torch.autograd.grad(T.encode_text(staged, cfg, tokens, remat=True).sum(), w)[0]
    assert torch.equal(got[0], T.encode_image(params, cfg, images))
    assert torch.equal(got[1], T.encode_text(params, cfg, tokens))
    whole = params["text_transformer"]["mlp"]["fc_w"].requires_grad_(True)
    g_whole = torch.autograd.grad(T.encode_text(params, cfg, tokens, remat=True).sum(), whole)[0]
    half = cfg.transformer_layers // PP
    np.testing.assert_allclose(g_stage.numpy(), g_whole[half:].numpy(), atol=TOL, rtol=0)


def test_a_pp_run_needs_a_launch(tmp_path, monkeypatch):
    """`python -m clip_event_tpu_torch.train` with pp > 1 and no process
    group raises before it builds anything: nothing falls back to one
    process (as tp and dcn_dp refuse)."""
    import json

    from clip_event_tpu_torch import train as TR

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    path = tmp_path / "pp.json"
    path.write_text(json.dumps({"task": "t", "constrastive_loss": "ce", "batch_size": 2, "lr": 1e-4,
                                "optimizer": "adam", "max_epoch": 1, "pp": 2}))
    with pytest.raises(SystemExit, match="pp=2 shard the job over processes"):
        TR.main(["--cfg", str(path), "--device", "cpu"])


@pytest.mark.parametrize("extra", [
    {"pp": 2}, {"pp": 4, "pp_microbatches": 8}, {"pp": 2, "zero": True}, {"pp": 2, "fsdp": True},
    {"pp": 2, "tp": 2}, {"pp": 2, "dcn_dp": 2}, {"pp": 0}, {"pp": 1.5}, {"pp_microbatches": 0},
    {"pp": 2, "sp": True},
])
def test_pp_config_rules_match_jax(extra):
    """pp is accepted as the JAX package accepts it, and refused with its
    messages: pp × tp, pp × dcn_dp, pp < 1."""
    base = {"task": "t", "constrastive_loss": "ce", "batch_size": 2, "lr": 1e-4,
            "optimizer": "adam", "max_epoch": 1}
    try:
        ref = JC.validate_config(dict(base, **extra))
    except JC.ConfigError as err:
        with pytest.raises(TC.ConfigError) as got:
            TC.validate_config(dict(base, **extra))
        assert str(got.value) == str(err)
    else:
        assert TC.validate_config(dict(base, **extra)) == ref
