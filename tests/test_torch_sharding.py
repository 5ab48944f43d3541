"""ZeRO-1 and FSDP of the port (`parallel/sharding.py`) in one process, on
the CPU: the leaf layout (every rank's shard against the [W, k] rows the
collectives move, the full leaf back from them, the padding) at worlds of
1, 2 and 3; the sharded train steps at a world of one (a gloo group over a
FileStore) bit for bit the plain step (contrastive, the deduped
multiattention branch, gradient accumulation, two steps in one
`make_multi_step` dispatch); `train()` through the loop under `zero` and
`fsdp` bit for bit the unsharded loop (losses, the checkpoint files, the
validation on the gathered params) with the JAX CLI's log lines; and the
refusals (no launch, a step on another mesh, a state sharded twice). The
multi-rank numerics against JAX are in tests/test_torch_multiprocess.py.

Bit for bit under `torch.use_deterministic_algorithms` (the CPU's
`index_put_` accumulate of the token-embedding gradient is not
deterministic otherwise)."""

import logging
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from clip_event_tpu_torch.config import validate_config
from clip_event_tpu_torch.engine import optim as TO
from clip_event_tpu_torch.engine import train_step as TT
from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint
from clip_event_tpu_torch.models import clip as T
from clip_event_tpu_torch.parallel import mesh as TM
from clip_event_tpu_torch.parallel import sharding as TS
from tests import torch_multiprocess_worker as W
from tests.fixtures import make_voa_fixture
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank, and its mesh."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield TM.make_mesh("cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture
def deterministic():
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("shape,stacked", [((7,), False), ((6, 5), False), ((2, 5, 3), True),
                                           ((3, 4), True), ((), False)])
def test_leaf_layout_round_trips(world, shape, stacked):
    x = torch.arange(1, int(np.prod(shape)) + 1, dtype=torch.float32).reshape(shape)
    spec = TS.LeafSpec(tuple(shape), stacked, world, replicated=len(shape) == 0)
    rows = spec.to_rows(x)
    assert rows.shape[0] == world
    shards = [spec.shard_of(x, r) for r in range(world)]
    for r, shard in enumerate(shards):
        assert tuple(shard.shape) == spec.shard_shape
        assert torch.equal(shard.reshape(-1), rows[r])
    if spec.replicated:
        assert all(torch.equal(s, x) for s in shards)
    else:
        n = int(np.prod(shape)) // spec.rows
        assert spec.c == -(-n // world) and shards[0].numel() == spec.rows * spec.c
        # every element once, in its rank's chunk, the padding zeros
        joined = torch.stack([s.reshape(spec.rows, spec.c) for s in shards], 1).reshape(spec.rows, -1)
        assert torch.equal(joined[:, :n].reshape(shape), x) and not joined[:, n:].any()
    assert torch.equal(spec.from_rows(torch.stack([s.reshape(-1) for s in shards])), x)
    if stacked:
        layer = spec.layer()
        assert layer.shape == tuple(shape[1:]) and not layer.stacked
        for r in range(world):
            assert torch.equal(layer.shard_of(x[1], r), spec.shard_of(x, r)[1])


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _leaves(state):
    full = TS.gather_state(state)
    return TO.tree_leaves(full.params) + TO.tree_leaves(full.opt_state)


@pytest.mark.parametrize("case", ["contrastive", "multiattention", "accum_dedupe", "multi_step"])
@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_world_of_one_sharded_step_is_the_plain_step(mode, case, world_of_one, deterministic):
    """Two sharded steps (or one accumulated step of two microbatches, or a
    2-step dispatch), Adam with the clip, against the same without a
    sharding: every metric, param and moment bit for bit; the shards are
    the whole leaves, flat (one rank, no padding)."""
    mesh = world_of_one
    base = "contrastive" if case == "multi_step" else case
    params, cfg = W.init_params(base)
    opt = W.adam()
    kw = dict(compute_dtype=torch.float32, remat=True, mesh=mesh, **W.step_kwargs(base))
    if case == "accum_dedupe":
        micro = [W.make_batches(case, 1, 2, 20 + k)[1][0] for k in range(2)]
        batches = [_t({k: np.stack([m[k] for m in micro]) for k in micro[0]})]
        step = TT.make_accum_step(cfg, opt, 2, **kw)
    elif case == "multi_step":
        one = [_t(W.make_batches(base, 1, 2, 10 + i)[1][0]) for i in range(2)]
        batches = [{k: torch.stack([b[k] for b in one]) for k in one[0]}]
        step = TT.make_multi_step(cfg, opt, 2, **kw)[0]
    else:
        batches = [_t(W.make_batches(case, 1, 2, 10 + i)[1][0]) for i in range(2)]
        step = TT.make_train_step(cfg, opt, **kw)
    plain = TT.create_train_state(params, opt)
    sharded = TS.shard_state(TT.create_train_state(params, opt), mesh, mode)
    assert sharded.sharding.mode == mode
    for leaf, spec in zip(TO.tree_leaves(sharded.opt_state["mu"]), sharded.sharding.specs):
        assert tuple(leaf.shape) == spec.shard_shape
        assert leaf.numel() == int(np.prod(spec.shape))
    for batch in batches:
        plain, mp = step(plain, batch)
        sharded, ms = step(sharded, batch)
        assert mp.keys() == ms.keys()
        assert all(torch.equal(mp[k], ms[k]) for k in mp), {k: (mp[k], ms[k]) for k in mp}
    assert sharded.step == plain.step and sharded.sharding is not None
    assert all(torch.equal(a, b) for a, b in zip(_leaves(plain), _leaves(sharded)))


@pytest.mark.parametrize("mode", ["zero", "fsdp"])
def test_world_of_one_sharded_resnet_step_is_the_plain_step(mode, world_of_one, deterministic):
    """A tiny ResNet tower (its convolutions, BatchNorm statistics and
    attention pool gathered at their use under FSDP), with the global batch
    statistics of `sync_bn`: bit for bit the plain step."""
    from clip_event_tpu_torch.models import resnet

    mesh = world_of_one
    params, cfg = W.init_params("sync_bn")
    opt = W.adam()
    batch = _t(W.make_batches("sync_bn", 1, 2, 10)[1][0])
    with resnet.bn_mode("batch", mesh):
        step = TT.make_train_step(cfg, opt, compute_dtype=torch.float32, remat=True, mesh=mesh)
        plain, mp = step(TT.create_train_state(params, opt), batch)
        sharded, ms = step(TS.shard_state(TT.create_train_state(params, opt), mesh, mode), batch)
    assert all(torch.equal(mp[k], ms[k]) for k in mp)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(plain), _leaves(sharded)))


def test_sharding_refusals(world_of_one, tmp_path):
    mesh = world_of_one
    params, cfg = W.init_params("contrastive")
    opt = W.adam()
    state = TS.shard_state(TT.create_train_state(params, opt), mesh, "zero")
    with pytest.raises(ValueError, match="sharded already"):
        TS.shard_state(state, mesh, "fsdp")
    with pytest.raises(ValueError, match="sharding mode"):
        TS.shard_state(TT.create_train_state(params, opt), mesh, "zero3")
    batch = _t(W.make_batches("contrastive", 1, 2, 10)[1][0])
    with pytest.raises(ValueError, match="needs a step on that mesh"):
        TT.make_train_step(cfg, opt, compute_dtype=torch.float32)(state, batch)


def _loop_config(tmp_path, voa, **extra):
    return validate_config({
        "task": "shard", "constrastive_loss": "ce", "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "max_epoch": 1, "batch_size": 2, "lr": 1e-4, "optimizer": "adam", "lr_scheduler": "none",
        "compute_dtype": "float32", "remat": True, "num_workers": 0, "seed": 2,
        "validate_every": 1, "val_image_caption_json": [voa["mapping_json"]],
        "val_image_dir": [voa["image_dir"]], "model": dict(W.VIT, vision_layers=2),
        "ckpt_dir": str(tmp_path / "ckpt"), "tb_log_dir": str(tmp_path / "logs"), **extra,
    })


def test_train_loop_under_zero_and_fsdp(world_of_one, deterministic, tmp_path, caplog):
    """`train()` at a world of one: the plain loop, `zero` and `fsdp` give
    the same loss stream and the same checkpoint file, bit for bit, and
    log the JAX CLI's lines; without a launch the sharded loop refuses."""
    from clip_event_tpu_torch.train import build_dataset, train

    mesh = world_of_one
    voa = make_voa_fixture(str(tmp_path / "voa"), num_docs=6)
    runs = {}
    for mode in ("plain", "zero", "fsdp"):
        cfg = _loop_config(tmp_path / mode, voa, **({mode: True} if mode != "plain" else {}))
        mcfg = T.CLIPConfig(**cfg["model"])
        params = T.init_params(torch.Generator().manual_seed(2), mcfg, "cpu")
        losses = {}
        caplog.clear()
        with caplog.at_level(logging.INFO):
            state = train(cfg, mcfg, build_dataset(cfg, mcfg), params, "cpu", mesh=mesh,
                          on_step=lambda s, m: losses.__setitem__(s, float(m["loss"])))
        path = os.path.join(cfg["ckpt_dir"], "shard", "shard_0")
        runs[mode] = (losses, restore_checkpoint(path), state)
        if mode != "plain":
            assert "ZeRO-1: optimizer moments sharded over dp=1" in caplog.text
            assert ("FSDP: params sharded over dp=1" in caplog.text) == (mode == "fsdp")
            assert state.sharding.mode == mode
    losses, (params, opt_state, meta, _), _ = runs["plain"]
    assert len(losses) >= 2
    for mode in ("zero", "fsdp"):
        got, (p, o, m, _), _ = runs[mode]
        # the meta's perf is the validation's top-1 on the gathered params
        assert got == losses and m == meta
        assert all(torch.equal(a, b) for a, b in zip(TO.tree_leaves(p), TO.tree_leaves(params)))
        assert all(torch.equal(a, b) for a, b in zip(TO.tree_leaves(o), TO.tree_leaves(opt_state)))
    cfg = _loop_config(tmp_path / "nomesh", voa, zero=True)
    mcfg = T.CLIPConfig(**cfg["model"])
    with pytest.raises(SystemExit, match="launch with torchrun"):
        train(cfg, mcfg, build_dataset(cfg, mcfg), T.init_params(torch.Generator().manual_seed(2), mcfg, "cpu"),
              "cpu")
