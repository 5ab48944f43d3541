"""The port's data-parallel layer in one process, on the CPU: the cluster
adapter against the JAX package's on the same launch environments
(OpenMPI and its sub-environments, SLURM, a hostfile, none) and its own
torchrun rung; the rank-offset label layouts and the cross-rank weave of
the evals against JAX's; the train step with a mesh of one rank (a gloo
group over a FileStore) bit for bit against the step without one (the
gather and the gradient sum are copies there; plain contrastive, the
deduped multiattention branch, gradient accumulation with deduped texts);
`initialize_distributed` from torchrun's environment; the mesh in the
LayerNorm and attention choices. The multi-rank paths are in
tests/test_torch_multiprocess.py.

Layouts and the weave are exact (integers and copied rows); the steps are
bit for bit (under `torch.use_deterministic_algorithms`: the CPU's
`index_put_` accumulate of the token-embedding gradient is not
deterministic otherwise)."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")

from clip_event_tpu.data.labels import build_label_layout as jax_layout  # noqa: E402
from clip_event_tpu.evals import common as JEC  # noqa: E402
from clip_event_tpu.parallel import cluster as JCL  # noqa: E402
from clip_event_tpu.parallel import collectives as JCO  # noqa: E402
from clip_event_tpu_torch.data.common import DataLoader  # noqa: E402
from clip_event_tpu_torch.data.labels import build_label_layout  # noqa: E402
from clip_event_tpu_torch.engine import optim as TO  # noqa: E402
from clip_event_tpu_torch.engine import train_step as TT  # noqa: E402
from clip_event_tpu_torch.evals import common as TEC  # noqa: E402
from clip_event_tpu_torch.models import layers  # noqa: E402
from clip_event_tpu_torch.parallel import cluster as TCL  # noqa: E402
from clip_event_tpu_torch.parallel import collectives as TCO  # noqa: E402
from clip_event_tpu_torch.parallel import mesh as TM  # noqa: E402
from tests import torch_multiprocess_worker as W  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

LAUNCH_KEYS = (
    "JAX_COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
    "WORLD_SIZE", "RANK", "LOCAL_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
    "OMPI_COMM_WORLD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK", "PHILLY_CONTAINER_IP",
    "PHILLY_CONTAINER_PORT_RANGE_START", "AMLK8S_NUM_WORKER", "AZ_CMK8S_JOB_WORK_DIR",
    "CLIP_EVENT_ITP_ENV_FILE", "AZ_BATCH_MASTER_NODE", "OMPI_MCA_orte_default_hostfile",
    "SLURM_PROCID", "SLURM_NTASKS", "SLURM_NODELIST", "SLURM_LOCALID",
)


@pytest.fixture
def launch_env(monkeypatch):
    for key in LAUNCH_KEYS:
        monkeypatch.delenv(key, raising=False)

    def set_env(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)

    return set_env


def _ompi(size, rank, local_size, **extra):
    return dict(OMPI_COMM_WORLD_SIZE=str(size), OMPI_COMM_WORLD_RANK=str(rank),
                OMPI_COMM_WORLD_LOCAL_SIZE=str(local_size),
                OMPI_COMM_WORLD_LOCAL_RANK=str(rank % local_size), **extra)


CLUSTER_CASES = {
    "single": lambda tmp: {},
    "openmpi_master_addr": lambda tmp: _ompi(2, 1, 1, MASTER_ADDR="10.0.0.1", MASTER_PORT="1234"),
    "openmpi_single_node": lambda tmp: _ompi(2, 0, 2),
    "openmpi_hostfile": lambda tmp: _ompi(4, 2, 2, OMPI_MCA_orte_default_hostfile=str(tmp / "hosts")),
    "openmpi_aml": lambda tmp: _ompi(4, 1, 2, AZ_BATCH_MASTER_NODE="10.1.2.3:6000"),
    "openmpi_itp": lambda tmp: _ompi(4, 3, 2, AMLK8S_NUM_WORKER="2",
                                     CLIP_EVENT_ITP_ENV_FILE=str(tmp / "init.env")),
    "openmpi_itp_single_node": lambda tmp: _ompi(2, 1, 2, AMLK8S_NUM_WORKER="1",
                                                 CLIP_EVENT_ITP_ENV_FILE=str(tmp / "missing.env")),
    "openmpi_philly_one_process": lambda tmp: _ompi(1, 0, 1, PHILLY_CONTAINER_IP="10.2.2.2"),
    "slurm": lambda tmp: dict(SLURM_PROCID="3", SLURM_NTASKS="4", SLURM_LOCALID="1",
                              MASTER_ADDR="host1", MASTER_PORT="29500"),
    "slurm_no_address": lambda tmp: dict(SLURM_PROCID="0", SLURM_NTASKS="2"),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_detect_cluster_matches_jax(case, launch_env, tmp_path):
    (tmp_path / "hosts").write_text("\n# comment-free hostfile\nnode7 slots=2\nnode8 slots=2\n".lstrip("\n"))
    (tmp_path / "init.env").write_text("export FOO=1\nexport DLTS_SD_worker0_IP=10.9.8.7\n")
    env = CLUSTER_CASES[case](tmp_path)
    launch_env(env)
    ours, ref = TCL.detect_cluster(), JCL.detect_cluster()
    assert (ours.coordinator_address, ours.num_processes, ours.process_id, ours.source) == (
        ref.coordinator_address, ref.num_processes, ref.process_id, ref.source)
    assert ours.is_distributed == ref.is_distributed
    local = env.get("OMPI_COMM_WORLD_LOCAL_RANK", env.get("SLURM_LOCALID", "0"))
    assert ours.local_rank == int(local)


def test_torchrun_rung_and_the_mpi_broadcast_refusal(launch_env):
    """torchrun's variables come first (any world, a world of one too);
    an MPI launch that needs rank 0's address broadcast raises without
    mpi4py, in both packages."""
    launch_env(dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="29511", RANK="1", WORLD_SIZE="2",
                    LOCAL_RANK="1"))
    spec = TCL.detect_cluster()
    assert (spec.coordinator_address, spec.num_processes, spec.process_id, spec.source,
            spec.local_rank) == ("127.0.0.1:29511", 2, 1, "torchrun", 1)
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        os.environ.pop(key)
    try:
        import mpi4py  # noqa: F401

        pytest.skip("mpi4py is installed: the broadcast would run")
    except ImportError:
        pass
    launch_env(_ompi(4, 1, 2))  # multi-node, no address anywhere
    for pkg in (TCL, JCL):
        with pytest.raises(RuntimeError, match="mpi4py"):
            pkg.detect_cluster()


@pytest.mark.parametrize("rank,world", [(0, 2), (1, 2), (3, 4)])
@pytest.mark.parametrize("loss,overbatch", [("ce", True), ("kl", True), ("bce", False)])
def test_rank_label_layouts_match_jax(rank, world, loss, overbatch):
    B, P, G = 3, 1, 2
    ours = build_label_layout(B, P, G, loss, overbatch, rank=rank, world_size=world)
    ref = jax_layout(B, P, G, loss, overbatch, rank=rank, world_size=world)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    # the ranks' row blocks, in rank order, are the global batch's layout
    whole = build_label_layout(B * world, P, G, loss, overbatch)
    blocks = [build_label_layout(B, P, G, loss, overbatch, rank=r, world_size=world)
              for r in range(world)]
    for field in ("labels_per_image", "labels_per_text"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(b, field) for b in blocks]), getattr(whole, field))
    np.testing.assert_array_equal(ours.index_pos, whole.index_pos)


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,world", [(7, 2), (9, 4), (4, 4), (5, 1)])
def test_merge_across_ranks_matches_jax(n, world, monkeypatch):
    """Each rank's loader slice (its wrap-around rows included) woven back
    into dataset order by both packages: arrays and lists."""
    per_rank = []
    for r in range(world):
        idx = DataLoader(_Indexed(n), 2, shuffle=False, drop_last=False, rank=r,
                         world_size=world)._indices()
        per_rank.append((np.stack([idx * 10.0, idx + 0.5], 1).astype(np.float32),
                         [{"id": int(i)} for i in idx]))
    monkeypatch.setattr(TCO, "all_gather_objects", lambda parts: per_rank)
    monkeypatch.setattr(JCO, "all_gather_objects", lambda parts: per_rank)
    ours = TEC.merge_across_ranks(n, world, *per_rank[0])
    ref = JEC.merge_across_ranks(n, world, *per_rank[0])
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1] == [{"id": i} for i in range(n)]
    np.testing.assert_array_equal(ours[0][:, 0], np.arange(n) * 10.0)
    if world > 1:
        genuine = np.concatenate([TEC.genuine_rows(r, world, 0, len(p[1]), n)
                                  for r, p in enumerate(per_rank)])
        assert genuine.sum() == n


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


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("case", ["contrastive", "multiattention", "accum_dedupe"])
def test_world_of_one_step_is_the_step_without_a_mesh(case, world_of_one, deterministic):
    mesh = world_of_one
    assert (mesh.rank, mesh.world_size, mesh.device) == (0, 1, torch.device("cpu"))
    params, cfg = W.init_params(case)
    opt = TO.build_optimizer("adam", TO.build_schedule("none", 1e-3, 1))
    kw = dict(compute_dtype=torch.float32, remat=True, **W.step_kwargs(case))
    if case == "accum_dedupe":
        micro = [W.make_batches(case, 1, 4, 20 + k)[1][0] for k in range(2)]
        batches = [{k: np.stack([m[k] for m in micro]) for k in micro[0]}] * 2
        plain, dp = TT.make_accum_step(cfg, opt, 2, **kw), TT.make_accum_step(cfg, opt, 2, mesh=mesh, **kw)
    else:
        batches = [W.make_batches(case, 1, 4, 10 + i)[1][0] for i in range(2)]
        plain, dp = TT.make_train_step(cfg, opt, **kw), TT.make_train_step(cfg, opt, mesh=mesh, **kw)
    a, b = TT.create_train_state(params, opt), TT.create_train_state(params, opt)
    for batch in batches:
        a, ma = plain(a, _t(batch))
        b, mb = dp(b, _t(batch))
        assert ma.keys() == mb.keys()
        assert all(torch.equal(ma[k], mb[k]) for k in ma), {k: (ma[k], mb[k]) for k in ma}
    la = TO.tree_leaves(a.params) + TO.tree_leaves(a.opt_state)
    lb = TO.tree_leaves(b.params) + TO.tree_leaves(b.opt_state)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_initialize_distributed_from_torchrun_env(launch_env):
    """torchrun's environment at a world of one: a gloo group for the CPU,
    the mesh, the eval shard and the host collectives; a CUDA mesh over
    gloo is refused (a CUDA run never goes over gloo)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    launch_env(dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
                    LOCAL_RANK="0"))
    assert not dist.is_initialized()
    try:
        spec = TM.initialize_distributed("cpu")
        assert spec.source == "torchrun" and dist.get_backend() == "gloo"
        assert TM.initialize_distributed("cpu") is spec  # a no-op once initialised
        mesh = TM.make_mesh("cpu")
        assert (mesh.rank, mesh.world_size, str(mesh.device)) == (0, 1, "cpu")
        with pytest.raises(RuntimeError, match="cuda mesh over a gloo"):
            TM.make_mesh("cuda")
        assert TEC.resolve_shard(None, None) == (0, 1) and TEC.resolve_shard(2, 4) == (2, 4)
        assert TM.data_process_group() == (0, 1)
        # a tp group of 2 needs 2 processes, and so does a pp group of 2
        with pytest.raises(ValueError, match="does not divide process_count=1"):
            TM.data_process_group(2)
        with pytest.raises(ValueError, match="needs process groups of 2, which does not divide"):
            TM.data_process_group(1, pp=2)
        with pytest.raises(ValueError, match="pp=2 does not divide device count 1"):
            TM.make_mesh("cpu", pp=2)
        assert TCO.reduce_dict({"a": 1.5}) == {"a": 1.5} and TCO.all_gather_objects(3) == [3]
        assert TCO.any_rank(True) and not TCO.any_rank(False)
        TCO.comm.synchronize()
        tree = {"w": torch.arange(3.0), "b": [torch.ones(2, dtype=torch.int32)]}
        assert TM.replicate(tree, mesh) is tree
        batch = TM.shard_batch({"image": np.zeros((2, 3)), "index_pos": np.arange(4)}, mesh)
        assert batch["index_pos"].tolist() == [0, 1, 2, 3]
    finally:
        dist.destroy_process_group()


def test_no_launch_no_group(launch_env):
    assert TM.initialize_distributed("cpu") is None and not dist.is_initialized()
    assert TCO.comm.world_size == 1 and TCO.comm.rank == 0 and TCO.comm.is_main_process
    mesh = TM.make_mesh("cuda")
    assert mesh.device == torch.device("cuda", 0) and mesh.world_size == 1


def test_impl_setters_take_the_mesh():
    """The JAX package's `set_ln_impl(impl, mesh)` / `set_attention_impl`:
    the port's mesh is accepted (each rank's kernels run on its own rows),
    anything else is refused."""
    mesh = TM.make_mesh("cpu")
    try:
        layers.set_ln_impl("pallas", mesh=mesh)
        assert layers._resolve_ln() == "pallas"
        layers.set_attention_impl("plain", mesh=mesh)
        assert layers._resolve_attention() == "plain"
        for setter, impl in ((layers.set_ln_impl, "xla"), (layers.set_attention_impl, "kernel")):
            with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
                setter(impl, mesh="dp")
    finally:
        layers.set_ln_impl("xla")
        layers.set_attention_impl("kernel")
