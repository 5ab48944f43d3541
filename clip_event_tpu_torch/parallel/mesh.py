"""The process mesh of the port (counterpart of
`clip_event_tpu/parallel/mesh.py` and of `make_mesh_2d` in
`clip_event_tpu/parallel/sharding.py`; reference DDP/NCCL stack,
`utils.py:541-616`, `train.py:222-225`).

Parallelism model: one process per GPU. The processes form a mesh of
four axes, (dcn, dp, pp, tp), tp innermost: rank = ((dcn_idx·DP +
dp_idx)·PP + pp_idx)·TP + tp_idx, the flat device order of the JAX
package's `make_mesh_2d` and, for pp, of its `make_mesh_pp`
(`devices.reshape(dp, pp)`); the JAX package's config takes pp with
neither tp nor dcn (`config.py`), so a mesh has pp > 1 or tp / dcn > 1.
The ranks of one tp group (one (dcn_idx, dp_idx)) hold the Megatron shards
of the transformer stacks (`parallel/sharding.py`) and the same rows of the
batch; the ranks of one pp group (one dp_idx) hold the stages of the
stacks (`parallel/pipeline.py`) and the same rows too; the ranks with one
(pp_idx, tp_idx) form the data group, over which the batch is split
(`batch_size` rows a data rank, its rank-major block, the
row order JAX's `make_array_from_process_local_data` gives), and over
which the gradients are summed in one all-reduce
(`collectives.all_reduce_flat`; the dcn axis shapes the coordinates and
the loader's data rank, and NCCL's all-reduce already follows the links
between and within hosts). Each data rank holds a full copy of the
params and optimizer state, or its shard of them under ZeRO-1 / FSDP
(`parallel/sharding.py`). The JAX package gets the global loss from
GSPMD; here the train step makes it by hand (`engine/train_step.py`): the
contrastive features are all-gathered over the data group
(`collectives.gather_features`), the local loss sums stay local, and the
gradients are summed inside the step. The collectives run over NCCL on
the card and over gloo only when the caller asked for the CPU; NCCL
failing on a CUDA run is an error.

`mesh.data` is the data-parallel view (rank, world and group of the data
group), `mesh.tensor` the tensor-parallel view (of the tp group) and
`mesh.pipe` the pipeline view (of the pp group, its rank the stage); at tp
= pp = 1 the data view is the mesh itself. Under dcn > 1 `mesh.slice` is
the data ranks of this rank's slice and `mesh.cross` the ranks of its
dp_idx in every slice: ZeRO-1 and FSDP shard the state within the slice
and sum across slices (`parallel/sharding.py`), as the JAX package keeps
the moments off the dcn axis.

`initialize_distributed()` first (torchrun, OpenMPI or SLURM, through
`parallel.cluster`), then `make_mesh(device, tp=, dcn=, sp=, pp=)`: the rank,
the world, the device (`cuda:LOCAL_RANK`), the process groups.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from clip_event_tpu_torch.parallel import collectives
from clip_event_tpu_torch.parallel.cluster import ClusterSpec, detect_cluster, initialize_from_cluster

log = logging.getLogger(__name__)

# what `initialize_distributed` detected in this process (its local rank)
_CLUSTER: Optional[ClusterSpec] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in the job: its `rank` of `world_size`, its
    `device`, the process group of the whole job (`group`, None: the
    default group), the axes' sizes (`dcn`, `tp`, `pp`; dp follows),
    whether the transformer stacks' residual stream is sharded over the
    sequence (`sp`, Megatron sequence parallelism, tp > 1) and this rank's
    subgroups: its tp group and its pp group, its data group (under tp or
    pp > 1), its slice and cross groups (under dcn > 1). A mesh made by
    hand with the first four fields is a plain data-parallel mesh."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    tp: int = 1
    dcn: int = 1
    sp: bool = False
    tp_group: Any = None
    data_group: Any = None
    pp: int = 1
    pp_group: Any = None
    slice_group: Any = None
    cross_group: Any = None

    @property
    def model(self) -> int:
        """The ranks that hold one copy of the model: tp · pp."""
        return self.tp * self.pp

    @property
    def dp(self) -> int:
        return self.world_size // (self.model * self.dcn)

    @property
    def dcn_idx(self) -> int:
        return self.rank // (self.model * self.dp)

    @property
    def dp_idx(self) -> int:
        return (self.rank // self.model) % self.dp

    @property
    def pp_idx(self) -> int:
        return (self.rank // self.tp) % self.pp

    @property
    def tp_idx(self) -> int:
        return self.rank % self.tp

    @property
    def data(self) -> "Mesh":
        """The data-parallel view: this rank's place in its data group
        (rank // (tp·pp) of world // (tp·pp)); the mesh itself at tp = pp =
        1."""
        if self.model == 1:
            return self
        return Mesh(self.rank // self.model, self.world_size // self.model, self.device, self.data_group,
                    dcn=self.dcn, slice_group=self.slice_group, cross_group=self.cross_group)

    @property
    def tensor(self) -> "Mesh":
        """The tensor-parallel view: this rank's place in its tp group
        (tp_idx of tp), carrying `sp`."""
        return Mesh(self.tp_idx, self.tp, self.device, self.tp_group, sp=self.sp)

    @property
    def pipe(self) -> "Mesh":
        """The pipeline view: this rank's place in its pp group (its stage,
        pp_idx of pp)."""
        return Mesh(self.pp_idx, self.pp, self.device, self.pp_group)

    @property
    def slice(self) -> "Mesh":
        """The data ranks of this rank's slice (dp_idx of dp); the data view
        at dcn = 1."""
        if self.dcn == 1:
            return self.data
        return Mesh(self.dp_idx, self.dp, self.device, self.slice_group)

    @property
    def cross(self) -> Optional["Mesh"]:
        """The ranks of this rank's dp_idx (and tp_idx, pp_idx) in every
        slice (dcn_idx of dcn); None at dcn = 1."""
        if self.dcn == 1:
            return None
        return Mesh(self.dcn_idx, self.dcn, self.device, self.cross_group)

    def global_rank(self, rank: int) -> int:
        """The job's rank of rank `rank` of this view's group: a view's
        members are its group's ranks in order (`_axis_groups`); the whole
        job's view is the identity."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    if _CLUSTER is not None:
        return _CLUSTER.local_rank
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(device="cuda") -> Optional[ClusterSpec]:
    """Multi-process rendezvous. No-op when single-process or already
    initialised (returns what it found then, or None).

    The cluster adapter decides (`parallel.cluster.detect_cluster`:
    torchrun, OpenMPI, SLURM), so a `torchrun` / `mpirun` / `srun` launch
    needs no extra flags. The backend follows `device`: NCCL on the card
    (the process's GPU is `cuda:LOCAL_RANK`, made current before the group
    starts), gloo for "cpu". An NCCL group is warmed up by one all-reduce here, so a
    communicator that cannot start raises now; with more than one rank a
    gloo group for host-side objects joins it (`collectives.host_group`)."""
    global _CLUSTER
    if dist.is_initialized():
        return _CLUSTER
    backend = backend_for(device)
    spec = detect_cluster()
    if not (spec.source == "torchrun" or spec.is_distributed):
        return None
    if backend == "nccl":
        from clip_event_tpu_torch.platform import resolve_device

        resolve_device("cuda")
        torch.cuda.set_device(spec.local_rank)
    initialize_from_cluster(backend, spec)
    _CLUSTER = spec
    if backend == "nccl":
        warm = torch.zeros(1, device=torch.device("cuda", spec.local_rank))
        dist.all_reduce(warm)
        torch.cuda.synchronize()
    if dist.get_world_size() > 1:
        collectives.host_group()
    log.info("distributed: rank %d of %d, backend %s", dist.get_rank(), dist.get_world_size(), backend)
    return spec


def _axis_groups(world: int, tp: int, dcn: int, pp: int = 1):
    """Every subgroup's ranks, in one fixed order: under tp > 1 the tp
    groups (one a (dcn_idx, dp_idx, pp_idx)), under pp > 1 the pp groups
    (one a (dcn_idx, dp_idx, tp_idx)), under either the data groups (one a
    (pp_idx, tp_idx)); under dcn > 1 the slice groups (one a (dcn_idx,
    pp_idx, tp_idx)) and the cross groups (one a (dp_idx, pp_idx,
    tp_idx))."""
    dp = world // (tp * pp * dcn)

    def rank(c, d, p, t):
        return ((c * dp + d) * pp + p) * tp + t

    cs, ds, ps, ts = range(dcn), range(dp), range(pp), range(tp)
    out = {}
    if tp > 1:
        out["tp_group"] = [[rank(c, d, p, t) for t in ts] for c in cs for d in ds for p in ps]
    if pp > 1:
        out["pp_group"] = [[rank(c, d, p, t) for p in ps] for c in cs for d in ds for t in ts]
    if tp * pp > 1:
        out["data_group"] = [[rank(c, d, p, t) for c in cs for d in ds] for p in ps for t in ts]
    if dcn > 1:
        out["slice_group"] = [[rank(c, d, p, t) for d in ds] for c in cs for p in ps for t in ts]
        out["cross_group"] = [[rank(c, d, p, t) for c in cs] for d in ds for p in ps for t in ts]
    return out


def make_mesh(device=None, tp: int = 1, dcn: int = 1, sp: bool = False, pp: int = 1) -> Mesh:
    """This process's mesh. `device` None or "cuda" means `cuda:LOCAL_RANK`
    on an NCCL group; "cpu" needs a gloo group (or no group: a world of
    one). A device whose type does not match the group's backend raises: a
    CUDA run never goes over gloo. `tp` and `dcn` (the config's `tp` and
    `dcn_dp`), or `pp`, must divide the world together; dp is what is
    left. pp takes neither tp nor dcn (the JAX package's config rules).
    Every rank makes every subgroup, in one fixed order (`_axis_groups`):
    `new_group` is collective over the whole job; on NCCL each of the
    rank's subgroups is then warmed up by one all-reduce, so its first
    point-to-point call (the pipeline's) is not its communicator's start."""
    if dist.is_initialized():
        rank, world, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    tp, dcn, pp = int(tp), int(dcn), int(pp)
    if pp < 1 or (pp > 1 and (tp > 1 or dcn > 1)):
        raise ValueError(f"pp={pp} with tp={tp} / dcn_dp={dcn}: pp takes neither (and must be >= 1)")
    if pp > 1 and world % pp:
        raise ValueError(f"pp={pp} does not divide device count {world}")
    if tp < 1 or dcn < 1 or world % (dcn * tp):
        raise ValueError(f"dcn_dp={dcn} x tp={tp} does not divide device count {world}")
    if sp and tp <= 1:
        raise ValueError("sequence parallelism requires a 'tp' mesh axis of size > 1")
    if device is None:
        device = "cpu" if backend == "gloo" else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    if backend is not None and backend != backend_for(device):
        raise RuntimeError(f"a {device.type} mesh over a {backend} process group")
    groups = {}
    for name, members in _axis_groups(world, tp, dcn, pp).items():
        for ranks in members:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    if backend == "nccl":
        for group in groups.values():
            dist.all_reduce(torch.zeros(1, device=device), group=group)
    return Mesh(rank, world, device, tp=tp, dcn=dcn, sp=bool(sp), pp=pp, **groups)


def data_size(mesh: Mesh) -> int:
    """Total data-parallel degree: dcn · dp."""
    return mesh.world_size // mesh.model


def data_process_group(model_degree: int = 1, pp: int = 1) -> Tuple[int, int]:
    """(data_rank, data_world) for the batch loader of this process: the
    ranks of one model copy (`model_degree` · `pp` consecutive processes,
    one device each: a tp group, or a pp group) load the same rows, so the
    loader's rank collapses to the group, rank // (tp·pp) (JAX
    `mesh.py:126-148` at one device a process, and `train.py:124-126`)."""
    g = max(1, int(model_degree)) * max(1, int(pp))
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if world % g:
        raise ValueError(
            f"model degree {g} over 1-device processes needs process groups of {g}, "
            f"which does not divide process_count={world}")
    return rank // g, world // g


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's batch on its device. The loader already holds only the
    rank's rows (its rank-strided plan and the rank-offset label layout of
    `data/labels.py`), so every field moves as it is; `index_pos`, the
    global positive-row table, is whole on every rank."""
    return {k: torch.as_tensor(np.asarray(v)).to(mesh.device) for k, v in batch.items()}


def replicate(tree, mesh: Mesh):
    """Give every rank rank 0's values of a tree of tensors (params,
    optimizer state), in place: one broadcast per dtype over a flat
    buffer. A world of one returns the tree as it is."""
    if mesh.world_size <= 1:
        return tree
    from clip_event_tpu_torch.engine.optim import tree_leaves

    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in leaves}, key=str):
            group = [t for t in leaves if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0, group=mesh.group)
            for t, v in zip(group, torch.split(flat, [t.numel() for t in group])):
                t.copy_(v.view_as(t))
    return tree
