"""The data-parallel mesh of the port (counterpart of
`clip_event_tpu/parallel/mesh.py`; reference DDP/NCCL stack,
`utils.py:541-616`, `train.py:222-225`).

Parallelism model: one process per GPU, each holding a full copy of the
params and optimizer state (or its shard of them under ZeRO-1 / FSDP,
`parallel/sharding.py`) and `batch_size` rows of the global batch (its
rank-major block, the row order JAX's `make_array_from_process_local_data`
gives). The JAX package gets the global loss from GSPMD; here the train
step makes it by hand (`engine/train_step.py`): the contrastive features
are all-gathered (`collectives.gather_features`), the local loss sums stay
local, and the gradients are summed across ranks in one all-reduce inside
the step. The collectives run over NCCL on the card and over gloo only
when the caller asked for the CPU; NCCL failing on a CUDA run is an error.

`initialize_distributed()` first (torchrun, OpenMPI or SLURM, through
`parallel.cluster`), then `make_mesh(device)`: the rank, the world, the
device (`cuda:LOCAL_RANK`) and the process group.
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
    """One process's place in the data-parallel job: its `rank` of
    `world_size`, its `device`, and the process group of the step's
    collectives (`group`, None: the default group)."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None


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


def make_mesh(device=None) -> Mesh:
    """This process's data-parallel mesh. `device` None or "cuda" means
    `cuda:LOCAL_RANK` on an NCCL group; "cpu" needs a gloo group (or no
    group: a world of one). A device whose type does not match the group's
    backend raises: a CUDA run never goes over gloo."""
    if dist.is_initialized():
        rank, world, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    if device is None:
        device = "cpu" if backend == "gloo" else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    if backend is not None and backend != backend_for(device):
        raise RuntimeError(f"a {device.type} mesh over a {backend} process group")
    return Mesh(rank, world, device)


def data_size(mesh: Mesh) -> int:
    """Total data-parallel degree."""
    return mesh.world_size


def data_process_group(model_degree: int = 1) -> Tuple[int, int]:
    """(data_rank, data_world) for the batch loader of this process: the
    process's rank and the world while tensor and pipeline parallelism are
    not ported (ROADMAP A6(c))."""
    if int(model_degree) > 1:
        raise NotImplementedError("tp / pp process groups are not ported yet (ROADMAP A6(c))")
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


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
