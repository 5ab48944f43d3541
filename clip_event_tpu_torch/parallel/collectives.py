"""The port's collectives (counterpart of
`clip_event_tpu/parallel/collectives.py`; reference `utils.py:94-206,
459-512`).

Host side, over gloo (the default group of a CPU run; on the card a gloo
group beside the NCCL one, `host_group`), so that reading them never waits
for the card:

  * `comm` — world, rank, local rank, main process, barrier (the
    reference's `comm` singleton, `utils.py:459-512`);
  * `reduce_dict` — average or sum a dict of floats across processes
    (`utils.py:136`); `any_rank` — a flag true on any rank (the SIGTERM
    stop every rank agrees on);
  * `all_gather_objects` — gather picklable objects with the padded-pickle
    protocol (the reference's `all_gather`, `utils.py:94-134`, fixed).

Device side, over the mesh's group (NCCL on the card), differentiable, so
that the train step reproduces the JAX package's global loss:

  * `gather_features` — [b, ...] rank rows → [W·b, ...] global rows; its
    backward keeps only the rank's own slice of the cotangent. Every rank
    computes the whole global contrastive term from the gathered rows, so
    the cotangent of a rank's rows is complete on that rank, and the sum of
    the ranks' gradients counts the term once (JAX's tiled all_gather,
    whose VJP is psum_scatter, sums W partial cotangents instead: each of
    its ranks holds only its rows' share of the loss);
  * `replicated_term` — the same rule for a tensor every rank feeds into
    the global term whole (the logit scale): its gradient is kept on rank
    0 only;
  * `all_reduce_sum` — a sum across ranks whose backward sums the
    cotangents (the global BatchNorm statistics of `sync_bn`);
  * `all_reduce_flat` — sum a list of tensors across ranks, one all-reduce
    a dtype over a flat buffer (the step's gradients and local loss sums).

`torch.distributed.nn.functional.all_gather` is not used: its backward
sums every rank's cotangent, which under DDP's gradient averaging gives
each loss term a different factor of the world size.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

# the gloo group beside an NCCL default group: (the default group it
# belongs to, the group)
_HOST_GROUP = (None, None)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class _Comm:
    @property
    def world_size(self) -> int:
        return _world()

    @property
    def rank(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def local_rank(self) -> int:
        from clip_event_tpu_torch.parallel.mesh import local_rank

        return local_rank()

    @property
    def is_main_process(self) -> bool:
        return self.rank == 0

    def synchronize(self) -> None:
        """Cross-process barrier (reference `comm.synchronize`), on the host."""
        if _world() > 1:
            dist.barrier(group=host_group())


comm = _Comm()


def host_group():
    """The process group of host-side collectives: the default group when
    it is gloo, else a gloo group made on the first call, which every rank
    must make (`mesh.initialize_distributed` does, right after the NCCL
    group starts)."""
    global _HOST_GROUP
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if _HOST_GROUP[0] is not world:
        _HOST_GROUP = (world, dist.new_group(backend="gloo"))
    return _HOST_GROUP[1]


def reduce_dict(metrics: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Average (or sum) a dict of floats across processes."""
    if _world() <= 1:
        return dict(metrics)
    keys = sorted(metrics)
    values = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(values, group=host_group())
    if average:
        values /= _world()
    return dict(zip(keys, values.tolist()))


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (one all-reduce on the
    host; `flag` itself at a world of one)."""
    if _world() <= 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def all_gather_objects(obj) -> list:
    """Every process's picklable `obj`, in rank order: each pickles to a
    uint8 buffer, the sizes are all-gathered, then the payloads padded to
    the largest (the reference's padded-tensor protocol,
    `utils.py:110-127`)."""
    world = _world()
    if world <= 1:
        return [obj]
    group = host_group()
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([data.numel()], dtype=torch.int64), group=group)
    longest = int(max(s.item() for s in sizes))
    padded = torch.zeros(longest, dtype=torch.uint8)
    padded[: data.numel()] = data
    gathered = [torch.empty(longest, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(gathered, padded, group=group)
    return [pickle.loads(g[: int(s.item())].numpy().tobytes()) for g, s in zip(gathered, sizes)]


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """[b, ...] on every rank → [W·b, ...], rank-major (no gradient)."""
    out = x.new_empty((mesh.world_size * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=mesh.group)
    return out


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = (mesh.rank * x.shape[0], (mesh.rank + 1) * x.shape[0])
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None


def gather_features(features: torch.Tensor, mesh) -> torch.Tensor:
    """[b, E] rank rows → [W·b, E] global rows, differentiable; the backward
    keeps the rank's own slice of the cotangent (module docstring)."""
    return _GatherFeatures.apply(features, mesh)


class _ReplicatedTerm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank):
        ctx.rank = rank
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.rank == 0 else torch.zeros_like(grad)), None


def replicated_term(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` unchanged; its gradient is kept on rank 0 only (for a tensor
    that every rank feeds whole into a term every rank computes alike)."""
    return _ReplicatedTerm.apply(x, mesh.rank)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.group = mesh.group
        out = x.clone()
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable: the backward sums the
    ranks' cotangents (each rank's sum feeds that rank's loss)."""
    return _AllReduceSum.apply(x, mesh)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The sums of `tensors` over the ranks: one all-reduce a dtype over a
    flat buffer; the results are views of that buffer, shaped like the
    inputs, in the same order."""
    out: List[torch.Tensor] = [None] * len(tensors)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        for i, v in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = v.view_as(tensors[i])
    return out
