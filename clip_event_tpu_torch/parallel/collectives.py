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
  * `gather_shards` — FSDP's gather (`parallel/sharding.py`): param
    shards → the full params, all-gathered; its backward reduce-scatters
    the cotangents, so a shard's gradient is the sum over the ranks of its
    chunk;
  * `all_reduce_flat` — sum a list of tensors across ranks, one all-reduce
    a dtype over a flat buffer (the step's gradients and local loss sums);
  * `reduce_scatter_flat` / `all_gather_flat` — the same discipline for
    the sharded state of ZeRO-1 and FSDP (`parallel/sharding.py`): one
    reduce-scatter, or one all-gather, a dtype over a flat buffer.

The step passes the data view of its mesh (`mesh.data`) to these: a tp
group holds the same rows, so a gather over the whole job would count
each row tp times.

Megatron's operators over the tp group (`mesh.tensor`), for the
tensor-parallel blocks of `models/layers.py` (Shoeybi et al. 2019;
sequence parallelism, Korthikanti et al. 2022):

  * `tp_copy` (f) — identity forward, all-reduce backward: before a
    column-parallel product;
  * `tp_sum` (g) — all-reduce forward, identity backward: after a
    row-parallel product;
  * `sp_gather` — all-gather over the sequence forward, reduce-scatter
    backward: before a column-parallel product under sequence
    parallelism;
  * `sp_reduce_scatter` — reduce-scatter over the sequence forward,
    all-gather backward: after a row-parallel product under sequence
    parallelism;
  * `sp_scatter` / `sp_unscatter` — take this rank's sequence chunk
    forward and all-gather backward / all-gather forward and take the
    chunk backward: the entry and the exit of a sequence-parallel stack,
    where every rank holds the whole stream and its whole cotangent.

The pipeline's operators over the pp group (`mesh.pipe`), for
`parallel/pipeline.py`'s GPipe schedule (no gradient: the schedule's
backward is written out by hand):

  * `pipe_exchange` — one tick's point-to-point traffic of a stage: the
    activation block it sends to the next stage (or the cotangent it
    sends back to the one before) and the block it receives, posted
    together in one `dist.batch_isend_irecv` and waited on;
  * `pipe_broadcast` — a tensor of one stage on every stage: the last
    stage's output (JAX's `psum` over 'pp' of the output, which every
    other stage adds as zeros, `pipeline.py:193-195`), and stage 0's
    cotangent of the stack's input (the transpose of the input every
    stage holds).

`all_gather_into_tensor` and `reduce_scatter_tensor` are the names that
every torch this port runs on has; torch 2.13 renames them (`*_single`)
and warns on the old names, a notice that this module filters by its exact
text (a failed collective still raises).

`torch.distributed.nn.functional.all_gather` is not used: its backward
sums every rank's cotangent, which under DDP's gradient averaging gives
each loss term a different factor of the world size.
"""

from __future__ import annotations

import pickle
import warnings
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

# the gloo group beside an NCCL default group: (the default group it
# belongs to, the group)
_HOST_GROUP = (None, None)

warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|reduce_scatter_tensor)` is deprecated",
)


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
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
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


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, specs, mesh, *shards):
        ctx.specs, ctx.mesh = specs, mesh
        rows = all_gather_flat(shards, mesh)
        return tuple(s.from_rows(r) for s, r in zip(specs, rows))

    @staticmethod
    def backward(ctx, *grads):
        out = reduce_scatter_flat([s.to_rows(g) for s, g in zip(ctx.specs, grads)], ctx.mesh)
        return (None, None, *(o.reshape(s.shard_shape) for s, o in zip(ctx.specs, out)))


def gather_shards(shards: Sequence[torch.Tensor], specs, mesh) -> List[torch.Tensor]:
    """The full leaves of this rank's `shards` (each in its
    `sharding.LeafSpec`'s layout: `from_rows` / `to_rows`),
    differentiable: the forward all-gathers the ranks' shards, the
    backward reduce-scatters the cotangents, one collective a dtype each
    way (module docstring)."""
    return list(_GatherShards.apply(tuple(specs), mesh, *shards))


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The sums of `tensors` over the ranks: one all-reduce a dtype over a
    flat buffer; the results are views of that buffer, shaped like the
    inputs, in the same order."""
    out: List[torch.Tensor] = [None] * len(tensors)
    for _, idx in _by_dtype(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        for i, v in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = v.view_as(tensors[i])
    return out


# ------------------------------------------------------------ Megatron tp


def _all_reduce(x: torch.Tensor, tp) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=tp.group)
    return out


def _seq_all_gather(x: torch.Tensor, tp) -> torch.Tensor:
    """[B, s, ...] on every rank → [B, tp·s, ...], rank-major on dim 1."""
    parts = x.new_empty(tp.world_size * x.numel())
    dist.all_gather_into_tensor(parts, x.contiguous().reshape(-1), group=tp.group)
    parts = parts.view((tp.world_size,) + tuple(x.shape))
    return parts.transpose(0, 1).reshape((x.shape[0], tp.world_size * x.shape[1]) + tuple(x.shape[2:]))


def _seq_reduce_scatter(x: torch.Tensor, tp) -> torch.Tensor:
    """[B, tp·s, ...] partial sums on every rank → this rank's [B, s, ...]
    chunk of their sum over the ranks."""
    s = x.shape[1] // tp.world_size
    rows = x.reshape((x.shape[0], tp.world_size, s) + tuple(x.shape[2:])).transpose(0, 1).contiguous()
    out = x.new_empty((x.shape[0], s) + tuple(x.shape[2:]))
    dist.reduce_scatter_tensor(out.view(-1), rows.view(-1), group=tp.group)
    return out


def _seq_chunk(x: torch.Tensor, tp) -> torch.Tensor:
    s = x.shape[1] // tp.world_size
    return x[:, tp.rank * s:(tp.rank + 1) * s].contiguous()


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp), None


class _TPSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _seq_all_gather(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _seq_reduce_scatter(grad, ctx.tp), None


class _SPReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _seq_reduce_scatter(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _seq_all_gather(grad, ctx.tp), None


class _SPScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _seq_chunk(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _seq_all_gather(grad, ctx.tp), None


class _SPUnscatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _seq_all_gather(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _seq_chunk(grad, ctx.tp), None


def tp_copy(x: torch.Tensor, tp) -> torch.Tensor:
    """Megatron's f over the tp group `tp` (`mesh.tensor`)."""
    return _TPCopy.apply(x, tp)


def tp_sum(x: torch.Tensor, tp) -> torch.Tensor:
    """Megatron's g: the sum over the tp group, identity backward."""
    return _TPSum.apply(x, tp)


def sp_gather(x: torch.Tensor, tp) -> torch.Tensor:
    """[B, s, W] sequence chunks → [B, tp·s, W]; the backward
    reduce-scatters the cotangents (each rank's is partial)."""
    return _SPGather.apply(x, tp)


def sp_reduce_scatter(x: torch.Tensor, tp) -> torch.Tensor:
    """[B, tp·s, W] partial sums → this rank's [B, s, W] chunk of the sum;
    the backward all-gathers."""
    return _SPReduceScatter.apply(x, tp)


def sp_scatter(x: torch.Tensor, tp) -> torch.Tensor:
    """[B, tp·s, W], whole on every rank → this rank's [B, s, W] chunk; the
    backward all-gathers the chunks' cotangents."""
    return _SPScatter.apply(x, tp)


def sp_unscatter(x: torch.Tensor, tp) -> torch.Tensor:
    """[B, s, W] chunks → [B, tp·s, W] whole on every rank; the backward
    keeps this rank's chunk of the (whole) cotangent."""
    return _SPUnscatter.apply(x, tp)


# ------------------------------------------------------------ pipeline


def pipe_exchange(sends: Sequence, recvs: Sequence, pipe) -> List[torch.Tensor]:
    """One tick of a pipeline stage over the pp group `pipe` (`Mesh.pipe`):
    `sends` are (stage, tensor) pairs, `recvs` (stage, buffer) pairs; the
    sends and receives are posted together in one `dist.batch_isend_irecv`
    and all waited on. Returns the filled buffers, in order."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), pipe.global_rank(s), pipe.group) for s, t in sends]
    ops += [dist.P2POp(dist.irecv, b, pipe.global_rank(s), pipe.group) for s, b in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b for _, b in recvs]


def pipe_broadcast(x: torch.Tensor, stage: int, pipe) -> torch.Tensor:
    """Stage `stage`'s `x` on every stage of the pp group `pipe` (in place
    in `x`, which every stage passes with the same shape)."""
    dist.broadcast(x, src=pipe.global_rank(stage), group=pipe.group)
    return x


def _by_dtype(tensors: Sequence[torch.Tensor]):
    """(dtype, indices of `tensors` of that dtype), in a fixed dtype order
    (every rank must issue the collectives alike)."""
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        yield dtype, [i for i, t in enumerate(tensors) if t.dtype == dtype]


def reduce_scatter_flat(rows: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """This rank's sums over the ranks of `rows`, each [W, k] whose row r is
    what rank r receives: one reduce-scatter a dtype over the rows laid
    side by side ([W, K], rank-major when flat). Returns [k] tensors, views
    of the received buffer, in the order of `rows`."""
    out: List[torch.Tensor] = [None] * len(rows)
    for _, idx in _by_dtype(rows):
        # one tensor: no copy where it is contiguous
        flat = rows[idx[0]].contiguous() if len(idx) == 1 else torch.cat([rows[i] for i in idx], dim=1)
        recv = flat.new_empty(flat.shape[1])
        dist.reduce_scatter_tensor(recv, flat.reshape(-1), group=mesh.group)
        for i, v in zip(idx, torch.split(recv, [rows[i].shape[1] for i in idx])):
            out[i] = v
    return out


def all_gather_flat(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Every rank's `tensors`: one all-gather a dtype over a flat buffer.
    Returns a [W, numel] tensor for each input (row r: rank r's elements),
    views of the gathered buffer, in the order of `tensors`."""
    out: List[torch.Tensor] = [None] * len(tensors)
    for _, idx in _by_dtype(tensors):
        # one tensor: no copy where it is contiguous
        flat = (tensors[idx[0]].contiguous().reshape(-1) if len(idx) == 1
                else torch.cat([tensors[i].reshape(-1) for i in idx]))
        recv = flat.new_empty(mesh.world_size * flat.numel())
        dist.all_gather_into_tensor(recv, flat, group=mesh.group)
        recv = recv.view(mesh.world_size, flat.numel())
        for i, v in zip(idx, torch.split(recv, [tensors[i].numel() for i in idx], dim=1)):
            out[i] = v
    return out
