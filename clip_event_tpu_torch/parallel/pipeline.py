"""Pipeline parallelism over the transformer stacks, "pp" (counterpart of
`clip_event_tpu/parallel/pipeline.py`: GPipe over a 'pp' mesh axis).

The stacked [L, ...] layout of the towers makes the split natural: the pp
ranks of one pipeline (`Mesh.pipe`, consecutive ranks, `parallel/mesh.py`)
each hold L/pp contiguous layers of every stack whose L divides pp (stage
s: layers [s·L/pp, (s+1)·L/pp)), and every other leaf whole
(`stage_leaf`, JAX's `_is_stacked_transformer_leaf`); a stack whose L
does not divide pp stays whole on every rank and runs there as it is (JAX
`layers.py:505-519`). `PPLayout` is that split of a train state
(`shard_state_pp`), a `parallel.sharding.ModelLayout` as `TPLayout` is, so
ZeRO-1 and FSDP compose over it.

The schedule. The batch of a call (this rank's rows: the pp ranks of one
pipeline hold the same rows) is cut into M contiguous microbatches, M the
largest divisor of the rows not above `pp_microbatches`
(`_pick_microbatches`). The forward runs M + pp − 1 ticks: at tick t stage
s receives microbatch t − s from stage s − 1 (stage 0 takes it from the
input), runs its layers on it and sends its output of the tick before to
stage s + 1; one `dist.batch_isend_irecv` a tick carries a stage's send
and receive (`collectives.pipe_exchange`). A stage computes only its M
real microbatches: JAX's `lax.scan` runs every stage at every tick and
discards the bubble ticks' work, here they compute nothing. The last
stage's outputs are concatenated and broadcast to every stage
(`collectives.pipe_broadcast`, JAX's `psum` of the output that the other
stages hold as zeros), so every rank runs the rest of the model on the
same output. The forward keeps each stage's microbatch inputs, not its
activations.

The backward is the reverse schedule, written out: for each microbatch
in reverse order the last stage takes its slice of the output's
cotangent, and every other stage receives its dy from the stage after;
the stage recomputes its layers on the kept input under the stack's remat
policy with autograd on (so "full" recomputes each block once more inside,
and "attn" keeps each block's attention output for that microbatch), takes
`autograd.grad` for its input and its layers, and sends dx to the stage
before. Stage 0's dx, the cotangent of the input every stage holds, is
broadcast to every stage (the transpose of that replication). Autograd's
engine does not order this: with blocking point-to-point calls, two stages
walking their microbatches in different orders would wait on each other
for ever. The output's cotangent enters the pipeline once (the last
stage's), so the stage layers' gradients count it once; and since every
rank gets the same dx, the leaves outside the stacks (embeddings,
projections, `ln_final`, the logit scale, a ResNet tower) get the same
gradient on every pp rank, and the train step sums them over the data
group only (`engine/train_step.py`). The parameters' gradients are summed
over the microbatches, another order than one batch's: agreement within
1e-5, not equal bits. Two pipelined calls of one step (the OT and
multiattention steps encode twice) run one after the other, each through
its whole schedule, in the same order on every rank.

The stage function (`layers.run_stack` on a stage's layers) and the tick
schedule (`forward_ticks`, `backward_ticks`) are apart from the transport:
`pipelined_transformer` runs one stage a rank over the pp group,
`run_in_process` every stage in one process in tick order (a plain
function of its inputs: the tests hold it against the JAX package, and
`chip_smoke.py` runs the stages on one card with it; training never does).
"""

from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence

import torch

from clip_event_tpu_torch.engine.optim import tree_leaves, tree_unflatten
from clip_event_tpu_torch.parallel import collectives
from clip_event_tpu_torch.parallel.sharding import (
    STACKED_KEYS,
    ModelLayout,
    ShardedParam,
    _param_trees,
    tree_bytes,
)

log = logging.getLogger(__name__)

PIPE_AXIS = "pp"


def stage_leaf(path: Sequence, leaf, pp: int) -> bool:
    """Whether a param leaf is split into pipeline stages (JAX
    `_is_stacked_transformer_leaf`, `pipeline.py:56-61`): a leaf under
    `transformer` or `text_transformer` whose leading L divides pp."""
    if not any(k in STACKED_KEYS for k in path):
        return False
    shape = tuple(leaf.shape)
    return bool(shape) and shape[0] % pp == 0


def stage_leaves(params: dict, pp: int) -> List[bool]:
    """`stage_leaf` for every leaf of `params`, in `optim.tree_leaves`
    order (False everywhere at pp = 1)."""
    out = []

    def walk(tree, path):
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            if isinstance(v, (dict, list)):
                walk(v, path + (k,))
            else:
                out.append(pp > 1 and stage_leaf(path + (k,), v, pp))

    walk(params, ())
    return out


def _pick_microbatches(batch: int, requested: int) -> int:
    """Largest divisor of `batch` ≤ requested (JAX `pipeline.py:83`)."""
    m = max(1, min(requested, batch))
    while batch % m:
        m -= 1
    return m


@dataclasses.dataclass(frozen=True)
class PPSpec:
    """How one leaf splits over the pp ranks: `kind` "stage" (L/pp
    contiguous layers a stage) or None (whole on every rank)."""

    kind: Optional[str] = None
    partial: bool = False

    def shard_of(self, x: torch.Tensor, pp: int, rank: int) -> torch.Tensor:
        """Stage `rank`'s layers of a full leaf (a copy; a whole leaf as it
        is)."""
        if self.kind is None:
            return x
        return x.chunk(pp, dim=0)[rank].clone()

    def from_shards(self, shards: torch.Tensor) -> torch.Tensor:
        """[pp, L/pp, ...] (every stage's layers) → the full [L, ...] leaf."""
        return shards.reshape((-1,) + tuple(shards.shape[2:]))


class PPLayout(ModelLayout):
    """The pipeline sharding of one train state (mode "pp"): the mesh (its
    `pipe` view is the pp group) and a `PPSpec` a param leaf."""

    mode = "pp"

    def __init__(self, params: dict, mesh):
        self.mesh = mesh
        self.specs = [PPSpec("stage" if s else None) for s in stage_leaves(params, mesh.pp)]

    @property
    def view(self):
        return self.mesh.pipe


def shard_state_pp(state, mesh):
    """A full train state (the same on every rank) → this rank's pipeline
    stage of it, which carries its layout (`state.sharding`): the params
    (each stage slice a new leaf that requires grad) and every moment tree
    split alike."""
    if state.sharding is not None:
        raise ValueError("the state is sharded already")
    if mesh.pp <= 1:
        raise ValueError("a pipeline state needs a mesh with pp > 1")
    layout = PPLayout(state.params, mesh)
    with torch.no_grad():
        params = tree_unflatten(state.params, [
            t.detach().requires_grad_(True) for t in layout.shard_leaves(tree_leaves(state.params))])
        opt_state = dict(state.opt_state)
        for k in _param_trees(opt_state):
            opt_state[k] = tree_unflatten(opt_state[k], layout.shard_leaves(tree_leaves(opt_state[k])))
    staged = sum(s.kind is not None for s in layout.specs)
    log.info("PP: %d of %d param leaves split into %d stages (stage %d); params %d bytes, optimizer %d bytes a rank",
             staged, len(layout.specs), mesh.pp, mesh.pp_idx, tree_bytes(params), tree_bytes(opt_state))
    return state._replace(params=params, opt_state=opt_state, sharding=layout)


# ------------------------------------------------------------ the schedule


def forward_ticks(stage: int, pp: int, M: int):
    """Stage `stage`'s M + pp − 1 forward ticks: (send, compute) microbatch
    indices a tick, None where there is none. At tick t the stage sends its
    output of microbatch t − 1 − stage to the next stage and receives and
    computes microbatch t − stage; the bubble ticks compute nothing."""
    for t in range(M + pp - 1):
        send = t - 1 - stage
        m = t - stage
        yield (send if stage < pp - 1 and 0 <= send < M else None), (m if 0 <= m < M else None)


def backward_ticks(stage: int, pp: int, M: int):
    """The reverse schedule: stage `stage` walks the ticks of stage pp − 1 −
    stage over the microbatches in reverse order (M − 1 first), sending dx
    to the stage before and receiving dy from the stage after."""
    for send, m in forward_ticks(pp - 1 - stage, pp, M):
        yield (None if send is None else M - 1 - send), (None if m is None else M - 1 - m)


class _RankTransport:
    """One stage a rank, over the pp group (`Mesh.pipe`)."""

    def __init__(self, pipe):
        self.pipe = pipe

    def exchange(self, stage, sends, recvs):
        return collectives.pipe_exchange(sends, recvs, self.pipe)

    def share(self, x, stage):
        return collectives.pipe_broadcast(x, stage, self.pipe)


class _LocalTransport:
    """Every stage in this process: a mailbox a (source, destination) pair,
    read in the order it was written."""

    def __init__(self):
        self.boxes = defaultdict(deque)

    def exchange(self, stage, sends, recvs):
        for dst, t in sends:
            self.boxes[(stage, dst)].append(t)
        return [self.boxes[(src, stage)].popleft() for src, _ in recvs]

    def share(self, x, stage):
        return x


def _tensor(p) -> torch.Tensor:
    """The tensor a leaf is held as (an FSDP `ShardedParam`'s shard)."""
    return p.shard if isinstance(p, ShardedParam) else p


def _like(p, t: torch.Tensor):
    """Leaf `p` held as `t` (an FSDP `ShardedParam` around the new shard)."""
    return ShardedParam(t, p.spec, p.mesh) if isinstance(p, ShardedParam) else t


@dataclasses.dataclass
class _Run:
    """One pipelined call: the stages this process runs ({stage: its
    stacked params}), the transport, pp, M and the stack's settings."""

    stages: Dict[int, dict]
    transport: object
    pp: int
    M: int
    num_heads: int
    attn_bias: Optional[torch.Tensor]
    remat: object
    impl: str
    ln: str

    def _stage(self, h, tree):
        from clip_event_tpu_torch.models import layers

        return layers.run_stack(h, tree, self.num_heads, self.attn_bias, self.impl, self.remat, self.ln)

    def forward(self, x: torch.Tensor):
        """(the stack's output on every stage, the stages' microbatch
        inputs)."""
        pp, M = self.pp, self.M
        xs = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:])).unbind(0)
        inputs = {s: [None] * M for s in self.stages}
        outs = {s: [None] * M for s in self.stages}
        plans = {s: list(forward_ticks(s, pp, M)) for s in self.stages}
        for t in range(M + pp - 1):
            for s in sorted(self.stages):
                send, m = plans[s][t]
                sends = [] if send is None else [(s + 1, outs[s][send])]
                recvs = [] if m is None or s == 0 else [(s - 1, torch.empty_like(xs[0]))]
                got = self.transport.exchange(s, sends, recvs)
                if send is not None:
                    outs[s][send] = None
                if m is not None:
                    h = xs[m] if s == 0 else got[0]
                    inputs[s][m] = h
                    outs[s][m] = self._stage(h, self.stages[s])
        last = pp - 1
        out = torch.cat(outs[last]) if last in self.stages else torch.empty_like(x)
        return self.transport.share(out, last), inputs

    def backward(self, dy: torch.Tensor, inputs, needs: Sequence[bool]):
        """(dx on every stage, the gradients of the stages' leaves in
        `tree_leaves` order, stage after stage; None where not needed)."""
        pp, M = self.pp, self.M
        dys = dy.reshape((M, dy.shape[0] // M) + tuple(dy.shape[1:])).unbind(0)
        dxs = {s: [None] * M for s in self.stages}
        grads = {}
        wanted = iter(needs)
        for s in sorted(self.stages):
            leaves = tree_leaves(self.stages[s])
            grads[s] = [None if not next(wanted) else torch.zeros_like(_tensor(p)) for p in leaves]
        plans = {s: list(backward_ticks(s, pp, M)) for s in self.stages}
        for t in range(M + pp - 1):
            for s in sorted(self.stages, reverse=True):
                send, m = plans[s][t]
                sends = [] if send is None else [(s - 1, dxs[s][send])]
                recvs = [] if m is None or s == pp - 1 else [(s + 1, torch.empty_like(dys[0]))]
                got = self.transport.exchange(s, sends, recvs)
                if send is not None:
                    dxs[s][send] = None
                if m is None:
                    continue
                dxs[s][m] = self._stage_vjp(s, inputs[s][m], dys[m] if s == pp - 1 else got[0], grads[s])
                inputs[s][m] = None
        dx = torch.cat(dxs[0]) if 0 in self.stages else torch.empty_like(dy)
        return self.transport.share(dx, 0), [g for s in sorted(self.stages) for g in grads[s]]

    def _stage_vjp(self, s, h, dy, grads) -> torch.Tensor:
        """Stage `s`'s layers recomputed on input `h` under the remat
        policy, with autograd on; their vector-Jacobian product with `dy`
        added into `grads` (the leaves' running sums); returns dx."""
        tree = self.stages[s]
        leaves = tree_leaves(tree)
        held = [_tensor(p).detach().requires_grad_(g is not None) for p, g in zip(leaves, grads)]
        with torch.enable_grad():
            h = h.detach().requires_grad_(True)
            y = self._stage(h, tree_unflatten(tree, [_like(p, t) for p, t in zip(leaves, held)]))
        wanted = [h] + [t for t, g in zip(held, grads) if g is not None]
        out = torch.autograd.grad(y, wanted, dy, allow_unused=True)
        it = iter(out[1:])
        for g in grads:
            if g is not None:
                d = next(it)
                if d is not None:
                    g.add_(d)
        return out[0]


class _Pipelined(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, run, *leaves):
        ctx.run = run
        out, ctx.inputs = run.forward(x)
        return out

    @staticmethod
    def backward(ctx, dy):
        dx, grads = ctx.run.backward(dy.contiguous(), ctx.inputs, ctx.needs_input_grad[2:])
        ctx.inputs = None
        return (dx, None, *grads)


def _call(x, run: _Run) -> torch.Tensor:
    leaves = [_tensor(p) for s in sorted(run.stages) for p in tree_leaves(run.stages[s])]
    return _Pipelined.apply(x, run, *leaves)


def pipelined_transformer(x: torch.Tensor, stacked_params: dict, num_heads: int,
                          attn_bias: Optional[torch.Tensor], pipe, microbatches: int = 4, remat=False,
                          impl: str = "kernel", ln: str = "xla") -> torch.Tensor:
    """GPipe over the pp group `pipe` (`Mesh.pipe`; its rank is this rank's
    stage): `stacked_params` are the stage's layers of a stack, x [B, S, W]
    the rank's rows, the same on every stage; returns the stack's output,
    the same on every stage (module docstring). `layers.transformer` calls
    it for a stage's slice under `set_pipeline`."""
    M = _pick_microbatches(x.shape[0], microbatches)
    run = _Run({pipe.rank: stacked_params}, _RankTransport(pipe), pipe.world_size, M, num_heads,
               attn_bias, remat, impl, ln)
    return _call(x, run)


def run_in_process(x: torch.Tensor, stages: Sequence[dict], num_heads: int,
                   attn_bias: Optional[torch.Tensor] = None, microbatches: int = 4, remat=False,
                   impl: Optional[str] = None, ln: Optional[str] = None) -> torch.Tensor:
    """Every stage of a pipeline in this process, in tick order, forward
    and backward (the schedule of `pipelined_transformer`, the transport a
    mailbox): `stages` are the stages' stacked params (`PPLayout`'s
    slices, stage 0 first); differentiable in x and every stage's leaves.
    `impl` and `ln` None take the process-wide choices, as `transformer`
    does."""
    from clip_event_tpu_torch.models import layers

    impl = layers._resolve_attention(impl)
    ln = layers._resolve_ln() if ln is None else ln
    layers.remat_policy(remat)
    M = _pick_microbatches(x.shape[0], microbatches)
    run = _Run(dict(enumerate(stages)), _LocalTransport(), len(stages), M, num_heads, attn_bias,
               remat, impl, ln)
    return _call(x, run)
