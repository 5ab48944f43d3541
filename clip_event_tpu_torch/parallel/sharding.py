"""ZeRO-1 and FSDP of the port: the optimizer state, and with FSDP the
params too, sharded over the data-parallel ranks (counterpart of the
ZeRO/FSDP half of `clip_event_tpu/parallel/sharding.py`:
`zero_opt_shardings` / `shard_opt_state_zero`, `fsdp_param_shardings` /
`shard_params_fsdp`; its tensor-parallel half waits for ROADMAP A6(c)).

Layout. A leaf's elements are flattened and split into W (the world size)
chunks of c = ceil(n / W), the last padded with zeros; rank r keeps chunk
r. A stacked transformer leaf ([L, ...], under `transformer` or
`text_transformer`) is split layer by layer, so its shard is [L, c] and
FSDP gathers one layer at a time. A 0-d leaf (`logit_scale`) stays whole
on every rank. The JAX package's rule (`_dp_leaf_sharding`: the data axis
on a leaf's largest divisible dim, leaves under 1024 elements replicated)
is a GSPMD layout whose numbers do not depend on it; this one puts every
collective of a step on one flat buffer a dtype. The full leaves, laid out
as [W, S] rows (row r: rank r's chunk of every leaf, a whole leaf in every
row), reduce-scatter into each rank's summed shards, and the shards
all-gather back into the full leaves (`collectives.reduce_scatter_flat`,
`all_gather_flat`): the bytes of the unsharded step's one all-reduce.

ZeRO-1 ("zero"): the params stay whole on every rank; Adam's moments
(SGD's trace) are shards. The step reduce-scatters the gradients, updates
this rank's shards of the params and moments, and all-gathers the new
params into the whole tensors the forward reads (`engine/train_step.py`).

FSDP ("fsdp"): the params are shards too, and the moments with them. The
model reads a param through `full` at each use (`models/layers.py`,
`vit.py`, `clip.py`, `resnet.py`): a `ShardedParam` all-gathers in the
forward and reduce-scatters its cotangent in the backward
(`collectives.gather_shards`), so the gradients arrive summed over the
ranks, as shards. A transformer block's leaves are gathered together
(`full_tree`: one collective a block each way) inside its recomputed
region, so a block holds one block's full weights, gathered again in the
backward.

A world of one runs the same code with one shard: no padding, each
collective a copy, and the step bit for bit the unsharded one.
`shard_state` shards a full state (after init, or after a resume and
`mesh.replicate`); `gather_state` gives the full trees back, collectively
(the checkpoint holds them, so a run resumes at any world, sharded or
not).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from clip_event_tpu_torch.engine.optim import global_norm, tree_leaves, tree_unflatten
from clip_event_tpu_torch.parallel import collectives

log = logging.getLogger(__name__)

MODES = ("zero", "fsdp")
# the keys whose subtrees hold [L, ...] leaves stacked by layer
STACKED_KEYS = ("transformer", "text_transformer")


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """How one leaf splits over `world` ranks: its full `shape`, `rows`
    rows of `n` elements (L layers, or 1), each cut into chunks of `c`;
    `replicated`: kept whole on every rank (a 0-d leaf)."""

    shape: Tuple[int, ...]
    stacked: bool
    world: int
    replicated: bool = False

    @property
    def rows(self) -> int:
        return self.shape[0] if self.stacked else 1

    @property
    def n(self) -> int:
        return math.prod(self.shape) // self.rows

    @property
    def c(self) -> int:
        return self.n if self.replicated else -(-self.n // self.world)

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        if self.replicated:
            return self.shape
        return (self.rows, self.c) if self.stacked else (self.c,)

    def layer(self) -> "LeafSpec":
        """The spec of one layer of a stacked leaf."""
        return LeafSpec(self.shape[1:], False, self.world)

    def to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A full leaf → [W, k]: row r is rank r's shard, flat (a replicated
        leaf whole in every row)."""
        if self.replicated:
            return x.reshape(1, -1).expand(self.world, -1)
        r = x.reshape(self.rows, self.n)
        pad = self.world * self.c - self.n
        if pad:
            r = F.pad(r, (0, pad))
        r = r.reshape(self.rows, self.world, self.c).transpose(0, 1)
        return r.reshape(self.world, self.rows * self.c)

    def from_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """[W, k] rows (every rank's shard, flat) → the full leaf."""
        if self.replicated:
            return rows[0].reshape(self.shape)
        r = rows.reshape(self.world, self.rows, self.c).transpose(0, 1)
        return r.reshape(self.rows, self.world * self.c)[:, : self.n].reshape(self.shape)

    def shard_of(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank `rank`'s shard of a full leaf (a view where no copy is
        needed)."""
        if self.replicated:
            return x
        r = x.reshape(self.rows, self.n)
        lo, hi = min(rank * self.c, self.n), min((rank + 1) * self.c, self.n)
        r = r[:, lo:hi]
        if hi - lo < self.c:
            r = F.pad(r, (0, self.c - (hi - lo)))
        return r.reshape(self.shard_shape)


class ShardedParam:
    """One FSDP param as a rank holds it: its `shard` (a leaf of the train
    state, or one layer's row of it), the full leaf's `spec` and the mesh.
    `full(p)` gathers it; `p[i]` is layer i of a stacked param (what
    `layers._layer` slices); `shape` is the full shape."""

    __slots__ = ("shard", "spec", "mesh")

    def __init__(self, shard: torch.Tensor, spec: LeafSpec, mesh):
        self.shard, self.spec, self.mesh = shard, spec, mesh

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.spec.shape)

    def __getitem__(self, i: int) -> "ShardedParam":
        if not self.spec.stacked:
            raise TypeError("only a stacked param is sliced by layer")
        return ShardedParam(self.shard[i], self.spec.layer(), self.mesh)


def full(p):
    """A param as the model uses it: a tensor as it is, a `ShardedParam`
    gathered from the ranks (differentiable)."""
    if isinstance(p, ShardedParam):
        return collectives.gather_shards([p.shard], [p.spec], p.mesh)[0]
    return p


def full_tree(tree):
    """A tree of params as the model uses them: its `ShardedParam`s
    gathered in one collective a dtype (a transformer block's leaves at
    once), its tensors as they are."""
    leaves = tree_leaves(tree)
    sharded = [p for p in leaves if isinstance(p, ShardedParam)]
    if not sharded:
        return tree
    gathered = iter(collectives.gather_shards([p.shard for p in sharded], [p.spec for p in sharded],
                                              sharded[0].mesh))
    return tree_unflatten(tree, [next(gathered) if isinstance(p, ShardedParam) else p for p in leaves])


def _specs(tree, world: int, stacked: bool = False) -> List[LeafSpec]:
    """The leaves' specs in `optim.tree_leaves` order."""
    out = []
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        inner = stacked or k in STACKED_KEYS
        if isinstance(v, (dict, list)):
            out.extend(_specs(v, world, inner))
        else:
            out.append(LeafSpec(tuple(v.shape), inner, world, replicated=v.dim() == 0))
    return out


class ShardLayout:
    """The sharding of one train state: the `mode` ("zero" or "fsdp"), the
    mesh, and a `LeafSpec` a param leaf (in `optim.tree_leaves` order; every
    param-shaped tree of the optimizer state follows it)."""

    def __init__(self, params: dict, mesh, mode: str):
        if mode not in MODES:
            raise ValueError(f"sharding mode {mode!r}; options: {MODES}")
        self.mode, self.mesh = mode, mesh
        self.specs = _specs(params, mesh.world_size)

    def shard_leaves(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's shards of full leaves."""
        return [s.shard_of(x, self.mesh.rank) for s, x in zip(self.specs, leaves)]

    def gather_leaves(self, shards: Sequence[torch.Tensor], specs=None) -> List[torch.Tensor]:
        """The full leaves of every rank's shards (collective: one
        all-gather a dtype); `specs` default to one per param leaf."""
        specs = self.specs if specs is None else specs
        rows = collectives.all_gather_flat(list(shards), self.mesh)
        return [s.from_rows(r) for s, r in zip(specs, rows)]

    def reduce_scatter(self, grads: Sequence[torch.Tensor], extra: Sequence[torch.Tensor] = ()):
        """(this rank's shards of the gradients summed over the ranks, the
        sums of `extra`): the full gradients and the extra tensors (whole in
        every row) in one reduce-scatter a dtype."""
        world = self.mesh.world_size
        rows = [s.to_rows(g) for s, g in zip(self.specs, grads)]
        rows += [e.reshape(1, -1).expand(world, -1) for e in extra]
        out = collectives.reduce_scatter_flat(rows, self.mesh)
        n = len(self.specs)
        shards = [o.view(s.shard_shape) for s, o in zip(self.specs, out[:n])]
        return shards, [o.view_as(e) for o, e in zip(out[n:], extra)]

    def norm(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of a sharded gradient (`optim.global_norm` with
        each leaf's norm combined over the ranks)."""
        return global_norm(shards, self.mesh, [s.replicated for s in self.specs])

    def wrap(self, params: dict) -> dict:
        """An FSDP state's params as the model reads them: a `ShardedParam`
        for each sharded leaf, a replicated leaf as it is."""
        leaves = [x if s.replicated else ShardedParam(x, s, self.mesh)
                  for s, x in zip(self.specs, tree_leaves(params))]
        return tree_unflatten(params, leaves)


def tree_bytes(*trees) -> int:
    """The bytes of the tensors of `trees` (this rank's, when sharded)."""
    return sum(t.numel() * t.element_size() for tree in trees for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _param_trees(opt_state: dict):
    """The keys of the optimizer state's param-shaped trees (mu, nu,
    trace; not the step count)."""
    return [k for k, v in opt_state.items() if isinstance(v, dict)]


def shard_state(state, mesh, mode: str):
    """A full train state (`engine.train_step.TrainState`, the same on
    every rank) → this rank's sharded state, which carries its layout
    (`state.sharding`). "zero" shards the optimizer's moments, "fsdp" the
    params too (each shard a new leaf that requires grad)."""
    if state.sharding is not None:
        raise ValueError("the state is sharded already")
    layout = ShardLayout(state.params, mesh, mode)
    with torch.no_grad():
        opt_state = dict(state.opt_state)
        for k in _param_trees(opt_state):
            tree = opt_state[k]
            opt_state[k] = tree_unflatten(tree, [t.clone() for t in layout.shard_leaves(tree_leaves(tree))])
        params = state.params
        if mode == "fsdp":
            params = tree_unflatten(params, [t.detach().clone().requires_grad_(True)
                                             for t in layout.shard_leaves(tree_leaves(params))])
    out = state._replace(params=params, opt_state=opt_state, sharding=layout)
    if mode == "fsdp":
        log.info("FSDP: params sharded over dp=%d", mesh.world_size)
    log.info("ZeRO-1: optimizer moments sharded over dp=%d", mesh.world_size)
    log.info("sharded state (%s, world %d): params %d bytes, optimizer %d bytes a rank",
             mode, mesh.world_size, tree_bytes(params), tree_bytes(opt_state))
    return out


def full_params(state) -> dict:
    """The full params of a train state: under FSDP gathered on every rank
    (collective), else the state's own."""
    layout = state.sharding
    if layout is None or layout.mode != "fsdp":
        return state.params
    with torch.no_grad():
        leaves = layout.gather_leaves([t.detach() for t in tree_leaves(state.params)])
    return tree_unflatten(state.params, leaves)


def gather_trees(layout: ShardLayout, params: dict, opt_state: dict):
    """(full params, full optimizer state) of a state sharded by `layout`,
    on every rank (collective: one all-gather a dtype over the sharded
    leaves)."""
    keys = _param_trees(opt_state)
    trees = ([params] if layout.mode == "fsdp" else []) + [opt_state[k] for k in keys]
    leaves = [t.detach() for tree in trees for t in tree_leaves(tree)]
    with torch.no_grad():
        gathered = layout.gather_leaves(leaves, layout.specs * len(trees))
    n = len(layout.specs)
    full_trees = [tree_unflatten(tree, gathered[i * n:(i + 1) * n]) for i, tree in enumerate(trees)]
    if layout.mode == "fsdp":
        params = full_trees.pop(0)
    opt_state = dict(opt_state)
    opt_state.update(zip(keys, full_trees))
    return params, opt_state


def gather_state(state):
    """The full train state of a sharded one, on every rank (collective,
    `gather_trees`); the state as it is when it is not sharded. The result
    carries no layout."""
    layout = state.sharding
    if layout is None:
        return state
    params, opt_state = gather_trees(layout, state.params, state.opt_state)
    return state._replace(params=params, opt_state=opt_state, sharding=None)
