"""The port's sharded states: Megatron tensor parallelism of the
transformer stacks over the tp ranks, and ZeRO-1 and FSDP over the
data-parallel ranks (counterpart of `clip_event_tpu/parallel/sharding.py`:
`_TRANSFORMER_RULES` / `param_shardings` / `shard_params`, and
`zero_opt_shardings` / `shard_opt_state_zero`, `fsdp_param_shardings` /
`shard_params_fsdp`). Both kinds are a layout object carried by the train
state (`TrainState.sharding`): a model layout (`ModelLayout`: a
`TPLayout`, "tp", or the pipeline's `parallel.pipeline.PPLayout`, "pp"),
or a `ShardLayout` ("zero", "fsdp"), which may hold a model layout as its
`inner` level: ZeRO-1 and FSDP then chunk the rank's own leaves (its tp
slices, its pipeline stage) over its data group, the JAX package's rule of
keeping the tp and pp dims and adding the data axis (`_dp_leaf_sharding`,
`sharding.py:112-147`). Under dcn > 1 the chunks go over the data ranks of
the rank's slice (`Mesh.slice`) and the state is the same in every slice:
the gradients reduce-scatter within the slice, then sum across the slices
(`Mesh.cross`), and the update's all-gather stays within the slice, as
the JAX package keeps the moments off the dcn axis
(`tests/test_multislice.py::test_zero_moments_stay_intra_slice`).

Tensor parallelism ("tp", `shard_state_tp`). Inside `transformer` and
`text_transformer` the JAX package's leaf rules, column-parallel `qkv_w`
[L, W, 3W], `qkv_b`, `fc_w` [L, W, 4W] and `fc_b` (the last dim split),
row-parallel `out_w` [L, W, W] and `proj_w` [L, 4W, W] (the dim before
it), `out_b` and `proj_b` whole; `token_embedding` [V, W] vocab-parallel
(rows, where V % tp == 0); every other leaf whole on every rank, the
ResNet tower included. Two differences kept on purpose: (1) the rule is
a tower's, not a leaf's: a stack whose W or H does not divide tp (or
that holds int8 weights) stays whole on every rank and runs unsharded, the
same numbers, where JAX drops the annotation of each leaf that does not
divide (`sharding.py:94-102`); (2) the head-group reorder of JAX's
`sharded_attention_tp` (`attention_pallas.py:357-362`, [q|k|v] lanes to
[q_g|k_g|v_g]) is done once in the weight, not at every step in the
activation: rank g's `qkv_w` shard is [L, W, 3W/tp] with the columns
[q_g|k_g|v_g] (and `qkv_b` alike), so its projection is already the packed
QKV of its H/tp heads, and head group g's attention output is lanes
[g·W/tp, (g+1)·W/tp) of the canonical output, the rows of `out_w` rank g
holds. `TPLayout.gather_leaves` inverts the reorder (`full_params`,
`gather_state`); checkpoints hold the unsharded tree.

Layout. A leaf's elements are flattened and split into W (the ranks the
state is chunked over: the data group, or the slice's data ranks under
dcn) chunks of c = ceil(n / W), the last padded with zeros; rank r keeps
chunk r. A stacked transformer leaf ([L, ...], under `transformer` or
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
`mesh.replicate`), or one a model layout holds; `gather_state` gives the
full trees back, collectively, through both levels (the checkpoint holds
them, so a run resumes at any world, sharded or not). A leaf whose
gradient the tp ranks hold in part is summed over the tp group (its
shard, under FSDP) before the update, as without the data level.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from clip_event_tpu_torch.engine.optim import global_norm, leaf_norms, tree_leaves, tree_unflatten
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
    mesh, the model layout below it (`inner`: a `TPLayout` or `PPLayout`,
    or None), and a `LeafSpec` a param leaf of the rank's own params (in
    `optim.tree_leaves` order; every param-shaped tree of the optimizer
    state follows it), chunked over `shards` (`Mesh.slice`: the data
    group, or the slice's data ranks under dcn, whose sums `cross` then
    completes)."""

    def __init__(self, params: dict, mesh, mode: str, inner=None):
        if mode not in MODES:
            raise ValueError(f"sharding mode {mode!r}; options: {MODES}")
        self.mode, self.mesh, self.inner = mode, mesh, inner
        self.shards, self.cross = mesh.slice, mesh.cross
        self.specs = _specs(params, self.shards.world_size)

    def shard_leaves(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's shards of full leaves."""
        return [s.shard_of(x, self.shards.rank) for s, x in zip(self.specs, leaves)]

    def gather_leaves(self, shards: Sequence[torch.Tensor], specs=None) -> List[torch.Tensor]:
        """The full leaves of every rank's shards (collective: one
        all-gather a dtype); `specs` default to one per param leaf."""
        specs = self.specs if specs is None else specs
        rows = collectives.all_gather_flat(list(shards), self.shards)
        return [s.from_rows(r) for s, r in zip(specs, rows)]

    def reduce_scatter(self, grads: Sequence[torch.Tensor], extra: Sequence[torch.Tensor] = ()):
        """(this rank's shards of the gradients summed over the ranks, the
        sums of `extra`): the full gradients and the extra tensors (whole in
        every row) in one reduce-scatter a dtype, then under dcn one
        all-reduce a dtype across the slices."""
        world = self.shards.world_size
        rows = [s.to_rows(g) for s, g in zip(self.specs, grads)]
        rows += [e.reshape(1, -1).expand(world, -1) for e in extra]
        out = collectives.reduce_scatter_flat(rows, self.shards)
        if self.cross is not None:
            out = collectives.all_reduce_flat(out, self.cross)
        n = len(self.specs)
        shards = [o.view(s.shard_shape) for s, o in zip(self.specs, out[:n])]
        return shards, [o.view_as(e) for o, e in zip(out[n:], extra)]

    def norm(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of a sharded gradient: each leaf's norm combined
        over the ranks of its chunks (`optim.leaf_norms`), then over the
        model group below (`inner.norm`: a split leaf's over its slices, a
        whole leaf once)."""
        norms = leaf_norms(shards, self.shards, [s.replicated for s in self.specs])
        if self.inner is None:
            return torch.linalg.vector_norm(norms)
        return self.inner.norm(list(norms.unbind()))

    def wrap(self, params: dict) -> dict:
        """An FSDP state's params as the model reads them: a `ShardedParam`
        for each sharded leaf, a replicated leaf as it is."""
        leaves = [x if s.replicated else ShardedParam(x, s, self.shards)
                  for s, x in zip(self.specs, tree_leaves(params))]
        return tree_unflatten(params, leaves)


def model_layout(layout):
    """The model level of a state's layout (a `ModelLayout`, or None)."""
    if isinstance(layout, ModelLayout):
        return layout
    return getattr(layout, "inner", None)


def tree_bytes(*trees) -> int:
    """The bytes of the tensors of `trees` (this rank's, when sharded)."""
    return sum(t.numel() * t.element_size() for tree in trees for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _param_trees(opt_state: dict):
    """The keys of the optimizer state's param-shaped trees (mu, nu,
    trace; not the step count)."""
    return [k for k, v in opt_state.items() if isinstance(v, dict)]


def shard_state(state, mesh, mode: str):
    """A train state, full (the same on every rank) or held by a model
    layout (`shard_state_tp`, `parallel.pipeline.shard_state_pp`) → this
    rank's sharded state, which carries its layout (`state.sharding`, the
    model layout as its `inner`). "zero" shards the optimizer's moments,
    "fsdp" the params too (each shard a new leaf that requires grad), over
    the data group (`ShardLayout`)."""
    inner = state.sharding
    if inner is not None and not isinstance(inner, ModelLayout):
        raise ValueError("the state is sharded already")
    if inner is not None and inner.mesh != mesh:
        raise ValueError(f"a state held over {inner.mesh} sharded over {mesh}")
    layout = ShardLayout(state.params, mesh, mode, inner)
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
    dp = layout.shards.world_size
    if mode == "fsdp":
        log.info("FSDP: params sharded over dp=%d", dp)
    log.info("ZeRO-1: optimizer moments sharded over dp=%d", dp)
    log.info("sharded state (%s%s, world %d): params %d bytes, optimizer %d bytes a rank",
             mode, "" if inner is None else f" over {inner.mode}", mesh.world_size,
             tree_bytes(params), tree_bytes(opt_state))
    return out


def local_params(state) -> dict:
    """The params of a train state as this rank's model level holds them:
    under FSDP gathered over the data ranks (collective), its tp slices or
    pipeline stage kept; else the state's own."""
    layout = state.sharding
    if not isinstance(layout, ShardLayout) or layout.mode != "fsdp":
        return state.params
    with torch.no_grad():
        leaves = layout.gather_leaves([t.detach() for t in tree_leaves(state.params)])
    return tree_unflatten(state.params, leaves)


def full_params(state) -> dict:
    """The full params of a train state: under FSDP, tp and pp gathered on
    every rank (collective), else the state's own."""
    params = local_params(state)
    inner = model_layout(state.sharding)
    return params if inner is None else inner.gather_trees(params, {})[0]


def gather_trees(layout, params: dict, opt_state: dict):
    """(full params, full optimizer state) of a state sharded by `layout`,
    on every rank (collective: one all-gather a dtype over the sharded
    leaves; a model layout, alone or below, gathers over its group)."""
    if isinstance(layout, ModelLayout):
        return layout.gather_trees(params, opt_state)
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
    if layout.inner is not None:
        return layout.inner.gather_trees(params, opt_state)
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


class ModelLayout:
    """A model-parallel layout of one train state (`TPLayout`, and the
    pipeline's `PPLayout`): the `mesh`, the model group's view (`view`:
    the tp or the pp group) and a spec a param leaf (in `optim.tree_leaves`
    order; every param-shaped tree of the optimizer state follows it), each
    with a `kind` (None: whole on every rank of the group), `shard_of`,
    `from_shards` and `partial`."""

    mode = None
    mesh = None
    specs: list = []

    @property
    def view(self):
        raise NotImplementedError

    def shard_leaves(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's slices of full leaves (copies; whole leaves as they
        are)."""
        v = self.view
        return [s.shard_of(x, v.world_size, v.rank) for s, x in zip(self.specs, leaves)]

    def gather_leaves(self, shards: Sequence[torch.Tensor], specs=None) -> List[torch.Tensor]:
        """The full leaves of every rank's slices (collective over the
        group: one all-gather a dtype of the split leaves)."""
        specs = self.specs if specs is None else specs
        v = self.view
        split = [i for i, s in enumerate(specs) if s.kind is not None]
        out = [t for t in shards]
        rows = collectives.all_gather_flat([shards[i] for i in split], v)
        for i, r in zip(split, rows):
            out[i] = specs[i].from_shards(r.reshape((v.world_size,) + tuple(shards[i].shape)))
        return out

    def norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of a model-sharded gradient: each split leaf's
        norm combined over the group's ranks, a whole leaf counted once
        (`optim.global_norm`)."""
        return global_norm(grads, self.view, [s.kind is None for s in self.specs])

    def partial(self) -> List[int]:
        """The leaves whose gradient the group's ranks hold in part."""
        return [i for i, s in enumerate(self.specs) if s.partial]

    def gather_trees(self, params: dict, opt_state: dict):
        """(full params, full optimizer state), on every rank (collective)."""
        keys = _param_trees(opt_state)
        trees = [params] + [opt_state[k] for k in keys]
        with torch.no_grad():
            full = [tree_unflatten(t, self.gather_leaves([x.detach() for x in tree_leaves(t)]))
                    for t in trees]
        opt_state = dict(opt_state)
        opt_state.update(zip(keys, full[1:]))
        return full[0], opt_state


# ------------------------------------------------------------ tensor parallel

# the JAX package's leaf rules inside a stacked transformer subtree
# (`_TRANSFORMER_RULES`): the dim of the full leaf that tp splits, counted
# from the end ("qkv": the last dim, head-group reordered)
TP_RULES = {"qkv_w": "qkv", "qkv_b": "qkv", "fc_w": "column", "fc_b": "column",
            "out_w": "row", "proj_w": "row"}
_TP_DIM = {"qkv": -1, "column": -1, "row": -2, "vocab": 0}
# replicated leaves of a sharded stack whose gradient each tp rank holds in
# part: ln_1 always (its output's cotangent comes from the rank's heads:
# the tp operator sits before it, outside the "attn" policy's saved
# region); under sequence parallelism also the leaves that see the rank's
# rows only
TP_PARTIAL = ("ln_1",)
SP_PARTIAL = ("ln_1", "ln_2", "out_b", "proj_b")


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """How one leaf splits over the tp ranks: `kind` None (whole on every
    rank), "qkv", "column", "row" or "vocab"; `partial`: a whole leaf whose
    gradient is split over the tp ranks (summed over the tp group by the
    step)."""

    kind: Optional[str] = None
    partial: bool = False

    def shard_of(self, x: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
        """Rank `rank`'s slice of a full leaf (a copy; a whole leaf as it
        is)."""
        if self.kind is None:
            return x
        if self.kind == "qkv":
            w = x.shape[-1] // 3 // tp
            return x.reshape(*x.shape[:-1], 3, tp, w)[..., rank, :].reshape(*x.shape[:-1], 3 * w).clone()
        return x.chunk(tp, dim=_TP_DIM[self.kind])[rank].clone()

    def from_shards(self, shards: torch.Tensor) -> torch.Tensor:
        """[tp, *shard] (every rank's slice) → the full leaf."""
        if self.kind == "qkv":
            tp, lead, w = shards.shape[0], tuple(shards.shape[1:-1]), shards.shape[-1] // 3
            parts = shards.reshape((tp,) + lead + (3, w)).movedim(0, -2)
            return parts.reshape(lead + (3 * tp * w,))
        return torch.cat(list(shards.unbind(0)), dim=_TP_DIM[self.kind])


def tp_stack_sharded(stack: dict, width: int, heads: int, tp: int) -> bool:
    """Whether a stacked transformer subtree splits over `tp` ranks: W and H
    divide tp, and no leaf is an int8 `QuantWeight` (its weights stay whole,
    as the JAX eval CLI keeps them)."""
    if tp <= 1 or width % tp or heads % tp:
        return False
    return all(isinstance(t, torch.Tensor) for t in tree_leaves(stack))


def _stack_heads(cfg) -> dict:
    """{stack key: (width, heads)} of a model config's transformer stacks."""
    out = {"text_transformer": (cfg.transformer_width, cfg.transformer_heads)}
    if cfg.is_vit:
        out["transformer"] = (cfg.vision_width, cfg.vision_heads)
    return out


def tp_specs(params: dict, cfg, tp: int, sp: bool = False) -> List[TPSpec]:
    """A `TPSpec` a leaf of `params`, in `optim.tree_leaves` order."""
    heads = _stack_heads(cfg)
    partial = SP_PARTIAL if sp else TP_PARTIAL
    out = []

    def walk(tree, path, stack):
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            if isinstance(v, (dict, list)):
                inner = stack
                if stack is None and k in heads:
                    inner = tp_stack_sharded(v, *heads[k], tp)
                walk(v, path + (k,), inner)
            elif stack:
                kind = TP_RULES.get(k)
                out.append(TPSpec(kind, partial=kind is None and (k in partial or path[-1] in partial)))
            elif (path, k) == ((), "token_embedding") and tp > 1 and isinstance(v, torch.Tensor) \
                    and v.shape[0] % tp == 0:
                out.append(TPSpec("vocab"))
            else:
                out.append(TPSpec())

    walk(params, (), None)
    return out


def check_tp_kernels(cfg, tp: int, text_len: Optional[int] = None) -> None:
    """Raise, naming the tower and the shape, where a sharded stack's head
    group (S, W/tp, H/tp) is a shape no attention kernel takes
    (`ops.attention.core_kernel`): ViT-B/16's vision tower at tp = 4
    (W/tp = 192). The JAX package runs its einsum path there
    (`layers.py:249-283`); here the kernel path refuses at setup, as
    `attention_core` refuses such a shape."""
    from clip_event_tpu_torch.ops.attention import core_kernel

    seqs = {"text_transformer": text_len or cfg.context_length}
    if cfg.is_vit:
        seqs["transformer"] = cfg.grid_size ** 2 + 1
    for key, (width, heads) in _stack_heads(cfg).items():
        if tp > 1 and width % tp == 0 and heads % tp == 0:
            try:
                core_kernel(seqs[key], width // tp, heads // tp)
            except ValueError as err:
                raise ValueError(f"tp={tp}: the {key} stack's head group (S={seqs[key]}, "
                                 f"W={width // tp}, H={heads // tp}) has no attention kernel: {err}") from None


class TPLayout(ModelLayout):
    """The tensor-parallel sharding of one train state (mode "tp"): the
    mesh (its `tensor` view is the tp group), and a `TPSpec` a param leaf."""

    mode = "tp"

    def __init__(self, params: dict, cfg, mesh):
        self.mesh = mesh
        self.specs = tp_specs(params, cfg, mesh.tp, mesh.sp)

    @property
    def view(self):
        return self.mesh.tensor


def shard_params_tp(params: dict, cfg, mesh) -> dict:
    """This rank's slices of a full param tree (`TPLayout`'s rule; int8
    leaves and the stacks that do not divide stay whole)."""
    layout = TPLayout(params, cfg, mesh)
    return tree_unflatten(params, layout.shard_leaves(tree_leaves(params)))


def shard_state_tp(state, cfg, mesh):
    """A full train state (the same on every rank) → this rank's
    tensor-parallel one, which carries its layout (`state.sharding`): the
    params (each slice a new leaf that requires grad) and every moment
    tree split alike."""
    if state.sharding is not None:
        raise ValueError("the state is sharded already")
    if mesh.tp <= 1:
        raise ValueError("a tensor-parallel state needs a mesh with tp > 1")
    layout = TPLayout(state.params, cfg, mesh)
    with torch.no_grad():
        params = tree_unflatten(state.params, [
            t.detach().requires_grad_(True) for t in layout.shard_leaves(tree_leaves(state.params))])
        opt_state = dict(state.opt_state)
        for k in _param_trees(opt_state):
            opt_state[k] = tree_unflatten(opt_state[k], layout.shard_leaves(tree_leaves(opt_state[k])))
    split = sum(s.kind is not None for s in layout.specs)
    log.info("TP: %d of %d param leaves split over tp=%d%s; params %d bytes, optimizer %d bytes a rank",
             split, len(layout.specs), mesh.tp, " (sequence parallel)" if mesh.sp else "",
             tree_bytes(params), tree_bytes(opt_state))
    return state._replace(params=params, opt_state=opt_state, sharding=layout)
