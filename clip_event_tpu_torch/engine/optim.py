"""Optimizer + LR schedule factories (counterpart of
`clip_event_tpu/engine/optim.py`; reference `engine.py:129-175`,
`utils.py:312-416`).

The JAX package builds an optax chain; this is the same chain written as
plain tensor code, so that its semantics are optax's and not those of
`torch.optim.Adam` with `clip_grad_norm_`:

  * clip by global norm first: `g / norm * max_norm` when norm >= max_norm
    (torch's `clip_grad_norm_` multiplies by `max_norm / (norm + 1e-6)`);
  * then L2 weight decay added to the gradient (torch `Adam`, not AdamW);
  * then Adam (bias-corrected, eps outside the root) or SGD with classic
    momentum (`trace`);
  * then the learning rate, read from the schedule at the step count
    *before* it is incremented (step 0 uses `schedule(0)`).

The update math is fp32. `moment_dtype="bfloat16"` stores only Adam's
first moment (or SGD's trace) in bf16; as in optax, the decay of the stored
moment (`b1 * mu`) is taken in that type, b1 itself rounded to it (optax
multiplies by a weakly typed Python float, which JAX casts to the array's
type: b1 = 0.9 acts as 0.8984375 on a bf16 moment), and the rest in fp32. The step
count and every scalar of the update stay on the device, so an update
needs no host sync, and no tensor is made from host data inside one (the
constants are Python scalars), so a CUDA graph can capture it. Schedules
are functions of the step count computed in fp32, as the JAX ones are
traced.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Schedule = Callable[[object], torch.Tensor]
_INT32_MAX = 2**31 - 1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _rounded_to(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as a Python float: the value a weakly typed
    Python scalar takes when JAX multiplies an array of that type by it."""
    return float(torch.tensor(x, dtype=dtype))


def build_schedule(
    name: str,
    base_lr: float,
    max_epoch: int,
    begin_epoch: int = 0,
    steps_per_epoch: int = 1,
    lr_steps: Optional[Sequence[int]] = None,
    lr_gamma: float = 0.1,
    warmup_epochs: int = 5,
    warmup_factor: float = 0.001,
) -> Schedule:
    """Returns a schedule: step count (int or integer tensor) → lr as an
    fp32 0-dim tensor on the step's device. `steps_per_epoch=1` reproduces
    the reference's per-step scheduler stepping."""
    milestones = sorted(lr_steps or []) or [_INT32_MAX]

    def epoch_of(step):
        return torch.div(_f32(step), steps_per_epoch, rounding_mode="floor")

    def warmup_at(e):
        alpha = e / warmup_epochs
        linear = warmup_factor * (1.0 - alpha) + alpha
        return torch.where(e < warmup_epochs, linear, torch.ones_like(linear))

    def decay_at(e):
        # the milestones passed <= e, counted against Python scalars: no
        # tensor made from host data inside a step (a CUDA graph replays it)
        passed = sum((e >= float(m)).float() for m in milestones)
        return lr_gamma ** passed

    if name == "none":
        return lambda step: torch.full_like(_f32(step), base_lr)

    if name == "multisteplr":
        return lambda step: base_lr * decay_at(epoch_of(step))

    if name == "cosineannealinglr":
        t_max = max(max_epoch - begin_epoch, 1)
        return lambda step: base_lr * 0.5 * (
            1.0 + torch.cos(math.pi * torch.clamp(epoch_of(step), max=t_max) / t_max)
        )

    if name == "warmup":  # detectron2-style WarmupCosineLR (utils.py:348-386)
        def sched(step):
            e = epoch_of(step) + begin_epoch
            return base_lr * warmup_at(e) * 0.5 * (1.0 + torch.cos(math.pi * e / max_epoch))

        return sched

    if name == "warmupmultisteplr":  # WarmupMultiStepLR (utils.py:310-345)
        def sched(step):
            e = epoch_of(step) + begin_epoch
            return base_lr * warmup_at(e) * decay_at(e)

        return sched

    raise ValueError(f"invalid lr scheduler {name!r}")


# ------------------------------------------------------------ param trees


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, depth first in key order; a list (a
    ResNet stage's blocks) in its own order."""
    out = []
    for v in (tree.values() if isinstance(tree, dict) else tree):
        out.extend(tree_leaves(v) if isinstance(v, (dict, list)) else [v])
    return out


def tree_unflatten(like, leaves):
    """A nested dict (and list) shaped like `like` holding `leaves` in
    `tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, list):
            return [build(v) for v in t]
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)

    return build(like)


def global_norm(tensors: Sequence[torch.Tensor], mesh=None,
                replicated: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every element, fp32 (`optax.global_norm`).

    With a `mesh` of more than one rank the tensors are this rank's shards
    of the leaves (`parallel/sharding.py`): the shards' norms are
    all-gathered and each leaf's norm is the norm of its ranks' norms (a
    leaf that `replicated` marks, whole on every rank, counted once). At a
    world of one that is the unsharded value, bit for bit."""
    return torch.linalg.vector_norm(leaf_norms(tensors, mesh, replicated))


def leaf_norms(tensors: Sequence[torch.Tensor], mesh=None,
               replicated: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """[n] fp32: each leaf's norm, over the ranks of `mesh` as
    `global_norm` combines them (a sharded state's first level, before the
    model group's, `parallel.sharding.ShardLayout.norm`)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if mesh is not None and mesh.world_size > 1:
        from clip_event_tpu_torch.parallel.collectives import all_gather_flat

        if replicated is not None and mesh.rank != 0:
            # a leaf whole on every rank counts once, as rank 0's
            norms = torch._foreach_mul(norms, [0.0 if r else 1.0 for r in replicated])
        per_rank = all_gather_flat([torch.stack(norms)], mesh)[0]
        return torch.linalg.vector_norm(per_rank, dim=0)
    return torch.stack(norms)


class Optimizer:
    """Adam/SGD with global-norm clipping (`build_optimizer` of the JAX
    package; the reference clips at 1.0, `engine.py:89`).

    `init(params)` → state {"count", and "mu"/"nu" (Adam) or "trace" (SGD
    with momentum)}, trees shaped like `params`. `update(grads, state,
    params)` → (new param leaves, new state), leaving its inputs as they
    are; the train step decides whether to keep them (the non-finite
    freeze)."""

    def __init__(
        self,
        name: str,
        schedule,
        weight_decay: float = 0.0,
        momentum: float = 0.9,
        grad_clip_norm: Optional[float] = 1.0,
        moment_dtype: Optional[str] = None,
    ):
        if name not in ("adam", "sgd"):
            raise ValueError(f"invalid optimizer {name!r}")
        self.name = name
        self.schedule = schedule if callable(schedule) else (
            lambda step, lr=schedule: torch.full_like(_f32(step), lr))
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.grad_clip_norm = grad_clip_norm
        self.moment_dtype = getattr(torch, moment_dtype) if moment_dtype else torch.float32
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        # the decays of the stored moment, rounded to its type once here
        self._stored_b1 = _rounded_to(self.b1, self.moment_dtype)
        self._stored_momentum = _rounded_to(momentum, self.moment_dtype)

    def init(self, params: dict) -> Dict[str, object]:
        leaves = tree_leaves(params)
        dev = leaves[0].device
        state: Dict[str, object] = {"count": torch.zeros((), dtype=torch.int32, device=dev)}

        def zeros(dtype):
            return tree_unflatten(params, [torch.zeros_like(p, dtype=dtype) for p in leaves])

        if self.name == "adam":
            state["mu"] = zeros(self.moment_dtype)
            state["nu"] = zeros(torch.float32)
        elif self.momentum:
            state["trace"] = zeros(self.moment_dtype)
        return state

    def _decayed(self, stored: List[torch.Tensor], decay: float) -> List[torch.Tensor]:
        """decay·stored in the stored type, `decay` already rounded to it
        (`_rounded_to`), back in fp32 (JAX's weak-type promotion)."""
        return [t.float() for t in torch._foreach_mul(stored, decay)]

    def update(
        self, grads: dict, state: Dict[str, object], params: dict,
        grad_norm: Optional[torch.Tensor] = None,
    ) -> Tuple[List[torch.Tensor], Dict[str, object]]:
        """`grad_norm`: the gradient's global norm where the caller has it
        (a sharded gradient's, which no one rank can take alone)."""
        p = tree_leaves(params)
        g = [t.float() for t in tree_leaves(grads)]
        count = state["count"]
        if self.grad_clip_norm is not None:
            norm = global_norm(g) if grad_norm is None else grad_norm
            factor = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                 self.grad_clip_norm / norm)
            g = torch._foreach_mul(g, factor)
        if self.weight_decay:
            g = torch._foreach_add(g, [t.float() for t in p], alpha=self.weight_decay)

        new_state: Dict[str, object] = {"count": count + 1}
        if self.name == "adam":
            mu = torch._foreach_add(
                self._decayed(tree_leaves(state["mu"]), self._stored_b1),
                torch._foreach_mul(g, 1.0 - self.b1),
            )
            nu = torch._foreach_add(
                torch._foreach_mul(tree_leaves(state["nu"]), self.b2),
                torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
            )
            n = (count + 1).float()
            mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, n))
            nu_hat = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, n))
            denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
            upd = torch._foreach_div(mu_hat, denom)
            new_state["mu"] = tree_unflatten(params, [t.to(self.moment_dtype) for t in mu])
            new_state["nu"] = tree_unflatten(params, nu)
        elif self.momentum:
            trace = torch._foreach_add(self._decayed(tree_leaves(state["trace"]), self._stored_momentum), g)
            upd = trace
            new_state["trace"] = tree_unflatten(params, [t.to(self.moment_dtype) for t in trace])
        else:
            upd = g

        neg_lr = -self.schedule(count).to(device=count.device)
        upd = torch._foreach_mul(upd, neg_lr)
        new_params = [(a + u).to(a.dtype) for a, u in zip(p, upd)]
        return new_params, new_state


def build_optimizer(
    name: str,
    schedule,
    weight_decay: float = 0.0,
    momentum: float = 0.9,
    grad_clip_norm: Optional[float] = 1.0,
    moment_dtype: Optional[str] = None,
) -> Optimizer:
    """Adam/SGD with global-norm clipping; `schedule` may be a float or a
    step → lr function. `moment_dtype` "bfloat16" stores Adam's first
    moment / SGD's momentum buffer in bf16 (Adam's second moment stays
    fp32)."""
    return Optimizer(name, schedule, weight_decay, momentum, grad_clip_norm, moment_dtype)
