"""The training step (counterpart of `clip_event_tpu/engine/train_step.py`;
reference hot loop, `engine.py:16-112`).

One step: forward (image + text towers, each block recomputed in the
backward pass under `remat`), contrastive loss, the optional OT alignment
branch (object crops and entity mentions re-encoded, IPOT), backward,
global-norm clip, optimizer update, single device. The NaN abort
(`engine.py:79-82`) becomes a `finite` flag in the returned metrics, and a
non-finite loss keeps the old params and optimizer state (`torch.where` on
the device), so the host loop can read the flag whenever it next syncs and
abort from an intact state; no step forces a host sync.

The step updates `state.params` and `state.opt_state` in place (the same
tensors stay the model's parameters and the optimizer's state from step to
step) and returns the new state. `make_multi_step` runs K steps in one
dispatch, on the card as a CUDA graph of the step replayed K times.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from clip_event_tpu_torch.engine.losses import contrastive_loss
from clip_event_tpu_torch.engine.optim import Optimizer, global_norm, tree_leaves, tree_unflatten
from clip_event_tpu_torch.models import clip as clip_model
from clip_event_tpu_torch.models import layers
from clip_event_tpu_torch.models.clip import CLIPConfig
from clip_event_tpu_torch.ops import counters
from clip_event_tpu_torch.ops.ot import alignment_loss


class TrainState(NamedTuple):
    params: dict  # leaf tensors that require grad
    opt_state: dict
    step: int  # optimizer steps taken, non-finite ones included (as in JAX)


def create_train_state(params: dict, optimizer: Optimizer) -> TrainState:
    """A copy of every param as a leaf that requires grad, and the
    optimizer state (the step updates the copies in place, never the
    caller's tensors)."""
    params = tree_unflatten(
        params, [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    )
    return TrainState(params, optimizer.init(params), 0)


def loss_fn(
    params: dict,
    batch: Dict[str, torch.Tensor],
    cfg: CLIPConfig,
    loss_type: str = "ce",
    overbatch: bool = True,
    compute_dtype=torch.float32,
    remat=False,
    impl: str = "kernel",
    alignment: bool = False,
    use_pallas_ot="auto",
    alignment_chunks: int = 1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {loss_i, loss_t[, loss_ot]}) of one batch, in fp32.
    With `alignment` the batch carries `object_image`, `object_mask`,
    `entity_text` and `entity_mask`, and `loss_ot` joins the total."""
    kw = dict(compute_dtype=compute_dtype, impl=impl, remat=remat)
    if "text_unique" in batch:
        # dedupe-encode: encode each unique token row once and gather the
        # features back to the full layout (data/dedupe.py); exact for the
        # loss, and the gather's backward sums the duplicates' gradients
        image_features = clip_model.l2_normalize(
            clip_model.encode_image(params, cfg, batch["image"], **kw)
        )
        text_features = clip_model.l2_normalize(
            clip_model.encode_text(params, cfg, batch["text_unique"], **kw)
        )[batch["text_inverse"].long()]
        logits_per_image, logits_per_text = clip_model.contrastive_logits(
            params, image_features, text_features, overbatch
        )
    else:
        logits_per_image, logits_per_text = clip_model.forward(
            params, cfg, batch["image"], batch["text"], overbatch=overbatch, **kw
        )
    loss_dict = contrastive_loss(
        logits_per_image, logits_per_text, batch["labels_per_image"],
        batch["labels_per_text"], batch["index_pos"], loss_type=loss_type,
    )
    if alignment:
        object_feats, entity_feats = clip_model.sim_entity(
            params, cfg, batch["object_image"], batch["entity_text"],
            chunks=alignment_chunks, **kw,
        )
        loss_dict["loss_ot"] = alignment_loss(
            entity_feats, object_feats, batch["entity_mask"], batch["object_mask"],
            use_pallas=use_pallas_ot,
        )
    return sum(loss_dict.values()), loss_dict


def _grads(total: torch.Tensor, params: dict):
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _apply_update(
    state: TrainState,
    grads,
    total: torch.Tensor,
    loss_dict: Dict[str, torch.Tensor],
    optimizer: Optimizer,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer update + the non-finite freeze, shared by the single
    and the gradient-accumulated step."""
    with torch.no_grad():
        grad_tree = tree_unflatten(state.params, grads)
        new_params, new_opt = optimizer.update(grad_tree, state.opt_state, state.params)
        finite = torch.isfinite(total)
        # every leaf of the state, the step count included, is written in
        # place: a CUDA graph replay reads the buffers the last one wrote
        for p, new in zip(tree_leaves(state.params), new_params):
            p.copy_(torch.where(finite, new, p))
        for key, old in state.opt_state.items():
            new = new_opt[key]
            pairs = zip(tree_leaves(old), tree_leaves(new)) if isinstance(old, dict) else [(old, new)]
            for o, n in pairs:
                o.copy_(torch.where(finite, n, o))
        # pre-clip global gradient norm, the training-health signal
        metrics = {
            "loss": total.detach(),
            "finite": finite,
            "grad_norm": global_norm(grads),
            **{k: v.detach() for k, v in loss_dict.items()},
        }
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_train_step(
    cfg: CLIPConfig,
    optimizer: Optimizer,
    loss_type: str = "ce",
    overbatch: bool = True,
    compute_dtype=torch.float32,
    remat=True,
    impl: str = "kernel",
    alignment: bool = False,
    use_pallas_ot="auto",
    alignment_chunks: int = 1,
):
    """Returns `train_step(state, batch) -> (state, metrics)`; metrics are
    device tensors (loss, finite, grad_norm, loss_i, loss_t[, loss_ot])."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        total, loss_dict = loss_fn(
            state.params, batch, cfg, loss_type, overbatch, compute_dtype, remat, impl,
            alignment, use_pallas_ot, alignment_chunks,
        )
        return _apply_update(state, _grads(total, state.params), total, loss_dict, optimizer)

    return train_step


def make_multi_step(cfg: CLIPConfig, optimizer: Optimizer, num_steps: int, **step_kwargs):
    """K = `num_steps` training steps in one dispatch (JAX's
    `make_multi_step`, a `lax.scan` there). Returns `(many, many_fixed)`:
    `many(state, batches)` takes a stack whose fields have a leading [K]
    axis (or one batch, which every step then takes, as JAX's `stacked`
    check decides by that axis), `many_fixed(state, batch)` runs K steps on
    one batch. Both return `(state, metrics)`, each metric stacked as [K],
    and run `make_train_step`'s step function with these `step_kwargs`: the
    same loss surface (`alignment` too) and the same metrics.

    On the CPU that is K calls of the step. On a CUDA device the step is a
    CUDA graph (`_CapturedStep`) replayed K times: each replay copies its
    batch into the graph's input buffers, replays the whole step (forward,
    `autograd.grad`, clip, update, non-finite freeze) on the state's own
    tensors and copies the step's metrics into row j of the outputs, with
    no host sync. A graph is captured on the first dispatch of each key
    (the per-step batch's fields, shapes, dtypes and device, the state's
    tensors, the process-wide LayerNorm choice): that dispatch runs its
    first step eagerly, which warms up what a capture must not do for the
    first time, then captures, then replays K - 1 times. A capture or
    replay that fails raises; nothing falls back to the eager step."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    step_fn = make_train_step(cfg, optimizer, **step_kwargs)
    graphs: Dict[tuple, _CapturedStep] = {}

    def run(state: TrainState, batches: Dict[str, torch.Tensor], stacked: bool):
        def batch_at(j):
            return {k: v[j] for k, v in batches.items()} if stacked else batches

        if tree_leaves(state.params)[0].device.type != "cuda":
            rows = []
            for j in range(num_steps):
                state, m = step_fn(state, batch_at(j))
                rows.append(m)
            return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

        first = batch_at(0)
        key = _graph_key(state, first)
        graph, j0, out = graphs.get(key), 0, None
        if graph is None:
            state, m = step_fn(state, first)
            out = {k: v.new_empty((num_steps,) + tuple(v.shape)) for k, v in m.items()}
            for k, v in m.items():
                out[k][0].copy_(v)
            graph = graphs[key] = _CapturedStep(step_fn, state, first)
            j0 = 1
        metrics = graph.metrics
        if out is None:
            out = {k: v.new_empty((num_steps,) + tuple(v.shape)) for k, v in metrics.items()}
        for j in range(j0, num_steps):
            graph.replay(batch_at(j) if stacked or j == j0 else None)
            for k, v in metrics.items():
                out[k][j].copy_(v)
        return state._replace(step=state.step + num_steps - j0), out

    def many(state: TrainState, batches: Dict[str, torch.Tensor]):
        if batches is None:
            raise ValueError("pass a [K, ...] batch stack or a single batch")
        stacked = next(iter(batches.values())).shape[0] == num_steps
        return run(state, batches, stacked)

    def many_fixed(state: TrainState, batch: Dict[str, torch.Tensor]):
        return run(state, batch, False)

    # the captured steps by key, for a caller that replays or profiles one
    many.graphs = many_fixed.graphs = graphs
    return many, many_fixed


def _graph_key(state: TrainState, batch: Dict[str, torch.Tensor]) -> tuple:
    """What a captured step is valid for: the batch's fields, shapes, dtypes
    and device, the state's tensors (a graph writes the ones it captured)
    and the process-wide LayerNorm choice (`transformer` reads it)."""
    fields = tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items()))
    buffers = tuple(t.data_ptr() for t in tree_leaves(state.params) + tree_leaves(state.opt_state))
    return fields, buffers, layers._resolve_ln()


class _CapturedStep:
    """One train step captured as a CUDA graph (`torch.cuda.graph`, its own
    memory pool) over input buffers of the batch's shape, on the tensors of
    the state it was captured with. `metrics` are the graph's output
    tensors, which each replay rewrites. The kernel wrappers count during
    the capture, which launches nothing: those counts are taken as one
    replay's launches (`launches`), put back after the capture, and added
    to the counts once a replay (`ops.counters`)."""

    def __init__(self, step_fn, state: TrainState, batch: Dict[str, torch.Tensor]):
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        self.graph = torch.cuda.CUDAGraph()
        before = counters.snapshot()
        with torch.cuda.graph(self.graph):
            _, self.metrics = step_fn(state, self.inputs)
        after = counters.snapshot()
        counters.restore(before)
        self.launches = {k: after[k] - before[k] for k in after}

    def replay(self, batch: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Copy `batch` (None: the last one stays) into the inputs and run
        the step once; returns the metrics tensors."""
        if batch is not None:
            for k, v in batch.items():
                self.inputs[k].copy_(v)
        self.graph.replay()
        counters.add(self.launches)
        return self.metrics


def make_accum_step(
    cfg: CLIPConfig,
    optimizer: Optimizer,
    accum_steps: int,
    loss_type: str = "ce",
    overbatch: bool = True,
    compute_dtype=torch.float32,
    remat=True,
    impl: str = "kernel",
    alignment: bool = False,
    use_pallas_ot="auto",
    alignment_chunks: int = 1,
):
    """ONE optimizer step from K microbatches (gradient accumulation).

    `batches` maps each field to a [K, B_micro, ...] tensor. Each
    microbatch's forward and backward run in turn, so only one microbatch's
    activations are alive at a time, plus one gradient sum. Gradients and
    loss metrics are K-averaged, then one update applies, so the clip and
    the LR schedule see the averaged gradient. InfoNCE negatives stay
    within each microbatch (the logit matrix is batch-coupled)."""

    def accum_step(state: TrainState, batches: Dict[str, torch.Tensor]):
        lead = next(iter(batches.values())).shape[0]
        if lead != accum_steps:
            raise ValueError(
                f"batch stack has leading dim {lead}, expected "
                f"accum_steps={accum_steps} (gradients would mis-scale)"
            )
        gsum = msum = None
        for k in range(accum_steps):
            micro = {key: v[k] for key, v in batches.items()}
            total, loss_dict = loss_fn(
                state.params, micro, cfg, loss_type, overbatch, compute_dtype, remat, impl,
                alignment, use_pallas_ot, alignment_chunks,
            )
            grads = _grads(total, state.params)
            metrics = {"loss": total.detach(), **{n: v.detach() for n, v in loss_dict.items()}}
            if gsum is None:
                gsum, msum = grads, metrics
            else:
                torch._foreach_add_(gsum, grads)
                msum = {n: msum[n] + v for n, v in metrics.items()}
        inv = 1.0 / accum_steps
        grads = torch._foreach_mul(gsum, inv)
        avg = {n: v * inv for n, v in msum.items()}
        total = avg.pop("loss")
        return _apply_update(state, grads, total, avg, optimizer)

    return accum_step
