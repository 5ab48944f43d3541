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

The step updates `state.params` in place (the same leaf tensors stay the
model's parameters from step to step) and returns the new state.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from clip_event_tpu_torch.engine.losses import contrastive_loss
from clip_event_tpu_torch.engine.optim import Optimizer, global_norm, tree_leaves, tree_unflatten
from clip_event_tpu_torch.models import clip as clip_model
from clip_event_tpu_torch.models.clip import CLIPConfig
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
        for p, new in zip(tree_leaves(state.params), new_params):
            p.copy_(torch.where(finite, new, p))
        opt_state = {}
        for key, new in new_opt.items():
            old = state.opt_state[key]
            if isinstance(new, dict):
                kept = [torch.where(finite, n, o) for n, o in zip(tree_leaves(new), tree_leaves(old))]
                opt_state[key] = tree_unflatten(new, kept)
            else:
                opt_state[key] = torch.where(finite, new, old)
        # pre-clip global gradient norm, the training-health signal
        metrics = {
            "loss": total.detach(),
            "finite": finite,
            "grad_norm": global_norm(grads),
            **{k: v.detach() for k, v in loss_dict.items()},
        }
    return TrainState(state.params, opt_state, state.step + 1), metrics


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
