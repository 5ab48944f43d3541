"""Checkpoint save/resume (counterpart of `clip_event_tpu/engine/checkpoint.py`;
reference `save_model_on_master`, `engine.py:202-218`, and the resume path
`train.py:108-124`).

One checkpoint per epoch under `<ckpt_dir>/<task>/<task>_<epoch>`: a
`torch.save` file in the reference's layout {epoch, model: task,
state_dict, perf, optimizer}, with the params as an OpenAI-named state dict
(`models/convert.py::state_dict_from_params`), so the JAX package's
`import_initial_checkpoint` and reference tooling read it, plus `step` and
`mid_epoch`. The same meta sits in a `<path>.meta.json` sidecar, readable
without loading the tensors. A mid-epoch save (`save_steps`, `max_steps`,
SIGTERM) overwrites the epoch's file: the latest state is what a resume
wants. Every write is synchronous; the JAX package's orbax directories are
not read (ROADMAP A9: not to do, orbax imports JAX). Under data
parallelism the save is collective: every rank calls it, rank 0 (whose
state every rank shares) writes the file and the meta, and every rank
waits at a barrier until the write is done; a resume loads the file on
every rank. A ZeRO-1, FSDP, tensor-parallel or pipeline state
(`parallel/sharding.py`, `parallel/pipeline.py`; the data level, then the
model level below it) is gathered first, on every rank (a tp state with
its head-group reorder inverted, a pp state's stages laid back in layer
order), so its file is the one an unsharded run writes: the full params
and optimizer trees. A resume loads the full state and the
train loop shards it again (`train.py`), so a file written at one world,
sharded or not, resumes at any other.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from clip_event_tpu_torch.models.clip import CLIPConfig
from clip_event_tpu_torch.models.convert import (
    load_torch_checkpoint,
    params_from_state_dict,
    state_dict_from_params,
)

log = logging.getLogger(__name__)


def _ckpt_path(ckpt_dir: str, task: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), task, f"{task}_{epoch}")


def _map(fn, tree):
    """`fn` on every leaf of a nested dict (and list) of tensors."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _to_cpu(tree):
    return _map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, tree)


def save_checkpoint(
    ckpt_dir: str,
    task: str,
    epoch: int,
    params: dict,
    opt_state: dict,
    cfg: CLIPConfig,
    perf: float = 0.0,
    step: int = 0,
    mid_epoch: bool = False,
    sharding=None,
) -> Optional[str]:
    """Save the state; errors are logged, not raised (engine.py:215-218).
    Returns the path, or None if the write failed or on a rank other than
    0. The file is written to a temporary name and renamed, so a crash
    mid-write never leaves a path that `latest_checkpoint` would pick up.
    Collective under data parallelism (module docstring); `sharding`: the
    state's layout (`TrainState.sharding`), whose shards every rank
    gathers first."""
    from clip_event_tpu_torch.parallel.collectives import comm

    if sharding is not None:
        from clip_event_tpu_torch.parallel.sharding import gather_trees

        params, opt_state = gather_trees(sharding, params, opt_state)
    out = None
    if comm.is_main_process:
        out = _write(ckpt_dir, task, epoch, params, opt_state, cfg, perf, step, mid_epoch)
    comm.synchronize()
    return out


def _write(ckpt_dir, task, epoch, params, opt_state, cfg, perf, step, mid_epoch) -> Optional[str]:
    path = _ckpt_path(ckpt_dir, task, epoch)
    meta = {
        "epoch": epoch, "model": task, "perf": float(perf), "step": int(step),
        "mid_epoch": bool(mid_epoch),
    }
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        sd = state_dict_from_params(params, cfg)
        obj = {
            **meta,
            # (ascontiguousarray makes 0-d arrays 1-d: keep logit_scale's shape)
            "state_dict": {
                k: torch.from_numpy(np.ascontiguousarray(v).reshape(np.shape(v)))
                for k, v in sd.items()
            },
            "optimizer": _to_cpu(opt_state),
        }
        torch.save(obj, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(path + ".meta.json", "w") as fh:
            json.dump(meta, fh)
        log.info("=> saved checkpoint to %s", path)
        return path
    except (OSError, RuntimeError, ValueError):
        log.exception("=> error when saving checkpoint!")
        return None


def load_meta(path: str) -> dict:
    """Checkpoint metadata {epoch, model, perf, step, mid_epoch} from the
    sidecar, without loading the tensors."""
    meta = {"epoch": 0, "model": "", "perf": 0.0, "step": 0, "mid_epoch": False}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as fh:
            meta.update(json.load(fh))
    return meta


def restore_checkpoint(path: str, device="cpu") -> Tuple[dict, dict, dict, CLIPConfig]:
    """Returns (params, opt_state, meta, CLIPConfig): the params in the
    port's layout and the optimizer state as saved, both on `device`."""
    from clip_event_tpu_torch.models.convert import params_from_jax

    obj = torch.load(path, map_location="cpu", weights_only=False)
    np_params, cfg = params_from_state_dict(obj["state_dict"])
    params = params_from_jax(np_params, cfg, device)
    meta = load_meta(path)
    meta.update({k: obj[k] for k in ("epoch", "perf", "step", "mid_epoch") if k in obj})

    # the optimizer walks its moments leaf by leaf beside the params: give
    # each param-shaped tree the restored params' key order
    opt_state = {k: _ordered_like(v, params) if isinstance(v, dict) else v
                 for k, v in obj["optimizer"].items()}
    return params, _map(lambda t: t.to(device), opt_state), meta, cfg


def _ordered_like(tree, like):
    """`tree` with the dict key order of `like` (the same nesting)."""
    if isinstance(like, dict):
        return {k: _ordered_like(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [_ordered_like(t, v) for t, v in zip(tree, like)]
    return tree


def latest_checkpoint(ckpt_dir: str, task: str) -> Optional[str]:
    base = os.path.join(os.path.abspath(ckpt_dir), task)
    if not os.path.isdir(base):
        return None
    best = None
    for name in os.listdir(base):
        if name.startswith(task + "_") and not name.endswith((".meta.json", ".tmp")):
            try:
                epoch = int(name.rsplit("_", 1)[1])
            except ValueError:
                continue
            if best is None or epoch > best[0]:
                best = (epoch, os.path.join(base, name))
    return best[1] if best else None


def import_initial_checkpoint(path: str) -> Tuple[dict, CLIPConfig]:
    """Torch-world weights (OpenAI JIT archive / state_dict .pth / reference
    training checkpoint) → (numpy params in the JAX layout, inferred
    CLIPConfig)."""
    return params_from_state_dict(load_torch_checkpoint(path))
