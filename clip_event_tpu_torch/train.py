"""CLIP-Event training entry point of the port (counterpart of `train.py`):

    python -m clip_event_tpu_torch.train --cfg config.json [--device cpu]
    torchrun --nproc_per_node N -m clip_event_tpu_torch.train --cfg config.json

The config is the JAX CLI's (`config.py`). It trains from a random init
(`seed`), from an OpenAI / reference `.pth` (`jit: true` + `begin_ckpt`), or
resumes a checkpoint of this port (`begin_ckpt`), mid-epoch resumes
included. Any model of `config.py` (the ViT and ResNet presets or a model
dict; `sync_bn` takes the ResNet tower's BatchNorm statistics from the
batch), the OT alignment and local-attention (`multiattention`, with the
SR/bbox data channel) branches, length buckets, dedupe-encode, gradient
accumulation, K steps a dispatch (`steps_per_dispatch`: a CUDA graph of
the step on the card), the remat policies, `max_steps`, `save_steps`,
`use_pallas_ln`, the offline image cache (`image_cache`), the SIGTERM
checkpoint, the NaN abort with its `nan_debug_step*.json` artifact and
per-epoch zero-shot matching validation work as in the JAX CLI;
`config.json` and `scalars.jsonl` are written beside the logs. The default
device is the card; with no card and no `--device cpu` the CLI raises.

Data parallel: launched by `torchrun` (or `mpirun` / `srun`), one process
per GPU joins an NCCL group (`parallel/mesh.py`; gloo with `--device cpu`)
on `cuda:LOCAL_RANK`, and `batch_size` is per process, as in the JAX CLI
(one JAX process of a 4-chip host drives its 4 chips; here 4 processes
run). Each rank loads its rank-strided rows with the rank-offset label
layout, every rank starts from rank 0's state, and the step's loss,
gradients and metrics are the global batch's (`engine/train_step.py`).
Rank 0 writes the logs' scalars, `config.json` and the checkpoints (every
rank waits at the save); a SIGTERM on any rank stops every rank at the
same step boundary; the meters are synced at each epoch's end, and the
validation is sharded by rank. `zero` (ZeRO-1) shards Adam's moments over
the ranks and `fsdp` the params too (`parallel/sharding.py`), after any
resume, as in the JAX CLI; they need a launch (`torchrun`, a world of one
included, which runs the sharded code with one shard) and refuse a plain
process. The checkpoints hold the full state, gathered, and the
validation reads the full params.

Tensor, sequence and multi-slice data parallelism (`tp`, `sp`, `dcn_dp`):
the launch's ranks form a (dcn × dp × tp) mesh (`parallel/mesh.py`), tp
innermost; every rank builds the full state (from the seed, or restored:
a file of any tp resumes at any other) and keeps its tp rank's Megatron
slices of the transformer stacks (`parallel.sharding.shard_state_tp`); a
tp group loads the same rows (its data rank, `mesh.data`), and
`batch_size` is per data rank. `sp` shards the stacks' residual stream
over the sequence; `dcn_dp` splits the data ranks into slices (the mesh's
coordinates; the gradient sum stays one all-reduce over the data group).
They need a launch, and refuse a plain
process.

Pipeline parallelism (`pp`, `pp_microbatches`): the launch's ranks form a
(dp × pp) mesh, pp innermost (`parallel/mesh.py`); every rank builds the
full state and keeps its stage (`parallel.pipeline.shard_state_pp`: L/pp
layers of each stack whose depth divides pp, every other leaf whole), a
pp group loads the same rows, and the stacks run the GPipe schedule over
the pp group (`layers.set_pipeline`, for the length of the run), the
per-epoch validation too (on each rank's stage, the data ranks' slices of
the set). pp needs a launch of dp · pp ranks and refuses a plain process.
`zero` / `fsdp` compose with tp, dcn_dp and pp: they shard each rank's
own leaves (its tp slices, its stage) over its data group (within its
slice under dcn).

`train(...)` is the epoch loop (loader → prefetch → step → metrics) over
any `ExampleDataset`; `main` builds the VOA dataset and calls it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import logging
import os
import pprint
import signal
import sys
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from clip_event_tpu_torch.config import load_config, model_config
from clip_event_tpu_torch.data.common import DataLoader
from clip_event_tpu_torch.data.prefetch import device_prefetch
from clip_event_tpu_torch.engine.checkpoint import save_checkpoint
from clip_event_tpu_torch.engine.metrics import MetricLogger, ScalarWriter, create_logger
from clip_event_tpu_torch.engine.optim import build_optimizer, build_schedule
from clip_event_tpu_torch.engine.train_step import (
    TrainState,
    create_train_state,
    make_accum_step,
    make_multi_step,
    make_train_step,
)
from clip_event_tpu_torch.models import layers, resnet
from clip_event_tpu_torch.models.clip import CLIPConfig
from clip_event_tpu_torch.parallel.collectives import any_rank, comm
from clip_event_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_mesh,
    replicate,
)
from clip_event_tpu_torch.parallel.pipeline import shard_state_pp
from clip_event_tpu_torch.parallel.sharding import (
    check_tp_kernels,
    full_params,
    local_params,
    shard_state,
    shard_state_tp,
)
from clip_event_tpu_torch.platform import resolve_device

log = logging.getLogger(__name__)


def train(
    cfg: dict,
    mcfg: CLIPConfig,
    dataset,
    params: dict,
    device="cuda",
    opt_state: Optional[dict] = None,
    resume_step: int = 0,
    begin_epoch: Optional[int] = None,
    mid_epoch_resume: bool = False,
    best_perf: float = 0.0,
    writer: Optional[ScalarWriter] = None,
    on_step: Optional[Callable[[int, dict], None]] = None,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """Run the epochs `begin_epoch .. max_epoch` of a validated config over
    `dataset`, from `params` (and a restored `opt_state` at `resume_step`).
    `on_step(global_step, metrics)` is called after each optimizer step is
    dispatched (with `steps_per_dispatch` K, K times after each dispatch),
    with the metrics still on the device. Returns the final state.

    With a data-parallel `mesh` every rank calls it with its own `dataset`
    (built with its `dist_rank` / `dist_world`) on `mesh.device`, and
    `writer` only on rank 0. Under `zero` / `fsdp` the returned state is
    this rank's sharded one (`parallel.sharding.gather_state` gives the
    full one)."""
    device = resolve_device(device)
    task, ckpt_dir = cfg["task"], cfg["ckpt_dir"]
    # the loader's place: the data rank (a tp group loads the same rows)
    rank, world = (mesh.data.rank, mesh.data.world_size) if mesh is not None else (0, 1)
    begin_epoch = cfg["begin_epoch"] if begin_epoch is None else begin_epoch
    loader = DataLoader(
        dataset, batch_size=cfg["batch_size"], shuffle=cfg["is_train"], seed=cfg["seed"],
        drop_last=cfg["is_train"], num_workers=cfg["num_workers"], prefetch=cfg["prefetch"],
        rank=rank, world_size=world,
        bucket_widths=(list(cfg["length_buckets"]) if cfg["is_train"] else None) or None,
    )
    grad_accum = max(int(cfg["grad_accum_steps"]), 1)
    if cfg["is_train"] and len(loader) < grad_accum:
        raise SystemExit(
            f"grad_accum_steps={grad_accum} > batches per epoch ({len(loader)}): "
            "every epoch would run ZERO optimizer steps"
        )
    steps_per_epoch = max(len(loader) // grad_accum, 1)

    schedule = build_schedule(
        cfg["lr_scheduler"], cfg["lr"], cfg["max_epoch"], begin_epoch=begin_epoch,
        steps_per_epoch=1 if cfg["steps_per_epoch_schedule"] else steps_per_epoch,
        lr_steps=cfg["lr_steps"], lr_gamma=cfg["lr_gamma"], warmup_epochs=cfg["warmup_epoch"],
    )
    optimizer = build_optimizer(
        cfg["optimizer"], schedule, weight_decay=cfg["weight_decay"],
        momentum=cfg["momentum"], grad_clip_norm=cfg["grad_clip_norm"],
        moment_dtype=cfg["moment_dtype"],
    )
    step_kwargs = dict(
        loss_type=cfg["constrastive_loss"], overbatch=cfg["constrastive_overbatch"],
        compute_dtype=torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32,
        remat=cfg["remat"], impl="kernel" if cfg["use_pallas_attention"] else "plain",
        alignment=cfg["alignment"], alignment_chunks=cfg["alignment_chunks"],
        use_pallas_ot=cfg["use_pallas_ot"], multiattention=cfg["multiattention"],
        multiattention_pooling=cfg["multiattention_pooling"], mesh=mesh,
    )
    state = create_train_state(params, optimizer)
    if opt_state is not None:
        state = state._replace(opt_state=opt_state, step=resume_step)
    if mesh is not None:
        # every rank starts from rank 0's params and optimizer state
        replicate(state.params, mesh)
        replicate(state.opt_state, mesh)
    if mesh is not None and mesh.tp > 1:
        if step_kwargs["impl"] == "kernel":
            check_tp_kernels(mcfg, mesh.tp, int(cfg["context_cap"]) or None)
        # the tp rank's Megatron slices of the full state (fresh or
        # restored: after the placement above)
        state = shard_state_tp(state, mcfg, mesh)
    if mesh is not None and mesh.pp > 1:
        # the rank's pipeline stage of the full state (fresh or restored)
        state = shard_state_pp(state, mesh)
    if cfg["zero"] or cfg["fsdp"]:
        if mesh is None:
            raise SystemExit(
                "zero / fsdp shard the state over the data-parallel ranks: launch with "
                "torchrun (or mpirun / srun; a world of one runs the sharded code)"
            )
        # ZeRO-1 shards the moments, FSDP the params too (fresh or
        # restored: after the resume placement above), of the rank's own
        # leaves under tp or pp
        state = shard_state(state, mesh, "fsdp" if cfg["fsdp"] else "zero")
    steps_per_dispatch = max(int(cfg["steps_per_dispatch"]), 1)
    if steps_per_dispatch > 1:
        # K optimizer steps in one dispatch: on the card a CUDA graph of the
        # step, replayed K times over a stack of K loader batches
        multi_step, _ = make_multi_step(mcfg, optimizer, steps_per_dispatch, **step_kwargs)
    elif grad_accum > 1:
        accum_step = make_accum_step(mcfg, optimizer, grad_accum, **step_kwargs)
    else:
        train_step = make_train_step(mcfg, optimizer, **step_kwargs)
    # loader batches stacked into one dispatch: K steps, or K microbatches
    # of one step; a trailing partial stack is dropped, as in the JAX CLI
    group = steps_per_dispatch if steps_per_dispatch > 1 else grad_accum

    global_step = resume_step
    resume_in_epoch = 0
    if mid_epoch_resume and cfg["is_train"]:
        # optimizer steps per epoch are uniform (drop_last), so the in-epoch
        # offset follows from the global step; the loader skips grad_accum
        # microbatches per optimizer step
        resume_in_epoch = min(max(resume_step - begin_epoch * steps_per_epoch, 0), steps_per_epoch)
        if resume_in_epoch:
            log.info("=> mid-epoch resume: epoch %d restarts at batch %d/%d",
                     begin_epoch, resume_in_epoch, steps_per_epoch)
    save_steps = max(int(cfg["save_steps"]), 0)
    max_steps = max(int(cfg["max_steps"]), 0)
    next_save = ((global_step // save_steps) + 1) * save_steps if save_steps else None
    stop_training = False

    # preemption: the handler only sets a flag; the checkpoint is written at
    # the next optimizer-step boundary, then the run stops
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True
        log.warning("=> SIGTERM: checkpointing at the next step boundary, then exiting")

    old_handler = signal.signal(signal.SIGTERM, on_sigterm) if cfg["is_train"] else None
    # the fused LayerNorm kernels (K4) in every residual block for the length
    # of this run; the process-wide choice is put back when the loop returns,
    # so one process can run both settings
    old_ln = layers._resolve_ln()
    if cfg["use_pallas_ln"]:
        layers.set_ln_impl("pallas")
    # sync_bn: the ResNet tower's BatchNorm takes the global batch's
    # statistics (over the mesh's ranks) for the length of this run
    old_bn = (resnet.get_bn_mode(), resnet.get_bn_mesh())
    if cfg["sync_bn"] and not mcfg.is_vit:
        resnet.set_bn_mode("batch", None if mesh is None else mesh.data)
    # pp: the stacks' stages run the GPipe schedule for the length of this
    # run (JAX's process-wide `set_pipeline`), put back after
    scoped = contextlib.ExitStack()
    if mesh is not None and mesh.pp > 1:
        scoped.enter_context(layers.pipeline(mesh, int(cfg["pp_microbatches"])))
    try:
        for epoch in range(begin_epoch, cfg["max_epoch"]):
            log.info("=> Epoch[%d]: train start", epoch)
            loader.set_epoch(
                epoch, start_batch=resume_in_epoch * grad_accum if epoch == begin_epoch else 0
            )
            metric_logger = MetricLogger()
            start = time.time()
            # metrics stay on the device between prints: reading them every
            # step would sync the host with the card every step
            pending = []
            # the image ids in flight per recent step: enough to re-assemble
            # a batch offline (the loader is deterministic) on a NaN abort
            recent_meta = collections.deque(maxlen=max(cfg["print_freq"], 1) + 2)

            def drain():
                nonlocal pending
                for step_idx, m in pending:
                    if not bool(m["finite"]):
                        values = {k: float(v) for k, v in m.items()}
                        log.error("Loss is not finite, stopping training")
                        log.error(values)
                        debug = {
                            "epoch": epoch, "global_step": step_idx, "metrics": values,
                            "recent_batches": [
                                {"global_step": s, "image_ids": ids} for s, ids in recent_meta
                            ],
                        }
                        path = os.path.join(ckpt_dir, task, f"nan_debug_step{step_idx}_rank{rank}.json")
                        os.makedirs(os.path.dirname(path), exist_ok=True)
                        with open(path, "w") as fh:
                            json.dump(debug, fh, indent=1)
                        log.error("NaN debug artifact written to %s", path)
                        sys.exit(1)
                    scalars = {k: float(v) for k, v in m.items() if k != "finite"}
                    scalars["lr"] = float(schedule(step_idx))
                    metric_logger.update(**scalars)
                pending = []

            def step_hooks() -> bool:
                """save_steps / max_steps / preemption checks; True = stop."""
                nonlocal next_save, stop_training
                hit_max = bool(max_steps) and global_step >= max_steps
                # every rank stops at the same step boundary, for the
                # collective save, when any rank got the signal
                hit_term = any_rank(preempted["flag"])
                if (next_save is not None and global_step >= next_save) or hit_max or hit_term:
                    drain()
                    save_checkpoint(ckpt_dir, task, epoch, state.params, state.opt_state, mcfg,
                                    best_perf, step=global_step, mid_epoch=True,
                                    sharding=state.sharding)
                    log.info("=> step checkpoint at global step %d", global_step)
                    if next_save is not None:
                        while next_save <= global_step:
                            next_save += save_steps
                if hit_max:
                    log.info("=> max_steps=%d reached, stopping", max_steps)
                    stop_training = True
                if hit_term:
                    log.warning("=> preemption checkpoint written, stopping")
                    stop_training = True
                return stop_training

            buffer = []
            for batch, meta in metric_logger.log_every(
                device_prefetch(loader, device, depth=cfg["prefetch"]),
                cfg["print_freq"], header=f"Epoch: [{epoch}]",
            ):
                recent_meta.append(
                    (global_step + len(buffer), [mm.get("image_id") for mm in meta])
                )
                if group > 1:
                    buffer.append(batch)
                    if len(buffer) < group:
                        continue
                    stacked = {k: torch.stack([b[k] for b in buffer]) for k in buffer[0]}
                    buffer = []
                    if steps_per_dispatch > 1:
                        state, metrics_k = multi_step(state, stacked)
                        dispatched = [{k: v[j] for k, v in metrics_k.items()}
                                      for j in range(steps_per_dispatch)]
                    else:
                        state, metrics = accum_step(state, stacked)
                        dispatched = [metrics]
                else:
                    state, metrics = train_step(state, batch)
                    dispatched = [metrics]
                for metrics in dispatched:
                    pending.append((global_step, metrics))
                    if on_step is not None:
                        on_step(global_step, metrics)
                    global_step += 1
                if len(pending) >= max(cfg["print_freq"], 1):
                    drain()
                if step_hooks():
                    break
            drain()
            # the host-side meters differ by rank: their global stats
            metric_logger.synchronize_between_processes()
            log.info("=> Epoch[%d]: train end, duration: %.2fs", epoch, time.time() - start)
            if stop_training:
                break  # the step checkpoint is written; no end-of-epoch save

            if writer is not None:
                writer.add_scalar("train_loss", metric_logger.loss.global_avg, epoch)
                for name, meter in metric_logger.meters.items():
                    if name.startswith("loss_"):
                        writer.add_scalar(name, meter.global_avg, epoch)

            if (
                cfg["validate_every"]
                and (epoch + 1) % cfg["validate_every"] == 0
                and cfg["val_image_caption_json"]
            ):
                from clip_event_tpu_torch.data.voa import VOACaptionDataset
                from clip_event_tpu_torch.evals.matching import evaluate_matching

                val_ds = VOACaptionDataset(
                    cfg["val_image_caption_json"], cfg["val_image_dir"],
                    image_size=mcfg.image_resolution,
                )
                # the validation encodes with the step's attention choice,
                # each rank its slice (evals/common.py::resolve_shard);
                # under pp through the pipeline, on the rank's stage, each
                # pp group one data rank's slice
                shard = {}
                val_params = None
                if mesh is not None and mesh.pp > 1:
                    shard = {"rank": mesh.data.rank, "world_size": mesh.data.world_size}
                    val_params = local_params(state)
                with layers.attention_impl(step_kwargs["impl"]):
                    val = evaluate_matching(full_params(state) if val_params is None else val_params,
                                            mcfg, val_ds, batch_size=cfg["batch_size"], device=device,
                                            **shard)
                best_perf = max(best_perf, val["i2t_top1"])
                log.info("=> Epoch[%d] validation: %s (best %.4f)", epoch, val, best_perf)
                if writer is not None:
                    writer.add_scalar("val_i2t_top1", val["i2t_top1"], epoch)

            save_checkpoint(ckpt_dir, task, epoch, state.params, state.opt_state, mcfg,
                            best_perf, step=state.step, sharding=state.sharding)
    finally:
        layers.set_ln_impl(old_ln)
        resnet.set_bn_mode(*old_bn)
        scoped.close()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
    return state


def initial_state(cfg: dict, device="cuda"):
    """Where a run starts, from a validated config: (params, CLIPConfig,
    the resume keywords of `train`). A random init from `seed`, an OpenAI /
    reference `.pth` (`jit` + `begin_ckpt`), or a checkpoint of this port
    (`begin_ckpt`), whose params, optimizer state, step and epoch it
    restores."""
    from clip_event_tpu_torch.engine.checkpoint import import_initial_checkpoint, restore_checkpoint
    from clip_event_tpu_torch.models.clip import init_params
    from clip_event_tpu_torch.models.convert import params_from_jax

    device = resolve_device(device)
    resume = {"begin_epoch": cfg["begin_epoch"]}
    if cfg["jit"]:
        np_params, mcfg = import_initial_checkpoint(cfg["begin_ckpt"])
        log.info("=> imported torch checkpoint %s (%s)", cfg["begin_ckpt"], mcfg)
        return params_from_jax(np_params, mcfg, device), mcfg, resume
    if cfg["begin_ckpt"] and os.path.exists(str(cfg["begin_ckpt"])):
        path = str(cfg["begin_ckpt"])
        params, opt_state, meta, mcfg = restore_checkpoint(path, device)
        # a mid-epoch checkpoint re-enters its own epoch at the saved batch
        # offset; an end-of-epoch one starts the next epoch
        mid_epoch = bool(meta.get("mid_epoch", False))
        resume = {
            "opt_state": opt_state,
            "resume_step": int(meta.get("step", 0)),
            "begin_epoch": int(meta.get("epoch", cfg["begin_epoch"]))
            + (1 if cfg["is_train"] and not mid_epoch else 0),
            "mid_epoch_resume": mid_epoch,
            "best_perf": meta.get("perf", 0.0),
        }
        log.info("=> resuming %s (%s)", path,
                 {k: v for k, v in resume.items() if k != "opt_state"})
        return params, mcfg, resume
    if cfg["begin_ckpt"]:
        log.error("=> cannot find checkpoint: %s", cfg["begin_ckpt"])
        sys.exit(1)
    mcfg = model_config(cfg)
    log.info("=> random init (%s)", mcfg)
    return init_params(torch.Generator().manual_seed(int(cfg["seed"])), mcfg, device), mcfg, resume


def build_dataset(cfg: dict, mcfg: CLIPConfig, rank: int = 0, world: int = 1):
    """The VOA fine-tuning dataset a config describes, for data rank `rank`
    of `world` (its label layout and deduped channels). The config's
    `image_cache` is activated first, unless CLIP_EVENT_IMAGE_CACHE names
    one, as in the JAX CLI."""
    from clip_event_tpu_torch.data.voa import VOADescriptionDataset

    if cfg["image_cache"] and not os.environ.get("CLIP_EVENT_IMAGE_CACHE"):
        from clip_event_tpu_torch.data import cache as image_cache

        image_cache.activate(cfg["image_cache"])

    return VOADescriptionDataset(
        posneg_descriptions_json=cfg["posneg_descriptions_json"],
        image_caption_jsons=cfg["image_caption_json"],
        image_dirs=cfg["image_dir"],
        load_object=cfg["load_object"],
        object_pickles=cfg["object_pickle"],
        object_ontology_file=cfg["object_ontology_file"],
        object_detection_threshold=cfg["object_detection_threshold"],
        object_topk=cfg["object_topk"],
        max_objects=cfg["max_objects"],
        load_ie=cfg["load_ie"],
        input_entities=cfg["input_entities"],
        input_events=cfg["input_events"],
        max_entities=cfg["max_entities"],
        max_events=cfg["max_events"],
        load_sr=cfg["load_sr"],
        max_bboxes=cfg["max_bboxes"],
        contrastive_loss=cfg["constrastive_loss"],
        overbatch=cfg["constrastive_overbatch"],
        image_size=mcfg.image_resolution,
        uint8_images=cfg["device_normalize"],
        context_cap=cfg["context_cap"],
        dedupe_texts=cfg["dedupe_texts"],
        dedupe_sr_texts=cfg["dedupe_sr_texts"],
        # an overflow falls back to a differently shaped batch, which a
        # stack of K steps or of accumulated microbatches cannot take:
        # raise there instead
        dedupe_strict=int(cfg["steps_per_dispatch"]) > 1 or int(cfg["grad_accum_steps"]) > 1,
        dist_rank=rank,
        dist_world=world,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train CLIP-Event (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, help="config JSON path")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = load_config(args.cfg)
    # the process group first (torchrun / mpirun / srun; a no-op alone)
    owned = not dist.is_initialized()
    initialize_distributed(args.device)
    tp, dcn, sp, pp = int(cfg["tp"]), int(cfg["dcn_dp"]), bool(cfg["sp"]), int(cfg["pp"])
    if dist.is_initialized():
        mesh = make_mesh(args.device, tp=tp, dcn=dcn, sp=sp, pp=pp)
    elif tp > 1 or dcn > 1 or pp > 1:
        raise SystemExit(
            f"tp={tp} / dcn_dp={dcn} / pp={pp} shard the job over processes, one a GPU: launch "
            "dcn_dp x dp x tp (or dp x pp) ranks with torchrun (or mpirun / srun)")
    else:
        mesh = None
    device = resolve_device(mesh.device if mesh is not None else args.device)
    try:
        _main(cfg, device, mesh)
        # align the ranks before they exit
        comm.synchronize()
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _main(cfg: dict, device: torch.device, mesh: Optional[Mesh]):
    task = cfg["task"]
    rank = comm.rank
    tb_log_dir = os.path.join(cfg["tb_log_dir"], task, "tensorboard")
    log_dir = os.path.join(cfg["tb_log_dir"], task, "log")
    for d in (tb_log_dir, log_dir, os.path.join(cfg["ckpt_dir"], task)):
        os.makedirs(d, exist_ok=True)
    create_logger(task, log_dir, cfg["log_level"], phase="train" if rank == 0 else f"train_rank{rank}")
    if rank == 0:
        log.info("config:\n%s", pprint.pformat(cfg))
        with open(os.path.join(tb_log_dir, "config.json"), "w") as fh:
            json.dump(cfg, fh, indent=2)
    log.info("device: %s (rank %d of %d)",
             torch.cuda.get_device_name(device) if device.type == "cuda" else device, rank, comm.world_size)

    if mesh is not None and (mesh.tp > 1 or mesh.dcn > 1):
        # the JAX CLI's mesh lines (`train.py:278-285, 323`)
        if mesh.tp > 1:
            log.info("mesh: %sdp=%d x tp=%d (Megatron weight sharding)",
                     f"dcn={mesh.dcn} x " if mesh.dcn > 1 else "", mesh.dp, mesh.tp)
        else:
            log.info("mesh: dcn=%d x dp=%d", mesh.dcn, mesh.dp)
        if mesh.sp:
            log.info("SP: residual-stream sequence axis sharded over tp=%d "
                     "(Megatron sequence parallelism)", mesh.tp)
    if mesh is not None and mesh.pp > 1:
        # the JAX CLI's pipeline lines (`train.py:295-319`); each rank
        # holds its own rows, so the attention kernel runs in the stages
        # whatever the batch (JAX falls back to einsum where its global
        # batch does not divide dp)
        log.info("mesh: dp=%d x pp=%d (GPipe layer sharding, M=%d)",
                 mesh.dp, mesh.pp, int(cfg["pp_microbatches"]))
        if mesh.dp > 1 and cfg["use_pallas_attention"]:
            log.info("pp=%d x dp=%d: pipeline stages run on each rank's rows — the fused "
                     "attention kernel stays active on each device's local batch shard",
                     mesh.pp, mesh.dp)
    params, mcfg, resume = initial_state(cfg, device)
    # the loader's rank and the label layout's: the data rank (a tp
    # group's ranks load the same rows)
    data_rank, data_world = (mesh.data.rank, mesh.data.world_size) if mesh is not None else (0, 1)
    for key in ("dedupe_texts", "dedupe_sr_texts"):
        if cfg[key] and cfg[key] % data_world:
            log.warning(
                "%s=%d does not divide the data-parallel degree %d: each rank holds "
                "cap / world unique rows, so the dataset refuses it — pick a multiple of %d",
                key, cfg[key], data_world, data_world,
            )
        elif cfg[key] and data_world > 1:
            log.info("%s=%d: unique rows shard over dp=%d", key, cfg[key], data_world)
    dataset = build_dataset(cfg, mcfg, data_rank, data_world)
    writer = ScalarWriter(tb_log_dir) if rank == 0 else None
    try:
        train(cfg, mcfg, dataset, params, device, writer=writer, mesh=mesh, **resume)
    finally:
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
