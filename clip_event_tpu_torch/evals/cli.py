"""Shared CLI plumbing for the port's eval entry points (counterpart of
`clip_event_tpu/evals/cli.py`).

The CLIs serve in float32, as the JAX CLI does. On the card every block of
both towers runs the hand-written attention kernel, unless the config says
`"use_pallas_attention": false` (default true, the JAX CLI's key): then
every encoder call of the run takes the plain attention, and the
process-wide choice is put back when the run ends. `--device cpu` runs the
plain PyTorch path instead; with no card and no `--device cpu` the CLI
raises.

Launched by `torchrun` (or `mpirun` / `srun`), every process evaluates its
rank's slice of the dataset on `cuda:LOCAL_RANK` (NCCL; gloo with
`--device cpu`), every rank ends with the full-set metrics, and rank 0
prints them and writes `output_json` (`evals/common.py`).

`"quantize": "int8"` serves the dense weights in int8 with dynamic
per-row activation scales; `"int8_static"` adds static scales calibrated
at load time (`calibration_batches_from_cfg`); `"quantize_towers":
["visual"]` (or ["text"]) quantizes one tower only. On the card every
quantized dense layer runs K5 (`ops/quant.py`).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from clip_event_tpu_torch.platform import resolve_device


def build_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cfg", type=str, required=True, help="eval config JSON")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def load_model_from_cfg(cfg: dict, device="cuda"):
    """Returns (CLIP module, CLIPConfig) on `device`, from `ckpt` (a torch /
    OpenAI state-dict file in OpenAI naming) or from the `model` preset with
    weights drawn from `seed` (for smoke runs); int8 when `quantize` says
    so, with `quantize_towers` and the `calibration_*` keys."""
    from clip_event_tpu_torch.config import model_config
    from clip_event_tpu_torch.models.clip import CLIP, init_params
    from clip_event_tpu_torch.models.convert import (
        load_torch_checkpoint,
        params_from_jax,
        params_from_state_dict,
    )

    dev = resolve_device(device)
    quant = cfg.get("quantize")
    if quant and quant not in ("int8", "int8_static"):
        raise ValueError(
            f"quantize={quant!r}; options: 'int8' (dynamic activation scales), "
            "'int8_static' (calibrated static scales)"
        )
    ckpt = cfg.get("ckpt")
    if ckpt:
        if os.path.isdir(ckpt):
            raise NotImplementedError(
                f"{ckpt} is a checkpoint directory (the JAX package's format); "
                "give a torch state-dict file"
            )
        np_params, mcfg = params_from_state_dict(load_torch_checkpoint(ckpt))
        # the state-dict converter yields the JAX package's layout
        params = params_from_jax(np_params, mcfg, dev)
    else:
        logging.warning("no `ckpt` in config — evaluating a randomly initialized model")
        mcfg = model_config(cfg)
        gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
        params = init_params(gen, mcfg, dev)
    if quant:
        from clip_event_tpu_torch.ops.quant import calibrate_act_scales, quantize_params

        act_stats = None
        if quant == "int8_static":
            imgs, toks = calibration_batches_from_cfg(cfg, mcfg)
            act_stats = calibrate_act_scales(params, mcfg, imgs, toks)
        towers = cfg.get("quantize_towers")
        logging.info("quantizing dense weights to int8 (W8A8 inference path%s)",
                     f", towers={towers}" if towers else "")
        params = quantize_params(params, act_stats=act_stats, towers=tuple(towers) if towers else None)
    return CLIP(mcfg, params), mcfg


def calibration_batches_from_cfg(cfg: dict, mcfg):
    """Sample batches for static int8 calibration, the JAX CLI's draws
    (`clip_event_tpu/evals/cli.py:76-157`): real images
    (`calibration_images`, a directory or a list of files, decoded by the
    serving preprocess) and prompts (`calibration_texts`, one per line) when
    the config gives them; else `calibration_batches` (2) batches of
    N(0, 1) images from `np.random.default_rng(seed)` and six fixed prompts
    (synthetic token rows from the same generator for a vocab smaller than
    CLIP's). Batches of min(batch_size, 16). Returns (image_batches,
    token_batches) for `calibrate_act_scales`."""
    import numpy as np

    rng = np.random.default_rng(cfg.get("seed", 0))
    bs = min(int(cfg.get("batch_size", 16)), 16)
    res = mcfg.image_resolution

    src = cfg.get("calibration_images")
    if src:
        from clip_event_tpu_torch.data.common import load_image_file

        files = (
            sorted(os.path.join(src, f) for f in os.listdir(src)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
            if isinstance(src, str) else list(src)
        )
        if not files:
            raise ValueError(f"calibration_images: no images under {src!r}")
        arr = np.stack([load_image_file(f, res) for f in files])
        imgs = [arr[i : i + bs] for i in range(0, len(arr), bs)]
        logging.info("int8 calibration: %d real images from %s", len(arr), src)
    else:
        n = int(cfg.get("calibration_batches", 2))
        imgs = [rng.normal(size=(bs, res, res, 3)).astype(np.float32) for _ in range(n)]
        logging.info("int8 calibration: %d synthetic image batches (pass "
                     "`calibration_images` for real scales)", n)

    texts_src = cfg.get("calibration_texts")
    if texts_src:
        with open(texts_src, encoding="utf-8") as fh:
            prompts = [line.strip() for line in fh if line.strip()]
        if not prompts:
            raise ValueError(f"calibration_texts: {texts_src!r} is empty")
    else:
        prompts = [
            "a photo of a person", "an image of a protest march",
            "soldiers at a military checkpoint", "a meeting of officials",
            "a building on fire after an attack", "a crowd at a rally",
        ]
    if mcfg.vocab_size >= 49408:
        from clip_event_tpu_torch.tokenizer import tokenize

        toks = np.asarray(tokenize(prompts, context_length=mcfg.context_length))
    else:  # reduced-vocab test models: synthetic token rows
        toks = np.zeros((len(prompts), mcfg.context_length), np.int32)
        toks[:, 0] = mcfg.vocab_size - 2
        toks[:, 1:8] = rng.integers(1, mcfg.vocab_size - 2, (len(prompts), 7))
        toks[:, 8] = mcfg.vocab_size - 1
    token_batches = [toks[i : i + bs] for i in range(0, len(toks), bs)]
    return imgs, token_batches


def run(description: str, evaluate) -> None:
    """Parse --cfg/--device, join the process group of a multi-process
    launch, build the model, call `evaluate(cfg, model, mcfg, device)`
    under the attention choice of `use_pallas_attention`; rank 0 prints
    the metrics JSON."""
    import torch.distributed as dist

    from clip_event_tpu_torch.models import layers
    from clip_event_tpu_torch.parallel.collectives import comm
    from clip_event_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    logging.basicConfig(level=logging.INFO)
    args = build_parser(description).parse_args()
    with open(args.cfg) as fh:
        cfg = json.load(fh)
    if int(cfg.get("tp", 1)) > 1:
        raise SystemExit("tp>1 evals are not ported yet (ROADMAP A6(c))")
    if cfg.get("image_cache"):
        logging.warning("image_cache is not ported yet: decoding images live")
    owned = not dist.is_initialized()
    initialize_distributed(args.device)
    device = make_mesh(args.device).device if dist.is_initialized() else args.device
    try:
        model, mcfg = load_model_from_cfg(cfg, device)
        with layers.attention_impl("kernel" if cfg.get("use_pallas_attention", True) else "plain"):
            metrics = evaluate(cfg, model, mcfg, device)
        if comm.is_main_process:
            print(json.dumps(metrics, indent=2))
            out = cfg.get("output_json")
            if out:
                with open(out, "w") as fh:
                    json.dump(metrics, fh, indent=2)
        comm.synchronize()
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
