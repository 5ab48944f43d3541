"""Shared CLI plumbing for the port's eval entry points (counterpart of
`clip_event_tpu/evals/cli.py`).

The CLIs serve in float32, as the JAX CLI does. On the card every block of
both towers runs the hand-written attention kernel. `--device cpu` runs the
plain PyTorch path instead; with no card and no `--device cpu` the CLI
raises.
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
    weights drawn from `seed` (for smoke runs)."""
    from clip_event_tpu_torch.config import model_config
    from clip_event_tpu_torch.models.clip import CLIP, init_params
    from clip_event_tpu_torch.models.convert import (
        load_torch_checkpoint,
        params_from_jax,
        params_from_state_dict,
    )

    dev = resolve_device(device)
    if cfg.get("quantize"):
        raise NotImplementedError("int8 serving (`quantize`) is not ported yet")
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
    return CLIP(mcfg, params), mcfg


def run(description: str, evaluate) -> None:
    """Parse --cfg/--device, build the model, call
    `evaluate(cfg, model, mcfg, device)`, print the metrics JSON."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser(description).parse_args()
    with open(args.cfg) as fh:
        cfg = json.load(fh)
    if int(cfg.get("tp", 1)) > 1:
        raise SystemExit("tp>1 evals are not ported yet (single device only)")
    if cfg.get("image_cache"):
        logging.warning("image_cache is not ported yet: decoding images live")
    model, mcfg = load_model_from_cfg(cfg, args.device)
    metrics = evaluate(cfg, model, mcfg, args.device)
    print(json.dumps(metrics, indent=2))
    out = cfg.get("output_json")
    if out:
        with open(out, "w") as fh:
            json.dump(metrics, fh, indent=2)
