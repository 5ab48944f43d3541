"""Config-JSON contract of the port's CLIs (counterpart of
`clip_event_tpu/config.py`; reference README.md:151-197).

The same keys, defaults and checks as the JAX package's `validate_config`
(including the original `constrastive_*` spellings). Every key trains
through the port (`_UNPORTED` is empty; a key listed there would raise
`ConfigError` naming its ROADMAP item when set to anything but its
default). `zero` (ZeRO-1: the optimizer's moments sharded over the
data-parallel ranks) and `fsdp` (the params too) take a bool, as in the
JAX package (`parallel/sharding.py`), and compose with every model axis.
`tp` (Megatron tensor parallelism), `sp` (sequence parallelism over the tp
ranks), `pp` and `pp_microbatches` (GPipe over the pp ranks,
`parallel/pipeline.py`) and `dcn_dp` (data-parallel slices) follow the
JAX package's rules and messages (`clip_event_tpu/config.py:233-256`):
pp takes neither tp nor dcn_dp.
`image_cache` names a cache that `data/cache.py` built (the train and eval
CLIs activate it). Data parallelism (A6(a)) needs no key: it follows the
launch (`torchrun`, `mpirun`, `srun`), with `batch_size` per process.
`remat` takes false, true or a policy name of
`models.layers.REMAT_POLICIES`, checked here as the JAX package's
`transformer` checks it. `model` is one of the ViT and ResNet presets or a
`CLIPConfig` dict.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict

from clip_event_tpu_torch.models.clip import (
    RN50,
    RN50X4,
    RN101,
    VIT_B16,
    VIT_B32,
    VIT_L14,
    CLIPConfig,
)
from clip_event_tpu_torch.models.layers import remat_policy

PRESETS = {
    "ViT-B/32": VIT_B32, "ViT-B/16": VIT_B16, "ViT-L/14": VIT_L14,
    "RN50": RN50, "RN101": RN101, "RN50x4": RN50X4,
}

_CHOICES = {
    "constrastive_loss": ("ce", "bce", "kl"),
    "optimizer": ("adam", "sgd"),
    "lr_scheduler": ("cosineannealinglr", "multisteplr", "warmup", "warmupmultisteplr", "none"),
    "log_level": ("info", "debug"),
    "compute_dtype": ("float32", "bfloat16"),
    "moment_dtype": ("float32", "bfloat16"),
}

_REQUIRED = ("task", "constrastive_loss", "batch_size", "lr", "optimizer", "max_epoch")

# the JAX package's defaults table (`clip_event_tpu/config.py:40-211`); see
# there for what each key does
_DEFAULTS: Dict[str, Any] = {
    "constrastive_overbatch": True,
    "alignment": False,
    "alignment_chunks": 4,
    "multiattention": False,
    "posneg_descriptions_json": None,
    "image_caption_json": [],
    "image_dir": [],
    "load_object": False,
    "object_pickle": [],
    "object_ontology_file": None,
    "object_detection_threshold": 0.2,
    "object_topk": 50,
    "load_ie": False,
    "ie_ontology_json": None,
    "input_entities": [],
    "input_events": [],
    "ltf_dir": None,
    "load_sr": False,
    "sync_bn": False,
    "ckpt_dir": "checkpoints",
    "tb_log_dir": "logs",
    "print_freq": 1,
    "log_level": "info",
    "is_train": True,
    "begin_ckpt": None,
    "jit": False,
    "begin_epoch": 0,
    "max_epoch": 30,
    "weight_decay": 0.0,
    "momentum": 0.9,
    "lr_scheduler": "none",
    "lr_steps": [],
    "lr_gamma": 0.1,
    "warmup_epoch": 5,
    "seed": 999,
    "grad_clip_norm": 1.0,
    "model": "ViT-B/32",
    "compute_dtype": "bfloat16",
    "remat": True,
    "use_pallas_ot": "auto",
    # true: the hand-written attention kernels (forward and backward) on the
    # card; false: their plain PyTorch versions
    "use_pallas_attention": True,
    # true: the fused LayerNorm kernels (forward and backward) in every
    # residual block; false: the plain PyTorch LayerNorm
    "use_pallas_ln": False,
    "tp": 1,
    "pp": 1,
    "sp": False,
    "pp_microbatches": 4,
    "dcn_dp": 1,
    "zero": False,
    "fsdp": False,
    "context_cap": 0,
    "length_buckets": [],
    "dedupe_texts": 0,
    "dedupe_sr_texts": 0,
    "moment_dtype": None,
    "num_workers": 8,
    "prefetch": 2,
    "image_cache": None,
    "device_normalize": True,
    "max_objects": None,
    "max_entities": 16,
    "max_events": 8,
    "max_bboxes": 8,
    "multiattention_pooling": "mean",
    "steps_per_epoch_schedule": True,
    "steps_per_dispatch": 1,
    "grad_accum_steps": 1,
    # write the checkpoints on a background thread (engine/checkpoint.py)
    "async_save": False,
    "save_steps": 0,
    "max_steps": 0,
    "validate_every": 0,
    "val_image_caption_json": [],
    "val_image_dir": [],
}

# keys of parts not ported yet: the ROADMAP item that brings each (none:
# every key of the JAX package's config trains through the port)
_UNPORTED: Dict[str, str] = {}


class ConfigError(ValueError):
    pass


def validate_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Fill defaults and enforce the schema. Returns a new dict."""
    out = dict(_DEFAULTS)
    out.update(cfg)

    missing = [k for k in _REQUIRED if k not in out or out[k] is None]
    if missing:
        raise ConfigError(f"missing required config keys: {missing}")

    for key, item in _UNPORTED.items():
        if out[key] not in (_DEFAULTS[key], None, False, 0):
            raise ConfigError(f"{key}={out[key]!r} is not ported yet (ROADMAP {item})")
    try:
        remat_policy(out["remat"])
    except ValueError as err:
        raise ConfigError(str(err)) from None

    for key, choices in _CHOICES.items():
        if out.get(key) is not None and out[key] not in choices:
            raise ConfigError(f"{key}={out[key]!r} not in {choices}")

    if not isinstance(out["batch_size"], int) or out["batch_size"] <= 0:
        raise ConfigError("batch_size must be a positive int")
    # the JAX package's model-parallel rules, with its messages
    if not isinstance(out["tp"], int) or out["tp"] < 1:
        raise ConfigError("tp must be a positive int (1 = data-parallel only)")
    if not isinstance(out["pp"], int) or out["pp"] < 1:
        raise ConfigError("pp must be a positive int (1 = no pipeline parallelism)")
    if out["pp"] > 1 and out["tp"] > 1:
        raise ConfigError(
            "pp>1 and tp>1 are mutually exclusive: pick ONE model-sharding "
            "axis (tp column/row-shards weights, pp layer-shards the stacks)"
        )
    if out["sp"] and out["tp"] <= 1:
        raise ConfigError(
            "sp (sequence parallelism) shards the residual stream over the "
            "tp axis — it requires tp > 1"
        )
    if not isinstance(out["pp_microbatches"], int) or out["pp_microbatches"] < 1:
        raise ConfigError("pp_microbatches must be a positive int")
    if not isinstance(out["dcn_dp"], int) or out["dcn_dp"] < 1:
        raise ConfigError("dcn_dp must be a positive int (1 = single slice)")
    if out["dcn_dp"] > 1 and out["pp"] > 1:
        raise ConfigError(
            "dcn_dp>1 with pp>1 is not supported: the GPipe ppermute "
            "schedule would rotate activations over DCN every microbatch — "
            "keep pipeline stages inside one slice"
        )
    cap = out["context_cap"]
    if not isinstance(cap, int) or cap < 0:
        raise ConfigError("context_cap must be an int ≥ 0 (0 = full context)")
    mspec = out.get("model")
    ctx = mspec.get("context_length", 77) if isinstance(mspec, dict) else 77
    if cap and not 2 <= cap <= ctx:
        raise ConfigError(
            f"context_cap must be in [2, context_length={ctx}] (SOT + EOT need two slots)"
        )
    buckets = out["length_buckets"]
    if not isinstance(buckets, (list, tuple)) or not all(
        isinstance(w, int) and not isinstance(w, bool) for w in buckets
    ):
        raise ConfigError("length_buckets must be a list of ints (widths)")
    if buckets:
        eff = cap or ctx
        if not all(2 <= w < eff for w in buckets):
            raise ConfigError(
                f"length_buckets widths must be in [2, {eff}) — the "
                "effective full width is an implicit final bucket"
            )
        if int(out.get("steps_per_dispatch", 1)) > 1 or out["grad_accum_steps"] > 1:
            raise ConfigError(
                "length_buckets needs one static width per dispatch: "
                "incompatible with steps_per_dispatch>1 / grad_accum_steps>1 "
                "(stacked batches must share a shape)"
            )
    for key in ("dedupe_texts", "dedupe_sr_texts"):
        v = out[key]
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ConfigError(f"{key} must be an int ≥ 0 (0 = off, else the unique-row cap)")
    if out["dedupe_sr_texts"] and not (out["load_sr"] or out["multiattention"]):
        raise ConfigError(
            "dedupe_sr_texts dedupes the bbox text channels: set load_sr=true "
            "or multiattention"
        )
    if not isinstance(out["zero"], bool):
        raise ConfigError("zero must be a bool (ZeRO-1 moment sharding)")
    if not isinstance(out["fsdp"], bool):
        raise ConfigError("fsdp must be a bool (ZeRO-3 param sharding)")
    if out["begin_epoch"] > out["max_epoch"]:
        raise ConfigError("begin_epoch must be ≤ max_epoch")
    if not isinstance(out["grad_accum_steps"], int) or out["grad_accum_steps"] < 1:
        raise ConfigError("grad_accum_steps must be a positive int")
    if out["grad_accum_steps"] > 1 and int(out.get("steps_per_dispatch", 1)) > 1:
        raise ConfigError(
            "grad_accum_steps>1 and steps_per_dispatch>1 are mutually "
            "exclusive (one accumulates microbatches into one optimizer "
            "step, the other fuses K optimizer steps into one dispatch)"
        )

    loss = out["constrastive_loss"]
    if loss == "bce" and out["constrastive_overbatch"]:
        raise ConfigError("set constrastive_overbatch=false for constrastive_loss='bce'")
    if loss == "kl" and not out["constrastive_overbatch"]:
        raise ConfigError("set constrastive_overbatch=true for constrastive_loss='kl'")
    if out["alignment"] and not (out["load_object"] and out["load_ie"]):
        raise ConfigError(
            "alignment=true requires load_object=true and load_ie=true "
            "(OT aligns detected objects with text entities)"
        )
    if out["load_object"] and not out["object_ontology_file"]:
        raise ConfigError("load_object=true requires object_ontology_file")

    # multiattention: a bool (true → "desc") or one of the contrast modes
    ma = out["multiattention"]
    if ma is True:
        out["multiattention"] = "desc"
    elif ma in (False, None):
        out["multiattention"] = None
    elif ma not in ("desc", "desc_type", "desc_type_text"):
        raise ConfigError(
            "multiattention must be bool or one of desc/desc_type/desc_type_text"
        )
    if out["multiattention"]:
        if not (out["load_sr"] or out["load_object"]):
            raise ConfigError(
                "multiattention needs a bbox channel: set load_sr=true or load_object=true"
            )
        # the loss reads the bbox channel, which the dataset emits under
        # load_sr (from the detections load_object reads too)
        if not out["load_sr"]:
            if "load_sr" in cfg and cfg["load_sr"] in (False, 0):
                raise ConfigError(
                    "multiattention requires the bbox channel: load_sr was "
                    "explicitly false — remove it or set load_sr=true"
                )
            logging.getLogger(__name__).warning(
                "multiattention set: enabling load_sr=true (bbox channel)"
            )
            out["load_sr"] = True
    if out["multiattention_pooling"] not in ("mean", "attention"):
        raise ConfigError("multiattention_pooling must be 'mean' or 'attention'")
    return out


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return validate_config(json.load(fh))


def model_config(cfg: Dict[str, Any]) -> CLIPConfig:
    """Resolve the model spec: a preset name or an explicit dict."""
    spec = cfg.get("model", "ViT-B/32")
    if isinstance(spec, str):
        if spec not in PRESETS:
            raise ConfigError(f"unknown model preset {spec!r}; options: {list(PRESETS)}")
        return PRESETS[spec]
    if isinstance(spec, dict):
        vl = spec.get("vision_layers")
        if isinstance(vl, list):
            spec = dict(spec, vision_layers=tuple(vl))
        return CLIPConfig(**spec)
    raise ConfigError("model must be a preset name or a CLIPConfig dict")
