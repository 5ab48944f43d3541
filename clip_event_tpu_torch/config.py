"""Model presets for the port's CLIs (counterpart of
`clip_event_tpu/config.py::model_config`; the ResNet presets are not ported
yet)."""

from __future__ import annotations

from typing import Any, Dict

from clip_event_tpu_torch.models.clip import VIT_B16, VIT_B32, VIT_L14, CLIPConfig

PRESETS = {"ViT-B/32": VIT_B32, "ViT-B/16": VIT_B16, "ViT-L/14": VIT_L14}


class ConfigError(ValueError):
    pass


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
