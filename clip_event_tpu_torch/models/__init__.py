"""The model package. Its names load on first use (PEP 562), so that a
module needing only `models.clip_config` or `models.convert` (the serving
bundle's loader, `engine/export.py`) does not import the model code."""

import importlib

_EXPORTS = {
    "clip": ("CLIP", "CLIPConfig", "VIT_B16", "VIT_B32", "VIT_L14", "encode_image", "encode_text",
             "forward", "init_params"),
    "convert": ("config_from_state_dict", "params_from_jax", "params_from_state_dict",
                "state_dict_from_params"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
