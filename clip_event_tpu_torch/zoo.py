"""Model-zoo facade of the port (counterpart of `clip_event_tpu/zoo.py`;
reference `clip.py:22-165`).

`load()` accepts a zoo name or a local path: zoo names resolve to the OpenAI
release URLs with SHA256-verified download+cache (requires network egress;
`download` is kept as code, with the JAX package's URLs and check, but has
not been run: neither package's test or chip machine has a network); local
paths go straight through the torch-checkpoint importer
(`engine/checkpoint.py::import_initial_checkpoint`). Returns (params,
CLIPConfig, preprocess_fn): the port's param dict on `device` (the card
unless the caller passes "cpu"), and the bit-exact host transform sized for
the model's input resolution (`data/transform.py::preprocess_image`).
"""

from __future__ import annotations

import hashlib
import logging
import os
import urllib.request
from functools import partial
from typing import Callable, List, Tuple

from clip_event_tpu_torch.models.clip_config import CLIPConfig

log = logging.getLogger(__name__)

# name → (url, expected sha256 = path component) — reference clip.py:22-27
_MODELS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
}


def available_models() -> List[str]:
    return list(_MODELS.keys())


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(name: str, cache_dir: str | None = None) -> str:
    """Fetch + SHA256-verify a zoo checkpoint (reference `_download`)."""
    url = _MODELS[name]
    expected = url.split("/")[-2]
    cache_dir = cache_dir or os.path.expanduser("~/.cache/clip")
    os.makedirs(cache_dir, exist_ok=True)
    target = os.path.join(cache_dir, os.path.basename(url))

    if os.path.isfile(target):
        if _sha256(target) == expected:
            return target
        log.warning("%s exists with bad SHA256; re-downloading", target)
    with urllib.request.urlopen(url) as resp, open(target, "wb") as out:
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            out.write(chunk)
    if _sha256(target) != expected:
        raise RuntimeError("downloaded checkpoint failed SHA256 verification")
    return target


def load(
    name_or_path: str, cache_dir: str | None = None, device="cuda"
) -> Tuple[dict, CLIPConfig, Callable]:
    """Zoo name or local checkpoint path → (params, cfg, preprocess)."""
    from clip_event_tpu_torch.data.transform import preprocess_image
    from clip_event_tpu_torch.engine.checkpoint import import_initial_checkpoint
    from clip_event_tpu_torch.models.convert import params_from_jax

    if name_or_path in _MODELS:
        path = download(name_or_path, cache_dir)
    elif os.path.isfile(name_or_path):
        path = name_or_path
    else:
        raise RuntimeError(
            f"Model {name_or_path} not found; available models = {available_models()}"
        )
    np_params, cfg = import_initial_checkpoint(path)
    params = params_from_jax(np_params, cfg, device)
    return params, cfg, partial(preprocess_image, size=cfg.image_resolution)


def tokenize(texts, context_length: int = 77):
    """Re-export for facade parity (reference `clip.tokenize`)."""
    from clip_event_tpu_torch.tokenizer import tokenize as _tokenize

    return _tokenize(texts, context_length)
