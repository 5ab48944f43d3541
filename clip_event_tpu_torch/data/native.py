"""ctypes bindings of the native host-preprocessing library (counterpart of
`clip_event_tpu/data/native.py`).

`clip_event_tpu_torch/native/host_preprocess.cc` is the input hot path in
C++: libjpeg decode, PIL-exact fixed-point bicubic, center crop and CLIP
normalize. ctypes calls release the GIL, so the loader's worker threads
scale across cores.

The library is built from the package's own copy of the source with `g++`
at first use, into `_build/libclip_event_host-<hash>.so` inside the package
(the hash covers the source and the flags, as `ops/_build.py` keys the
kernels), and loaded with ctypes. Nothing is built at import time.

Where libjpeg (its header or library) is missing, the library is built
without it (`-DCE_NO_LIBJPEG`): the JPEG entry points then decode the file
with PIL (its C decoder, which releases the GIL too) and resize, crop and
normalize here, with the same bits, since the JAX package's pins hold PIL's
decode equal to libjpeg's. `jpeg_decoder()` says which decodes, and
`build_error()` why libjpeg was not linked. Where no library builds at all,
every entry point returns None and the caller takes the pure-Python path
(PIL + `data.transform`), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE, "native", "host_preprocess.cc")
BUILD_DIR = os.path.join(_PACKAGE, "_build")
# the JAX package's native/Makefile flags, so both libraries compute alike
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LINK_FLAGS = ("-ljpeg",)

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _flags(jpeg: bool):
    return (*CXX_FLAGS, *(LINK_FLAGS if jpeg else ("-DCE_NO_LIBJPEG",)))


def library_path(jpeg: bool = True) -> str:
    """Where the library built from the package's source with the current
    compiler and flags (with libjpeg, or without it) lives."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    digest.update(" ".join((_cxx(), *_flags(jpeg))).encode())
    return os.path.join(BUILD_DIR, f"libclip_event_host-{digest.hexdigest()[:16]}.so")


def build_library(jpeg: bool = True) -> ctypes.CDLL:
    """The library (with libjpeg, or without it), built first if missing and
    bound. Raises RuntimeError with the compiler's output if the build
    fails, OSError if it does not load."""
    path = library_path(jpeg)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # unique temporary name + atomic rename: concurrent builders never
        # load a half-written library
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_cxx(), SOURCE, "-o", tmp, *_flags(jpeg)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:  # no compiler
            raise RuntimeError(f"{' '.join(cmd)} failed: {exc}") from None
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{(proc.stdout + proc.stderr).strip()}")
        os.replace(tmp, path)
    return _bind(ctypes.CDLL(path))


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, with libjpeg where it
    builds, else without; None if neither builds or loads. Tried once a
    process; `build_error()` keeps the reasons."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        errors = []
        for jpeg in (True, False):
            try:
                _lib = build_library(jpeg)
                break
            except (OSError, RuntimeError, AttributeError) as exc:
                errors.append(f"{type(exc).__name__}: {exc}")
        _error = "\n".join(errors) or None
        if _error:
            log.info("native preprocess: %s", _error)
        return _lib


def build_error() -> Optional[str]:
    """Why the library with libjpeg was not built or loaded (and the one
    without it, where neither was); None where it was, or before
    `get_lib()`."""
    return _error


def jpeg_decoder() -> Optional[str]:
    """"libjpeg" where the library decodes JPEG itself, "PIL" where it was
    built without libjpeg, None where there is no library."""
    lib = get_lib()
    if lib is None:
        return None
    return "libjpeg" if lib.ce_has_libjpeg() else "PIL"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p, f32p, c_int = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_float), ctypes.c_int
    signatures = {
        "ce_has_libjpeg": [],
        "ce_jpeg_dims": [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(c_int), ctypes.POINTER(c_int)],
        "ce_preprocess_jpeg": [ctypes.c_char_p, ctypes.c_size_t, c_int, f32p],
        "ce_preprocess_rgb": [u8p, c_int, c_int, c_int, f32p],
        "ce_resize_bicubic": [u8p, c_int, c_int, c_int, c_int, u8p],
        "ce_preprocess_jpeg_u8": [ctypes.c_char_p, ctypes.c_size_t, c_int, u8p],
        "ce_preprocess_rgb_u8": [u8p, c_int, c_int, c_int, u8p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_int
    return lib


def available() -> bool:
    return get_lib() is not None


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def _rgb(rgb: np.ndarray) -> np.ndarray:
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an RGB uint8 [h, w, 3] image, got shape {rgb.shape}")
    return rgb


def _decode_with_pil(path: str) -> np.ndarray:
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = 933120000
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def preprocess_jpeg_file(path: str, size: int = 224) -> Optional[np.ndarray]:
    """Full native path: JPEG file → float32 [size, size, 3]. None if the
    library is unavailable or libjpeg cannot decode the file to RGB (the
    caller falls back to PIL). A library without libjpeg decodes with PIL."""
    lib = get_lib()
    if lib is None:
        return None
    if not lib.ce_has_libjpeg():
        return preprocess_rgb(_decode_with_pil(path), size)
    with open(path, "rb") as fh:
        data = fh.read()
    out = np.empty((size, size, 3), np.float32)
    rc = lib.ce_preprocess_jpeg(data, len(data), size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def preprocess_rgb(rgb: np.ndarray, size: int = 224) -> Optional[np.ndarray]:
    """Decoded RGB uint8 [h, w, 3] → float32 [size, size, 3]."""
    lib = get_lib()
    if lib is None:
        return None
    rgb = _rgb(rgb)
    out = np.empty((size, size, 3), np.float32)
    rc = lib.ce_preprocess_rgb(_u8(rgb), rgb.shape[0], rgb.shape[1], size,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def preprocess_jpeg_file_u8(path: str, size: int = 224) -> Optional[np.ndarray]:
    """JPEG file → uint8 [size, size, 3] (resize + crop, pre-normalize): the
    bit-exact intermediate the image cache stores. None falls back to the
    pure-Python path (`transform.preprocess_image_u8`). A library without
    libjpeg decodes with PIL."""
    lib = get_lib()
    if lib is None:
        return None
    if not lib.ce_has_libjpeg():
        return preprocess_rgb_u8(_decode_with_pil(path), size)
    with open(path, "rb") as fh:
        data = fh.read()
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.ce_preprocess_jpeg_u8(data, len(data), size, _u8(out))
    return out if rc == 0 else None


def preprocess_rgb_u8(rgb: np.ndarray, size: int = 224) -> Optional[np.ndarray]:
    """Decoded RGB uint8 [h, w, 3] → uint8 [size, size, 3] (pre-normalize)."""
    lib = get_lib()
    if lib is None:
        return None
    rgb = _rgb(rgb)
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.ce_preprocess_rgb_u8(_u8(rgb), rgb.shape[0], rgb.shape[1], size, _u8(out))
    return out if rc == 0 else None


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """PIL-exact BICUBIC resize of an RGB uint8 [h, w, 3] image."""
    lib = get_lib()
    if lib is None:
        return None
    img = _rgb(img)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.ce_resize_bicubic(_u8(img), img.shape[0], img.shape[1], out_h, out_w, _u8(out))
    return out if rc == 0 else None
