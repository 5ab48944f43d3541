"""Build and load the hand-written CUDA kernels at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` into
`_build/<name>-<hash>.so` inside the package, then loaded with `ctypes`. The
hash covers the source, every header `csrc/*.cuh` (a source may include
any of them) and the flags, so an edited source or header rebuilds and an
unchanged one is loaded as it is. No PyTorch header is compiled in, which
keeps a build to seconds. Nothing here runs at import time: the CPU suite
imports every module on a machine with no `nvcc`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence, Tuple

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(_PACKAGE, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEADER_SUFFIX = ".cuh"

# name → loaded library / last compiler output (registers, shared memory and
# spills per kernel, from -Xptxas -v)
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}
# (name, symbol) → (library, entry point with its argument types set)
_ENTRIES: Dict[Tuple[str, str], tuple] = {}
_NO_CONTEXT = contextlib.nullcontext()


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
            "kernels are built from source at first use"
        )
    return path


def library_path(name: str) -> str:
    """Where the library built from `csrc/<name>.cu`, the headers beside it
    and the current flags lives."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(HEADER_SUFFIX))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            digest.update(fname.encode() + b"\0" + fh.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, one `nvcc` per
    source, all started together. Returns the seconds each build took (0.0
    for a library that was already there). Raises with the compiler's
    output if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    seconds = {name: 0.0 for name in names}
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib):
            continue
        # unique temporary name + atomic rename: concurrent builders never
        # load a half-written library
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, lib)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(library_path(name))
        lib.clip_cuda_error_string.argtypes = [ctypes.c_int]
        lib.clip_cuda_error_string.restype = ctypes.c_char_p
    return lib


def entry(name: str, symbol: str, argtypes):
    """(library, C entry point `symbol` of `csrc/<name>.cu`) with its
    argument types set: every entry point returns a CUDA error code.
    Resolved once; later calls read it from a table (a wrapper asks on every
    launch)."""
    found = _ENTRIES.get((name, symbol))
    if found is None:
        lib = load(name)
        fn = getattr(lib, symbol)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        found = _ENTRIES[name, symbol] = (lib, fn)
    return found


def on_device(device: torch.device):
    """The context a launch on CUDA `device` needs: `torch.cuda.device` where
    another device is current, else none (entering it costs host time on
    every call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _NO_CONTEXT
    return torch.cuda.device(device)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.clip_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
