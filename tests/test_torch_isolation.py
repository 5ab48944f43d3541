"""The port stands alone: no file of clip_event_tpu_torch, nor chip_smoke.py,
imports JAX or the JAX package, and importing every module of the port
(the int8 serving path, the zero-shot evals, the LayerNorm kernels' module,
the bench entry point, the component bench, the serving bundle, the
data-parallel layer, the host image path and the description pipeline
among them) leaves JAX out of sys.modules. The port's native preprocessing library is built from the
port's own copy of its C++ source, into the port's build directory, and no
port file names the repo's `native/` directory."""

import ast
import os
import subprocess
import sys
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "clip_event_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "clip_event_tpu"}
# the int8 serving path and the zero-shot evals beside matching
INT8_AND_EVAL_MODULES = {
    f"clip_event_tpu_torch.{m}" for m in (
        "ops.quant", "ops.bbox", "evals.gsr", "evals.m2e2", "evals.vcr", "evals.visualcomet",
        "evals.retrieval", "data.m2e2", "data.vcr", "data.visualcomet", "data.retrieval",
        "eval_m2e2", "eval_vcr", "eval_visualcomet", "eval_retrieval",
    )
}
# the fused LayerNorm kernels, the bench entry point, the component bench
LN_AND_BENCH_MODULES = {
    f"clip_event_tpu_torch.{m}" for m in ("ops.ln", "bench", "tools", "tools.bench_components", "tools.bench_presets")
}
# the serving bundle: the kernels as custom ops, the export, its CLI, and
# the model config its loader reads without the model code
EXPORT_MODULES = {
    f"clip_event_tpu_torch.{m}" for m in ("ops.library", "engine.export", "export_serving",
                                          "models.clip_config")
}
# data parallelism: the cluster adapter, the mesh, the collectives
PARALLEL_MODULES = {
    f"clip_event_tpu_torch.{m}" for m in ("parallel", "parallel.cluster", "parallel.mesh",
                                          "parallel.collectives")
}

# the host image path: the cache, the native decoder, the on-device resize,
# the corpus repair, the imSitu dataset, and their CLIs
IMAGE_PATH_MODULES = {
    f"clip_event_tpu_torch.{m}" for m in ("data.cache", "data.native", "data.device_pipeline",
                                          "data.repair", "data.situation", "cache_images",
                                          "bench_input")
}

# the description pipeline: the ColdStart loader, the CLIP type scorer, the
# templates, the IE runner, the visualization, the zoo, and their CLIs
DESCRIPTION_MODULES = {
    f"clip_event_tpu_torch.{m}" for m in ("preprocess", "preprocess.ke", "preprocess.selection",
                                          "preprocess.templates", "preprocess.ie_pipeline", "zoo",
                                          "tools.visualization", "preprocess_descriptions",
                                          "run_ie_pipeline")
}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    bad = {
        os.path.relpath(f, REPO): sorted(set(_imported_roots(f)) & FORBIDDEN)
        for f in files
    }
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_port_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import clip_event_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "missing = sorted(set(%r) - set(names))\n"
        "assert not missing, missing\n"
        "print(len(names))\n"
    ) % (sorted(FORBIDDEN),
         sorted(INT8_AND_EVAL_MODULES | LN_AND_BENCH_MODULES | EXPORT_MODULES | PARALLEL_MODULES
                | IMAGE_PATH_MODULES | DESCRIPTION_MODULES))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 64


def test_native_library_builds_from_the_ports_own_source():
    from clip_event_tpu_torch.data import native

    for path in (native.SOURCE, native.BUILD_DIR, native.library_path(True), native.library_path(False)):
        assert os.path.commonpath([os.path.abspath(path), PORT]) == PORT, path
    assert os.path.isfile(native.SOURCE) and native.SOURCE.endswith(".cc")
    # nothing of the port reads or loads the JAX package's native/ directory
    # or its prebuilt library
    jax_native = os.path.join(REPO, "native")
    for path in _port_files():
        with open(path) as fh:
            text = fh.read()
        assert "libclip_event_host.so" not in text and jax_native not in text, path
        assert "CLIP_EVENT_NATIVE_DIR" not in text, path
