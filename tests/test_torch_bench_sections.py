"""The eleven sections of the port's component bench that time the
encoders, the kernels and the plain train step (`python -m
clip_event_tpu_torch.tools.bench_components matmul quantgemm text vision
visionsplit step textsplit textwidth latency quant ot`), each through its
`main` at a tiny size on the CPU: the rows, the printed lines, the JSON
line, the process-wide attention and int8 GEMM choices put back, a shape
no attention kernel takes reported as unsupported (not run on another
path under the kernel's label), and the refusal to run on the card's
default device without a card. A CPU run is a rehearsal of the path: its
times are not named per chip. The callables against the JAX package's
expressions: tests/test_torch_bench_sections_jax.py."""

import json
import math

import pytest
import torch

from clip_event_tpu_torch.models import layers as TL
from clip_event_tpu_torch.ops import quant as TQ
from clip_event_tpu_torch.tools import bench_components as BC

from tests.test_torch_bench import COMPONENT_ARGS, MODEL
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

TOWER = [v for v, _, _ in BC.TOWER_VARIANTS]
QG = ["mm", "int8 plain", "torch._int_mm", "K5", "K5 GEMM alone", "K5 row pass"]
QV = [v for v, _ in BC.QUANT_VARIANTS]
# (case, variant) of every row at MODEL, --batch 2 --layers 1
EXPECTED = {
    "matmul": [(c, "torch.matmul bf16") for c in ("text fc", "text qkv", "vis fc", "peak")],
    "quantgemm": [(c, v) for c in ("vis qkv", "vis fc", "text qkv") for v in QG],
    "text": [("text grad", v) for v in TOWER],
    "vision": [("vision grad", v) for v in TOWER],
    "visionsplit": [("vision stack", v) for v in BC.VISIONSPLIT] + [("vision", "patch embed only")],
    "step": [("step", "train step (plain attention)"), ("step", "train step (kernel attention)")],
    "textsplit": [("text stack", v) for v in BC.TEXTSPLIT],
    "textwidth": [("B=8", "width 16")],
    "latency": [(f"B={b}", v) for v in ("bf16", "int8 static") for b in (1, 8, 64)],
    "quant": [(c, v) for c in ("image B=1", "image B=2", "text B=2", "text B=8") for v in QV],
    "ot": [("B=2 M=16 N=10 E=512", "ipot dist, plain loop"), ("B=2 M=16 N=10 E=512", "ipot dist, K3")],
}
SHAPES = {  # [M, K, N] by case: B·D·16 text rows, B·5 vision rows, the 32·B square; B·16 text rows
    "matmul": {"text fc": [96, 64, 256], "text qkv": [96, 64, 192], "vis fc": [10, 64, 256],
               "peak": [64, 64, 64]},
    "quantgemm": {"vis qkv": [10, 64, 192], "vis fc": [10, 64, 256], "text qkv": [32, 64, 192]},
}


def _run(capsys, argv):
    assert BC.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert len(lines) == len(summary["rows"]) + 1
    assert summary["device"] == {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    # the process-wide choices are put back
    assert TL._resolve_attention() == "kernel" and TQ._GEMM_IMPL == "auto" and TL._resolve_ln() == "xla"
    return lines[:-1], summary["rows"]


def _positive(x):
    return x is not None and math.isfinite(x) and x > 0


@pytest.mark.parametrize("section", list(EXPECTED))
def test_section_rows(capsys, section):
    lines, rows = _run(capsys, [section] + COMPONENT_ARGS)
    assert [(r["case"], r["variant"]) for r in rows] == EXPECTED[section]
    for line, r in zip(lines, rows):
        assert r["section"] == section and _positive(r["ms_per_iter"]), r
        assert line.startswith(f"{r['case']}: {r['variant']}") and "skipped" not in line
    if section in SHAPES:
        assert {r["case"]: r["shape"] for r in rows} == SHAPES[section]
        rate = "tflops" if section == "matmul" else "tera_ops_per_s"
        for r in rows:
            m, k, n = r["shape"]
            if r["variant"] != "K5 row pass":
                assert math.isclose(r[rate], 2 * m * k * n / r["ms_per_iter"] / 1e9, rel_tol=1e-9)
            else:
                assert r[rate] is None
        # the card's peak is not a CPU figure
        assert all(r.get("share_of_h100_bf16_peak") is None for r in rows)
    if section == "step":
        for r in rows:
            assert (r["batch"], r["steps_per_call"], r["calls"]) == (2, 1, BC.CALLS)
            assert math.isclose(r["pairs_per_s"], 6 / r["ms_per_iter"] * 1e3, rel_tol=1e-9)
    if section in ("latency", "quant", "textwidth"):
        for r in rows:
            assert math.isclose(r["items_per_s"], r["rows"] / r["ms_per_iter"] * 1e3, rel_tol=1e-9)
    if section == "latency":
        assert all(_positive(r["host_p50_ms"]) for r in rows)
    if section == "quant":
        bf16 = {r["case"]: r["ms_per_iter"] for r in rows if r["variant"] == "bf16"}
        for r in rows:
            assert math.isclose(r["speedup_vs_bf16"], bf16[r["case"]] / r["ms_per_iter"], rel_tol=1e-9)
    if section in ("text", "vision"):
        assert {(r["rows"], r["S"], r["W"]) for r in rows} == {(6, 16, 64) if section == "text" else (2, 5, 64)}


def test_unsupported_attention_shape_is_reported(capsys):
    """A text tower of head_dim 132 (no kernel takes it): the plain rows
    run, the kernel rows are reported unsupported with the reason."""
    model = json.dumps(dict(json.loads(MODEL), transformer_width=264, transformer_heads=2))
    lines, rows = _run(capsys, ["text", "textsplit", "--device", "cpu", "--model", model,
                                "--batch", "1", "--layers", "1", "--steps", "1"])
    for line, r in zip(lines, rows):
        if "kernel" in r["variant"]:
            assert r["ms_per_iter"] is None and "no attention kernel" in r["unsupported"]
            assert "skipped (no attention kernel" in line
        else:
            assert _positive(r["ms_per_iter"]) and "unsupported" not in r
    assert sum(r["ms_per_iter"] is None for r in rows) == 3 + 2


def test_sections_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for section in EXPECTED:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BC.main([section, "--model", MODEL, "--batch", "2", "--layers", "1", "--steps", "1"])


def test_unroll_has_no_counterpart():
    assert "unroll" not in BC.SECTIONS and set(BC.SECTIONS) == set(BC.BENCHES)
    with pytest.raises(SystemExit):
        BC.main(["unroll"] + COMPONENT_ARGS)
