"""The seventeen sections of the port's component bench that time the
encoders, the kernels, the train step, its branches and the engine
(`python -m clip_event_tpu_torch.tools.bench_components matmul quantgemm
text vision visionsplit step textsplit textwidth latency quant ot
alignment multiattention dedupe accum ckpt moments`), each through its
`main` at a tiny size on the CPU: the rows, the printed lines, the JSON
line, the process-wide attention and int8 GEMM choices put back, a shape
no attention kernel takes reported as unsupported (not run on another
path under the kernel's label), a branch step that raises reported as
FAILED with its error, the section flags, and the refusal to run on the
card's default device without a card. A CPU run is a rehearsal of the
path: its times are not named per chip. The callables against the JAX
package's expressions: tests/test_torch_bench_sections_jax.py and
tests/test_torch_bench_engine_jax.py."""

import json
import math
import os
import tempfile

import pytest
import torch

from clip_event_tpu_torch.models import layers as TL
from clip_event_tpu_torch.engine.optim import tree_leaves
from clip_event_tpu_torch.ops import quant as TQ
from clip_event_tpu_torch.parallel.sharding import tree_bytes
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
    "alignment": [("B=2 N=11 M=16", "align step (kernel attention)")],
    "multiattention": [("B=2 R=8", f"multiattn step ({m})") for m in ("desc", "desc_type")],
    "dedupe": [("B=2 D=3", "step plain")] + [("B=2 D=3", f"step deduped (U={u} of 6)") for u in (96, 192, 384)]
    + [(f"multiattn {m} R=8", v) for m in ("desc", "desc_type")
       for v in ("plain", "sr-deduped (U=64)", "all-deduped")],
    "accum": [("B=2", "single step"), ("B=2", "accum K=2 (eff 4)"), ("B=2", "accum K=4 (eff 8)")],
    "ckpt": [("save", "sync save"), ("save", "async save")],
    "moments": [("adam", "moments=None"), ("adam", "moments=bfloat16")],
}
BRANCH = ("alignment", "multiattention", "dedupe")
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
def test_section_rows(capsys, monkeypatch, tmp_path, section):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # where ckpt writes
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
    if section in BRANCH:
        for r in rows:  # --steps 1: one step a call, the branch steps' two timed calls
            assert (r["batch"], r["steps_per_call"], r["calls"], r["peak_gib"]) == (2, 1, BC.BRANCH_CALLS, None)
            assert math.isclose(r["pairs_per_s"], 6 / r["ms_per_iter"] * 1e3, rel_tol=1e-9)
    if section == "alignment":
        assert (rows[0]["objects"], rows[0]["entities"], rows[0]["chunks"]) == (11, 16, 4)
    if section == "accum":
        single = rows[0]["ms_per_iter"]
        assert [(r["microbatches"], r["calls"]) for r in rows] == [(1, BC.CALLS), (2, 4), (4, 4)]
        for r in rows[1:]:
            assert math.isclose(r["pct_vs_single"], r["ms_per_iter"] / single * 100 - 100, rel_tol=1e-9)
    if section == "ckpt":
        mcfg = BC._with_layers(BC.model_config({"model": json.loads(MODEL)}), 1)
        state = BC.step_call(mcfg, BC._params(mcfg, "cpu"), BC.step_batch(mcfg, 2, "cpu"), "kernel", 1).state[0]
        for r in rows:
            assert r["total_ms"] > r["ms_per_iter"] and r["steps"] == 1
            assert r["state_gb"] == tree_bytes(state.params, state.opt_state) / 1e9
        assert os.listdir(tmp_path) == []  # the checkpoints' directory is removed
    if section == "moments":
        n = sum(p.numel() for p in tree_leaves(BC._params(
            BC._with_layers(BC.model_config({"model": json.loads(MODEL)}), 1), "cpu")))
        # the count, fp32 nu, and mu in fp32 or bf16
        assert [r["opt_state_mb"] for r in rows] == [(4 + 8 * n) / 1e6, (4 + 6 * n) / 1e6]


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


def test_section_flags_and_a_failed_branch_step(capsys, monkeypatch):
    """`--objects`, `--align-chunks`, `--bboxes`, `--dedupe-unique` and
    `--calls` reach their sections; an alignment step that raises (as out
    of memory at `--objects 51` would) gives a FAILED row with its error,
    and the next section runs."""
    lines, rows = _run(capsys, ["alignment", "dedupe", "accum", "--objects", "3", "--align-chunks", "2",
                                "--bboxes", "2", "--dedupe-unique", "8", "--calls", "1"] + COMPONENT_ARGS)
    assert [(r["case"], r["variant"]) for r in rows] == [
        ("B=2 N=3 M=16", "align step (kernel attention)"), ("B=2 D=3", "step plain"),
        ("B=2 D=3", "step deduped (U=8 of 6)")] + [
        (f"multiattn {m} R=2", v) for m in ("desc", "desc_type") for v in ("plain", "sr-deduped (U=64)", "all-deduped")
    ] + [("B=2", "single step"), ("B=2", "accum K=2 (eff 4)"), ("B=2", "accum K=4 (eff 8)")]
    assert (rows[0]["objects"], rows[0]["chunks"]) == (3, 2) and all(_positive(r["ms_per_iter"]) for r in rows)
    # one timed call a step row; accum's K-microbatch steps keep their floor of 4
    assert [r["calls"] for r in rows] == [1] * 9 + [1, 4, 4]

    def out_of_memory(*args, **kwargs):
        raise RuntimeError("CUDA out of memory. Tried to allocate 1.00 GiB\nmore detail")

    monkeypatch.setattr(BC, "alignment_call", out_of_memory)
    lines, rows = _run(capsys, ["alignment", "moments"] + COMPONENT_ARGS)
    assert rows[0]["ms_per_iter"] is None
    assert rows[0]["error"] == "RuntimeError: CUDA out of memory. Tried to allocate 1.00 GiB"
    assert lines[0].endswith("FAILED: RuntimeError: CUDA out of memory. Tried to allocate 1.00 GiB")
    assert [r["section"] for r in rows] == ["alignment", "moments", "moments"]
    assert all(_positive(r["ms_per_iter"]) for r in rows[1:])


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
