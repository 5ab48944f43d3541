"""The port's preset sweep (`python -m clip_event_tpu_torch.tools.bench_presets`)
at a tiny size on the CPU: the grids and the entry syntax (MODEL:BATCH:REMAT,
the remat map, a JSON model), an entry's row through `main`, a failing
entry reported as FAILED while the sweep goes on, `--fast`'s verdict line
both ok and regressed against a patched `FAST_GRID`, and the refusal to run
on the card's default device without a card. A CPU run is a rehearsal of
the path: its times are not named per chip."""

import json
import math

import pytest
import torch

from clip_event_tpu_torch import bench
from clip_event_tpu_torch.tools import bench_presets as BP

from tests.test_torch_bench import MODEL
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

TINY = json.dumps(dict(json.loads(MODEL), vision_layers=1, transformer_layers=1))
CPU_ARGS = ["--device", "cpu", "--steps", "1", "--calls", "1"]


def _run(capsys, argv):
    assert BP.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def test_grids_and_entries():
    """The JAX tool's 15 default entries and 6 fast entries, and its
    MODEL:BATCH:REMAT syntax; no TPU figure is left in `FAST_GRID`."""
    assert len(BP.DEFAULT_GRID) == 15 and len(set(BP.DEFAULT_GRID)) == 15
    assert list(BP.FAST_GRID) == ["ViT-B/32:384:1", "ViT-B/16:96:attn", "ViT-L/14:64:attn", "RN50:128:1",
                                  "RN101:128:attn", "RN50x4:128:1"]
    tpu = {3312.0, 1859.0, 519.0, 2929.0, 2575.0, 1309.0}  # the JAX tool's figures
    assert all(isinstance(v, float) and v > 0 and v not in tpu for v in BP.FAST_GRID.values())
    assert BP.FAST_TOLERANCE == 0.05 and (BP.STEPS_PER_CALL, BP.MEASURE_CALLS) == (10, 3)
    for entry in BP.DEFAULT_GRID + list(BP.FAST_GRID):
        model, batch, remat = BP.parse_entry(entry)
        assert model in bench.DEFAULT_BATCH and batch > 0 and remat in ("1", "attn", "dots_nobatch")
    assert BP.parse_entry("ViT-L/14:64:dots_nobatch") == ("ViT-L/14", 64, "dots_nobatch")
    model, batch, remat = BP.parse_entry(f"{TINY}:3:0")
    assert model == json.loads(TINY) and (batch, remat) == (3, "0")
    # the remat map: 0 off, 1 full, a policy by name
    assert [bench.remat_setting(r) for r in ("0", "1", "attn", "dots", "dots_nobatch")] == \
        [False, True, "attn", "dots", "dots_nobatch"]
    for bad in ("ViT-B/32:384", "ViT-B/32:many:1", "ViT-B/32:384:offload"):
        with pytest.raises(ValueError, match="entry"):
            BP.parse_entry(bad)
    with pytest.raises(SystemExit):
        BP.main(["ViT-B/32:384:offload", "--device", "cpu"])


def test_cpu_entries_and_a_failing_one(capsys):
    """Two entries on the tiny model (full remat and "attn") and one whose
    model raises: a row each, the failing one with its error, in order."""
    bad = json.dumps(dict(json.loads(TINY), vision_width=60))  # no head count divides 60 / 64
    lines, out = _run(capsys, [f"{TINY}:2:1", f"{bad}:2:1", f"{TINY}:3:attn"] + CPU_ARGS)
    rows = out["rows"]
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    assert "ok" not in out and len(lines) == 3
    assert [(r["model"], r["batch"], r["remat"]) for r in rows] == [("custom", 2, "1"), ("custom", 2, "1"),
                                                                    ("custom", 3, "attn")]
    for i in (0, 2):
        r = rows[i]
        assert "error" not in r and math.isfinite(r["loss"]) and (r["steps_per_call"], r["calls"]) == (1, 1)
        assert r["step_ms"] > 0 and math.isclose(r["pairs_per_s"], r["batch"] * 3 / r["step_ms"] * 1e3)
        assert set(r["launches_per_step"].values()) == {0}  # no kernel on the CPU
        assert lines[i].startswith(f"custom    B={r['batch']:<4d} remat={r['remat']}") and "pairs/s" in lines[i]
    assert rows[1]["error"].split(":")[0].endswith("Error") and "step_ms" not in rows[1]
    assert "FAILED: " + rows[1]["error"] in lines[1]


@pytest.mark.parametrize("expected,ok", [(1.0, True), (1e9, False)])
def test_fast_verdict(capsys, monkeypatch, expected, ok):
    """`--fast` runs FAST_GRID with one call an entry and prints the
    verdict in the one JSON line: an entry below (1 - FAST_TOLERANCE) of
    its figure is regressed, and so is one that did not run."""
    missing = "ViT-B/32:384:1"
    grid = {f"{TINY}:2:1": expected, f"{TINY}:2:attn": expected}
    monkeypatch.setattr(BP, "FAST_GRID", grid)
    lines, out = _run(capsys, ["--fast", "--device", "cpu", "--steps", "1"])
    assert [r["calls"] for r in out["rows"]] == [1, 1] and len(lines) == 2
    assert out["expected"] == grid and out["tolerance"] == BP.FAST_TOLERANCE and out["ok"] is ok
    assert set(out["fast_presets"]) == set(grid) and all(v > 0 for v in out["fast_presets"].values())
    assert set(out["regressed"]) == (set() if ok else set(grid))
    for e, r in out["regressed"].items():
        assert r == {"got": next(x["pairs_per_s"] for x in out["rows"] if x["entry"] == e), "expected": 1e9}
    # an entry of the fast grid that did not run is regressed
    verdict = BP.verdict(out["rows"], dict(grid, **{missing: 10.0}))
    assert verdict["regressed"][missing] == {"got": None, "expected": 10.0} and not verdict["ok"]


def test_presets_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BP.main([f"{TINY}:2:1", "--steps", "1", "--calls", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BP.main(["--fast"])
