"""The port's bench entry point (`python -m clip_event_tpu_torch.bench`) and
the `ln` and `megakernel` sections of its component bench
(`python -m clip_event_tpu_torch.tools.bench_components`) at a tiny size on
the CPU: the one JSON line and its keys, with the plain LayerNorm and with
`BENCH_LN=pallas` (by flag and by environment), the rows of each section,
and the refusal to run on the card's default device without a card. A CPU
run is a rehearsal of the path: its metric is not named per chip."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from clip_event_tpu_torch import bench
from clip_event_tpu_torch.models import layers as TL
from clip_event_tpu_torch.tools import bench_components

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = json.dumps({
    "embed_dim": 32, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
    "vision_patch_size": 16, "context_length": 16, "vocab_size": 128,
    "transformer_width": 64, "transformer_heads": 2, "transformer_layers": 2,
})
TINY = ["--device", "cpu", "--model", MODEL, "--batch", "2", "--steps", "1", "--warmup", "1"]


def _check_line(result, ln, images="uint8"):
    assert result["images"] == images
    assert result["metric"] == "contrastive_pairs_per_sec_cpu" and result["unit"] == "pairs/s"
    assert math.isfinite(result["value"]) and result["value"] > 0
    assert math.isclose(result["value"], 2 * 3 / result["step_ms"] * 1e3, rel_tol=1e-9)
    assert (result["model"], result["batch_images"], result["descriptions_per_image"]) == ("custom", 2, 3)
    assert (result["tokens"], result["compute_dtype"], result["remat"]) == (16, "bfloat16", "full")
    assert result["ln"] == ln and result["optimizer"] == "adam" and math.isfinite(result["loss"])
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    # compared with no figure of another device
    assert not any("baseline" in k or "v100" in k.lower() or "tpu" in k.lower() for k in result)
    assert set(result["launches_per_step"].values()) == {0}  # no kernel on the CPU


@pytest.mark.parametrize("ln", ["xla", "pallas"])
def test_bench_prints_one_json_line(capsys, ln):
    assert bench.main(TINY + ["--ln", ln]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    _check_line(json.loads(lines[0]), ln)
    assert TL._resolve_ln() == "xla"  # put back


@pytest.mark.parametrize("images", ["uint8", "float32"])
def test_bench_images_option(capsys, images):
    """`--images float32` feeds the JAX bench's N(0, 1) float32 images,
    `uint8` (the default) the train loop's pixels; the line says which."""
    assert bench.main(TINY + ["--images", images]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    _check_line(json.loads(lines[0]), "xla", images)
    mcfg = bench.model_config({"model": json.loads(MODEL)})
    data = bench.bench_batch(mcfg, 2, 16, torch.device("cpu"), images)
    assert data["image"].dtype == getattr(torch, images) and data["image"].shape == (2, 32, 32, 3)
    other = bench.bench_batch(mcfg, 2, 16, torch.device("cpu"))
    assert torch.equal(data["text"], other["text"])  # the same token rows either way
    if images == "float32":
        assert abs(float(data["image"].mean())) < 0.1 and abs(float(data["image"].std()) - 1.0) < 0.1
    with pytest.raises(ValueError, match="images"):
        bench.bench_batch(mcfg, 2, 16, torch.device("cpu"), "float16")


def test_bench_module_reads_the_environment():
    """`BENCH_MODEL`, `BENCH_BATCH`, `BENCH_LN=pallas`, `BENCH_STEPS`,
    `BENCH_WARMUP`, `BENCH_REMAT` and `BENCH_CONTEXT_CAP`, as the JAX bench
    reads them, and `BENCH_CALLS`."""
    env = dict(os.environ, BENCH_MODEL=MODEL, BENCH_BATCH="2", BENCH_LN="pallas", BENCH_STEPS="1",
               BENCH_WARMUP="0", BENCH_REMAT="0", BENCH_CONTEXT_CAP="8", BENCH_CALLS="1")
    proc = subprocess.run([sys.executable, "-m", "clip_event_tpu_torch.bench", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert (result["ln"], result["remat"], result["tokens"], result["warmup_steps"]) == ("pallas", "off", 8, 0)
    assert result["metric"] == "contrastive_pairs_per_sec_cpu" and result["value"] > 0


def test_bench_presets_and_remat_note(capsys):
    """The JAX bench's presets, remat policies and protocol (10 steps a
    call, 3 timed calls after 1 warm-up call); `--remat` takes a policy
    name and the line reports it by name, with no note."""
    assert bench.DEFAULT_BATCH == {"ViT-B/32": 384, "ViT-B/16": 96, "ViT-L/14": 64,
                                   "RN50": 128, "RN101": 128, "RN50x4": 128}
    assert (bench.NUM_POS, bench.NUM_NEG) == (1, 2)
    assert bench.DEFAULT_REMAT == {"ViT-B/32": "1", "ViT-B/16": "attn", "ViT-L/14": "attn",
                                   "RN50": "1", "RN101": "attn", "RN50x4": "1"}
    assert (bench.STEPS_PER_CALL, bench.MEASURE_CALLS, bench.WARMUP_CALLS) == (10, 3, 1)
    assert bench.REMAT_CHOICES == ("0", "1", "full", "dots", "dots_nobatch", "attn")
    assert bench.main(TINY + ["--remat", "attn", "--calls", "2"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert (result["remat"], result["steps_per_call"], result["calls"], result["warmup_calls"]) == \
        ("attn", 1, 2, 1)
    assert (result["steps"], result["warmup_steps"]) == (2, 1)
    assert not any("note" in k for k in result)
    with pytest.raises(SystemExit):
        bench.main(TINY + ["--remat", "offload"])


def test_bench_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--model", MODEL, "--batch", "2", "--steps", "1", "--warmup", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_components.main(["ln", "--model", MODEL, "--batch", "2", "--layers", "1", "--steps", "1"])


COMPONENT_ARGS = ["--device", "cpu", "--model", MODEL, "--batch", "2", "--layers", "1", "--steps", "1"]


@pytest.mark.parametrize("section,variants", [
    ("ln", ["plain LN", "fused LN kernels", "LN-free ceiling"]),
    ("megakernel", ["ln+qkv+core unfused", "ln+qkv+core megakernel"]),
])
def test_component_bench_section(capsys, section, variants):
    assert bench_components.main([section] + COMPONENT_ARGS) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    rows = summary["rows"]
    assert len(lines) == len(rows) + 1 == 2 * len(variants) + 1
    assert [(r["tower"], r["variant"]) for r in rows] == [(t, v) for t in ("text", "vision") for v in variants]
    for r in rows:
        assert r["section"] == section and r["layers"] == 1
        assert math.isfinite(r["ms_per_iter"]) and r["ms_per_iter"] > 0
        assert (r["rows"], r["S"], r["W"]) == ((6, 16, 64) if r["tower"] == "text" else (2, 5, 64))
    assert summary["device"] == {"platform": "cpu", "kind": "cpu", "nvidia_smi": None}
    assert TL._resolve_ln() == "xla"


def test_component_bench_default_runs_both_and_refuses_unknown(capsys):
    assert bench_components.main(COMPONENT_ARGS) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["section"] for r in summary["rows"]] == ["ln"] * 6 + ["megakernel"] * 4
    with pytest.raises(SystemExit):
        bench_components.main(["attention"] + COMPONENT_ARGS)
    # the JAX tool's shapes are the defaults
    assert (bench_components.B, bench_components.D, bench_components.STEPS) == (256, 3, 10)
    assert bench_components.SECTIONS == ("ln", "megakernel")


def test_component_bench_reports_an_unsupported_megakernel_shape(capsys):
    """A tower whose head_dim the megakernel does not take is reported, not
    run through another path."""
    model = json.dumps(dict(json.loads(MODEL), transformer_width=132, transformer_heads=6))
    args = ["megakernel", "--device", "cpu", "--model", model, "--batch", "2", "--layers", "1", "--steps", "1"]
    assert bench_components.main(args) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rows = json.loads(out[-1])["rows"]
    assert rows[0]["variant"] == "unsupported shape" and rows[0]["ms_per_iter"] is None
    assert "skipped" in out[0] and len(rows) == 3
