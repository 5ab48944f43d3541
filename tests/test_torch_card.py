"""The port's CLIs on the card at the presets this slice added (marker
`cuda`: each test skips without a CUDA device; on the card it builds the
kernels with nvcc at first use). Run them on a machine with an H100 with

    python -m pytest tests/test_torch_card.py -m cuda -q

- `python -m clip_event_tpu_torch.train` at full-width ViT-L/14 (vision
  through K2) with finetune_ot.json's OT keys (object crops, IE channel,
  alignment, `use_pallas_ot`, so K3) on the synthetic VOA fixture: the
  epoch's losses are finite, `loss_ot` > 0, and K2 and K3 launched;
- `python -m clip_event_tpu_torch.embed` at ViT-B/16 and `.eval_matching`
  at ViT-L/14, seeded weights: unit-norm features of the right shape and
  the matching metrics of the fixture's pairs."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def voa(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (tests/test_torch_card.py docstring)")
    # tests/fixtures.py by path: `tests` has no __init__.py, so an installed
    # package named `tests` can shadow `tests.fixtures`
    spec = importlib.util.spec_from_file_location("voa_fixtures", os.path.join(HERE, "fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    return fixtures.make_voa_fixture(str(tmp_path_factory.mktemp("voa_card")), num_docs=4)


def _scalars(path):
    with open(path) as fh:
        return {(r["tag"], r["step"]): r["value"] for r in map(json.loads, fh)}


def test_train_cli_vit_l14_with_ot(voa, tmp_path):
    from clip_event_tpu_torch.ops import attention as A
    from clip_event_tpu_torch.ops import ot
    from clip_event_tpu_torch.train import main

    cfg = {
        "task": "card", "model": "ViT-L/14", "seed": 0, "constrastive_loss": "ce",
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "alignment": True, "alignment_chunks": 2, "use_pallas_ot": True,
        "load_object": True, "object_pickle": [voa["object_pickle"]],
        "object_ontology_file": voa["ontology_csv"], "max_objects": 4,
        "load_ie": True, "input_entities": [voa["entity_cs"]], "input_events": [voa["event_cs"]],
        "batch_size": 2, "max_epoch": 1, "lr": 1e-6, "optimizer": "adam",
        "compute_dtype": "bfloat16", "remat": True, "num_workers": 2,
        "ckpt_dir": str(tmp_path / "ckpt"), "tb_log_dir": str(tmp_path / "logs"),
    }
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    A.fused_attention_qkv_headgrid.launches = ot.ipot_kernel.launches = 0
    main(["--cfg", str(path)])
    # 4 images at batch 2; each of the 24 vision blocks runs its forward
    # twice for the image and three times in each of the 2 crop chunks
    steps = 2
    assert A.fused_attention_qkv_headgrid.launches == 24 * (2 + 3 * 2) * steps
    assert ot.ipot_kernel.launches == steps
    scalars = _scalars(tmp_path / "logs" / "card" / "tensorboard" / "scalars.jsonl")
    assert all(np.isfinite(scalars[tag, 0]) for tag in ("train_loss", "loss_i", "loss_t"))
    assert scalars["loss_ot", 0] > 0


def _cli(module, cfg, tmp_path):
    path = tmp_path / f"{module}.json"
    path.write_text(json.dumps(cfg))
    proc = subprocess.run([sys.executable, "-m", f"clip_event_tpu_torch.{module}", "--cfg", str(path)],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def test_embed_cli_vit_b16(voa, tmp_path):
    out = tmp_path / "out"
    summary = _cli("embed", {"model": "ViT-B/16", "seed": 0, "output_dir": str(out),
                             "image_dir": [voa["image_dir"]], "texts": ["a protest", "a wedding"],
                             "batch_size": 4, "num_workers": 2}, tmp_path)
    assert summary["images"]["count"] == 4 and summary["texts"]["count"] == 2
    with open(out / "manifest.json") as fh:
        manifest = json.load(fh)
    for kind, n in (("images", 4), ("texts", 2)):
        feats = np.concatenate([np.load(out / s)["features"] for s in manifest[kind]["shards"]])
        assert feats.shape == (n, 512) and np.isfinite(feats).all()
        np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-4)


def test_eval_matching_cli_vit_l14(voa, tmp_path):
    metrics = _cli("eval_matching", {"model": "ViT-L/14", "seed": 0, "dataset": "voa",
                                     "image_caption_json": [voa["mapping_json"]],
                                     "image_dir": [voa["image_dir"]], "batch_size": 4}, tmp_path)
    assert metrics["num_pairs"] == 4
    assert 0.0 <= metrics["i2t_top1"] <= metrics["i2t_top5"] <= 1.0
