"""The port's serving path on the CPU against the JAX package's: `run_embed`
(images, texts, length buckets, shard rollover, manifest) and
`evaluate_matching`, on the same weights and a small corpus of seeded
images and texts. Features within atol 1e-4, manifests and metrics equal.
Both sides decode images with PIL (the JAX package's native JPEG decoder is
switched off: it differs from PIL by one unit in the last place)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from clip_event_tpu.embed import run_embed as jax_run_embed  # noqa: E402
from clip_event_tpu.evals.matching import evaluate_matching as jax_matching  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.embed import run_embed  # noqa: E402
from clip_event_tpu_torch.evals.matching import evaluate_matching  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=77, vocab_size=49408,
    transformer_width=64, transformer_heads=1, transformer_layers=2,
)
ATOL = 1e-4
TEXTS = [f"caption number {i}" for i in range(5)] + [
    "a much longer caption about a protest march in a large city " * 2,
    "short",
]


@pytest.fixture(scope="module")
def weights():
    np_params = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), J.CLIPConfig(**CFG_KW)))
    return np_params, T.CLIP(T.CLIPConfig(**CFG_KW), params_from_jax(np_params, T.CLIPConfig(**CFG_KW), "cpu"))


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    monkeypatch.delenv("CLIP_EVENT_IMAGE_CACHE", raising=False)


def _make_images(root, n=7):
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n):
        arr = rng.integers(0, 256, size=(40 + 3 * i, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, f"im_{i:03d}.png"))
    return img_dir


def _read(out_dir, manifest_entry):
    ids, feats = [], []
    for shard in manifest_entry["shards"]:
        with np.load(os.path.join(out_dir, shard)) as z:
            ids += list(z["ids"])
            feats.append(z["features"])
    return ids, np.concatenate(feats)


@pytest.mark.parametrize("buckets", [[], [8, 16]])
def test_run_embed_matches_jax(tmp_path, weights, buckets):
    np_params, model = weights
    img_dir = _make_images(str(tmp_path))
    base = {
        "image_dir": img_dir, "texts": TEXTS, "batch_size": 4, "shard_size": 3,
        "num_workers": 2, "length_buckets": buckets,
    }
    ref_dir, our_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    ref_sum = jax_run_embed(dict(base, output_dir=ref_dir), np_params, J.CLIPConfig(**CFG_KW))
    our_sum = run_embed(dict(base, output_dir=our_dir), model, model.cfg, device="cpu")
    assert our_sum == ref_sum

    with open(os.path.join(ref_dir, "manifest.json")) as fh:
        ref_m = json.load(fh)
    with open(os.path.join(our_dir, "manifest.json")) as fh:
        our_m = json.load(fh)
    assert our_m == ref_m
    assert sorted(os.listdir(our_dir)) == sorted(os.listdir(ref_dir))
    for kind in ("images", "texts"):
        ref_ids, ref_f = _read(ref_dir, ref_m[kind])
        our_ids, our_f = _read(our_dir, our_m[kind])
        assert our_ids == ref_ids
        assert our_f.dtype == np.float32
        np.testing.assert_allclose(our_f, ref_f, atol=ATOL, rtol=0, err_msg=kind)
        np.testing.assert_allclose(np.linalg.norm(our_f, axis=1), 1.0, atol=1e-5)


def test_evaluate_matching_matches_jax(tmp_path, weights):
    from clip_event_tpu.data.voa import VOACaptionDataset as JVOA
    from clip_event_tpu_torch.data.voa import VOACaptionDataset as TVOA

    np_params, model = weights
    voa = fixtures.make_voa_fixture(str(tmp_path), num_docs=7)
    args = ([voa["mapping_json"]], [voa["image_dir"]])
    ref = jax_matching(np_params, J.CLIPConfig(**CFG_KW), JVOA(*args, image_size=32),
                       batch_size=4, rank=0, world_size=1)
    ours = evaluate_matching(model, model.cfg, TVOA(*args, image_size=32), batch_size=4, device="cpu")
    assert ours == ref
    assert ours["num_pairs"] == 7


def test_encoders_pad_the_last_batch(weights):
    from clip_event_tpu_torch.evals.common import Encoders

    _, model = weights
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(5, 32, 32, 3), dtype=np.uint8)
    enc = Encoders(model, model.cfg, batch_size=4, device="cpu")
    feats = enc.images(images)
    assert feats.shape == (5, 64) and feats.dtype == np.float32
    one = enc.images(images[4:])
    np.testing.assert_allclose(one[0], feats[4], atol=1e-6, rtol=0)
    bf16 = Encoders(model, model.cfg, batch_size=4, compute_dtype=torch.bfloat16, device="cpu")
    low = bf16.images(images)
    cos = (low * feats).sum(axis=1) / np.linalg.norm(low, axis=1)
    assert (cos > 0.999).all()


def test_embed_cli_on_cpu(tmp_path):
    img_dir = _make_images(str(tmp_path), n=3)
    cfg = {
        "output_dir": str(tmp_path / "out"), "image_dir": img_dir, "texts": ["a", "b c"],
        "batch_size": 2, "num_workers": 1, "model": CFG_KW, "seed": 3,
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "clip_event_tpu_torch.embed", "--cfg", str(path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout)
    assert summary["images"]["count"] == 3 and summary["texts"]["count"] == 2
    # asking for the card where there is none fails, never runs on the CPU
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "clip_event_tpu_torch.embed", "--cfg", str(path)],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_recall_at_k_matches_jax():
    from clip_event_tpu.evals.common import recall_at_k as jax_recall
    from clip_event_tpu_torch.evals.common import recall_at_k

    ranks = np.random.default_rng(5).integers(0, 20, size=50)
    assert recall_at_k(ranks) == jax_recall(ranks)
    assert recall_at_k(ranks, ks=(2, 7)) == jax_recall(ranks, ks=(2, 7))


def test_eval_matching_cli_on_cpu(tmp_path):
    voa = fixtures.make_voa_fixture(str(tmp_path), num_docs=5)
    out = tmp_path / "metrics.json"
    cfg = {
        "dataset": "voa", "image_caption_json": [voa["mapping_json"]],
        "image_dir": [voa["image_dir"]], "batch_size": 2, "model": CFG_KW, "seed": 1,
        "output_json": str(out),
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "clip_event_tpu_torch.eval_matching", "--cfg", str(path),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(out.read_text())
    assert metrics == json.loads(proc.stdout)
    assert metrics["num_pairs"] == 5
    assert 0.0 <= metrics["i2t_top1"] <= metrics["i2t_top5"] <= 1.0
