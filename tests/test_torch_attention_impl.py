"""`use_pallas_attention` reaches every encoder call outside the train step:
the five eval CLIs and `embed` through `evals.cli.run`, and the train
loop's per-epoch validation. For each, with the key true, false and absent:
the `impl` that `layers.attention_core` receives is "plain" when false and
"kernel" otherwise, the metrics are equal either way on the CPU (the kernel
wrappers run their plain versions there), and the process-wide choice is
back to its old value after the run. Then the process-wide choice itself:
`set_attention_impl`, the `attention_impl` context, and that an explicit
`impl` wins over it.

Model: ViT towers of 2 layers, width 64 (1 head), patch 16, image 32; text
width 64, 77 tokens, the real vocab; weights drawn from the config's seed."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from clip_event_tpu_torch import (
    embed,
    eval_m2e2,
    eval_matching,
    eval_retrieval,
    eval_vcr,
    eval_visualcomet,
)
from clip_event_tpu_torch.config import validate_config
from clip_event_tpu_torch.evals import cli
from clip_event_tpu_torch.evals import matching as matching_mod
from clip_event_tpu_torch.models import clip as T
from clip_event_tpu_torch.models import layers as TL
from clip_event_tpu_torch.train import build_dataset, initial_state, train
from tests import fixtures

MODEL = {
    "embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
    "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2,
}
SETTINGS = {"true": {"use_pallas_attention": True}, "false": {"use_pallas_attention": False},
            "absent": {}}


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    monkeypatch.delenv("CLIP_EVENT_IMAGE_CACHE", raising=False)


@pytest.fixture
def received(monkeypatch):
    """Every `attention_core` call's (impl, autograd recording?)."""
    calls = []
    core = TL.attention_core

    def recording(qkv, attn_bias, num_heads, scale, impl=None):
        calls.append((impl, torch.is_grad_enabled()))
        return core(qkv, attn_bias, num_heads, scale, impl)

    monkeypatch.setattr(TL, "attention_core", recording)
    return calls


def _eval_cfg(name, root):
    if name == "eval_matching":
        p = fixtures.make_voa_fixture(root)
        return eval_matching.evaluate, {"image_caption_json": [p["mapping_json"]], "image_dir": [p["image_dir"]]}
    if name == "eval_m2e2":
        p = fixtures.make_m2e2_fixture(root)
        return eval_m2e2.evaluate, {"image_anno": p["anno_json"], "image_dir": p["image_dir"],
                                    "ie_ontology_json": p["ontology_json"]}
    if name == "eval_vcr":
        p = fixtures.make_vcr_fixture(root)
        return eval_vcr.evaluate, {"qa_jsonl": p["qa_jsonl"], "image_dir": p["image_dir"]}
    if name == "eval_visualcomet":
        p = fixtures.make_visualcomet_fixture(root)
        return eval_visualcomet.evaluate, {"anno_json": p["anno_json"], "image_dir": p["image_dir"]}
    if name == "eval_retrieval":
        p = fixtures.make_retrieval_fixture(root)
        return eval_retrieval.evaluate, {"dataset": "coco", "caption_file": p["coco_json"],
                                         "image_dir": p["coco_dir"]}
    assert name == "embed"
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(3):
        arr = rng.integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, f"im_{i}.png"))
    return embed.run_embed, {"image_dir": img_dir, "texts": ["a", "b c"], "output_dir": os.path.join(root, "out")}


def _run_cli(name, evaluate, cfg, tmp_path, monkeypatch, capsys, tag):
    path = tmp_path / f"{name}_{tag}.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(sys, "argv", [name, "--cfg", str(path), "--device", "cpu"])
    capsys.readouterr()
    cli.run(name, evaluate)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("name", ["eval_matching", "eval_m2e2", "eval_vcr", "eval_visualcomet",
                                  "eval_retrieval", "embed"])
def test_cli_honours_use_pallas_attention(tmp_path, monkeypatch, capsys, received, name, setting):
    evaluate, data = _eval_cfg(name, str(tmp_path))
    base = {"model": MODEL, "seed": 0, "batch_size": 3, "num_workers": 1, **data}
    want = "plain" if setting == "false" else "kernel"
    # the process-wide choice the run must put back, whichever it is
    with TL.attention_impl("plain" if want == "kernel" else "kernel"):
        before = TL._resolve_attention()
        metrics = _run_cli(name, evaluate, {**base, **SETTINGS[setting]}, tmp_path, monkeypatch,
                           capsys, setting)
        assert TL._resolve_attention() == before
    # `transformer` resolved the choice once a tower and handed it down
    assert received and {impl for impl, _ in received} == {want}
    assert TL._resolve_attention() == "kernel"
    reference = _run_cli(name, evaluate, {**base, "use_pallas_attention": True}, tmp_path,
                         monkeypatch, capsys, "reference")
    assert metrics == reference  # one path on the CPU, whatever the choice


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_train_validation_honours_use_pallas_attention(tmp_path, monkeypatch, received, setting):
    voa = fixtures.make_voa_fixture(str(tmp_path / "voa"))
    cfg = validate_config({
        "task": "val", "constrastive_loss": "ce", "model": MODEL, "seed": 0,
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "max_epoch": 1, "batch_size": 2, "lr": 1e-4, "optimizer": "adam", "lr_scheduler": "none",
        "compute_dtype": "float32", "remat": True, "num_workers": 1,
        "validate_every": 1, "val_image_caption_json": [voa["mapping_json"]],
        "val_image_dir": [voa["image_dir"]], "ckpt_dir": str(tmp_path / "ckpt"),
        **SETTINGS[setting],
    })
    want = "plain" if setting == "false" else "kernel"
    seen = {}
    evaluate_matching = matching_mod.evaluate_matching

    def validating(*args, **kwargs):
        seen["inside"] = TL._resolve_attention()
        start = len(received)
        out = evaluate_matching(*args, **kwargs)
        seen["calls"] = received[start:]
        seen["metrics"] = out
        return out

    monkeypatch.setattr(matching_mod, "evaluate_matching", validating)
    params, mcfg, resume = initial_state(cfg, "cpu")
    with TL.attention_impl("plain" if want == "kernel" else "kernel"):
        before = TL._resolve_attention()
        train(cfg, mcfg, build_dataset(cfg, mcfg), params, "cpu", **resume)
        assert TL._resolve_attention() == before
    assert seen["inside"] == want
    assert seen["calls"] and all(impl == want and not grad for impl, grad in seen["calls"])
    # the step's own calls carry the choice explicitly
    assert {impl for impl, grad in received if grad} == {want}
    assert TL._resolve_attention() == "kernel"
    assert 0.0 <= seen["metrics"]["i2t_top1"] <= 1.0


def test_gsr_grid_encode_takes_the_process_wide_choice(received):
    from clip_event_tpu_torch.evals import gsr

    cfg = T.CLIPConfig(**MODEL)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    images = np.random.default_rng(0).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    feats = []
    for impl in ("kernel", "plain"):
        with TL.attention_impl(impl):
            feats.append(gsr._grid_features_fn(cfg)(params, images))
    assert [impl for impl, _ in received] == ["kernel"] * 2 + ["plain"] * 2
    np.testing.assert_array_equal(np.asarray(feats[0]), np.asarray(feats[1]))


def test_set_attention_impl_and_context():
    assert TL._resolve_attention() == "kernel"  # the default, as `use_pallas_attention: true`
    with TL.attention_impl("plain"):
        assert TL._resolve_attention() == "plain"
        with TL.attention_impl("kernel"):
            assert TL._resolve_attention() == "kernel"
        assert TL._resolve_attention() == "plain"
    assert TL._resolve_attention() == "kernel"
    with pytest.raises(RuntimeError, match="boom"):
        with TL.attention_impl("plain"):
            raise RuntimeError("boom")
    assert TL._resolve_attention() == "kernel"  # put back after an error too
    with pytest.raises(ValueError, match="attention impl"):
        TL.set_attention_impl("pallas")
    with pytest.raises(ValueError, match="attention impl"):
        TL.attention_core(torch.zeros(1, 2, 12), None, 1, 1.0, "xla")


@pytest.mark.parametrize("choice", ["kernel", "plain"])
@pytest.mark.parametrize("explicit", [None, "kernel", "plain"])
def test_explicit_impl_wins_over_the_process_wide_choice(monkeypatch, choice, explicit):
    """`transformer` resolves None once and hands every block the resolved
    value; an explicit "kernel" or "plain" is handed on as it is."""
    got = []
    monkeypatch.setattr(TL.A, "attend", lambda qkv, b, h, s, impl: got.append("plain") or qkv[..., :8])
    monkeypatch.setattr(TL.A, "fused_attention_qkv", lambda qkv, b, h, s: got.append("kernel") or qkv[..., :8])
    stack = TL.init_transformer(torch.Generator().manual_seed(0), 2, 8)
    x = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(1))
    with TL.attention_impl(choice):
        TL.transformer(x, stack, 2, impl=explicit)
    assert got == [explicit or choice] * 2
