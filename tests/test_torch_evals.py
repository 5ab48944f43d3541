"""The port's zero-shot evals on the CPU against the JAX package's: M2E2
(with and without argument grounding, a fixed null threshold and the
threshold sweep), VCR, VisualCOMET and retrieval on the fixtures of
`tests/fixtures.py`, with the same converted weights. Counts equal,
rates within 1e-6 and the selected null threshold (a probability) within
1e-5 (`PROB_TOL`). Then each new CLI end to end with `--device cpu`
(float and int8), against the JAX eval functions on the same checkpoint.
Both sides decode images with PIL (the JAX package's native JPEG decoder
is switched off: it differs from PIL by one unit in the last place)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax, state_dict_from_params  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=77, vocab_size=49408,
    transformer_width=64, transformer_heads=1, transformer_layers=2,
)
JCFG, TCFG = J.CLIPConfig(**CFG_KW), T.CLIPConfig(**CFG_KW)
RATE_TOL = 1e-6
# `null_threshold_selected` is a probability, softmax over 100 · cosine
# (both packages), not a rate. A softmax probability moves by at most
# 2 p (1 − p) ≤ 1/2 times the largest change of a logit, and the two
# frameworks' fp32 encoders give cosines that differ by fp32 rounding: on
# the M2E2 fixture the [8, 3] logits differ by up to 1.67e-5 (1.67e-7 in
# a cosine; features by 1.5e-7 an element), the top probabilities by up to
# 2.6e-6, the selected one by 1.25e-6. Allowing 2e-7 in a cosine gives
# 0.5 · 100 · 2e-7 = 1e-5.
LOGIT_SCALE, COSINE_TOL = 100.0, 2e-7
PROB_TOL = 0.5 * LOGIT_SCALE * COSINE_TOL
PROB_KEYS = {"null_threshold_selected"}


@pytest.fixture(scope="module")
def weights():
    np_params = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), JCFG))
    return np_params, T.CLIP(TCFG, params_from_jax(np_params, TCFG, "cpu"))


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    monkeypatch.delenv("CLIP_EVENT_IMAGE_CACHE", raising=False)


def assert_metrics_match(ours, ref, path=""):
    """Same keys; ints and None equal; floats within RATE_TOL (the
    probabilities of PROB_KEYS within PROB_TOL)."""
    assert set(ours) == set(ref), (path, sorted(set(ours) ^ set(ref)))
    for k, r in ref.items():
        o = ours[k]
        if isinstance(r, dict):
            assert_metrics_match(o, r, f"{path}.{k}")
        elif isinstance(r, float):
            tol = PROB_TOL if k in PROB_KEYS else RATE_TOL
            assert isinstance(o, float) and abs(o - r) <= tol, (f"{path}.{k}", o, r)
        else:
            assert o == r and type(o) is type(r), (f"{path}.{k}", o, r)


def _m2e2_with_roles(root):
    paths = fixtures.make_m2e2_fixture(root)
    with open(paths["ontology_json"]) as fh:
        ontology = json.load(fh)
    roles = {"Attacker": "the person attacking", "Place": "where it happens"}
    paths["roles_json"] = os.path.join(root, "m2e2_ontology_roles.json")
    with open(paths["roles_json"], "w") as fh:
        json.dump({t: {"template": v, "roles": roles} for t, v in ontology.items()}, fh)
    return paths


M2E2_CASES = {
    "plain": {},
    "null_threshold": {"null_threshold": 0.34},
    "ground_arguments": {"ground_arguments": True, "arg_topk": 2},
    "select_null_threshold": {"select_null_threshold": True},
}


@pytest.mark.parametrize("case", list(M2E2_CASES))
def test_m2e2_matches_jax(tmp_path, weights, case):
    from clip_event_tpu.data.m2e2 import M2E2Dataset as JM2E2
    from clip_event_tpu.evals.m2e2 import evaluate_m2e2 as jax_m2e2
    from clip_event_tpu_torch.data.m2e2 import M2E2Dataset
    from clip_event_tpu_torch.evals.m2e2 import evaluate_m2e2

    np_params, model = weights
    kw = M2E2_CASES[case]
    paths = _m2e2_with_roles(str(tmp_path))
    ontology = paths["roles_json"] if kw.get("ground_arguments") else paths["ontology_json"]
    args = (paths["anno_json"], paths["image_dir"], ontology)
    ref = jax_m2e2(np_params, JCFG, JM2E2(*args, image_size=32), batch_size=3, rank=0, world_size=1, **kw)
    ds = M2E2Dataset(*args, image_size=32)
    assert len(ds) == 8 and ds.candidate_tokens.shape == (3, 77)
    ours = evaluate_m2e2(model, TCFG, ds, batch_size=3, device="cpu", **kw)
    assert_metrics_match(ours, ref)
    assert ours["num_images"] == 8
    if kw.get("ground_arguments"):
        assert ours["argument_mentions_gold"] == 8
    if kw.get("select_null_threshold"):
        assert ours["dev_images"] == 4 and ours["eval_images"] == 4


def test_m2e2_protocol_helpers_match_jax():
    from clip_event_tpu.evals import m2e2 as JE
    from clip_event_tpu_torch.evals import m2e2 as TE

    pred = {"a": ["x", "x", "y"], "b": ["z"], "c": []}
    gold = {"a": ["x", "y", "y"], "c": ["x"]}
    assert TE.event_mention_prf(pred, gold) == JE.event_mention_prf(pred, gold)
    box, off = [0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]
    pa = {"a": [("x", "Agent", box), ("x", "Agent", box), ("x", "Place", off)]}
    ga = {"a": [("x", "Agent", [0.1, 0.1, 0.45, 0.5]), ("x", "Place", box)], "b": [("y", "Agent", box)]}
    assert TE.argument_prf(pa, ga) == JE.argument_prf(pa, ga)
    rng = np.random.default_rng(0)
    probs = np.round(rng.uniform(size=40), 2)  # ties
    correct = rng.uniform(size=40) < 0.4
    assert TE.sweep_null_threshold(probs, correct, 25) == JE.sweep_null_threshold(probs, correct, 25)
    assert TE.sweep_null_threshold([], [], 3) == (None, 0.0)


def test_bbox_and_grid_helpers_match_jax():
    from clip_event_tpu.evals.gsr import patch_window_bbox as j_pwb
    from clip_event_tpu.evals.gsr import window_boxes as j_wb
    from clip_event_tpu.ops import bbox as JB
    from clip_event_tpu_torch.evals.gsr import patch_window_bbox, window_boxes
    from clip_event_tpu_torch.ops import bbox as TB

    rng = np.random.default_rng(1)
    heat = rng.normal(size=(3, 5, 49))
    for k in (1, 4):
        np.testing.assert_array_equal(window_boxes(heat, 7, k), j_wb(heat, 7, k))
    assert patch_window_bbox(heat[0, 0], 7, 3) == j_pwb(heat[0, 0], 7, 3)
    a = rng.uniform(size=(6, 4)); a[:, 2:] += a[:, :2]
    b = rng.uniform(size=(6, 4)); b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(TB.iou_batch(a, b), JB.iou_batch(a, b))
    assert [TB.iou(x, y) for x, y in zip(a, b)] == [JB.iou(x, y) for x, y in zip(a, b)]
    assert TB.grounding_correct(a[:2], b[:3]) == JB.grounding_correct(a[:2], b[:3])
    assert TB.union_box(a) == JB.union_box(a)
    np.testing.assert_array_equal(TB.patch_from_norm_bbox_batch(a / 2), JB.patch_from_norm_bbox_batch(a / 2))


@pytest.mark.parametrize("rationale", [False, True], ids=["answer", "rationale"])
def test_vcr_matches_jax(tmp_path, weights, rationale):
    from clip_event_tpu.data.vcr import VCRDataset as JVCR
    from clip_event_tpu.evals.vcr import evaluate_vcr as jax_vcr
    from clip_event_tpu_torch.data.vcr import VCRDataset
    from clip_event_tpu_torch.evals.vcr import evaluate_vcr

    np_params, model = weights
    paths = fixtures.make_vcr_fixture(str(tmp_path))
    args = (paths["qa_jsonl"], paths["image_dir"])
    ref = jax_vcr(np_params, JCFG, JVCR(*args, rationale=rationale, image_size=32), batch_size=4,
                  rank=0, world_size=1)
    ds = VCRDataset(*args, rationale=rationale, image_size=32)
    tensors, _ = ds[0]
    assert tensors["text"].shape == (4, 77) and "person" in ds.data[0]["question"]
    assert_metrics_match(evaluate_vcr(model, TCFG, ds, batch_size=4, device="cpu"), ref)


@pytest.mark.parametrize("field", ["event", "intent", "before"])
def test_visualcomet_matches_jax(tmp_path, weights, field):
    from clip_event_tpu.data.visualcomet import VisualCOMETDataset as JVC
    from clip_event_tpu.evals.visualcomet import evaluate_visualcomet as jax_vc
    from clip_event_tpu_torch.data.visualcomet import VisualCOMETDataset
    from clip_event_tpu_torch.evals.visualcomet import evaluate_visualcomet

    np_params, model = weights
    paths = fixtures.make_visualcomet_fixture(str(tmp_path))
    args = (paths["anno_json"], paths["image_dir"])
    ref = jax_vc(np_params, JCFG, JVC(*args, field=field, image_size=32), batch_size=4, rank=0, world_size=1)
    ds = VisualCOMETDataset(*args, field=field, image_size=32)
    assert ds.candidates == JVC(*args, field=field, image_size=32).candidates
    assert_metrics_match(evaluate_visualcomet(model, TCFG, ds, batch_size=4, device="cpu"), ref)


@pytest.mark.parametrize("kind", ["coco", "flickr"])
def test_retrieval_matches_jax(tmp_path, weights, kind):
    from clip_event_tpu.data import retrieval as JR
    from clip_event_tpu.evals.retrieval import evaluate_retrieval as jax_retrieval
    from clip_event_tpu_torch.data import retrieval as TR
    from clip_event_tpu_torch.evals.retrieval import evaluate_retrieval

    np_params, model = weights
    p = fixtures.make_retrieval_fixture(str(tmp_path))
    if kind == "coco":
        args, cls = (p["coco_json"], p["coco_dir"]), "COCODataset"
    else:
        args, cls = (p["flickr_split"], p["flickr_csv"], p["flickr_dir"]), "FlickrDataset"
    ref = jax_retrieval(np_params, JCFG, getattr(JR, cls)(*args, image_size=32), batch_size=3,
                        rank=0, world_size=1)
    ds = getattr(TR, cls)(*args, image_size=32)
    assert len(ds) == 4 and ds[0][0]["text"].shape == (5, 77)
    assert_metrics_match(evaluate_retrieval(model, TCFG, ds, batch_size=3, device="cpu"), ref)


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, weights):
    """The fixture weights as a torch state-dict file both packages load."""
    np_params, _ = weights
    path = str(tmp_path_factory.mktemp("ckpt") / "weights.pt")
    sd = state_dict_from_params(np_params, TCFG)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return path


def _port_cli(module, cfg, tmp_path):
    out = tmp_path / f"{module}.json"
    path = tmp_path / f"{module}_cfg.json"
    path.write_text(json.dumps(dict(cfg, output_json=str(out))))
    proc = subprocess.run(
        [sys.executable, "-m", f"clip_event_tpu_torch.{module}", "--cfg", str(path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CLIP_EVENT_NATIVE="0"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(out.read_text())
    assert metrics == json.loads(proc.stdout)
    return metrics


def _jax_eval(script, cfg):
    """The JAX package's eval of a root `eval_*.py` on the same config, in
    this process: its `load_model_from_cfg` (int8 and calibration included)
    and its `evaluate`."""
    import importlib.util

    from clip_event_tpu.evals.cli import load_model_from_cfg

    spec = importlib.util.spec_from_file_location(script[:-3], os.path.join(REPO, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    params, mcfg = load_model_from_cfg(cfg)
    return mod.evaluate(cfg, params, mcfg)


CLI_CASES = {
    "m2e2_ground": ("eval_m2e2", {"ground_arguments": True}),
    "m2e2_int8": ("eval_m2e2", {"quantize": "int8", "null_threshold": 0.34}),
    "vcr_int8_static_visual": ("eval_vcr", {"rationale": True, "quantize": "int8_static",
                                            "quantize_towers": ["visual"], "calibration_batches": 1}),
    "visualcomet": ("eval_visualcomet", {"field": "intent"}),
    "retrieval_int8_static": ("eval_retrieval", {"dataset": "flickr", "quantize": "int8_static",
                                                 "calibration_batches": 1}),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_eval_cli_on_cpu_matches_jax(tmp_path, ckpt, case):
    module, extra = CLI_CASES[case]
    root = str(tmp_path)
    if module == "eval_m2e2":
        p = _m2e2_with_roles(root)
        data = {"image_anno": p["anno_json"], "image_dir": p["image_dir"],
                "ie_ontology_json": p["roles_json"]}
    elif module == "eval_vcr":
        p = fixtures.make_vcr_fixture(root)
        data = {"qa_jsonl": p["qa_jsonl"], "image_dir": p["image_dir"]}
    elif module == "eval_visualcomet":
        p = fixtures.make_visualcomet_fixture(root)
        data = {"anno_json": p["anno_json"], "image_dir": p["image_dir"]}
    else:
        p = fixtures.make_retrieval_fixture(root)
        data = {"split_list": p["flickr_split"], "caption_file": p["flickr_csv"],
                "image_dir": p["flickr_dir"]}
    cfg = {"ckpt": ckpt, "batch_size": 3, "seed": 0, **data, **extra}
    ours = _port_cli(module, cfg, tmp_path)
    assert_metrics_match(ours, _jax_eval(module + ".py", cfg))
    for v in ours.values():
        if isinstance(v, float):
            assert np.isfinite(v)
