"""The port's GSR/SWiG eval against the JAX package's, on the CPU in fp32,
on `tests/fixtures.py::make_swig_fixture` with the same converted weights:
`GSRDataset` items (every prompt style, the detected-object channel),
`evaluate_gsr` grounding through the grid and through the detected
objects, with and without the noun value metrics, the verb-only eval of a
ResNet model (no grid tokens), and `python -m clip_event_tpu_torch.eval_gsr
--device cpu` against the JAX eval on one checkpoint, in float and int8.

Counts equal, rates within 1e-6 (`assert_metrics_match` of
tests/test_torch_evals.py). Both sides decode images with PIL (the JAX
package's native JPEG decoder is switched off: it differs from PIL by one
unit in the last place). The eval runs in one process here; its sharding
by rank is held against the single-process eval in
tests/test_torch_multiprocess.py."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from clip_event_tpu.data.sr import GSRDataset as JaxGSR  # noqa: E402
from clip_event_tpu.evals.gsr import evaluate_gsr as jax_gsr  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.data.sr import GSRDataset  # noqa: E402
from clip_event_tpu_torch.evals.gsr import _pad_object_boxes, evaluate_gsr  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax, state_dict_from_params  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.test_torch_evals import assert_metrics_match  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=8, context_length=77, vocab_size=49408,
    transformer_width=64, transformer_heads=1, transformer_layers=2,
)
JCFG, TCFG = J.CLIPConfig(**CFG_KW), T.CLIPConfig(**CFG_KW)
RN_KW = dict(CFG_KW, vision_layers=(1, 1, 1, 1), vision_width=16, vision_patch_size=None)
JRN, TRN = J.CLIPConfig(**RN_KW), T.CLIPConfig(**RN_KW)


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    monkeypatch.delenv("CLIP_EVENT_IMAGE_CACHE", raising=False)


def _jax_tree(tcfg, jcfg, seed):
    """A JAX numpy param tree from the port's random init through JAX's
    state-dict converter (JAX's own init runs op by op, slowly, here)."""
    from clip_event_tpu.models.convert import params_from_state_dict

    params = T.init_params(torch.Generator().manual_seed(seed), tcfg, "cpu")
    return params_from_state_dict(state_dict_from_params(params, tcfg), jcfg)[0]


@pytest.fixture(scope="module")
def weights():
    np_params = _jax_tree(TCFG, JCFG, 0)
    return np_params, T.CLIP(TCFG, params_from_jax(np_params, TCFG, "cpu"))


@pytest.fixture(scope="module")
def swig(tmp_path_factory):
    """The SWiG fixture plus a detections pickle (two person boxes an image,
    one label outside the class map) and its class map."""
    root = tmp_path_factory.mktemp("swig")
    paths = fixtures.make_swig_fixture(str(root))
    det = {
        f"swig_{i:03d}.jpg": [
            {"label": "/m/01g317", "bbox": [5, 5, 60, 90],
             "bbox_normalized": [0.04, 0.05, 0.47, 0.94], "score": 0.9},
            {"label": "/m/01g317", "bbox": [64, 5, 125, 90],
             "bbox_normalized": [0.5, 0.05, 0.98, 0.94], "score": 0.8},
            {"label": "/m/unknown", "bbox": [0, 0, 5, 5],
             "bbox_normalized": [0, 0, 0.04, 0.05], "score": 0.99},
        ][: 1 + i % 3]
        for i in range(6)
    }
    paths["object_detection"] = str(root / "det.pkl")
    with open(paths["object_detection"], "wb") as fh:
        pickle.dump(det, fh)
    paths["object_class_map"] = str(root / "classes.csv")
    with open(paths["object_class_map"], "w") as fh:
        fh.write("/m/01g317,Person,1\n")
    return paths


def _datasets(swig, **kw):
    args = (swig["anno_json"], swig["image_dir"], swig["ontology_json"])
    if kw.pop("objects", False):
        kw.update(load_object=True, object_detection=swig["object_detection"],
                  object_class_map=swig["object_class_map"])
    return GSRDataset(*args, image_size=32, **kw), JaxGSR(*args, image_size=32, **kw)


@pytest.mark.parametrize("prompt", ["def", "abstract", "name", "short"])
def test_dataset_items_match_jax(swig, prompt):
    ours, ref = _datasets(swig, prompt=prompt, objects=prompt == "short", max_roles=3)
    assert len(ours) == len(ref) == 6
    assert ours.candidate_verbs == ref.candidate_verbs
    np.testing.assert_array_equal(ours.candidate_tokens, ref.candidate_tokens)
    assert ours.data == ref.data
    for i in range(6):
        (ta, ma), (ja, mj) = ours[i], ref[i]
        assert ta.keys() == ja.keys() and ma == mj
        for k in ta:
            assert np.asarray(ta[k]).dtype == np.asarray(ja[k]).dtype, k
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert ours.role_description("marching", "agent", None) == \
        ref.role_description("marching", "agent", None)
    with pytest.raises(ValueError, match="prompt"):
        GSRDataset(swig["anno_json"], swig["image_dir"], swig["ontology_json"], prompt="long")


EVAL_CASES = {
    "grid_values": dict(ground_via="grid"),
    "grid_topk1_no_values": dict(ground_via="grid", ground_topk=1, value_metrics=False),
    "objects_values": dict(ground_via="objects", objects=True),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluate_gsr_matches_jax(swig, weights, case):
    np_params, model = weights
    kw = dict(EVAL_CASES[case])
    ours_ds, ref_ds = _datasets(swig, objects=kw.pop("objects", False))
    ref = jax_gsr(np_params, JCFG, ref_ds, batch_size=4, rank=0, world_size=1, **kw)
    ours = evaluate_gsr(model, TCFG, ours_ds, batch_size=4, device="cpu", **kw)
    assert_metrics_match(ours, ref)
    assert ours["num_images"] == 6 and ours["ground_via"] == kw["ground_via"]
    assert ours["grounded_args"] == 6  # one role with a gold box an image
    if kw.get("value_metrics", True):
        assert ours["value_roles"] == 12 and ours["value_frames"] == 6
    else:
        assert "value" not in ours


def test_resnet_model_gets_verb_metrics_only(swig, monkeypatch):
    """A ResNet tower has no grid tokens: the verb metrics alone
    (`do_grounding = cfg.is_vit`). JAX's eval means the same but reads
    `cfg.grid_size` first, which asserts a ViT (`evals/gsr.py:131`): the
    reference here is JAX's eval with that property answering None."""
    np_params = _jax_tree(TRN, JRN, 3)
    ours_ds, ref_ds = _datasets(swig)
    with pytest.raises(AssertionError):
        jax_gsr(np_params, JRN, ref_ds, batch_size=4, rank=0, world_size=1)
    monkeypatch.setattr(J.CLIPConfig, "grid_size", property(lambda self: None))
    ref = jax_gsr(np_params, JRN, ref_ds, batch_size=4, rank=0, world_size=1)
    ours = evaluate_gsr(params_from_jax(np_params, TRN, "cpu"), TRN, ours_ds, batch_size=4,
                        device="cpu")
    assert_metrics_match(ours, ref)
    assert set(ours) == {"verb_top1", "verb_top5", "num_images"}


def test_objects_need_the_object_channel(swig, weights):
    ours_ds, _ = _datasets(swig)
    with pytest.raises(ValueError, match="load_object"):
        evaluate_gsr(weights[1], TCFG, ours_ds, ground_via="objects", device="cpu")
    box, mask = _pad_object_boxes([{"object_bboxes": [[0, 0, 1, 1]]}, {}], 2)
    assert box.shape == (2, 1, 4) and mask.tolist() == [[1], [0]]
    assert _pad_object_boxes([{}, {"object_bboxes": []}], 2) == (None, None)


# ----------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, weights):
    path = str(tmp_path_factory.mktemp("gsr_ckpt") / "weights.pt")
    sd = state_dict_from_params(weights[0], TCFG)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return path


def _jax_eval(cfg):
    import importlib.util

    from clip_event_tpu.evals.cli import load_model_from_cfg

    spec = importlib.util.spec_from_file_location("eval_gsr", os.path.join(REPO, "eval_gsr.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    params, mcfg = load_model_from_cfg(cfg)
    return mod.evaluate(cfg, params, mcfg)


CLI_CASES = {
    "objects": {"ground_via": "objects", "load_object": True, "prompt": "short"},
    "int8_plain_attention": {"quantize": "int8", "use_pallas_attention": False},
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_eval_gsr_cli_matches_jax(swig, ckpt, tmp_path, case):
    cfg = {"ckpt": ckpt, "batch_size": 4, "seed": 0, "anno_json": swig["anno_json"],
           "image_dir": swig["image_dir"], "ontology_json": swig["ontology_json"],
           "object_detection": swig["object_detection"],
           "object_class_map": swig["object_class_map"], **CLI_CASES[case]}
    out = tmp_path / "gsr.json"
    path = tmp_path / "gsr_cfg.json"
    path.write_text(json.dumps(dict(cfg, output_json=str(out))))
    proc = subprocess.run(
        [sys.executable, "-m", "clip_event_tpu_torch.eval_gsr", "--cfg", str(path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CLIP_EVENT_NATIVE="0"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ours = json.loads(out.read_text())
    assert ours == json.loads(proc.stdout)
    assert_metrics_match(ours, _jax_eval(cfg))
    assert ours["grounded_args"] == 6 and ours["value_frames"] == 6
