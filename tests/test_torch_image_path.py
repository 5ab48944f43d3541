"""The rest of the port's host image path against the JAX package: the
on-device resize (`data/device_pipeline.py`, run here on the CPU) and
`transform.resize_matrix`, the corpus repair (`data/repair.py`, `file://`
URLs only), `ImSituDataset` (`data/situation.py`) on the fixture
tests/test_evals.py uses, `bench_input` at a small size, and the train CLI
reading its images from an image cache: the same loss stream, bit for bit,
as without the cache."""

import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from clip_event_tpu.data import repair as JR  # noqa: E402
from clip_event_tpu.data.common import DataLoader as JaxLoader  # noqa: E402
from clip_event_tpu.data.device_pipeline import preprocess_on_device as jax_on_device  # noqa: E402
from clip_event_tpu.data.situation import ImSituDataset as JaxImSitu  # noqa: E402
from clip_event_tpu.data.situation import load_sr_mapping as jax_load_sr_mapping  # noqa: E402
from clip_event_tpu.data.transform import resize_matrix as jax_resize_matrix  # noqa: E402
from clip_event_tpu_torch import bench_input  # noqa: E402
from clip_event_tpu_torch.config import validate_config  # noqa: E402
from clip_event_tpu_torch.data import cache as TC  # noqa: E402
from clip_event_tpu_torch.data import repair as TR  # noqa: E402
from clip_event_tpu_torch.data import situation as TS  # noqa: E402
from clip_event_tpu_torch.data.common import DataLoader  # noqa: E402
from clip_event_tpu_torch.data.device_pipeline import preprocess_on_device  # noqa: E402
from clip_event_tpu_torch.data.transform import preprocess_image, resize_matrix  # noqa: E402
from clip_event_tpu_torch.train import build_dataset, initial_state, train  # noqa: E402
from tests import fixtures  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

MODEL = {
    "embed_dim": 32, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
    "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2,
}


def _rand_img(rng, h, w):
    return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def test_resize_matrix_equals_jax():
    for in_size, out_size in [(300, 224), (400, 298), (100, 224), (37, 11), (224, 224)]:
        ours = resize_matrix(in_size, out_size)
        assert ours.dtype == np.float32 and not ours.flags.writeable
        np.testing.assert_array_equal(ours, jax_resize_matrix(in_size, out_size))


@pytest.mark.parametrize("hw", [(300, 400), (100, 150), (400, 300)])
def test_preprocess_on_device_matches_jax_and_the_host_path(hw):
    rng = np.random.default_rng(sum(hw))
    imgs = np.stack([_rand_img(rng, *hw) for _ in range(3)])
    got = preprocess_on_device(imgs, 224, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_on_device(imgs, 224)), rtol=0, atol=1e-5)
    # a tensor stays on its device; a float batch is taken as it is
    same = preprocess_on_device(torch.from_numpy(imgs).float(), 224)
    np.testing.assert_array_equal(same.numpy(), got.numpy())
    # the host path up to PIL's uint8 rounding between its passes, where
    # the images shrink (tests/test_transform.py::test_device_pipeline_matches_host's
    # bar; an upscale of noise clips overshoot between PIL's passes, and the
    # JAX test checks only its shape there)
    for i in range(3 if min(hw) >= 224 else 0):
        diff = np.abs(got[i].numpy() - preprocess_image(imgs[i], 224))
        assert np.percentile(diff, 99) <= 1.5 / 255 / 0.26 + 1e-3
        assert diff.max() <= 20.0 / 255 / 0.26


def _voa_with_missing(root):
    """The VOA fixture with three images gone: one with a `file://` URL to a
    copy, one with an empty URL, one whose URL names no file."""
    voa = fixtures.make_voa_fixture(str(root))
    with open(voa["mapping_json"]) as fh:
        mapping = json.load(fh)
    docs = sorted(mapping)
    keep = pathlib.Path(root) / "elsewhere"
    keep.mkdir()
    src = os.path.join(voa["image_dir"], f"{docs[0]}_0.jpg")
    shutil.copy(src, keep / "copy.jpg")
    mapping[docs[0]]["0"]["url"] = (keep / "copy.jpg").as_uri()
    mapping[docs[1]]["0"]["url"] = ""
    mapping[docs[2]]["0"]["url"] = (keep / "absent.jpg").as_uri()
    with open(voa["mapping_json"], "w") as fh:
        json.dump(mapping, fh)
    for d in docs[:3]:
        os.remove(os.path.join(voa["image_dir"], f"{d}_0.jpg"))
    return voa, src, keep / "copy.jpg"


def test_find_and_repair_missing_images_equal_jax(tmp_path):
    summaries = {}
    for name, mod in (("port", TR), ("jax", JR)):
        voa, src, copy = _voa_with_missing(tmp_path / name)
        args = ([voa["mapping_json"]], [voa["image_dir"]])
        missing = mod.find_missing_images(*args)
        assert [m["path"] for m in missing] == [m["path"] for m in JR.find_missing_images(*args)]
        assert len(missing) == 3 and all(not os.path.exists(m["path"]) for m in missing)
        summaries[name] = mod.repair_missing_images(*args, timeout=5.0)
        with open(src, "rb") as got, open(copy, "rb") as want:
            assert got.read() == want.read()
        assert len(mod.find_missing_images(*args)) == 2
    assert summaries["port"] == summaries["jax"] == {"missing": 3, "downloaded": 1, "failed": 2}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("objects", [False, True])
def test_imsitu_dataset_equals_jax(tmp_path, objects):
    import pickle

    paths = fixtures.make_swig_fixture(str(tmp_path))
    kw = dict(image_dir=paths["image_dir"], imsitu_ontology_file=paths["ontology_json"],
              imsitu_annotation_file=paths["anno_json"], verb_mapping_file=paths["mapping_tsv"],
              max_args=4, image_size=32)
    if objects:
        det = {f"swig_{i:03d}.jpg": [{"label": "/m/01g317", "bbox": [5, 5, 60, 90], "score": 0.9},
                                     {"label": "/m/x", "bbox": [0, 0, 9, 9], "score": 0.95}]
               for i in range(6)}
        with open(tmp_path / "det.pkl", "wb") as fh:
            pickle.dump(det, fh)
        (tmp_path / "classes.csv").write_text("/m/01g317,person,1\n/m/x,thing,0\n")
        kw.update(load_object=True, object_ontology_file=str(tmp_path / "classes.csv"),
                  object_detection_pkl_file=str(tmp_path / "det.pkl"), max_objects=3)
    ours, ref = TS.ImSituDataset(**kw), JaxImSitu(**kw)
    assert len(ours) == len(ref) == 6 and ours.ids == ref.ids
    assert ours.vocab_verb.id2word == ref.vocab_verb.id2word
    assert ours.vocab_role.id2word == ref.vocab_role.id2word
    assert ours.vocab_noun.id2word == ref.vocab_noun.id2word
    assert ours.event2id == ref.event2id and ours.eerole2id == ref.eerole2id
    np.testing.assert_array_equal(ours.role_mask, ref.role_mask)
    for i in range(len(ours)):
        (ta, ma), (tj, mj) = ours[i], ref[i]
        _equal(ta, tj)
        assert ma == mj
    batches = [list(DataLoader(ours, 3, shuffle=False, num_workers=2)),
               list(JaxLoader(ref, 3, shuffle=False, num_workers=2))]
    assert len(batches[0]) == len(batches[1]) == 2
    for (ba, ma), (bj, mj) in zip(*batches):
        _equal(ba, bj)
        assert ma == mj
    assert ours.vocab_verb.get("no such verb") == TS.UNK_IDX
    assert TS.event_type_norm("Conflict||Attack ") == "Conflict.Attack"
    assert TS.role_name_norm(" attacker") == "Attacker"
    assert TS.load_sr_mapping(paths["mapping_tsv"]) == jax_load_sr_mapping(paths["mapping_tsv"])


def test_bench_input_keys(capsys):
    out = bench_input.main(["--images", "6"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    # the keys of the repo's bench_input.py
    assert set(out) == {
        "native_images_per_sec", "python_pil_images_per_sec", "native_1w_images_per_sec",
        "native_2w_images_per_sec", "native_4w_images_per_sec", "thread_scaling_4w_over_1w",
        "speedup", "cache_build_images_per_sec", "cached_images_per_sec", "cached_1w_images_per_sec",
        "cached_2w_images_per_sec", "cached_4w_images_per_sec", "cache_speedup",
    }
    assert all(v > 0 for v in out.values())
    assert TC.active_cache() is None and "CLIP_EVENT_NATIVE" not in os.environ


def test_train_cli_loss_stream_is_the_same_from_a_cache(tmp_path, monkeypatch):
    """The port's loop (`build_dataset` + `train`, uint8 images as the card
    takes them) over the VOA fixture: from an image cache of its corpus the
    loss stream equals, bit for bit, the run that decodes every image."""
    monkeypatch.delenv("CLIP_EVENT_IMAGE_CACHE", raising=False)
    torch.use_deterministic_algorithms(True)
    voa = fixtures.make_voa_fixture(str(tmp_path / "voa"))
    cache_dir = str(tmp_path / "cache")
    stats = TC.build_image_cache(TC.scan_image_files(voa["image_dir"]), cache_dir,
                                 size=MODEL["image_resolution"], num_workers=2)
    assert stats["images"] == 6 and stats["failed"] == 0
    hits = []
    get_u8 = TC.ImageCache.get_u8

    def counted(self, path, size=224):
        out = get_u8(self, path, size)
        hits.append(out is not None)
        return out

    monkeypatch.setattr(TC.ImageCache, "get_u8", counted)
    base = {"task": "cache", "constrastive_loss": "ce", "model": MODEL,
            "posneg_descriptions_json": voa["descriptions_json"],
            "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
            "max_epoch": 1, "batch_size": 2, "lr": 1e-3, "optimizer": "adam",
            "lr_scheduler": "none", "compute_dtype": "float32", "remat": False,
            "num_workers": 2, "seed": 5, "length_buckets": [16], "dedupe_texts": 4}
    streams = {}
    try:
        for name, extra in (("cached", {"image_cache": cache_dir}), ("live", {})):
            TC.activate(None)
            cfg = validate_config(dict(base, ckpt_dir=str(tmp_path / f"ck_{name}"), **extra))
            params, mcfg, resume = initial_state(cfg, "cpu")
            record = streams[name] = {}
            train(cfg, mcfg, build_dataset(cfg, mcfg), params, "cpu",
                  on_step=lambda step, m, r=record: r.__setitem__(step, float(m["loss"])), **resume)
            if name == "cached":
                assert TC.active_cache() is not None and TC.active_cache().cache_dir == cache_dir
                assert len(hits) == 6 and all(hits)
    finally:
        torch.use_deterministic_algorithms(False)
        TC.activate(None)
    assert len(hits) == 6  # the live run read no cache
    assert sorted(streams["cached"]) == list(range(3))
    assert streams["cached"] == streams["live"]


def test_tokenize_on_loader_threads_equals_serial_and_jax():
    """The loader tokenizes on its threads; the tokenizer's matches keep the
    GIL (`concurrent=False`), which changes their speed there, not their
    tokens: 16 threads give the serial rows and the JAX package's."""
    from concurrent.futures import ThreadPoolExecutor

    from clip_event_tpu.tokenizer import tokenize as jax_tokenize
    from clip_event_tpu_torch.tokenizer import tokenize

    texts = [f"A {ev} event in {city}, said  the   reporter's 2nd source."
             for ev in ("protest", "flood", "trial") for city in ("Kabul", "Lima", "Ōsaka")]
    serial = tokenize(texts, 32)
    with ThreadPoolExecutor(max_workers=16) as pool:
        rows = list(pool.map(lambda t: tokenize([t], 32)[0], texts * 4))
    np.testing.assert_array_equal(np.stack(rows), np.concatenate([serial] * 4))
    np.testing.assert_array_equal(serial, jax_tokenize(texts, 32))
