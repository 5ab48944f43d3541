"""The port's offline image cache (`data/cache.py`), native decoder
(`data/native.py`), `load_image_file` and `cache_images` CLI against the
JAX package's, on synthetic JPEGs made as tests/test_cache.py makes them.

The cache files are the JAX package's bytes, each package reads the
other's cache, a hit equals the live decode bit for bit, and misses, size
mismatches, unreadable files and CLIP_EVENT_IMAGE_CACHE behave alike. The
native entry points equal JAX's (the same source and flags) bit for bit,
and the pure-Python path bit for bit on the uint8 stage and on the float
one within the 1-ulp difference of its /255 (ADVICE.md: the native
normalize multiplies by 1/255 where numpy divides; after the subtraction
of the mean and the division by the std that is the JAX tests' atol 1e-6)."""

import json
import os

import numpy as np
import pytest
from PIL import Image

import cache_images as jax_cache_images
from clip_event_tpu.data import cache as JC
from clip_event_tpu.data import common as JCommon
from clip_event_tpu.data import native as JN
from clip_event_tpu_torch import cache_images as port_cache_images
from clip_event_tpu_torch.data import cache as TC
from clip_event_tpu_torch.data import common as TCommon
from clip_event_tpu_torch.data import native as TN
from clip_event_tpu_torch.data.transform import (
    preprocess_image,
    preprocess_image_u8,
    resize_bicubic_uint8,
)
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

FLOAT_ATOL = 1e-6  # the /255 stage's 1 ulp, through (v - mean) / std
SHAPES = [(300, 500), (224, 224), (120, 90), (640, 480)]


@pytest.fixture
def jpeg_corpus(tmp_path):
    rng = np.random.default_rng(7)
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p = tmp_path / "jpg" / f"img_{i}.jpg"
        p.parent.mkdir(exist_ok=True)
        Image.fromarray(arr).save(p, quality=90)
        paths.append(str(p))
    return paths


@pytest.fixture(autouse=True)
def _no_global_cache():
    yield
    TC.activate(None)
    JC.activate(None)


def _native_or_skip():
    """The port's library; the test skips only where g++ or libjpeg's
    header is missing (the JAX package's native tests skip there too)."""
    if TN.jpeg_decoder() != "libjpeg":
        err = TN.build_error() or ""
        if "jpeglib.h" in err or "No such file or directory: 'g++'" in err:
            pytest.skip(f"g++ or jpeglib.h missing: {err.splitlines()[0]}")
        pytest.fail(f"the native library did not build with libjpeg: {err}")
    if not JN.available():
        pytest.skip("the JAX package's native library does not build here")
    return TN.get_lib()


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("native_flag", ["1", "0"])
def test_cache_files_are_the_jax_packages_bytes(jpeg_corpus, tmp_path, monkeypatch, native_flag):
    monkeypatch.setenv("CLIP_EVENT_NATIVE", native_flag)
    if native_flag == "1":
        _native_or_skip()
    ours, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    # one worker: the JAX index lists keys as its threads finish them
    stats = TC.build_image_cache(jpeg_corpus, ours, size=64, num_workers=1)
    assert stats == JC.build_image_cache(jpeg_corpus, ref, size=64, num_workers=1)
    assert stats == {"images": 4, "failed": 0, "size": 64}
    for name in ("images.u8", "index.json"):
        assert _read(os.path.join(ours, name)) == _read(os.path.join(ref, name)), name
    # the port's index is in row order whatever its threads do
    threaded = str(tmp_path / "port_threads")
    TC.build_image_cache(jpeg_corpus, threaded, size=64, num_workers=3)
    for name in ("images.u8", "index.json"):
        assert _read(os.path.join(threaded, name)) == _read(os.path.join(ref, name)), name


def test_each_package_reads_the_others_cache(jpeg_corpus, tmp_path):
    ours, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    TC.build_image_cache(jpeg_corpus, ours, size=64, num_workers=2)
    JC.build_image_cache(jpeg_corpus, ref, size=64, num_workers=2)
    for reader, cache_dir in ((TC.ImageCache, ref), (JC.ImageCache, ours)):
        cache = reader(cache_dir)
        assert len(cache) == 4 and cache.size == 64
        for p in jpeg_corpus:
            with Image.open(p) as img:
                u8 = preprocess_image_u8(img, 64)
            np.testing.assert_array_equal(cache.get_u8(p, 64), u8)
            np.testing.assert_array_equal(cache.get(p, 64), preprocess_image(u8, 64))


def test_hits_misses_size_mismatch_and_unreadable_files(jpeg_corpus, tmp_path):
    bad = str(tmp_path / "jpg" / "bad.jpg")
    with open(bad, "wb") as fh:
        fh.write(b"not a jpeg")
    stats = {}
    for name, mod in (("port", TC), ("jax", JC)):
        cache_dir = str(tmp_path / name)
        stats[name] = mod.build_image_cache(jpeg_corpus[:3] + [bad], cache_dir, size=64)
        cache = mod.ImageCache(cache_dir)
        assert len(cache) == 3
        assert cache.get(jpeg_corpus[3], 64) is None      # not cached
        assert cache.get_u8(jpeg_corpus[0], 96) is None   # another size
        assert cache.get_u8(bad, 64) is None              # skipped
        # a path elsewhere resolves by its basename
        moved = str(tmp_path / "moved" / os.path.basename(jpeg_corpus[1]))
        assert cache.get_u8(moved, 64) is not None
        np.testing.assert_array_equal(cache.get_u8(moved, 64), cache.get_u8(jpeg_corpus[1], 64))
    assert stats["port"] == stats["jax"] == {"images": 3, "failed": 1, "size": 64}
    # relative keys, and scan_image_files
    root = os.path.dirname(jpeg_corpus[0])
    assert TC.scan_image_files(root) == JC.scan_image_files(root) == sorted(jpeg_corpus + [bad])
    assert TC.path_key(jpeg_corpus[0], relative_to=str(tmp_path)) == os.path.join("jpg", "img_0.jpg")


def test_env_var_activation(jpeg_corpus, tmp_path, monkeypatch):
    cache_dir = str(tmp_path / "cache")
    TC.build_image_cache(jpeg_corpus, cache_dir, size=64)
    monkeypatch.setenv("CLIP_EVENT_IMAGE_CACHE", cache_dir)
    # reset the lazy latch so this process reads the variable again
    monkeypatch.setattr(TC, "_env_checked", False)
    monkeypatch.setattr(TC, "_active", None)
    assert TC.active_cache() is not None and TC.active_cache().cache_dir == cache_dir
    monkeypatch.setenv("CLIP_EVENT_IMAGE_CACHE", str(tmp_path / "nowhere"))
    monkeypatch.setattr(TC, "_env_checked", False)
    monkeypatch.setattr(TC, "_active", None)
    assert TC.active_cache() is None  # an unusable cache is logged, not raised


def test_native_entry_points_equal_jax_and_python(jpeg_corpus):
    import ctypes

    lib = _native_or_skip()
    rng = np.random.default_rng(0)
    for in_hw, out_hw in [((480, 640), (224, 224)), ((100, 100), (224, 224)), ((97, 131), (33, 57))]:
        img = rng.integers(0, 256, size=in_hw + (3,), dtype=np.uint8)
        ours = TN.resize_bicubic(img, *out_hw)
        np.testing.assert_array_equal(ours, JN.resize_bicubic(img, *out_hw))
        np.testing.assert_array_equal(ours, resize_bicubic_uint8(img, *out_hw))
    for shape in [(480, 640), (311, 475), (224, 224), (150, 90)]:
        img = rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
        u8 = TN.preprocess_rgb_u8(img, 224)
        np.testing.assert_array_equal(u8, JN.preprocess_rgb_u8(img, 224))
        np.testing.assert_array_equal(u8, preprocess_image_u8(img, 224))
        ours = TN.preprocess_rgb(img, 224)
        np.testing.assert_array_equal(ours, JN.preprocess_rgb(img, 224))
        np.testing.assert_allclose(ours, preprocess_image(img, 224), rtol=0, atol=FLOAT_ATOL)
    for p in jpeg_corpus:
        with Image.open(p) as img:
            u8 = preprocess_image_u8(img, 224)
            h, w = img.height, img.width
        got = TN.preprocess_jpeg_file_u8(p, 224)
        np.testing.assert_array_equal(got, JN.preprocess_jpeg_file_u8(p, 224))
        np.testing.assert_array_equal(got, u8)
        ours = TN.preprocess_jpeg_file(p, 224)
        np.testing.assert_array_equal(ours, JN.preprocess_jpeg_file(p, 224))
        np.testing.assert_allclose(ours, preprocess_image(u8, 224), rtol=0, atol=FLOAT_ATOL)
        dims = (ctypes.c_int(), ctypes.c_int())
        data = _read(p)
        assert lib.ce_jpeg_dims(data, len(data), ctypes.byref(dims[0]), ctypes.byref(dims[1])) == 0
        assert (dims[0].value, dims[1].value) == (h, w)
    # bytes libjpeg refuses: None, and the caller falls back
    bad = os.path.join(os.path.dirname(jpeg_corpus[0]), "bad.jpg")
    with open(bad, "wb") as fh:
        fh.write(b"not a jpeg")
    assert TN.preprocess_jpeg_file_u8(bad) is None and TN.preprocess_jpeg_file(bad) is None
    with pytest.raises(ValueError, match="RGB"):
        TN.preprocess_rgb_u8(np.zeros((8, 8), np.uint8))


def test_library_without_libjpeg_decodes_with_pil(jpeg_corpus, monkeypatch):
    """The build for a host without libjpeg (`-DCE_NO_LIBJPEG`): its JPEG
    entry points decode with PIL and give the libjpeg build's bits."""
    full = _native_or_skip()
    expected = [(TN.preprocess_jpeg_file_u8(p, 96), TN.preprocess_jpeg_file(p, 96)) for p in jpeg_corpus]
    monkeypatch.setattr(TN, "_lib", TN.build_library(jpeg=False))
    assert TN.jpeg_decoder() == "PIL" and full.ce_has_libjpeg() == 1
    assert TN.library_path(jpeg=False) != TN.library_path(jpeg=True)
    for p, (u8, f32) in zip(jpeg_corpus, expected):
        np.testing.assert_array_equal(TN.preprocess_jpeg_file_u8(p, 96), u8)
        np.testing.assert_array_equal(TN.preprocess_jpeg_file(p, 96), f32)


@pytest.mark.parametrize("raw", [True, False])
def test_load_image_file_with_a_cache_equals_jax(jpeg_corpus, tmp_path, raw):
    """Hits from each package's cache, a miss decoded live (raw: PIL and the
    Python u8 path; float: the native path for a JPEG), and the basename
    fallback of a moved file."""
    TC.activate(None)
    JC.activate(None)
    live = [TCommon.load_image_file(p, 64, raw=raw) for p in jpeg_corpus]
    TC.build_image_cache(jpeg_corpus[:3], str(tmp_path / "port"), size=64)
    JC.build_image_cache(jpeg_corpus[:3], str(tmp_path / "jax"), size=64)
    TC.activate(str(tmp_path / "port"))
    JC.activate(str(tmp_path / "jax"))
    moved = str(tmp_path / "moved" / os.path.basename(jpeg_corpus[0]))
    for p in jpeg_corpus + [moved]:
        ours, ref = TCommon.load_image_file(p, 64, raw=raw), JCommon.load_image_file(p, 64, raw=raw)
        assert ours.dtype == (np.uint8 if raw else np.float32) == ref.dtype
        np.testing.assert_array_equal(ours, ref, err_msg=p)
    # a hit is the Python path's bits; the live miss (jpeg_corpus[3]) is the decoder's
    hit = preprocess_image_u8(np.asarray(Image.open(jpeg_corpus[1]).convert("RGB")), 64)
    np.testing.assert_array_equal(TCommon.load_image_file(jpeg_corpus[1], 64, raw=raw),
                                  hit if raw else preprocess_image(hit, 64))
    np.testing.assert_array_equal(TCommon.load_image_file(jpeg_corpus[3], 64, raw=raw), live[3])


def test_cache_images_cli_equals_jax(jpeg_corpus, tmp_path, capsys):
    image_dir = os.path.dirname(jpeg_corpus[0])
    out = {}
    for name, cli in (("port", port_cache_images), ("jax", jax_cache_images)):
        assert cli.main(["--image-dir", image_dir, "--out", str(tmp_path / name), "--workers", "2",
                         "--size", "64"]) == 0
        out[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["port"].keys() == out["jax"].keys()
    for key in ("images", "failed", "size"):
        assert out["port"][key] == out["jax"][key], key
    assert out["port"]["out"] == str(tmp_path / "port")
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(jpeg_corpus[:2]) + "\n")
    assert port_cache_images.main(["--list", str(listing), "--out", str(tmp_path / "l"), "--size", "64"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["images"] == 2
    with pytest.raises(SystemExit):
        port_cache_images.main(["--out", str(tmp_path / "x")])
