"""The port's training data layer and config schema against the JAX
package, on the VOA fixture corpus of tests/fixtures.py: the fine-tuning
dataset's examples and batches (uint8 and float images, label layouts,
dedupe fields, length buckets), the loader's shuffled, resumed and
bucketed batch plans, the config defaults and the keys this port refuses,
`device_prefetch` on the CPU, and the checkpoint file's round trip. Every
comparison is exact: the same numpy ops run on both sides."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from clip_event_tpu import config as JC  # noqa: E402
from clip_event_tpu.data.common import DataLoader as JaxLoader  # noqa: E402
from clip_event_tpu.data.voa import VOADescriptionDataset as JaxVOA  # noqa: E402
from clip_event_tpu_torch import config as TC  # noqa: E402
from clip_event_tpu_torch.data.common import DataLoader, pad_stack  # noqa: E402
from clip_event_tpu_torch.data.prefetch import device_prefetch  # noqa: E402
from clip_event_tpu_torch.data.voa import VOADescriptionDataset  # noqa: E402
from clip_event_tpu_torch.engine import checkpoint as CK  # noqa: E402
from clip_event_tpu_torch.engine.optim import build_optimizer, tree_leaves  # noqa: E402
from clip_event_tpu_torch.models import layers  # noqa: E402
from clip_event_tpu_torch.models.clip import CLIPConfig, init_params  # noqa: E402
from tests.fixtures import make_voa_fixture  # noqa: E402


@pytest.fixture(scope="module")
def voa(tmp_path_factory):
    return make_voa_fixture(str(tmp_path_factory.mktemp("voa_data")), num_docs=9)


def _datasets(voa, **kw):
    args = (voa["descriptions_json"], [voa["mapping_json"]], [voa["image_dir"]])
    return VOADescriptionDataset(*args, image_size=32, **kw), JaxVOA(*args, image_size=32, **kw)


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("uint8", [True, False])
def test_dataset_examples_and_batches_match(voa, uint8, monkeypatch):
    # the JAX package's float path, not its native JPEG decoder (1 ulp off
    # the Python path by design; not ported yet)
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    ours, ref = _datasets(voa, uint8_images=uint8, dedupe_texts=12, context_cap=24)
    assert len(ours) == len(ref) == 9 and ours.num_desc == ref.num_desc == 3
    for i in (0, 4, 8):
        (ta, ma), (ja, mj) = ours[i], ref[i]
        _equal(ta, ja)
        assert ta["image"].dtype == (np.uint8 if uint8 else np.float32)
        assert ma["image_id"] == mj["image_id"] and ma["descriptions"] == mj["descriptions"]
    _equal(ours.batch_extras(3), ref.batch_extras(3))
    stack = {k: np.stack([ours[i][0][k] for i in range(3)]) for k in ("text", "image")}
    _equal(ours.finalize_batch(dict(stack)), ref.finalize_batch(dict(stack)))
    np.testing.assert_array_equal(ours.instance_widths(), ref.instance_widths())


def test_unported_channels_raise(voa, monkeypatch):
    """Every data channel is ported: the SR/bbox channel (`load_sr`) is
    accepted and carries JAX's fields (held bit for bit in
    tests/test_torch_local_attention.py; the object and IE channels in
    tests/test_torch_ot_train.py). The multi-process batch assembly
    (`dist_rank` / `dist_world`, ROADMAP A6(a)) is ported too: a rank's
    label layout is JAX's, and a dedupe cap the world does not divide is
    refused as in JAX."""
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    args = (voa["descriptions_json"], [voa["mapping_json"]], [voa["image_dir"]])
    ours = VOADescriptionDataset(*args, load_sr=True, max_bboxes=3, image_size=32,
                                 object_pickles=[voa["object_pickle"]],
                                 object_ontology_file=voa["ontology_csv"])
    ref = JaxVOA(*args, load_sr=True, max_bboxes=3, image_size=32,
                 object_pickles=[voa["object_pickle"]], object_ontology_file=voa["ontology_csv"])
    _equal(ours[0][0], ref[0][0])
    assert ours[0][0]["bbox_mask"].tolist() == [1, 1, 0]
    ours = VOADescriptionDataset(*args, dist_rank=1, dist_world=2, image_size=32)
    ref = JaxVOA(*args, dist_rank=1, dist_world=2, image_size=32)
    _equal(ours.batch_extras(2), ref.batch_extras(2))
    assert ours.batch_extras(2)["labels_per_image"].tolist() == [6, 9]
    with pytest.raises(ValueError, match="divide by world size 2"):
        VOADescriptionDataset(*args, dist_world=2, dedupe_texts=5)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True),
    dict(shuffle=False, drop_last=False),
    dict(shuffle=True, drop_last=True, bucket_widths=[16]),
])
def test_loader_plans_match(voa, kw):
    """Per-epoch shuffle, drop_last, a mid-epoch start, length buckets: the
    same batches in the same order as the JAX loader."""
    ours, ref = _datasets(voa, uint8_images=True)
    tl = DataLoader(ours, batch_size=2, seed=7, num_workers=2, **kw)
    jl = JaxLoader(ref, batch_size=2, seed=7, num_workers=2, **kw)
    assert len(tl) == len(jl)
    for epoch, start in ((0, 0), (1, 0), (1, 2)):
        tl.set_epoch(epoch, start)
        jl.set_epoch(epoch, start)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl) - start
        for (tb, tm), (jb, jm) in zip(got, want):
            _equal(tb, jb)
            assert [m["image_id"] for m in tm] == [m["image_id"] for m in jm]
    if "bucket_widths" in kw:
        assert tl.bucket_widths == [16, 77] and {b["text"].shape[-1] for b, _ in got} == {16}


def test_pad_stack():
    out = pad_stack([np.ones((2,), np.int32)] * 3, 5)
    assert out.dtype == np.int32 and out.sum() == 6 and out.shape == (5, 2)
    assert pad_stack([], 2, pad_shape=(3,)).shape == (2, 3)


def test_prefetch_on_cpu_keeps_order_and_reraises():
    loader = [({"x": np.full((2,), i)}, [i]) for i in range(5)]
    got = list(device_prefetch(loader, "cpu", depth=2))
    assert [m for _, m in got] == [[i] for i in range(5)]
    assert all(isinstance(b["x"], torch.Tensor) and int(b["x"][0]) == i
               for i, (b, _) in enumerate(got))

    def broken():
        yield {"x": np.zeros(1)}, []
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(device_prefetch(broken(), "cpu"))


def test_config_defaults_and_refusals():
    assert TC._DEFAULTS == JC._DEFAULTS
    base = {"task": "t", "constrastive_loss": "ce", "batch_size": 2, "lr": 1e-4,
            "optimizer": "adam", "max_epoch": 1}
    ours, ref = TC.validate_config(base), JC.validate_config(base)
    assert ours == ref
    # tensor, sequence, multi-slice and pipeline parallelism, and ZeRO-1 /
    # FSDP composed with them, are accepted as JAX accepts them (no key is
    # refused as not ported any more); JAX's own refusal of pp with tp stays
    for extra in ({"tp": 2}, {"tp": 2, "sp": True}, {"dcn_dp": 2}, {"pp": 2, "pp_microbatches": 3},
                  {"tp": 2, "zero": True}, {"dcn_dp": 2, "fsdp": True}, {"pp": 2, "zero": True}):
        assert TC.validate_config(dict(base, **extra)) == JC.validate_config(dict(base, **extra))
    assert TC._UNPORTED == {}
    with pytest.raises(TC.ConfigError, match="pp>1 and tp>1 are mutually exclusive"):
        TC.validate_config(dict(base, pp=2, tp=2))
    # the sharded optimizer state and params (A6(b)) are accepted as JAX
    # accepts them, and a value that is not a bool is refused alike
    for key in ("zero", "fsdp"):
        assert TC.validate_config(dict(base, **{key: True})) == JC.validate_config(dict(base, **{key: True}))
        for pkg in (TC, JC):
            with pytest.raises(pkg.ConfigError, match=f"{key} must be a bool"):
                pkg.validate_config(dict(base, **{key: 1}))
    # the image cache (A7) is accepted, as the JAX package accepts it: the
    # two shipped configs that set it validate as in JAX, and so does the
    # shipped tp config
    assert TC.validate_config(dict(base, image_cache="/c")) == JC.validate_config(dict(base, image_cache="/c"))
    configs = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
    for name in ("finetune_template_fast.json", "finetune_real_voa.json", "pretrain_vitl14_tp2.json"):
        with open(os.path.join(configs, name)) as fh:
            raw = json.load(fh)
        if name.startswith("pretrain"):
            assert raw["tp"] == 2 and TC.validate_config(raw) == JC.validate_config(raw)
        else:
            assert raw["image_cache"] and TC.validate_config(raw) == JC.validate_config(raw)
    # the SR channel, multiattention (A4) and the ResNet towers (A2) are
    # accepted, as the JAX package accepts them
    for extra in ({"multiattention": True, "load_object": True, "object_ontology_file": "o.csv"},
                  {"load_sr": True, "dedupe_sr_texts": 8}):
        assert TC.validate_config(dict(base, **extra)) == JC.validate_config(dict(base, **extra))
    rn_dict = {"embed_dim": 64, "image_resolution": 32, "vision_layers": [1, 1, 1, 1],
               "vision_width": 64, "vision_patch_size": None, "context_length": 77,
               "vocab_size": 512, "transformer_width": 64, "transformer_heads": 1,
               "transformer_layers": 1}
    for spec in ("RN50", "RN101", "RN50x4", rn_dict):
        ours, ref = TC.model_config({"model": spec}), JC.model_config({"model": spec})
        assert not ours.is_vit and dataclasses.asdict(ours) == dataclasses.asdict(ref)
    # data parallelism (A6(a)) is ported: the LayerNorm choice takes the
    # port's mesh (each rank's kernel runs on its own rows) and refuses
    # anything else
    from clip_event_tpu_torch.parallel.mesh import make_mesh

    layers.set_ln_impl("xla", mesh=make_mesh("cpu"))
    assert layers._resolve_ln() == "xla"
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        layers.set_ln_impl("xla", mesh=object())
    for bad in ({"constrastive_loss": "bce"}, {"batch_size": 0}, {"length_buckets": [80]},
                {"lr_scheduler": "linear"}):
        with pytest.raises(TC.ConfigError):
            TC.validate_config(dict(base, **bad))
        with pytest.raises(JC.ConfigError):
            JC.validate_config(dict(base, **bad))


def test_checkpoint_round_trip(tmp_path):
    cfg = CLIPConfig(64, 32, 1, 64, 16, 77, 512, 64, 1, 1)
    params = init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    opt = build_optimizer("adam", 1e-3, moment_dtype="bfloat16")
    state = opt.init(params)
    for epoch in (0, 3):
        path = CK.save_checkpoint(str(tmp_path), "t", epoch, params, state, cfg, perf=0.5,
                                  step=7, mid_epoch=epoch == 3)
    assert path == CK.latest_checkpoint(str(tmp_path), "t") and path.endswith("t_3")
    assert CK.load_meta(path) == {"epoch": 3, "model": "t", "perf": 0.5, "step": 7,
                                  "mid_epoch": True}
    p2, s2, meta, cfg2 = CK.restore_checkpoint(path)
    assert cfg2 == cfg and meta["step"] == 7
    for a, b in zip(tree_leaves(p2), tree_leaves(params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(s2["mu"]), tree_leaves(state["mu"])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert CK.latest_checkpoint(str(tmp_path), "missing") is None
