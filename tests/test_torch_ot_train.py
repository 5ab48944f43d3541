"""The port's OT graph-alignment fine-tuning path against the JAX package,
on the CPU in fp32: `sim_entity` (node-axis chunks, the divisor rule), the
object-crop and text-IE channels of `VOADescriptionDataset` on the VOA
fixture corpus of tests/fixtures.py (every tensor exactly equal, through
the loader, length buckets and dedupe), the train step with the alignment
branch (loss, loss_ot, grad_norm and SGD params after 2 steps), the train
CLI on a finetune_ot-like config (epoch losses), the config schema, and
the attention launches a step makes under the nested chunk- and
block-level checkpoints.

Tolerances: encoders atol 1e-4; losses and SGD params atol 1e-5, grad_norm
rtol 1e-4 (fp32 on both sides, only reduction orders differ); the CLI's
epoch losses 1e-5; data exactly equal (the same numpy ops on both sides).

Model: ViT towers of 2 layers, vision width 64 (1 head), patch 16, image
32; text width 64, 1 head, 77 tokens."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu import config as JC  # noqa: E402
from clip_event_tpu.data.common import DataLoader as JaxLoader  # noqa: E402
from clip_event_tpu.data.voa import VOADescriptionDataset as JaxVOA  # noqa: E402
from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.engine.checkpoint import export_torch_checkpoint  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch import config as TC  # noqa: E402
from clip_event_tpu_torch.data.common import DataLoader  # noqa: E402
from clip_event_tpu_torch.data.labels import build_label_layout  # noqa: E402
from clip_event_tpu_torch.data.voa import VOADescriptionDataset  # noqa: E402
from clip_event_tpu_torch.engine import optim as TO  # noqa: E402
from clip_event_tpu_torch.engine import train_step as TT  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402
from tests.fixtures import make_voa_fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {
    "embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
    "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2,
}
JCFG, TCFG = J.CLIPConfig(**MODEL), T.CLIPConfig(**MODEL)
B, NPOS, NNEG, NOBJ, NENT = 3, 1, 2, 4, 6


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(1), JCFG))


@pytest.fixture(scope="module")
def voa(tmp_path_factory):
    return make_voa_fixture(str(tmp_path_factory.mktemp("voa_ot")))


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _tokens(rng, shape):
    out = np.zeros(shape + (77,), np.int32)
    for idx in np.ndindex(*shape):
        eot = int(rng.integers(2, 30))
        out[idx][0] = 49406
        out[idx][1:eot] = rng.integers(1, 49000, eot - 1)
        out[idx][eot] = 49407
    return out


def _batch(seed):
    """A batch of the alignment workload: float32 images and crops (slot 0
    the whole image), ragged object and entity masks (one image with no
    entity), 3 descriptions per image."""
    rng = np.random.default_rng(seed)
    layout = build_label_layout(B, NPOS, NNEG)
    crops = rng.normal(size=(B, NOBJ, 32, 32, 3)).astype(np.float32)
    obj_n, ent_n = np.array([4, 2, 3]), np.array([6, 0, 3])
    crops[np.arange(NOBJ)[None] >= obj_n[:, None]] = 0.0
    return {
        "image": crops[:, 0].copy(),
        "text": _tokens(rng, (B * (NPOS + NNEG),)),
        "object_image": crops,
        "object_mask": (np.arange(NOBJ)[None] < obj_n[:, None]).astype(np.int32),
        "entity_text": _tokens(rng, (B, NENT)),
        "entity_mask": (np.arange(NENT)[None] < ent_n[:, None]).astype(np.int32),
        "labels_per_image": layout.labels_per_image,
        "labels_per_text": layout.labels_per_text,
        "index_pos": layout.index_pos,
    }


@pytest.mark.parametrize("chunks", [1, 3])
def test_sim_entity_matches(np_params, chunks):
    """chunks=3 → 4 object slots in 4 slices (the smallest divisor of 4 that
    is ≥ 3) and 6 entity rows in 3 slices of 2."""
    batch = _batch(0)
    jp = jax.tree.map(jnp.asarray, np_params)
    ref = J.sim_entity(jp, JCFG, jnp.asarray(batch["object_image"]),
                       jnp.asarray(batch["entity_text"]), chunks=chunks)
    params = params_from_jax(np_params, TCFG, device="cpu")
    for p in TO.tree_leaves(params):
        p.requires_grad_(True)
    ours = T.sim_entity(params, TCFG, torch.from_numpy(batch["object_image"]),
                        torch.from_numpy(batch["entity_text"]), chunks=chunks, remat=True)
    assert ours[0].shape == (B, NOBJ, 64) and ours[1].shape == (B, NENT, 64)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-4, rtol=0)
    # chunking changes memory, not math
    flat = T.sim_entity(params, TCFG, torch.from_numpy(batch["object_image"]),
                        torch.from_numpy(batch["entity_text"]), chunks=1)
    for a, b in zip(ours, flat):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, rtol=0)


def _datasets(voa, **kw):
    args = (voa["descriptions_json"], [voa["mapping_json"]], [voa["image_dir"]])
    channels = dict(
        load_object=True, object_pickles=[voa["object_pickle"]],
        object_ontology_file=voa["ontology_csv"], max_objects=4, load_ie=True,
        input_entities=[voa["entity_cs"]], input_events=[voa["event_cs"]], max_entities=3,
        max_events=2, image_size=32,
    )
    return (VOADescriptionDataset(*args, **channels, **kw), JaxVOA(*args, **channels, **kw))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_dataset_object_and_ie_channels_match(voa, monkeypatch):
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    ours, ref = _datasets(voa, uint8_images=True, dedupe_texts=8, context_cap=24)
    for i in range(len(ours)):
        (ta, ma), (ja, mj) = ours[i], ref[i]
        _equal(ta, ja)
        # the main image is the float32 whole-image crop even with uint8_images
        assert ta["image"].dtype == np.float32 and ta["object_image"].shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(ta["image"], ta["object_image"][0])
        # 2 detections pass the ontology and the threshold, plus slot 0
        assert ta["object_mask"].tolist() == [1, 1, 1, 0]
        assert ta["entity_mask"].tolist() == [1, 0, 0] and ta["event_mask"].tolist() == [1, 0]
        assert ta["entity_text"].dtype == np.int32 and ta["entity_text"].shape == (3, 24)
        for key in ("object_ids", "object_labels", "entity_names", "event_names"):
            assert ma[key] == mj[key], key
    stack = {k: np.stack([ours[i][0][k] for i in range(3)]) for k in ours[0][0]}
    _equal(ours.finalize_batch({**stack, **ours.batch_extras(3)}),
           ref.finalize_batch({**stack, **ref.batch_extras(3)}))


def test_loader_with_channels_buckets_matches(voa, monkeypatch):
    """Length buckets slice only the description channel; the object and
    IE channels pass through the loader as in JAX."""
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    ours, ref = _datasets(voa)
    kw = dict(batch_size=2, seed=3, num_workers=2, bucket_widths=[16])
    got, want = list(DataLoader(ours, **kw)), list(JaxLoader(ref, **kw))
    assert len(got) == len(want) == 3
    for (tb, tm), (jb, jm) in zip(got, want):
        _equal(tb, jb)
        assert tb["text"].shape[-1] == 16 and tb["entity_text"].shape == (2, 3, 77)
        assert [m["image_id"] for m in tm] == [m["image_id"] for m in jm]


def _optimizers():
    return (JO.build_optimizer("sgd", JO.build_schedule("none", 1e-2, 30)),
            TO.build_optimizer("sgd", TO.build_schedule("none", 1e-2, 30)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def test_alignment_train_steps_match(np_params):
    """Two SGD steps with the alignment branch (chunks 2): every loss term,
    grad_norm, and the params after each step."""
    jopt, topt = _optimizers()
    jstep = JT.make_train_step(JCFG, jopt, donate=False, compute_dtype=jnp.float32, remat=False,
                               alignment=True, use_pallas_ot=False, alignment_chunks=2)
    tstep = TT.make_train_step(TCFG, topt, compute_dtype=torch.float32, remat=True,
                               alignment=True, use_pallas_ot=True, alignment_chunks=2)
    js = JT.create_train_state(jax.tree.map(jnp.asarray, np_params), jopt)
    ts = TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"), topt)
    for i in range(2):
        batch = _batch(10 + i)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, _t(batch))
        for k in ("loss", "loss_i", "loss_t", "loss_ot"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["loss_ot"]) > 0 and bool(tm["finite"])
        a, b = _flat(ts.params), _flat(js.params)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0, err_msg=k)


def test_attention_calls_under_nested_checkpoints(np_params, monkeypatch):
    """With full remat and chunked alignment, each block of the main towers
    runs its attention forward twice per step (forward, block recompute)
    and each block of a chunk three times (forward, chunk recompute, block
    recompute); every block runs one backward. chip_smoke.py pins its K1
    launch counts on this rule."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = TA._FusedAttention.forward, TA._FusedAttention.backward

    def count_fwd(ctx, *args):
        calls["fwd"] += 1
        return fwd(ctx, *args)

    def count_bwd(ctx, *args):
        calls["bwd"] += 1
        return bwd(ctx, *args)

    monkeypatch.setattr(TA._FusedAttention, "forward", staticmethod(count_fwd))
    monkeypatch.setattr(TA._FusedAttention, "backward", staticmethod(count_bwd))
    params = TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"),
                                   _optimizers()[1]).params
    total, _ = TT.loss_fn(params, _t(_batch(20)), TCFG, remat=True, alignment=True,
                          alignment_chunks=2)
    torch.autograd.grad(total, TO.tree_leaves(params))
    blocks = MODEL["vision_layers"] + MODEL["transformer_layers"]
    chunked = 2 * MODEL["vision_layers"] + 2 * MODEL["transformer_layers"]  # 4 slots / 2, 6 rows / 2
    assert calls == {"fwd": 2 * blocks + 3 * chunked, "bwd": blocks + chunked}


def test_config_accepts_finetune_ot_and_refuses_the_rest():
    with open(os.path.join(REPO, "configs", "finetune_ot.json")) as fh:
        raw = json.load(fh)
    ours, ref = TC.validate_config(raw), JC.validate_config(raw)
    assert ours["alignment"] and ours["load_object"] and ours["load_ie"]
    for key in ("use_pallas_ot", "max_objects", "max_entities", "max_events", "object_topk",
                "object_detection_threshold", "alignment_chunks"):
        assert ours[key] == ref[key], key
    # the local-attention branch (A4) is accepted beside the OT branch, as
    # in JAX; the parts still refused are model parallelism (A6(c)) and the
    # image cache (A7)
    for extra in ({"multiattention": True}, {"load_sr": True, "dedupe_sr_texts": 16}):
        assert TC.validate_config(dict(raw, **extra)) == JC.validate_config(dict(raw, **extra))
    for key, value, item in [("tp", 2, r"A6\(c\)"), ("image_cache", "/c", "A7")]:
        with pytest.raises(TC.ConfigError, match=f"ROADMAP {item}"):
            TC.validate_config(dict(raw, **{key: value}))
    for bad in ({"load_object": False}, {"load_ie": False}, {"object_ontology_file": None}):
        with pytest.raises(TC.ConfigError):
            TC.validate_config(dict(raw, **bad))
        with pytest.raises(JC.ConfigError):
            JC.validate_config(dict(raw, **bad))


def _scalars(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            out[rec["tag"], rec["step"]] = rec["value"]
    return out


def test_train_cli_matches_jax_cli(voa, np_params, tmp_path):
    """`python -m clip_event_tpu_torch.train --device cpu` and `train.py` on
    a finetune_ot-like config (alignment, objects, IE; 3 steps of batch 2
    from one `.pth`): the epoch losses in both `scalars.jsonl` agree."""
    pth = str(tmp_path / "boot.pth")
    export_torch_checkpoint(pth, jax.tree.map(jnp.asarray, np_params), JCFG, epoch=0, task="boot")
    base = {
        "task": "ot", "constrastive_loss": "ce", "alignment": True, "alignment_chunks": 2,
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "load_object": True, "object_pickle": [voa["object_pickle"]],
        "object_ontology_file": voa["ontology_csv"], "max_objects": 4,
        "load_ie": True, "input_entities": [voa["entity_cs"]], "input_events": [voa["event_cs"]],
        "max_entities": 4, "max_events": 2,
        "max_epoch": 1, "batch_size": 2, "lr": 1e-4, "optimizer": "adam",
        "lr_scheduler": "none", "compute_dtype": "float32", "remat": True,
        "num_workers": 2, "jit": True, "begin_ckpt": pth,
    }
    runs = {}
    for name, extra, cmd, env in [
        ("jax", {"use_pallas_attention": False, "use_pallas_ot": False},
         [sys.executable, "train.py"],
         dict(os.environ, JAX_PLATFORMS="cpu", CLIP_EVENT_NATIVE="0",
              XLA_FLAGS="--xla_force_host_platform_device_count=1")),
        ("port", {"use_pallas_ot": True},
         [sys.executable, "-m", "clip_event_tpu_torch.train", "--device", "cpu"], dict(os.environ)),
    ]:
        cfg = dict(base, ckpt_dir=str(tmp_path / f"ckpt_{name}"),
                   tb_log_dir=str(tmp_path / f"logs_{name}"), **extra)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        runs[name] = subprocess.Popen(cmd + ["--cfg", str(path)], cwd=REPO, env=env, text=True,
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    for name, proc in runs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, err[-3000:])
    ours = _scalars(tmp_path / "logs_port" / "ot" / "tensorboard" / "scalars.jsonl")
    ref = _scalars(tmp_path / "logs_jax" / "ot" / "tensorboard" / "scalars.jsonl")
    for tag in ("train_loss", "loss_i", "loss_t", "loss_ot"):
        assert abs(ours[tag, 0] - ref[tag, 0]) <= 1e-5, (tag, ours, ref)
    assert ours["loss_ot", 0] > 0
