"""The port's local-attention ("multiattention") branch against the JAX
package, on the CPU in fp32: the bbox windows, both poolings, the three
loss modes with their gradients, padding boxes in "attention" pooling, the
dedupe channel, the train step with the branch (single and two steps a
dispatch), the config rules, the SR/bbox data channel on the VOA fixture
corpus of tests/fixtures.py, and the train CLI on a
`configs/clip_event_full.json`-shaped config against `train.py`.

Tolerances: windows and data exactly equal (the same ops on both sides);
pooled features 1e-6; losses 1e-5 and each gradient leaf within 1e-5 of
max(1, its largest magnitude) (fp32, reduction orders differ: the text
tower's positional-embedding gradient, a sum over every role text, reaches
|g| ≈ 4 and differs by up to 3.4e-5 between the frameworks); the port
against itself (padding boxes moved, the dedupe channel) the same; the
train step's losses and SGD params 1e-5, grad_norm rtol 1e-4; K steps a
dispatch against single steps exactly, under PyTorch's deterministic
algorithms; the CLI's epoch losses 1e-5.

Model: ViT towers of 1 layer, width 64 (1 head), patch 16, image 32
(a 2 × 2 grid; 4 × 4 where the test says so); text width 64, 1 head, 77
tokens, the real vocab."""

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
from clip_event_tpu.data.voa import VOADescriptionDataset as JaxVOA  # noqa: E402
from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.engine.checkpoint import export_torch_checkpoint  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.models import local_attention as JL  # noqa: E402
from clip_event_tpu_torch import config as TC  # noqa: E402
from clip_event_tpu_torch.data.labels import build_label_layout  # noqa: E402
from clip_event_tpu_torch.data.voa import VOADescriptionDataset  # noqa: E402
from clip_event_tpu_torch.engine import optim as TO  # noqa: E402
from clip_event_tpu_torch.engine import train_step as TT  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import local_attention as TL  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from tests.fixtures import make_voa_fixture  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {
    "embed_dim": 64, "image_resolution": 32, "vision_layers": 1, "vision_width": 64,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
    "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 1,
}
JCFG, TCFG = J.CLIPConfig(**MODEL), T.CLIPConfig(**MODEL)
# a 4 × 4 grid (patch 8) for the loss cases, so boxes cover different windows
MODEL4 = dict(MODEL, vision_patch_size=8)
JCFG4, TCFG4 = J.CLIPConfig(**MODEL4), T.CLIPConfig(**MODEL4)
B, R, NPOS, NNEG = 3, 4, 1, 2
# per image: 3, 1 and 0 real boxes (the last image is all padding)
BOX_N = np.array([3, 1, 0])


def _jax_tree(tcfg, jcfg, seed):
    """A JAX numpy param tree from the port's random init through JAX's
    state-dict converter (JAX's own init runs op by op, slowly, here)."""
    from clip_event_tpu.models.convert import params_from_state_dict
    from clip_event_tpu_torch.models.convert import state_dict_from_params

    params = T.init_params(torch.Generator().manual_seed(seed), tcfg, "cpu")
    return params_from_state_dict(state_dict_from_params(params, tcfg), jcfg)[0]


@pytest.fixture(scope="module")
def np_params():
    return _jax_tree(TCFG, JCFG, 1)


@pytest.fixture(scope="module")
def np_params4():
    return _jax_tree(TCFG4, JCFG4, 2)


def _tokens(rng, shape):
    out = np.zeros(shape + (77,), np.int32)
    for idx in np.ndindex(*shape):
        eot = int(rng.integers(2, 30))
        out[idx][0] = 49406
        out[idx][1:eot] = rng.integers(1, 49000, eot - 1)
        out[idx][eot] = 49407
    return out


def _boxes(rng, b=B, r=R):
    lo = rng.uniform(0, 0.6, size=(b, r, 2))
    hi = np.minimum(lo + rng.uniform(0.15, 0.6, size=(b, r, 2)), 1.0)
    return np.concatenate([lo, hi], -1).astype(np.float32)


def _mask(n=BOX_N, r=R):
    return (np.arange(r)[None] < n[:, None]).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _close_trees(ours, ref, atol):
    a, b = _flat(ours), _flat(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)


def _close_grads(ours, ref, tol=1e-5):
    """Each leaf within `tol` · max(1, max|ref leaf|)."""
    a, b = _flat(ours), _flat(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=tol * max(1.0, float(np.abs(b[k]).max())),
                                   rtol=0, err_msg=k)


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for one test (the CPU's
    token-embedding gradient sums repeated ids in a varying order without
    them; tests/test_torch_multi_step.py)."""
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(old)


# ---------------------------------------------------------------- windows


@pytest.mark.parametrize("grid", [2, 7])
def test_windows_match_jax_exactly(grid):
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 4, 6)
    boxes[0, 0] = [0.0, 0.0, 1.0, 1.0]  # the whole image
    boxes[0, 1] = [0.5, 0.5, 0.5, 0.5]  # a point on a cell boundary: empty
    mask = (rng.random((4, 6)) < 0.7).astype(np.int32)
    ours = TL.bbox_window_weights(torch.from_numpy(boxes), torch.from_numpy(mask), grid).numpy()
    ref = np.asarray(JL.bbox_window_weights(jnp.asarray(boxes), jnp.asarray(mask), grid))
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == (4, 6, grid * grid)
    np.testing.assert_array_equal(ours, ref)
    assert set(np.unique(ours)) <= {0.0, 1.0} and ours[mask == 0].sum() == 0


@pytest.mark.parametrize("mode", ["mean", "attention"])
def test_pooling_matches_jax(mode):
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(B, 49, 16)).astype(np.float32)
    cls = rng.normal(size=(B, 16)).astype(np.float32)
    boxes, mask = _boxes(rng), _mask()
    ours = TL.pool_bbox_features(torch.from_numpy(feats), torch.from_numpy(boxes),
                                 torch.from_numpy(mask), 7, mode=mode,
                                 cls_feats=torch.from_numpy(cls)).numpy()
    ref = np.asarray(JL.pool_bbox_features(jnp.asarray(feats), jnp.asarray(boxes),
                                           jnp.asarray(mask), 7, mode=mode,
                                           cls_feats=jnp.asarray(cls)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    assert np.isfinite(ours).all() and np.abs(ours[mask == 0]).max() == 0.0
    with pytest.raises(ValueError, match="unknown pooling"):
        TL.pool_bbox_features(torch.from_numpy(feats), torch.from_numpy(boxes),
                              torch.from_numpy(mask), 7, mode="max")


# ------------------------------------------------------------------- loss


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
        "bboxes": _boxes(rng),
        "bbox_mask": _mask(),
        "desc_tokens": _tokens(rng, (B, R)),
        "label_tokens": _tokens(rng, (B, R)),
    }


def _jax_loss(params, inputs, cfg, **kw):
    def total(p, x):
        out = JL.local_attention_loss(p, cfg, **x, **kw)
        return out["loss_bbox"] + out["loss_arg"], out

    (value, out), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in inputs.items()})
    return out, grads


def _port_loss(np_params, inputs, cfg, **kw):
    params = params_from_jax(np_params, cfg, "cpu")
    leaves = TO.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = TL.local_attention_loss(params, cfg, **{k: torch.from_numpy(v) for k, v in inputs.items()},
                                  **kw)
    out = {k: v.detach() for k, v in out.items()} | {"_total": out["loss_bbox"] + out["loss_arg"]}
    grads = torch.autograd.grad(out.pop("_total"), leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return out, TO.tree_unflatten(params, grads)


@pytest.mark.parametrize("train_arg,pooling", [("desc", "mean"), ("desc_type", "attention"),
                                               ("desc_type_text", "mean")])
def test_loss_modes_and_gradients_match_jax(np_params4, train_arg, pooling):
    """Each mode with padding boxes (the third image has none), each pooling
    in turn (desc_type_text with attention pooling is
    `test_padded_boxes_give_finite_gradients`): both loss terms and every
    parameter's gradient."""
    inputs = _loss_inputs(3)
    kw = dict(train_arg=train_arg, pooling=pooling)
    jout, jgrads = _jax_loss(np_params4, inputs, JCFG4, **kw)
    tout, tgrads = _port_loss(np_params4, inputs, TCFG4, **kw)
    for k in ("loss_bbox", "loss_arg"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), atol=1e-5, rtol=0, err_msg=k)
        assert float(tout[k]) > 0
    _close_grads(tgrads, jax.tree.map(np.asarray, jgrads))


def test_padded_boxes_give_finite_gradients(np_params4):
    """"attention" pooling over images whose padding boxes' softmax rows are
    all -inf (and one image with no box at all): the loss and every
    gradient are finite and equal JAX's, and a padding box adds nothing:
    moving it changes neither."""
    inputs = _loss_inputs(4)
    kw = dict(train_arg="desc_type_text", pooling="attention")
    tout, tgrads = _port_loss(np_params4, inputs, TCFG4, **kw)
    jout, jgrads = _jax_loss(np_params4, inputs, JCFG4, **kw)
    flat = _flat(tgrads)
    assert all(np.isfinite(v).all() for v in flat.values())
    assert sum(float(np.abs(v).sum()) for v in flat.values()) > 0
    for k in ("loss_bbox", "loss_arg"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), atol=1e-5, rtol=0)
    _close_grads(tgrads, jax.tree.map(np.asarray, jgrads))
    moved = dict(inputs, bboxes=inputs["bboxes"].copy(), desc_tokens=inputs["desc_tokens"].copy())
    moved["bboxes"][inputs["bbox_mask"] == 0] = [0.1, 0.1, 0.9, 0.9]
    moved["desc_tokens"][inputs["bbox_mask"] == 0] = inputs["desc_tokens"][0, 0]
    mout, mgrads = _port_loss(np_params4, moved, TCFG4, **kw)
    for k in ("loss_bbox", "loss_arg"):
        np.testing.assert_allclose(float(mout[k]), float(tout[k]), atol=1e-5, rtol=0)
    _close_grads(mgrads, tgrads)


def test_dedupe_channel_equals_undeduped(np_params4):
    """Role texts given as unique rows + inverse (tests/fixtures-like: two
    labels repeated over every box) give the undeduped loss and gradients,
    up to reduction order."""
    from clip_event_tpu_torch.data.dedupe import dedupe_rows

    inputs = _loss_inputs(5)
    rng = np.random.default_rng(5)
    vocab = _tokens(rng, (2,))
    inputs["desc_tokens"] = vocab[rng.integers(0, 2, size=(B, R))]
    inputs["label_tokens"] = vocab[::-1][rng.integers(0, 2, size=(B, R))]
    kw = dict(train_arg="desc_type_text", pooling="mean")
    full, gfull = _port_loss(np_params4, inputs, TCFG4, **kw)
    dd = {k: v for k, v in inputs.items() if not k.endswith("_tokens")}
    for field, prefix in (("desc_tokens", "desc"), ("label_tokens", "label")):
        unique, inverse = dedupe_rows(inputs[field].reshape(B * R, -1), 4, strict=True)
        assert unique.shape == (4, 77)
        dd[f"{prefix}_unique"], dd[f"{prefix}_inverse"] = unique, inverse
    deduped, gdd = _port_loss(np_params4, dd, TCFG4, **kw)
    for k in ("loss_bbox", "loss_arg"):
        np.testing.assert_allclose(float(deduped[k]), float(full[k]), atol=1e-5, rtol=0)
    _close_grads(gdd, gfull)
    with pytest.raises(ValueError, match="desc_tokens or desc_unique"):
        TL.local_attention_loss({}, TCFG4, None, None, torch.ones(1, 1))


# ------------------------------------------------------------- train step


def _batch(seed):
    """The contrastive batch plus the bbox channel, deduped role texts."""
    from clip_event_tpu_torch.data.dedupe import dedupe_rows

    rng = np.random.default_rng(seed)
    layout = build_label_layout(B, NPOS, NNEG)
    vocab = _tokens(rng, (3,))
    out = {
        "image": rng.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8),
        "text": _tokens(rng, (B * (NPOS + NNEG),)),
        "labels_per_image": layout.labels_per_image,
        "labels_per_text": layout.labels_per_text,
        "index_pos": layout.index_pos,
        "bbox": _boxes(rng),
        "bbox_mask": _mask(),
    }
    for prefix in ("bbox_desc", "bbox_label"):
        rows = vocab[rng.integers(0, 3, size=(B * R,))]
        out[f"{prefix}_unique"], out[f"{prefix}_inverse"] = dedupe_rows(rows, 6, strict=True)
    return out


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


KW = dict(multiattention="desc_type", multiattention_pooling="attention", remat=True)


def _sgd():
    return (JO.build_optimizer("sgd", JO.build_schedule("none", 1e-2, 30), momentum=0.9),
            TO.build_optimizer("sgd", TO.build_schedule("none", 1e-2, 30), momentum=0.9))


def test_multiattention_train_steps_match_jax(np_params, deterministic):
    """Two SGD steps with the branch: every loss term, grad_norm, and the
    params after each step; then the same two steps as one
    `make_multi_step` dispatch of the port give the same state."""
    jopt, topt = _sgd()
    jstep = JT.make_train_step(JCFG, jopt, donate=False, compute_dtype=jnp.float32, **KW)
    tstep = TT.make_train_step(TCFG, topt, compute_dtype=torch.float32, **KW)
    js = JT.create_train_state(jax.tree.map(jnp.asarray, np_params), jopt)
    ts = TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"), topt)
    batches = [_batch(10 + i) for i in range(2)]
    rows = []
    for batch in batches:
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, _t(batch))
        rows.append(tm)
        assert set(tm) == {"loss", "finite", "grad_norm", "loss_i", "loss_t", "loss_bbox", "loss_arg"}
        for k in ("loss", "loss_i", "loss_t", "loss_bbox", "loss_arg"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert bool(tm["finite"]) and float(tm["loss_bbox"]) > 0
        _close_trees(ts.params, jax.tree.map(np.asarray, js.params), atol=1e-5)
    many, _ = TT.make_multi_step(TCFG, _sgd()[1], 2, compute_dtype=torch.float32, **KW)
    fused, metrics = many(TT.create_train_state(params_from_jax(np_params, TCFG, device="cpu"),
                                                _sgd()[1]),
                          _t({k: np.stack([b[k] for b in batches]) for k in batches[0]}))
    for k in ("loss", "loss_bbox", "loss_arg", "grad_norm"):
        assert torch.equal(metrics[k], torch.stack([m[k] for m in rows])), k
    a, b = _flat(fused.params), _flat(ts.params)
    assert all(np.array_equal(a[k], b[k]) for k in a)


# ----------------------------------------------------------------- config


def test_config_rules_match_jax():
    base = {"task": "t", "constrastive_loss": "ce", "batch_size": 2, "lr": 1e-4,
            "optimizer": "adam", "max_epoch": 1}
    obj = {"load_object": True, "object_ontology_file": "o.csv"}
    for extra in ({"multiattention": True, **obj}, {"multiattention": "desc_type_text", "load_sr": True},
                  {"multiattention": False, "load_sr": True, "dedupe_sr_texts": 8},
                  {"multiattention": "desc_type", "multiattention_pooling": "attention", **obj}):
        ours, ref = TC.validate_config(dict(base, **extra)), JC.validate_config(dict(base, **extra))
        assert ours == ref
    assert TC.validate_config(dict(base, multiattention=True, **obj))["multiattention"] == "desc"
    assert TC.validate_config(dict(base, multiattention="desc", **obj))["load_sr"] is True
    for bad in ({"multiattention": "bbox"}, {"multiattention": True},
                {"multiattention": True, "load_sr": False, **obj},
                {"dedupe_sr_texts": 8}, {"dedupe_sr_texts": -1, "load_sr": True},
                {"multiattention_pooling": "max"}):
        with pytest.raises(TC.ConfigError) as ours:
            TC.validate_config(dict(base, **bad))
        with pytest.raises(JC.ConfigError) as ref:
            JC.validate_config(dict(base, **bad))
        assert str(ours.value) == str(ref.value)
    with open(os.path.join(REPO, "configs", "clip_event_full.json")) as fh:
        raw = json.load(fh)
    assert TC.validate_config(raw) == JC.validate_config(raw)


# ------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def voa(tmp_path_factory):
    return make_voa_fixture(str(tmp_path_factory.mktemp("voa_sr")))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("dedupe", [0, 6])
def test_sr_channel_matches_jax(voa, monkeypatch, dedupe):
    """`_sr_channel` through `__getitem__` (boxes normalized by the image's
    size, best score first, the threshold and the ontology applied), with
    the object and IE channels beside it, and `finalize_batch` with and
    without `dedupe_sr_texts`: every tensor bit-equal."""
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    args = (voa["descriptions_json"], [voa["mapping_json"]], [voa["image_dir"]])
    kw = dict(load_sr=True, max_bboxes=3, dedupe_sr_texts=dedupe, load_object=True,
              object_pickles=[voa["object_pickle"]], object_ontology_file=voa["ontology_csv"],
              max_objects=3, image_size=32, context_cap=24, load_ie=True,
              input_entities=[voa["entity_cs"]], input_events=[voa["event_cs"]], max_entities=2,
              max_events=2)
    ours, ref = VOADescriptionDataset(*args, **kw), JaxVOA(*args, **kw)
    for i in range(len(ours)):
        ta, ja = ours[i][0], ref[i][0]
        _equal(ta, ja)
        assert ta["bbox_mask"].tolist() == [1, 1, 0] and ta["bbox_desc_text"].shape == (3, 24)
    stack = {k: np.stack([ours[i][0][k] for i in range(3)]) for k in ours[0][0]}
    got = ours.finalize_batch({**stack, **ours.batch_extras(3)})
    _equal(got, ref.finalize_batch({**stack, **ref.batch_extras(3)}))
    if dedupe:
        assert "bbox_desc_text" not in got and got["bbox_desc_unique"].shape == (6, 24)
        np.testing.assert_array_equal(got["bbox_desc_unique"][got["bbox_desc_inverse"]],
                                      stack["bbox_desc_text"].reshape(9, 24))


def _scalars(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            out[rec["tag"], rec["step"]] = rec["value"]
    return out


def test_train_cli_matches_jax_cli(voa, np_params, tmp_path):
    """`configs/clip_event_full.json` with its data paths on the fixture
    corpus and a tiny model: `python -m clip_event_tpu_torch.train --device
    cpu` and `train.py` (3 steps of batch 2 from one `.pth`) agree on every
    epoch loss in `scalars.jsonl` (the contrastive, OT and local-attention
    terms)."""
    pth = str(tmp_path / "boot.pth")
    export_torch_checkpoint(pth, jax.tree.map(jnp.asarray, np_params), JCFG, epoch=0, task="boot")
    with open(os.path.join(REPO, "configs", "clip_event_full.json")) as fh:
        full = json.load(fh)
    base = dict(
        full, task="full", posneg_descriptions_json=voa["descriptions_json"],
        image_caption_json=[voa["mapping_json"]], image_dir=[voa["image_dir"]],
        object_pickle=[voa["object_pickle"]], object_ontology_file=voa["ontology_csv"],
        input_entities=[voa["entity_cs"]], input_events=[voa["event_cs"]],
        max_objects=4, max_entities=4, max_events=2, max_bboxes=3, dedupe_sr_texts=8,
        max_epoch=1, batch_size=2, lr=1e-4, lr_scheduler="none", compute_dtype="float32",
        num_workers=2, begin_ckpt=pth, print_freq=1, alignment_chunks=2,
    )
    runs = {}
    for name, extra, cmd, env in [
        ("jax", {"use_pallas_attention": False, "use_pallas_ot": False},
         [sys.executable, "train.py"],
         dict(os.environ, JAX_PLATFORMS="cpu", CLIP_EVENT_NATIVE="0",
              XLA_FLAGS="--xla_force_host_platform_device_count=1")),
        ("port", {"use_pallas_ot": True},
         [sys.executable, "-m", "clip_event_tpu_torch.train", "--device", "cpu"],
         dict(os.environ, CLIP_EVENT_NATIVE="0")),
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
    ours = _scalars(tmp_path / "logs_port" / "full" / "tensorboard" / "scalars.jsonl")
    ref = _scalars(tmp_path / "logs_jax" / "full" / "tensorboard" / "scalars.jsonl")
    for tag in ("train_loss", "loss_i", "loss_t", "loss_ot", "loss_bbox", "loss_arg"):
        assert abs(ours[tag, 0] - ref[tag, 0]) <= 1e-5, (tag, ours, ref)
    assert ours["loss_bbox", 0] > 0 and ours["loss_arg", 0] > 0
