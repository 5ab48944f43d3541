"""The port's ResNet towers (RN50, RN101, RN50x4) against the JAX package,
on the CPU in fp32, at reduced widths with each preset's structure: the
stage depths of RN50 (3, 4, 6, 3), RN101 (3, 4, 23, 3, the deep stage 3)
and RN50x4 (4, 6, 10, 6, at a resolution of 3 × 32 where the preset's 288
is 9 × 32: a 3 × 3 map into the attention pool; the others at 64, 2 × 2),
vision width 8 (4 attention-pool heads), a 2-layer text tower of width
64. The JAX trees come from the port's random init through JAX's own
`params_from_state_dict`, with random BatchNorm statistics.

Held: `encode_image` (frozen and batch BatchNorm) and `encode_text` at
1e-4; a train step (loss terms 1e-5, grad_norm rtol 1e-4, SGD params 1e-5)
under frozen BN (RN50's structure) and `sync_bn`'s batch statistics (the
one-block-a-stage `TINY` structure, as the capture proxy and the CLI); the OpenAI state dict
(JAX's `state_dict_from_params` equal bits, the round trip through the
port's converters equal bits, `config_from_state_dict`); int8 encoders
(the convolutions and the attention pool stay float, the text tower runs
K5's plain version) at the float bar; the param-tree walkers over the
stage lists, with a ViT tree's leaves in the order they had before lists
(which the optimizer state of a saved checkpoint relies on); a ResNet step
and a multiattention step under the capture-safety proxy of
tests/test_torch_multi_step.py; the train CLI with a ResNet model dict and
`sync_bn` against `train.py`; the presets through the config."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu import config as JCONF  # noqa: E402
from clip_event_tpu.engine import optim as JO  # noqa: E402
from clip_event_tpu.engine import train_step as JT  # noqa: E402
from clip_event_tpu.engine.checkpoint import export_torch_checkpoint  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.models import convert as JC  # noqa: E402
from clip_event_tpu.models import resnet as JR  # noqa: E402
from clip_event_tpu.ops import quant as JQ  # noqa: E402
from clip_event_tpu_torch import config as TCONF  # noqa: E402
from clip_event_tpu_torch.data.labels import build_label_layout  # noqa: E402
from clip_event_tpu_torch.engine import checkpoint as CK  # noqa: E402
from clip_event_tpu_torch.engine import optim as TO  # noqa: E402
from clip_event_tpu_torch.engine import train_step as TT  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import convert as TC  # noqa: E402
from clip_event_tpu_torch.models import resnet as TR  # noqa: E402
from clip_event_tpu_torch.ops import quant as TQ  # noqa: E402
from tests.fixtures import make_voa_fixture  # noqa: E402
from tests.test_torch_multi_step import _HostTraffic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = dict(context_length=77, vocab_size=49408, transformer_width=64, transformer_heads=1,
            transformer_layers=2)
PRESETS = {
    "RN50": dict(embed_dim=32, image_resolution=64, vision_layers=(3, 4, 6, 3), vision_width=8),
    "RN101": dict(embed_dim=32, image_resolution=64, vision_layers=(3, 4, 23, 3), vision_width=8),
    "RN50x4": dict(embed_dim=40, image_resolution=96, vision_layers=(4, 6, 10, 6), vision_width=8),
    # one block a stage, for the tests whose subject is not the depth
    "TINY": dict(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=8),
}
STRUCTURES = ("RN50", "RN101", "RN50x4")


def _cfgs(name):
    kw = dict(PRESETS[name], vision_patch_size=None, **TEXT)
    return J.CLIPConfig(**kw), T.CLIPConfig(**kw)


def _np_params(name, seed=0):
    """A JAX numpy tree with random BatchNorm statistics and scales (the
    init's zeros and ones would hide the frozen mode's arithmetic), made
    from the port's init by JAX's state-dict converter (JAX's own random
    init runs op by op here, 20 s for RN50)."""
    jcfg, tcfg = _cfgs(name)
    sd = TC.state_dict_from_params(T.init_params(torch.Generator().manual_seed(seed), tcfg, "cpu"),
                                   tcfg)
    params, _ = JC.params_from_state_dict(sd, jcfg)
    rng = np.random.default_rng(seed)

    def perturb(tree):
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = perturb(v)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                # the zero-init bn3 scale of each block becomes a small one:
                # the residual branches count, and the stages stay O(1)
                lo, hi = (0.05, 0.2) if not v.any() else (0.5, 1.0)
                out[k] = rng.uniform(lo, hi, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    params["visual"] = perturb(params["visual"])
    return params


@pytest.fixture(scope="module")
def rn50():
    return _np_params("RN50")


@pytest.fixture
def batch_bn():
    """Batch BatchNorm statistics on both sides for one test."""
    JR.set_bn_mode("batch")
    with TR.bn_mode("batch"):
        yield
    JR.set_bn_mode("frozen")


def _tokens(rng, n):
    out = np.zeros((n, 77), np.int32)
    for i in range(n):
        eot = int(rng.integers(2, 30))
        out[i, 0] = 49406
        out[i, 1:eot] = rng.integers(1, 49000, eot - 1)
        out[i, eot] = 49407
    return out


def _flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


# ----------------------------------------------------------------- encoders


@pytest.mark.parametrize("bn", ["frozen", "batch"])
@pytest.mark.parametrize("name", STRUCTURES)
def test_encoders_match_jax(name, bn):
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(name, seed=1)
    rng = np.random.default_rng(2)
    res = jcfg.image_resolution
    imgs = rng.normal(size=(3, res, res, 3)).astype(np.float32)
    toks = _tokens(rng, 3)
    params = TC.params_from_jax(np_params, tcfg, "cpu")
    assert tcfg.vision_heads == 4 and isinstance(params["visual"]["layer3"], list)
    assert params["visual"]["layer1"][0]["conv2_w"].shape == (8, 8, 3, 3)  # OIHW
    JR.set_bn_mode(bn)
    try:
        with TR.bn_mode(bn):
            ours = T.encode_image(params, tcfg, torch.from_numpy(imgs)).numpy()
            ours_u8 = T.encode_image(params, tcfg, torch.from_numpy(imgs.astype(np.uint8))).numpy()
        ref = np.asarray(J.encode_image(np_params, jcfg, jnp.asarray(imgs)))
        ref_u8 = np.asarray(J.encode_image(np_params, jcfg, jnp.asarray(imgs.astype(np.uint8))))
    finally:
        JR.set_bn_mode("frozen")
    assert ours.shape == (3, jcfg.embed_dim)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours_u8, ref_u8, atol=1e-4, rtol=0)
    np.testing.assert_allclose(T.encode_text(params, tcfg, torch.from_numpy(toks)).numpy(),
                               np.asarray(J.encode_text(np_params, jcfg, jnp.asarray(toks))),
                               atol=1e-4, rtol=0)
    with TR.bn_mode(bn):
        np.testing.assert_array_equal(
            T.CLIP(tcfg, params).encode_image(torch.from_numpy(imgs)).numpy(), ours)
    with pytest.raises(ValueError, match="ViT"):
        T.encode_image(params, tcfg, torch.from_numpy(imgs), use_grid=True)


def test_module_tree_and_cast(rn50):
    """The `CLIP` module holds a stage as a list (`visual.layer2.1.conv1_w`)
    and gives the list back; `cast_params` keeps what JAX's keeps in fp32."""
    jcfg, tcfg = _cfgs("RN50")
    params = TC.params_from_jax(rn50, tcfg, "cpu")
    model = T.CLIP(tcfg, params)
    names = dict(model.named_parameters())
    assert "visual.layer2.1.conv1_w" in names and "visual.layer4.0.downsample.bn.var" in names
    back = model.params()["visual"]
    assert isinstance(back["layer3"], list) and len(back["layer3"]) == 6
    assert back["layer3"][5]["conv3_w"] is names["visual.layer3.5.conv3_w"]
    ours = _flat(jax.tree.map(lambda x: np.asarray(str(x.dtype).replace("torch.", "")),
                              T.cast_params(params, torch.bfloat16)))
    ref = _flat(jax.tree.map(lambda x: np.asarray(str(x.dtype)),
                             J.cast_params(jax.tree.map(jnp.asarray, rn50), jnp.bfloat16)))
    assert ours == ref
    cast = T.cast_params(params, torch.bfloat16)
    assert cast["visual"]["layer1"][0]["conv1_w"].dtype == torch.bfloat16
    assert cast["visual"]["layer1"][0]["bn1"]["var"].dtype == torch.float32


# -------------------------------------------------------------- train step


def _batch(res, seed, b=3):
    rng = np.random.default_rng(seed)
    layout = build_label_layout(b, 1, 2)
    return {
        "image": rng.integers(0, 256, size=(b, res, res, 3), dtype=np.uint8),
        "text": _tokens(rng, b * 3),
        "labels_per_image": layout.labels_per_image,
        "labels_per_text": layout.labels_per_text,
        "index_pos": layout.index_pos,
    }


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _state_dicts_close(tparams, jparams, tcfg, jcfg, atol):
    ours = TC.state_dict_from_params(tparams, tcfg)
    ref = JC.state_dict_from_params(jax.tree.map(np.asarray, jparams), jcfg)
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], ref[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("name,bn", [("RN50", "frozen"), ("TINY", "batch")])
def test_train_steps_match_jax(name, bn):
    """Two SGD steps (momentum 0.9): loss terms, grad_norm and every param
    after each step, compared as OpenAI state dicts (the conv layouts
    differ between the trees)."""
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(name, seed=3)
    jopt = JO.build_optimizer("sgd", JO.build_schedule("none", 1e-2, 30), momentum=0.9)
    topt = TO.build_optimizer("sgd", TO.build_schedule("none", 1e-2, 30), momentum=0.9)
    jstep = JT.make_train_step(jcfg, jopt, donate=False, compute_dtype=jnp.float32, remat=True)
    tstep = TT.make_train_step(tcfg, topt, compute_dtype=torch.float32, remat=True)
    js = JT.create_train_state(jax.tree.map(jnp.asarray, np_params), jopt)
    ts = TT.create_train_state(TC.params_from_jax(np_params, tcfg, "cpu"), topt)
    JR.set_bn_mode(bn)
    try:
        with TR.bn_mode(bn):
            for i in range(2):
                batch = _batch(jcfg.image_resolution, 10 + i)
                js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
                ts, tm = tstep(ts, _t(batch))
                for k in ("loss", "loss_i", "loss_t"):
                    np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=0,
                                               err_msg=k)
                np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                           rtol=1e-4)
                _state_dicts_close(ts.params, js.params, tcfg, jcfg, atol=1e-5)
    finally:
        JR.set_bn_mode("frozen")
    assert TR.get_bn_mode() == "frozen"


# ------------------------------------------------------------- state dicts


@pytest.mark.parametrize("name", ["RN101", "RN50x4"])
def test_state_dict_round_trip_and_config(name):
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(name, seed=4)
    ref = JC.state_dict_from_params(np_params, jcfg)
    params = TC.params_from_jax(np_params, tcfg, "cpu")
    ours = TC.state_dict_from_params(params, tcfg)
    assert ours.keys() == ref.keys()
    last = f"visual.layer3.{jcfg.vision_layers[2] - 1}.bn3.running_var"
    assert last in ours and f"visual.layer3.{jcfg.vision_layers[2]}.bn1.weight" not in ours
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(TC.state_dict_from_params(np_params, tcfg)["visual.conv1.weight"],
                                  ref["visual.conv1.weight"])
    assert TC.config_from_state_dict(ref) == tcfg
    assert dataclasses.asdict(TC.config_from_state_dict(ref)) == \
        dataclasses.asdict(JC.config_from_state_dict(ref))
    np_back, cfg_back = TC.params_from_state_dict(ours)
    back = TC.params_from_jax(np_back, cfg_back, "cpu")
    a, b = _flat(back), _flat(params)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_checkpoint_file_round_trip(tmp_path, rn50):
    """A port checkpoint of a ResNet state (Adam moments over the stage
    lists) restores to equal bits; the JAX package's `.pth` export imports."""
    _, tcfg = _cfgs("RN50")
    params = TC.params_from_jax(rn50, tcfg, "cpu")
    opt = TO.build_optimizer("adam", 1e-3)
    state = opt.init(params)
    state["mu"]["visual"]["layer2"][1]["conv1_w"].fill_(0.25)
    path = CK.save_checkpoint(str(tmp_path), "rn", 0, params, state, tcfg, step=3)
    p2, s2, meta, cfg2 = CK.restore_checkpoint(path)
    assert cfg2 == tcfg and meta["step"] == 3
    a, b = _flat(p2), _flat(params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert isinstance(s2["mu"]["visual"]["layer2"], list)
    a, b = _flat(s2), _flat(state)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    # the restored moments follow the restored params' order, leaf by leaf,
    # whatever order the saved tree had (here the sorted keys of a JAX tree)
    for p, m in zip(TO.tree_leaves(p2), TO.tree_leaves(s2["mu"])):
        assert p.shape == m.shape
    pth = str(tmp_path / "jax.pth")
    export_torch_checkpoint(pth, jax.tree.map(jnp.asarray, rn50), _cfgs("RN50")[0], epoch=0, task="x")
    np_params, cfg = CK.import_initial_checkpoint(pth)
    assert cfg == tcfg
    a, b = _flat(TC.params_from_jax(np_params, cfg, "cpu")), _flat(params)
    # (the JAX export writes logit_scale as [1], the port keeps it 0-d)
    assert a.keys() == b.keys() and all(np.array_equal(np.ravel(a[k]), np.ravel(b[k])) for k in a)


# ------------------------------------------------------------------- int8


@pytest.mark.parametrize("static", [False, True], ids=["int8", "int8_static"])
def test_int8_encoders_match_jax(rn50, static):
    """The convolutions and the attention pool stay float in both packages;
    the text tower quantizes. Inputs without a rounding-boundary flip (see
    tests/test_torch_quant.py), held to the float bar."""
    jcfg, tcfg = _cfgs("RN50")
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)  # RN50's resolution
    toks = _tokens(rng, 3)
    jp = jax.tree.map(jnp.asarray, rn50)
    stats = JQ.calibrate_act_scales(jp, jcfg, [imgs], [toks]) if static else None
    jq = JQ.quantize_params(jp, act_stats=stats)
    tq = TC.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, "cpu")
    if static:
        tstats = TQ.calibrate_act_scales(TC.params_from_jax(rn50, tcfg, "cpu"), tcfg, [imgs], [toks])
        assert "visual" not in tstats and set(tstats) == set(stats)
    assert TQ.is_quantized(tq) and isinstance(tq["text_transformer"]["attn"]["qkv_w"], TQ.QuantWeight)
    ours_q = TQ.quantize_params(TC.params_from_jax(rn50, tcfg, "cpu"))
    assert not TQ.is_quantized(ours_q["visual"]) and TQ.is_quantized(ours_q)
    assert ours_q["visual"]["attnpool"]["q_w"].dtype == torch.float32
    for jfn, tfn, x in ((J.encode_image, T.encode_image, imgs), (J.encode_text, T.encode_text, toks)):
        np.testing.assert_allclose(tfn(tq, tcfg, torch.from_numpy(x)).numpy(),
                                   np.asarray(jfn(jq, jcfg, jnp.asarray(x))), atol=1e-4, rtol=0)


# ------------------------------------------------------------------- trees


def _old_leaves(tree):
    """The dict-only walker the optimizer used before lists."""
    out = []
    for v in tree.values():
        out.extend(_old_leaves(v) if isinstance(v, dict) else [v])
    return out


def test_vit_tree_leaves_keep_their_order():
    """A ViT tree flattens to the same tensors in the same order as before
    the walkers learned lists, and unflattens to the same nesting, so the
    optimizer state of an existing checkpoint lines up with its params."""
    cfg = T.CLIPConfig(64, 32, 2, 64, 16, 77, 512, 64, 1, 2)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    leaves = TO.tree_leaves(params)
    assert [id(x) for x in leaves] == [id(x) for x in _old_leaves(params)]
    assert len(leaves) == 38  # 20 vision, 17 text, logit_scale
    back = TO.tree_unflatten(params, leaves)
    assert _flat(back).keys() == _flat(params).keys()
    assert all(a is b for a, b in zip(TO.tree_leaves(back), leaves))
    state = TO.build_optimizer("adam", 1e-3).init(params)
    for p, m in zip(leaves, TO.tree_leaves(state["mu"])):
        assert p.shape == m.shape


def test_resnet_tree_leaves_follow_jax_nesting(rn50):
    _, tcfg = _cfgs("RN50")
    params = TC.params_from_jax(rn50, tcfg, "cpu")
    leaves = TO.tree_leaves(params)
    assert len(leaves) == len(jax.tree.leaves(rn50))
    back = TO.tree_unflatten(params, [t * 0 for t in leaves])
    assert isinstance(back["visual"]["layer1"], list) and len(back["visual"]["layer4"]) == 3
    assert _flat(back).keys() == _flat(params).keys()
    moved = T.tree_to(params, "cpu", torch.float64)
    assert moved["visual"]["layer2"][3]["bn2"]["mean"].dtype == torch.float64


# ------------------------------------------------------------ capture proxy


@pytest.mark.parametrize("workload", ["resnet_frozen", "resnet_sync_bn", "multiattention"])
def test_step_is_capture_safe(workload):
    """One step after a first one under the dispatch mode of
    tests/test_torch_multi_step.py: no host read of a device value, no
    tensor from host data, every leaf of the state written in place."""
    if workload == "multiattention":
        from tests.test_torch_local_attention import KW, TCFG as VIT, _batch as ma_batch

        cfg, params, kw = VIT, T.init_params(torch.Generator().manual_seed(1), VIT, "cpu"), KW

        def make(seed):
            return _t(ma_batch(seed))
    else:
        _, cfg = _cfgs("TINY")
        params = TC.params_from_jax(_np_params("TINY"), cfg, "cpu")
        kw = dict(remat=True)

        def make(seed):
            return _t(_batch(cfg.image_resolution, seed))
    opt = TO.build_optimizer("adam", TO.build_schedule("multisteplr", 1e-3, 4, lr_steps=[1]),
                             weight_decay=0.01, moment_dtype="bfloat16")
    step = TT.make_train_step(cfg, opt, compute_dtype=torch.float32, **kw)
    state = TT.create_train_state(params, opt)
    with TR.bn_mode("batch" if workload == "resnet_sync_bn" else "frozen"):
        state, _ = step(state, make(50))
        leaves = TO.tree_leaves(state.params) + TO.tree_leaves(state.opt_state)
        ptrs = [t.data_ptr() for t in leaves]
        batch = make(51)
        with _HostTraffic() as mode:
            state, m = step(state, batch)
    assert mode.seen == []
    after = TO.tree_leaves(state.params) + TO.tree_leaves(state.opt_state)
    assert [t.data_ptr() for t in after] == ptrs
    assert int(state.opt_state["count"]) == 2 and bool(m["finite"])


# ----------------------------------------------------------- config and CLI


def test_presets_resolve_through_the_config():
    for name, ref in (("RN50", J.RN50), ("RN101", J.RN101), ("RN50x4", J.RN50X4)):
        ours = TCONF.model_config({"model": name})
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert dataclasses.asdict(ours) == dataclasses.asdict(JCONF.model_config({"model": name}))
        assert ours.vision_heads == ref.vision_heads and not ours.is_vit
    assert T.RN50X4.vision_heads == 40 and T.RN50.vision_heads == 32
    with pytest.raises(ValueError, match="ViT"):
        T.RN50.grid_size  # noqa: B018


def _scalars(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            out[rec["tag"], rec["step"]] = rec["value"]
    return out


def test_train_cli_sync_bn_matches_jax_cli(tmp_path):
    """A ResNet model dict (`TINY`'s structure) with `sync_bn`: the port's
    train CLI and `train.py` (3 steps of batch 2, Adam, from one seed's
    `.pth`) agree on the epoch losses (frozen statistics would not); the
    port's loop, run in this process, puts the frozen mode back."""
    from clip_event_tpu_torch.train import main
    jcfg, _ = _cfgs("TINY")
    voa = make_voa_fixture(str(tmp_path / "voa"))
    pth = str(tmp_path / "boot.pth")
    export_torch_checkpoint(pth, _np_params("TINY", seed=6), jcfg, epoch=0, task="boot")
    base = {
        "task": "rn", "constrastive_loss": "ce", "sync_bn": True,
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "max_epoch": 1, "batch_size": 2, "lr": 1e-4, "optimizer": "adam",
        "lr_scheduler": "none", "compute_dtype": "float32", "remat": True,
        "num_workers": 2, "jit": True, "begin_ckpt": pth,
    }
    paths = {}
    for name in ("jax", "port"):
        cfg = dict(base, ckpt_dir=str(tmp_path / f"ckpt_{name}"),
                   tb_log_dir=str(tmp_path / f"logs_{name}"))
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(cfg))
    proc = subprocess.Popen(
        [sys.executable, "train.py", "--cfg", str(paths["jax"])], cwd=REPO, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu", CLIP_EVENT_NATIVE="0",
                 XLA_FLAGS="--xla_force_host_platform_device_count=1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    os.environ["CLIP_EVENT_NATIVE"] = "0"
    try:
        main(["--cfg", str(paths["port"]), "--device", "cpu"])
    finally:
        del os.environ["CLIP_EVENT_NATIVE"]
    assert TR.get_bn_mode() == "frozen"
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    ours = _scalars(tmp_path / "logs_port" / "rn" / "tensorboard" / "scalars.jsonl")
    ref = _scalars(tmp_path / "logs_jax" / "rn" / "tensorboard" / "scalars.jsonl")
    for tag in ("train_loss", "loss_i", "loss_t"):
        assert abs(ours[tag, 0] - ref[tag, 0]) <= 1e-5, (tag, ours, ref)
