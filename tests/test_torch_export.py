"""The port's serving bundle (`clip_event_tpu_torch/engine/export.py`, the
custom ops of `ops/library.py`, the `export_serving` CLI) on the CPU
against the JAX package's bundle (`clip_event_tpu/engine/export.py`), run
as tests/test_export.py runs it, on the same numpy weights.

Tolerances: a bundle against the live port encoders it was exported from,
1e-6 (the program is the same computation; it measures 0); against JAX's
bundle, 1e-4, the float and int8 encoder bar of tests/test_torch_quant.py
(the two frameworks' fp32 arithmetic differs in the last bits). An fp32
ulp upstream can flip a dynamic int8 rounding, which moves a feature by
~1e-3 (ROADMAP §C): the inputs held at 1e-4 (seeds 20 + b) put no
activation on a rounding boundary, and `test_int8_rounding_flip_across_
frameworks` pins an input that does (seed 31), held by cosine. The weight
files equal JAX's key for key and bit for bit; an int8_static file's
activation scales, which come from each framework's calibration forward,
within 1e-5 relative (tests/test_torch_quant.py's calibration bar).
"""

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

from clip_event_tpu.engine import export as JE  # noqa: E402
from clip_event_tpu.models import convert as JC  # noqa: E402
from clip_event_tpu.ops import quant as JQ  # noqa: E402
from clip_event_tpu_torch.engine import export as TE  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.models import resnet as TR  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax, state_dict_from_params  # noqa: E402
from clip_event_tpu_torch.ops import attention as TA  # noqa: E402
from clip_event_tpu_torch.ops import library  # noqa: E402
from clip_event_tpu_torch.ops import quant as TQ  # noqa: E402
from tests.test_model_parity import TINY_RN, TINY_VIT  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL, LIVE_TOL = 1e-4, 1e-6
ACT_RTOL = 1e-5
BATCHES = (1, 2, 5)
CFGS = {"vit": TINY_VIT, "rn": TINY_RN}
MODES = {"vit": (None, "int8", "int8_static"), "rn": (None, "int8")}
CASES = [(name, mode) for name in sorted(CFGS) for mode in MODES[name]]


def _tcfg(jcfg):
    return T.CLIPConfig(**dataclasses.asdict(jcfg))


def _inputs(cfg, b, seed):
    """N(0, 1) images and token rows (random ids, EOT = the largest id,
    zeros after it) at the config's sizes."""
    rng = np.random.default_rng(seed)
    res = cfg.image_resolution
    images = rng.normal(size=(b, res, res, 3)).astype(np.float32)
    tokens = np.zeros((b, cfg.context_length), np.int32)
    for i, n in enumerate(rng.integers(2, cfg.context_length, b)):
        tokens[i, :n] = rng.integers(1, cfg.vocab_size - 2, n)
        tokens[i, n - 1] = cfg.vocab_size - 1
    return images, tokens


def _live(params, cfg, images, tokens):
    with torch.no_grad():
        img = T.l2_normalize(T.encode_image(params, cfg, torch.from_numpy(images))).float()
        txt = T.l2_normalize(T.encode_text(params, cfg, torch.from_numpy(tokens))).float()
    return img.numpy(), txt.numpy()


def _served(model, images, tokens):
    return model.encode_image(images).cpu().numpy(), model.encode_text(tokens).cpu().numpy()


def _seeded(jcfg, seed):
    """(JAX params, JAX numpy tree, port params): one set of weights from a
    seed (the port's init scheme), through the OpenAI state dict into the
    JAX package's tree, and from that tree into the port's."""
    cfg = _tcfg(jcfg)
    sd = state_dict_from_params(T.init_params(torch.Generator().manual_seed(seed), cfg, "cpu"), cfg)
    np_params, _ = JC.params_from_state_dict(sd, jcfg)
    return jax.tree.map(jnp.asarray, np_params), np_params, params_from_jax(np_params, cfg, "cpu")


@pytest.fixture(scope="module")
def weights():
    """{name: (JAX params, JAX numpy tree, port params)} from seed 0."""
    return {name: _seeded(jcfg, 0) for name, jcfg in CFGS.items()}


def _calibration(cfg):
    return [_inputs(cfg, 3, 50)[0]], [_inputs(cfg, 3, 51)[1]]


@pytest.fixture(scope="module")
def bundles(weights, tmp_path_factory):
    """{(cfg name, mode): (JAX bundle dir, port bundle dir)}, each exported
    once: float and int8 at both sizes, int8_static at the ViT (whose
    tower has the activation scales a ResNet's lacks)."""
    root = tmp_path_factory.mktemp("bundles")
    out = {}
    for name, jcfg in CFGS.items():
        jp, _, tp = weights[name]
        tcfg = _tcfg(jcfg)
        stats = {}
        if "int8_static" in MODES[name]:
            imgs, toks = _calibration(jcfg)
            stats["int8_static"] = (JQ.calibrate_act_scales(jp, jcfg, imgs, toks),
                                    TQ.calibrate_act_scales(tp, tcfg, imgs, toks))
        for mode in MODES[name]:
            jstats, tstats = stats.get(mode, (None, None))
            jdir, tdir = str(root / f"{name}_{mode}_jax"), str(root / f"{name}_{mode}_torch")
            JE.save_serving_bundle(jdir, jp, jcfg, quantize=mode, act_stats=jstats)
            TE.save_serving_bundle(tdir, tp, tcfg, quantize=mode, act_stats=tstats)
            out[name, mode] = (jdir, tdir)
    return out


def _live_params(weights, name, mode, tdir):
    """The port's live tree a bundle was exported from: the float params,
    or them quantized with the bundle's own activation scales."""
    tp = weights[name][2]
    if mode is None:
        return tp
    loaded = TE.load_serving_bundle(tdir, "cpu").params
    return loaded if mode == "int8_static" else TQ.quantize_params(tp)


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m or 'float'}" for n, m in CASES])
def test_bundle_matches_jax_bundle_and_live(weights, bundles, name, mode):
    jdir, tdir = bundles[name, mode]
    cfg = _tcfg(CFGS[name])
    ours = TE.load_serving_bundle(tdir, device="cpu")
    ref = JE.load_serving_bundle(jdir)
    live = _live_params(weights, name, mode, tdir)
    for b in BATCHES:
        images, tokens = _inputs(cfg, b, seed=20 + b)
        got = _served(ours, images, tokens)
        for g, r, lv in zip(got, (ref.encode_image(images), ref.encode_text(tokens)),
                            _live(live, cfg, images, tokens)):
            assert g.shape == (b, cfg.embed_dim) and g.dtype == np.float32
            np.testing.assert_allclose(g, r, atol=JAX_TOL, rtol=0)
            np.testing.assert_allclose(g, lv, atol=LIVE_TOL, rtol=0)


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m or 'float'}" for n, m in CASES])
def test_bundle_files_match_jax(bundles, name, mode):
    jdir, tdir = bundles[name, mode]
    for f in (TE.IMAGE_MODULE, TE.TEXT_MODULE, TE.META_FILE):
        assert os.path.exists(os.path.join(tdir, f)), f
    jmeta, tmeta = (json.load(open(os.path.join(d, "meta.json"))) for d in (jdir, tdir))
    assert set(tmeta) == set(jmeta) - {"jax_version"} | {"torch_version"}
    assert tmeta["platforms"] == ["cpu", "cuda"] and tmeta["torch_version"] == torch.__version__
    for key in set(jmeta) - {"jax_version", "torch_version", "platforms"}:
        assert tmeta[key] == jmeta[key], key
    name_ = TE.QUANT_PARAMS_FILE if mode else TE.PARAMS_FILE
    assert not os.path.exists(os.path.join(tdir, TE.PARAMS_FILE if mode else TE.QUANT_PARAMS_FILE))
    with np.load(os.path.join(jdir, name_)) as jz, np.load(os.path.join(tdir, name_)) as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for k in jz.files:
            assert tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape, k
            if k.endswith(".act"):
                np.testing.assert_allclose(tz[k], jz[k], rtol=ACT_RTOL)
            else:
                np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    if mode:
        assert tmeta["params_tree"] == jmeta["params_tree"]
        assert any(k.endswith(".act") for k in np.load(os.path.join(tdir, name_)).files) == (
            mode == "int8_static")


def test_int8_bundle_is_smaller(bundles):
    _, fdir = bundles["vit", None]
    _, qdir = bundles["vit", "int8"]
    assert (os.path.getsize(os.path.join(qdir, TE.QUANT_PARAMS_FILE))
            < 0.7 * os.path.getsize(os.path.join(fdir, TE.PARAMS_FILE)))
    # the programs hold no weights: the float tree's bytes are in the npz only
    assert os.path.getsize(os.path.join(fdir, TE.IMAGE_MODULE)) < os.path.getsize(
        os.path.join(fdir, TE.PARAMS_FILE))


def test_capped_context_matches_full(weights, bundles, tmp_path):
    """A `context=S` bundle serves [b, S] tokens and, for texts whose EOT
    fits, gives the full-width bundle's features (JAX's
    test_bundle_capped_context_matches_full), and JAX's capped bundle's."""
    jp, _, tp = weights["vit"]
    jcfg, cfg = TINY_VIT, _tcfg(TINY_VIT)
    S = 8
    tdir = TE.save_serving_bundle(str(tmp_path / "capped"), tp, cfg, context=S)
    jdir = JE.save_serving_bundle(str(tmp_path / "capped_jax"), jp, jcfg, context=S)
    meta = json.load(open(os.path.join(tdir, "meta.json")))
    assert meta["context_length"] == S and meta["model_config"]["context_length"] == cfg.context_length
    capped = TE.load_serving_bundle(tdir, "cpu")
    full = TE.load_serving_bundle(bundles["vit", None][1], "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab_size - 2, size=(4, cfg.context_length)).astype(np.int32)
    tokens[:, S - 1:] = 0
    tokens[:, S - 1] = cfg.vocab_size - 1  # EOT at the cap boundary
    got = capped.encode_text(tokens[:, :S]).numpy()
    np.testing.assert_allclose(got, full.encode_text(tokens).numpy(), atol=LIVE_TOL, rtol=0)
    np.testing.assert_allclose(got, JE.load_serving_bundle(jdir).encode_text(tokens[:, :S]),
                               atol=JAX_TOL, rtol=0)
    for bad in (1, cfg.context_length + 1):
        with pytest.raises(ValueError, match="context"):
            TE.export_encoders(tp, cfg, context=bad)


def test_int8_tower_subset(weights, tmp_path):
    """quantize_towers=("visual",): vision int8, text float, against JAX's
    bundle of the same subset and the port's live tree."""
    jp, _, tp = weights["vit"]
    cfg = _tcfg(TINY_VIT)
    tdir = TE.save_serving_bundle(str(tmp_path / "v"), tp, cfg, quantize="int8", quantize_towers=["visual"])
    jdir = JE.save_serving_bundle(str(tmp_path / "vj"), jp, TINY_VIT, quantize="int8",
                                  quantize_towers=("visual",))
    ours = TE.load_serving_bundle(tdir, "cpu")
    assert ours.meta["quantize_towers"] == ["visual"]
    assert ours.meta["params_tree"] == json.load(open(os.path.join(jdir, "meta.json")))["params_tree"]
    assert isinstance(ours.params["visual"]["transformer"]["attn"]["qkv_w"], TQ.QuantWeight)
    assert isinstance(ours.params["text_projection"], torch.Tensor)
    assert TQ.is_k_major(ours.params["visual"]["transformer"]["mlp"]["fc_w"].q)
    ref = JE.load_serving_bundle(jdir)
    images, tokens = _inputs(cfg, 3, seed=23)
    live = _live(TQ.quantize_params(tp, towers=("visual",)), cfg, images, tokens)
    for g, r, lv in zip(_served(ours, images, tokens), (ref.encode_image(images), ref.encode_text(tokens)),
                        live):
        np.testing.assert_allclose(g, r, atol=JAX_TOL, rtol=0)
        np.testing.assert_allclose(g, lv, atol=LIVE_TOL, rtol=0)


def test_int8_rounding_flip_across_frameworks(weights, bundles):
    """Seed 31's images put an activation of the tiny ViT on a dynamic int8
    rounding boundary: the two frameworks' fp32 ulp flips it, and a feature
    moves by 2.3e-3 (ROADMAP §C). The port's bundle still
    equals the port's live tree there; against JAX's it is held by cosine,
    as int8 is across an fp32 ulp."""
    jdir, tdir = bundles["vit", "int8"]
    cfg = _tcfg(TINY_VIT)
    images, tokens = _inputs(cfg, 2, seed=31)
    got = TE.load_serving_bundle(tdir, "cpu").encode_image(images).numpy()
    ref = JE.load_serving_bundle(jdir).encode_image(images)
    live = _live(TQ.quantize_params(weights["vit"][2]), cfg, images, tokens)[0]
    np.testing.assert_allclose(got, live, atol=LIVE_TOL, rtol=0)
    assert np.abs(got - ref).max() > JAX_TOL
    cos = (got * ref).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() >= 0.999, cos


def test_loads_and_serves_without_the_model_code(bundles):
    """In a fresh process, loading and serving a manifest bundle and a float
    bundle leave `models.clip` and the layers out of sys.modules."""
    code = (
        "import sys, numpy as np\n"
        "from clip_event_tpu_torch.engine.export import load_serving_bundle\n"
        "for d in sys.argv[1:]:\n"
        "    m = load_serving_bundle(d, device='cpu')\n"
        "    f = m.encode_image(np.zeros((2, 32, 32, 3), np.float32))\n"
        "    t = m.encode_text(np.ones((3, 16), np.int32))\n"
        "    assert f.shape[0] == 2 and t.shape[0] == 3\n"
        "bad = [n for n in ('clip_event_tpu_torch.models.clip', 'clip_event_tpu_torch.models.layers',\n"
        "                   'clip_event_tpu_torch.models.vit', 'clip_event_tpu_torch.models.resnet')\n"
        "       if n in sys.modules]\n"
        "print('LOADED_MODEL_CODE', bad)\n"
    )
    dirs = [bundles["vit", "int8_static"][1], bundles["rn", "int8"][1], bundles["vit", None][1]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, *dirs], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED_MODEL_CODE []" in proc.stdout, proc.stdout


def test_manifest_path_and_pre_manifest_bundle(bundles, tmp_path, monkeypatch):
    """A manifest bundle never takes the skeleton path; a bundle without a
    manifest (written before it existed) still loads through the skeleton,
    to the same tree and features."""
    import shutil

    tdir = str(tmp_path / "legacy")
    shutil.copytree(bundles["vit", "int8_static"][1], tdir)

    def bomb(*a, **k):
        raise AssertionError("load_serving_bundle took the skeleton path")

    monkeypatch.setattr(TE, "_load_quant_params", bomb)
    model = TE.load_serving_bundle(tdir, "cpu")
    monkeypatch.undo()
    meta = json.load(open(os.path.join(tdir, "meta.json")))
    meta["params_tree"] = None
    json.dump(meta, open(os.path.join(tdir, "meta.json"), "w"))
    legacy = TE.load_serving_bundle(tdir, "cpu")
    a, b = TE.program_inputs(model.params), TE.program_inputs(legacy.params)
    assert len(a) == len(b) and all(torch.equal(x, y) and x.stride() == y.stride() for x, y in zip(a, b))
    images, tokens = _inputs(TINY_VIT, 3, seed=11)
    for x, y in zip(_served(model, images, tokens), _served(legacy, images, tokens)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_swapped_weights_need_no_re_export(weights, bundles, tmp_path, name):
    """Replacing params.npz with other weights serves those weights'
    features through the same programs."""
    import shutil

    cfg = _tcfg(CFGS[name])
    tdir = str(tmp_path / "swap")
    shutil.copytree(bundles[name, None][1], tdir)
    programs = {f: open(os.path.join(tdir, f), "rb").read() for f in (TE.IMAGE_MODULE, TE.TEXT_MODULE)}
    other = _seeded(CFGS[name], 7)[2]
    np.savez(os.path.join(tdir, TE.PARAMS_FILE), **state_dict_from_params(other, cfg))
    model = TE.load_serving_bundle(tdir, "cpu")
    images, tokens = _inputs(cfg, 2, seed=4)
    old = _live(weights[name][2], cfg, images, tokens)
    for g, lv, o in zip(_served(model, images, tokens), _live(other, cfg, images, tokens), old):
        np.testing.assert_allclose(g, lv, atol=LIVE_TOL, rtol=0)
        assert np.abs(g - o).max() > 1e-2
    assert all(open(os.path.join(tdir, f), "rb").read() == b for f, b in programs.items())


def test_export_restores_the_session_choices(weights, tmp_path):
    """The export takes the kernel ops, the plain LayerNorm and the frozen
    BatchNorm, and puts the session's choices back; the bundle does not
    depend on them."""
    cfg = _tcfg(TINY_RN)
    tp = weights["rn"][2]
    TL.set_ln_impl("pallas")
    TL.set_attention_impl("plain")
    TR.set_bn_mode("batch")
    try:
        image, text = TE.export_encoders(tp, cfg)
        assert (TL._resolve_ln(), TL._resolve_attention(), TR.get_bn_mode()) == ("pallas", "plain", "batch")
    finally:
        TL.set_ln_impl("xla")
        TL.set_attention_impl("kernel")
        TR.set_bn_mode("frozen")
    targets = {str(n.target) for n in text.graph.nodes}
    assert "clip_event_tpu.attention_core.default" in targets
    images, tokens = _inputs(cfg, 2, seed=5)
    weights_in = TE.program_inputs(tp)
    with torch.no_grad():
        got = (image.module()(weights_in, torch.from_numpy(images)).numpy(),
               text.module()(weights_in, torch.from_numpy(tokens)).numpy())
    for g, lv in zip(got, _live(tp, cfg, images, tokens)):
        np.testing.assert_allclose(g, lv, atol=LIVE_TOL, rtol=0)


# ------------------------------------------------------------------- the ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("S,W,H", [(16, 64, 2), (197, 128, 2)], ids=["k1", "k2"])
def test_attention_op_cpu_is_the_plain_version(S, W, H, causal, dtype):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn((3, S, 3 * W), generator=gen).to(dtype)
    bias = TL.causal_mask(S, device="cpu") if causal else None
    scale = (W // H) ** -0.5
    got = torch.ops.clip_event_tpu.attention_core(qkv, bias, H, scale)
    assert torch.equal(got, TA.fused_attention_qkv_plain(qkv, bias, H, scale))
    assert torch.equal(library.attention_core(qkv, bias, H, scale), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_quantized_linear_op_cpu_is_the_plain_version(bias, static, dtype):
    gen = torch.Generator().manual_seed(1)
    w = TQ.quantize_weight(torch.randn((588, 48), generator=gen), torch.tensor(3.0) if static else None)
    x = torch.randn((5, 588), generator=gen).to(dtype)
    b = torch.randn(48, generator=gen) if bias else None
    got = torch.ops.clip_event_tpu.quantized_linear(x, w.q, w.scale, w.act_scale, b)
    assert got.dtype == dtype
    assert torch.equal(got, TQ.quantized_matmul_plain(x, w.q, w.scale, b, w.act_scale))


class _OpsModule(torch.nn.Module):
    def forward(self, qkv, x, q, scale):
        a = torch.ops.clip_event_tpu.attention_core(qkv, None, 2, 0.125)
        return a, torch.ops.clip_event_tpu.quantized_linear(x, q, scale, None, None)


def test_ops_fake_shapes_under_a_symbolic_batch():
    """The fake implementations give [b, S, W] and [b, N] with b symbolic,
    from shapes alone: a q that is not K-major traces too (the layout is
    the CUDA implementation's check), and a shape no kernel takes fails the
    trace."""
    from torch.export import Dim

    b = Dim("b", min=1)
    w = TQ.quantize_weight(torch.randn(100, 24))
    q_rows = w.q.contiguous()  # [K, N] row-major: not K-major
    assert not TQ.is_k_major(q_rows)
    args = (torch.randn(3, 16, 3 * 64), torch.randn(3, 100), q_rows, w.scale)
    program = torch.export.export(_OpsModule(), args, dynamic_shapes=({0: b}, {0: b}, None, None))
    ops = [n for n in program.graph.nodes if "clip_event_tpu" in str(n.target)]
    assert len(ops) == 2
    (ba, sa, wa), (bq, nq) = (tuple(n.meta["val"].shape) for n in ops)
    assert isinstance(ba, torch.SymInt) and isinstance(bq, torch.SymInt)
    assert (sa, wa, nq) == (16, 64, 24)
    out = program.module()(torch.randn(5, 16, 3 * 64), torch.randn(5, 100), q_rows, w.scale)
    assert out[0].shape == (5, 16, 64) and out[1].shape == (5, 24)
    with pytest.raises(ValueError, match="no attention kernel"):
        torch.export.export(_OpsModule(), (torch.randn(2, 200, 3 * 100), *args[1:]))


def test_eager_paths_do_not_touch_the_ops(monkeypatch):
    """Outside an export, the attention core and the int8 dense layer run
    their wrappers as before: the ops are never called."""

    def bomb(*a, **k):
        raise AssertionError("an op ran outside an export")

    monkeypatch.setattr(library, "attention_core", bomb)
    monkeypatch.setattr(library, "quantized_linear", bomb)
    qkv = torch.randn(2, 16, 3 * 64)
    assert torch.equal(TL.attention_core(qkv, None, 2, 0.125, "kernel"),
                       TA.fused_attention_qkv_plain(qkv, None, 2, 0.125))
    w = TQ.quantize_weight(torch.randn(64, 32))
    x = torch.randn(2, 7, 64)
    assert torch.equal(TQ.quantized_linear(x, w),
                       TQ.quantized_matmul_plain(x.reshape(-1, 64), w.q, w.scale).reshape(2, 7, 32))


def test_op_namespace_is_the_ports_own():
    """No op of torch's own lives in the port's namespace: in a process that
    imports torch alone, `torch.ops.clip_event_tpu` holds nothing."""
    code = (
        "import torch\n"
        "ns = torch.ops.clip_event_tpu\n"
        "print(sorted(n for n in ('attention_core', 'quantized_linear') if hasattr(ns, n)))\n"
        "print(sorted(n for n in torch._C._dispatch_get_all_op_names() if n.startswith('clip_event_tpu::')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["[]", "[]"]
    assert library.NAMESPACE == "clip_event_tpu"
    names = [n for n in torch._C._dispatch_get_all_op_names() if n.startswith("clip_event_tpu::")]
    assert sorted(names) == ["clip_event_tpu::attention_core", "clip_event_tpu::quantized_linear"]


# ------------------------------------------------------------------- the CLI


def _write_ckpt(path, np_params, cfg):
    sd = state_dict_from_params(np_params, cfg)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


@pytest.fixture(scope="module")
def cli_bundles(weights, tmp_path_factory):
    """{mode: (root CLI bundle, port CLI bundle)} from one state-dict file:
    the root export_serving.py in a subprocess (JAX), the port's CLI here
    with --device cpu."""
    from clip_event_tpu_torch import export_serving

    root = tmp_path_factory.mktemp("cli")
    ckpt = str(root / "weights.pt")
    _write_ckpt(ckpt, weights["vit"][1], _tcfg(TINY_VIT))
    out, jax_runs = {}, []
    for mode in ("float32", "int8"):
        cfg = {"ckpt": ckpt, **({"quantize": "int8"} if mode == "int8" else {})}
        path = root / f"{mode}.json"
        path.write_text(json.dumps(cfg))
        jdir, tdir = str(root / f"{mode}_jax"), str(root / f"{mode}_torch")
        jax_runs.append(f"sys.argv = ['export_serving.py', '--cfg', {str(path)!r}, '--out', {jdir!r}]; main()")
        export_serving.main(["--cfg", str(path), "--out", tdir, "--device", "cpu"])
        out[mode] = (jdir, tdir)
    code = "import sys\nfrom export_serving import main\n" + "\n".join(jax_runs) + "\n"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_cli_matches_the_root_cli(cli_bundles, mode):
    jdir, tdir = cli_bundles[mode]
    for f in (TE.IMAGE_MODULE, TE.TEXT_MODULE, TE.META_FILE,
              TE.QUANT_PARAMS_FILE if mode == "int8" else TE.PARAMS_FILE):
        assert os.path.exists(os.path.join(tdir, f)), f
    ours, ref = TE.load_serving_bundle(tdir, "cpu"), JE.load_serving_bundle(jdir)
    assert ours.meta["quantize"] == ref.meta["quantize"]
    for b in (1, 4):
        images, tokens = _inputs(TINY_VIT, b, seed=20 + b)
        for g, r in zip(_served(ours, images, tokens), (ref.encode_image(images), ref.encode_text(tokens))):
            np.testing.assert_allclose(g, r, atol=JAX_TOL, rtol=0)


# ------------------------------------------------------------------ the card


@pytest.mark.cuda
def test_cpu_exported_bundle_serves_on_the_card(bundles):
    """A bundle exported on the CPU serves on the card through K1 and K5, at
    the live model's launch counts, against the live model there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (tests/test_torch_card.py docstring)")
    cfg = _tcfg(TINY_VIT)
    model = TE.load_serving_bundle(bundles["vit", "int8"][1], device="cuda")
    live = T.tree_to(model.params, "cuda")
    images, tokens = _inputs(cfg, 5, seed=9)
    TA.fused_attention_qkv.launches = TQ.quantized_matmul.launches = 0
    got = _served(model, images, tokens)
    counts = (TA.fused_attention_qkv.launches, TQ.quantized_matmul.launches)
    assert counts == (cfg.vision_layers + cfg.transformer_layers,
                      TQ.LAUNCHES_PER_CALL * (4 * cfg.vision_layers + 2 + 4 * cfg.transformer_layers + 1))
    with torch.no_grad():
        ref = (T.l2_normalize(T.encode_image(live, cfg, torch.from_numpy(images).cuda())).float(),
               T.l2_normalize(T.encode_text(live, cfg, torch.from_numpy(tokens).cuda())).float())
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.cpu().numpy())
