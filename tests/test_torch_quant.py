"""The port's int8 (W8A8) inference path on the CPU against the JAX
package's, on the same numpy-seeded inputs: `quantize_weight` (q equal,
scale within one ulp), the plain `quantized_linear` against JAX's XLA
composition and its Pallas kernel in interpret mode (fp32 within
1e-5·max|y|, bf16 within one bf16 ulp of max|y|), `quantize_params`,
the act-stat forwards and `calibrate_act_scales` (1e-5 relative), int8
encoders from a JAX-quantized tree (1e-4, the encoder bar), and the
QuantWeight's trip through `_layer`, `tree_to`, `cast_params` and `CLIP`."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.ops import quant as JQ  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402
from clip_event_tpu_torch.ops import quant as TQ  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=77, vocab_size=49408,
    transformer_width=64, transformer_heads=1, transformer_layers=2,
)
JCFG, TCFG = J.CLIPConfig(**CFG_KW), T.CLIPConfig(**CFG_KW)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jparams():
    return J.init_params(jax.random.PRNGKey(0), JCFG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(seed=0, n=4):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    toks = np.zeros((n, 77), np.int32)
    toks[:, 0] = 49406
    toks[:, 1:6] = rng.integers(1, 49000, (n, 5))
    toks[:, 6] = 49407
    return imgs, toks


def _ulp_diff(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def _assert_close(ours, ref, dtype):
    """Max abs err against max|ref|: at most 1e-5 of it in fp32, one bf16 ulp
    of it (2^(floor(log2 max|ref|) - 7)) in bf16. Relative to the max, not
    to each element: JAX's Pallas kernel and its XLA composition differ by
    an fp32 ulp (a fused multiply-add), which an element near a cancelling
    bias turns into many ulps of its own small value."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    top = np.abs(ref).max()
    diff = np.abs(ours - ref).max()
    bar = 1e-5 * top if dtype == "float32" else np.exp2(np.floor(np.log2(top)) - 7)
    assert diff <= bar, (diff, bar)


@pytest.mark.parametrize("shape", [(48, 96), (3, 32, 64), (588, 256)], ids=["2d", "stacked", "k588"])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = JQ.quantize_weight(jnp.asarray(w), act_absmax=jnp.float32(3.7))
    ours = TQ.quantize_weight(torch.from_numpy(w), act_absmax=torch.tensor(3.7))
    assert ours.q.dtype == torch.int8 and ours.q.shape == shape
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
    assert _ulp_diff(ours.scale.numpy(), np.asarray(ref.scale)) <= 1
    assert _ulp_diff(ours.act_scale.numpy().reshape(1), np.asarray(ref.act_scale).reshape(1)) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("m,k,n,bias", [(77, 64, 192, True), (1, 588, 256, True), (33, 48, 7, False)],
                         ids=["text", "m1_k588", "n_odd"])
def test_quantized_linear_matches_jax_xla(m, k, n, bias, static, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[0] = 0.0 if m > 1 else x[0]  # an all-zero row yields the bias
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    absmax = float(np.abs(x).max()) * 0.8 if static else None
    jd, td = DTYPES[dtype]
    jw = JQ.quantize_weight(jnp.asarray(w), act_absmax=absmax)
    tw = TQ.quantize_weight(torch.from_numpy(w), act_absmax=None if absmax is None else torch.tensor(absmax))
    ref = JQ.quantized_linear(jnp.asarray(x, jd), jw, None if b is None else jnp.asarray(b))
    ours = TQ.quantized_linear(torch.from_numpy(x).to(td), tw, None if b is None else torch.from_numpy(b))
    assert ours.dtype == td and tuple(ours.shape) == (m, n)
    _assert_close(ours.float().numpy(), np.asarray(ref, np.float32), dtype)
    if m > 1:
        expect = torch.from_numpy(b) if bias else torch.zeros(n)
        assert torch.equal(ours[0], expect.to(td))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(77, 512, 384), (1, 256, 128), (200, 128, 256)],
                         ids=["text", "m1", "m_pad"])
def test_quantized_matmul_matches_pallas_interpret(m, k, n, dtype):
    from clip_event_tpu.ops.quant_pallas import quantized_matmul as pallas_qmm

    rng = np.random.default_rng(3)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    jd, td = DTYPES[dtype]
    jw = JQ.quantize_weight(jnp.asarray(w))
    tw = TQ.quantize_weight(torch.from_numpy(w))
    ref = pallas_qmm(jnp.asarray(x, jd), jw.q, jw.scale, jnp.asarray(b), interpret=True)
    ours = TQ.quantized_matmul(torch.from_numpy(x).to(td), tw.q, tw.scale, torch.from_numpy(b))
    _assert_close(ours.float().numpy(), np.asarray(ref, np.float32), dtype)


def test_row_quantization_edges():
    x = torch.zeros(3, 5)
    x[1, 2] = 1e3  # one large value: it maps to 127, the rest of the row to 0
    x[2] = torch.tensor([0.5, -0.5, 1.5, 2.5, 127.0])  # halves round to even
    xq, s = TQ.quantize_rows_plain(x)
    assert s[0].item() == np.float32(1e-12) and (xq[0] == 0).all()
    assert xq[1].tolist() == [0, 0, 127, 0, 0]
    assert s[2].item() == 1.0 and xq[2].tolist() == [0, 0, 2, 2, 127]
    static = TQ.quantize_rows_plain(x, torch.tensor(1.0))
    assert static[1].tolist() == [1.0, 1.0, 1.0] and static[0][1].tolist() == [0, 0, 127, 0, 0]


def test_gemm_impl_and_devices():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(5, 40)).astype(np.float32))
    w = TQ.quantize_weight(torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32)))
    ref = TQ.quantized_matmul_plain(x, w.q, w.scale)
    for impl in TQ.GEMM_IMPLS:
        TQ.set_gemm_impl(impl)
        try:
            assert torch.equal(TQ.quantized_linear(x, w), ref)
        finally:
            TQ.set_gemm_impl("auto")
    with pytest.raises(ValueError):
        TQ.set_gemm_impl("triton")
    # a device that is neither the CPU nor CUDA: the wrapper raises, it never
    # runs the plain version there
    with pytest.raises(ValueError, match="CUDA"):
        TQ.quantized_matmul(x.to("meta"), w.q, w.scale)
    with pytest.raises(ValueError, match="layer"):
        TQ.quantized_linear(x, TQ.quantize_weight(torch.randn(2, 40, 24)))


@pytest.mark.parametrize("towers", [None, ("visual",), ("text",)], ids=["both", "visual", "text"])
def test_quantize_params_matches_jax(jparams, towers):
    imgs, toks = _inputs()
    jstats = JQ.calibrate_act_scales(jparams, JCFG, [imgs], [toks])
    ref = _np(JQ.quantize_params(jparams, act_stats=jstats, towers=towers))
    tparams = params_from_jax(_np(jparams), TCFG, "cpu")
    tstats = TQ.calibrate_act_scales(tparams, TCFG, [imgs], [toks])
    ours = TQ.quantize_params(tparams, act_stats=tstats, towers=towers)
    assert TQ.is_quantized(ours) and not TQ.is_quantized(tparams)
    n_quant = 0

    def walk(a, b, path):
        nonlocal n_quant
        assert set(a) == set(b), path
        for k in a:
            if isinstance(b[k], dict):
                walk(a[k], b[k], path + (k,))
            elif isinstance(b[k], JQ.QuantWeight):
                assert isinstance(a[k], TQ.QuantWeight), path + (k,)
                n_quant += 1
                np.testing.assert_array_equal(a[k].q.numpy(), b[k].q)
                assert _ulp_diff(a[k].scale.numpy(), np.asarray(b[k].scale, np.float32)) <= 1
                np.testing.assert_allclose(a[k].act_scale.numpy(), b[k].act_scale, rtol=1e-5)
            else:
                assert not isinstance(a[k], TQ.QuantWeight), path + (k,)
                np.testing.assert_array_equal(a[k].numpy(), b[k])

    walk(ours, ref, ())
    # 4 per stacked transformer + patch embed + proj (visual), + text_projection
    assert n_quant == {None: 11, ("visual",): 6, ("text",): 5}[towers]
    with pytest.raises(ValueError, match="towers"):
        TQ.quantize_params(tparams, towers=("audio",))


def test_act_stats_match_jax(jparams):
    from clip_event_tpu.models.clip import text_act_stats as j_text
    from clip_event_tpu.models.vit import vit_act_stats as j_vit
    from clip_event_tpu_torch.models.vit import vit_act_stats

    imgs, toks = _inputs(5)
    tparams = params_from_jax(_np(jparams), TCFG, "cpu")
    vit = vit_act_stats(tparams["visual"], torch.from_numpy(imgs), 16, TCFG.vision_heads)
    assert vit["transformer"]["mlp"]["fc_w"].shape == (2,)
    pairs = [
        (j_vit(jparams["visual"], jnp.asarray(imgs), 16, JCFG.vision_heads), vit),
        (j_text(jparams, JCFG, jnp.asarray(toks)), T.text_act_stats(tparams, TCFG, torch.from_numpy(toks))),
    ]
    for ref, ours in pairs:
        jax.tree.map(lambda r, o: np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5),
                     ref, ours)


def test_calibrate_act_scales_matches_jax(jparams):
    imgs_a, toks_a = _inputs(6)
    imgs_b, toks_b = _inputs(7, n=3)
    ref = JQ.calibrate_act_scales(jparams, JCFG, [imgs_a, imgs_b], [toks_a, toks_b])
    tparams = params_from_jax(_np(jparams), TCFG, "cpu")
    ours = TQ.calibrate_act_scales(tparams, TCFG, [imgs_a, imgs_b], [toks_a, toks_b])
    jax.tree.map(lambda r, o: np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5), ref, ours)


@pytest.mark.parametrize("static", [False, True], ids=["int8", "int8_static"])
def test_int8_encoders_match_jax(jparams, static):
    # The two frameworks' LayerNorms differ by an fp32 ulp; where a
    # quantized activation sits on a rounding boundary that ulp flips its
    # int8 value (with input seed 8, one element of image 2's first QKV
    # input: 4e-2 on its features). These inputs have no such element, so
    # the int8 paths are held to the float encoder bar.
    imgs, toks = _inputs(0)
    stats = JQ.calibrate_act_scales(jparams, JCFG, [imgs], [toks]) if static else None
    jq = JQ.quantize_params(jparams, act_stats=stats)
    tq = params_from_jax(_np(jq), TCFG, "cpu")
    assert isinstance(tq["visual"]["transformer"]["attn"]["qkv_w"], TQ.QuantWeight)
    for jfn, tfn, x in ((J.encode_image, T.encode_image, imgs), (J.encode_text, T.encode_text, toks)):
        ref = np.asarray(jfn(jq, JCFG, jnp.asarray(x)))
        ours = tfn(tq, TCFG, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    model = T.CLIP(TCFG, tq)
    ref = np.asarray(J.encode_image(jq, JCFG, jnp.asarray(imgs)))
    np.testing.assert_allclose(model.encode_image(torch.from_numpy(imgs)).numpy(), ref, atol=1e-4, rtol=0)


def test_quant_weight_round_trips(jparams):
    imgs, toks = _inputs(9)
    stats = JQ.calibrate_act_scales(jparams, JCFG, [imgs], [toks])
    tq = params_from_jax(_np(JQ.quantize_params(jparams, act_stats=stats)), TCFG, "cpu")
    w = tq["visual"]["transformer"]["mlp"]["fc_w"]
    assert w.q.shape == (2, 64, 256) and w.act_scale.shape == (2,)
    layer = TL._layer(tq["visual"]["transformer"], 1)["mlp"]["fc_w"]
    assert isinstance(layer, TQ.QuantWeight) and layer.act_scale.dim() == 0
    assert torch.equal(layer.q, w.q[1]) and torch.equal(layer.scale, w.scale[1])
    assert layer.act_scale.item() == w.act_scale[1].item()

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, TQ.QuantWeight):
            return (isinstance(b, TQ.QuantWeight) and torch.equal(a.q, b.q)
                    and torch.equal(a.scale, b.scale) and torch.equal(a.act_scale, b.act_scale))
        return torch.equal(a, b)

    moved = T.tree_to(tq, "cpu", torch.bfloat16)
    assert moved["visual"]["proj"].q.dtype == torch.int8  # a cast leaves int8 weights alone
    assert same(T.cast_params(tq)["text_projection"], tq["text_projection"])
    model = T.CLIP(TCFG, tq)
    assert same(model.params(), tq)
    assert "visual.transformer.attn.qkv_w.q" in dict(model.named_buffers())
    assert all(p.dtype != torch.int8 for p in model.parameters())
    # a whole-tree trip through the module keeps the encoders' outputs
    out = T.encode_image(model.params(), TCFG, torch.from_numpy(imgs))
    assert torch.equal(out, T.encode_image(tq, TCFG, torch.from_numpy(imgs)))


@pytest.mark.parametrize("cfg", [
    {"seed": 3, "batch_size": 8},
    {"seed": 0, "batch_size": 64, "calibration_batches": 3},
], ids=["bs8", "bs16x3"])
def test_calibration_batches_match_jax(cfg):
    from clip_event_tpu.evals.cli import calibration_batches_from_cfg as jcal
    from clip_event_tpu_torch.evals.cli import calibration_batches_from_cfg

    for kw in (CFG_KW, dict(CFG_KW, vocab_size=500)):
        ref = jcal(cfg, J.CLIPConfig(**kw))
        ours = calibration_batches_from_cfg(cfg, T.CLIPConfig(**kw))
        for a, b in zip(ours, ref):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def _write_ckpt(path, np_params):
    from clip_event_tpu_torch.models.convert import state_dict_from_params

    sd = state_dict_from_params(np_params, TCFG)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


@pytest.mark.parametrize("quant", [
    {"quantize": "int8"},
    {"quantize": "int8_static", "quantize_towers": ["visual"], "calibration_batches": 1},
], ids=["int8", "int8_static_visual"])
def test_load_model_from_cfg_quantizes_as_jax(tmp_path, jparams, quant):
    from clip_event_tpu.evals.cli import load_model_from_cfg as jload
    from clip_event_tpu_torch.evals.cli import load_model_from_cfg

    ckpt = str(tmp_path / "w.pt")
    _write_ckpt(ckpt, _np(jparams))
    cfg = {"ckpt": ckpt, "seed": 2, "batch_size": 4, **quant}
    jq, _ = jload(cfg)
    model, mcfg = load_model_from_cfg(cfg, "cpu")
    ours = model.params()
    ref = _np(jq)
    w = ours["visual"]["transformer"]["attn"]["qkv_w"]
    assert isinstance(w, TQ.QuantWeight)
    assert (w.act_scale is not None) == (quant["quantize"] == "int8_static")
    assert isinstance(ours["text_projection"], TQ.QuantWeight) == ("quantize_towers" not in quant)
    np.testing.assert_array_equal(w.q.numpy(), ref["visual"]["transformer"]["attn"]["qkv_w"].q)
    imgs, toks = _inputs(10)
    for jfn, tfn, x in ((J.encode_image, T.encode_image, imgs), (J.encode_text, T.encode_text, toks)):
        np.testing.assert_allclose(tfn(ours, mcfg, torch.from_numpy(x)).numpy(),
                                   np.asarray(jfn(jq, JCFG, jnp.asarray(x))), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="quantize"):
        load_model_from_cfg({"ckpt": ckpt, "quantize": "int4"}, "cpu")


def test_embed_cli_int8_static_on_cpu(tmp_path):
    cfg = {
        "output_dir": str(tmp_path / "out"), "texts": ["a protest", "a wedding", "a flood"],
        "batch_size": 2, "num_workers": 1, "model": CFG_KW, "seed": 3,
        "quantize": "int8_static", "quantize_towers": ["text"], "calibration_batches": 1,
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "clip_event_tpu_torch.embed", "--cfg", str(path), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["texts"]["count"] == 3
    feats = np.load(tmp_path / "out" / "text-00000.npz")["features"]
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
