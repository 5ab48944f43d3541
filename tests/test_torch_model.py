"""The port's CLIP encoders and forward against the JAX package on the same
weights (JAX `init_params`, carried over by `params_from_jax`) and the same
numpy inputs, at fp32 atol 1e-4 (the BASELINE.md parity bar), on a small ViT
config: 2 layers per tower, vision W=128 H=2 patch 16 res 64, text W=64
H=1, vocab 512."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402

CFG_KW = dict(
    embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=512,
    transformer_width=64, transformer_heads=1, transformer_layers=2,
)
JCFG = J.CLIPConfig(**CFG_KW)
TCFG = T.CLIPConfig(**CFG_KW)
ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    np_params = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), JCFG))
    return np_params, params_from_jax(np_params, TCFG, device="cpu")


def _images(n, uint8, seed=0):
    rng = np.random.default_rng(seed)
    if uint8:
        return rng.integers(0, 256, size=(n, 64, 64, 3), dtype=np.uint8)
    return rng.normal(size=(n, 64, 64, 3)).astype(np.float32)


def _tokens(n, width, seed=0):
    """SOT, random ids, EOT at a random position inside `width`, zero pad."""
    rng = np.random.default_rng(seed)
    V = CFG_KW["vocab_size"]
    out = np.zeros((n, width), np.int32)
    for i in range(n):
        eot = int(rng.integers(2, width))
        out[i, 0] = V - 2
        out[i, 1:eot] = rng.integers(1, V - 2, eot - 1)
        out[i, eot] = V - 1
    return out


def _close(ours, ref):
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("use_grid", [False, True])
def test_encode_image_matches_jax(weights, uint8, use_grid):
    np_params, tparams = weights
    x = _images(3, uint8)
    ref = J.encode_image(np_params, JCFG, jnp.asarray(x), use_grid=use_grid)
    ours = T.encode_image(tparams, TCFG, torch.from_numpy(x), use_grid=use_grid)
    assert ours.shape == ((3, 17, 64) if use_grid else (3, 64))
    _close(ours, ref)


@pytest.mark.parametrize("width", [77, 16])
def test_encode_text_matches_jax(weights, width):
    np_params, tparams = weights
    tok = _tokens(4, width, seed=width)
    ref = J.encode_text(np_params, JCFG, jnp.asarray(tok))
    _close(T.encode_text(tparams, TCFG, torch.from_numpy(tok)), ref)


def test_short_width_pools_like_full_width(weights):
    """Causal + EOT pooling: a caption that fits in 16 tokens gives the
    same feature at width 16 as in the 77-wide layout."""
    _, tparams = weights
    tok16 = _tokens(3, 16, seed=7)
    tok77 = np.zeros((3, 77), np.int32)
    tok77[:, :16] = tok16
    a = T.encode_text(tparams, TCFG, torch.from_numpy(tok16))
    b = T.encode_text(tparams, TCFG, torch.from_numpy(tok77))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("overbatch", [True, False])
def test_forward_matches_jax(weights, overbatch):
    np_params, tparams = weights
    images = _images(2, True, seed=3)
    tokens = _tokens(6, 77, seed=4)  # D=3 descriptions per image
    ref_i, ref_t = J.forward(np_params, JCFG, jnp.asarray(images), jnp.asarray(tokens), overbatch)
    ours_i, ours_t = T.forward(
        tparams, TCFG, torch.from_numpy(images), torch.from_numpy(tokens), overbatch
    )
    assert ours_i.shape == ((2, 6) if overbatch else (2, 3)) and ours_t.shape == (6, 2)
    np.testing.assert_allclose(ours_i.numpy(), np.asarray(ref_i), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours_t.numpy(), np.asarray(ref_t), atol=ATOL, rtol=0)


def test_module_matches_functional(weights):
    _, tparams = weights
    model = T.CLIP(TCFG, tparams)
    images = torch.from_numpy(_images(2, True, seed=5))
    tokens = torch.from_numpy(_tokens(2, 77, seed=6))
    a_i, a_t = model(images, tokens)
    b_i, b_t = T.forward(tparams, TCFG, images, tokens)
    assert torch.equal(a_i, b_i) and torch.equal(a_t, b_t)
    assert torch.equal(model.encode_text(tokens), T.encode_text(tparams, TCFG, tokens))
    names = dict(model.named_parameters())
    assert "visual.transformer.attn.qkv_w" in names and "text.text_transformer.ln_1.scale" in names


def test_plain_impl_matches_kernel_path_on_cpu(weights):
    _, tparams = weights
    images = torch.from_numpy(_images(2, False, seed=8))
    a = T.encode_image(tparams, TCFG, images, impl="kernel")
    b = T.encode_image(tparams, TCFG, images, impl="plain")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_cast_params_matches_jax(weights):
    np_params, tparams = weights
    ref = J.cast_params(np_params)
    ours = T.cast_params(tparams)

    def walk(r, o, path=""):
        for k in r:
            if isinstance(r[k], dict):
                walk(r[k], o[k], f"{path}.{k}")
            else:
                want = torch.bfloat16 if r[k].dtype == jnp.bfloat16 else torch.float32
                assert o[k].dtype == want, f"{path}.{k}"

    walk(ref, ours)
    assert ours["visual"]["ln_pre"]["scale"].dtype == torch.float32
    assert ours["visual"]["transformer"]["attn"]["qkv_w"].dtype == torch.bfloat16
