"""The port's state-dict converter against the JAX package's: the same
OpenAI-named state dict, key for key and value for value, and an exact round
trip."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.models import convert as JC  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import convert as TC  # noqa: E402
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()

CFG_KW = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=77, vocab_size=128,
    transformer_width=64, transformer_heads=1, transformer_layers=3,
)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(1), J.CLIPConfig(**CFG_KW)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_state_dict_equals_jax(np_params):
    ref = JC.state_dict_from_params(np_params, J.CLIPConfig(**CFG_KW))
    tparams = TC.params_from_jax(np_params, T.CLIPConfig(**CFG_KW), device="cpu")
    ours = TC.state_dict_from_params(tparams, T.CLIPConfig(**CFG_KW))
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_round_trip_is_exact(np_params):
    cfg = T.CLIPConfig(**CFG_KW)
    sd = TC.state_dict_from_params(np_params, cfg)
    back, inferred = TC.params_from_state_dict(sd)
    assert inferred == cfg
    want = dict(_leaves(np_params))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and from torch tensors, as a torch checkpoint holds them
    back_t, _ = TC.params_from_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    for k, v in _leaves(back_t):
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_config_from_state_dict_matches_jax(np_params):
    sd = JC.state_dict_from_params(np_params, J.CLIPConfig(**CFG_KW))
    assert TC.config_from_state_dict(sd) == T.CLIPConfig(**CFG_KW)
    assert dataclass_fields(JC.config_from_state_dict(sd)) == dataclass_fields(
        TC.config_from_state_dict(sd)
    )


def dataclass_fields(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


def test_torch_checkpoint_file_loads(tmp_path, np_params):
    from clip_event_tpu_torch.evals.cli import load_model_from_cfg

    cfg = T.CLIPConfig(**CFG_KW)
    sd = TC.state_dict_from_params(np_params, cfg)
    path = tmp_path / "ckpt.pt"
    torch.save({"epoch": 1, "state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
    model, mcfg = load_model_from_cfg({"ckpt": str(path)}, device="cpu")
    assert mcfg == cfg
    for k, v in _leaves(model.params()):
        np.testing.assert_array_equal(v.numpy(), dict(_leaves(np_params))[k], err_msg=k)


def test_resnet_is_refused():
    """Since the ResNet half of convert.py is ported, a ResNet state dict is
    read (tests/test_torch_resnet.py holds it against JAX); one without its
    attention pool is refused, by both packages alike."""
    sd = {"visual.layer1.0.conv1.weight": np.zeros((64, 64, 1, 1))}
    with pytest.raises(KeyError, match="attnpool"):
        TC.config_from_state_dict(sd)
    with pytest.raises(KeyError, match="attnpool"):
        JC.config_from_state_dict(sd)
