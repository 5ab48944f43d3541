"""The port's train CLI (`python -m clip_event_tpu_torch.train`) against the
JAX CLI (`train.py`) on the synthetic VOA corpus of tests/fixtures.py, on
the CPU in fp32: both start from one `.pth` written from JAX params
(`jit: true`) and train 2 epochs of 3 steps with Adam under the warmup
schedule; the epoch means of train_loss, loss_i and loss_t in their
`scalars.jsonl` agree to 1e-5 (fp32 on both sides, only reduction orders
differ). Checkpoints cross both ways, a mid-epoch resume reproduces the
uninterrupted run's loss stream and params, a diverging run aborts with
its debug artifact, and without `--device cpu` and a card the CLI raises.

Model: ViT towers of 2 layers, width 64 (1 head), patch 16, image 32; text
width 64, 1 head, 77 tokens, the real vocab (the tokenizer's)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from clip_event_tpu.engine.checkpoint import export_torch_checkpoint  # noqa: E402
from clip_event_tpu.engine.checkpoint import (  # noqa: E402
    import_initial_checkpoint as jax_import,
)
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.config import validate_config  # noqa: E402
from clip_event_tpu_torch.engine import checkpoint as TC  # noqa: E402
from clip_event_tpu_torch.train import build_dataset, initial_state, main, train  # noqa: E402
from tests.fixtures import make_voa_fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {
    "embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
    "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2,
}
TAGS = ("train_loss", "loss_i", "loss_t")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    voa = make_voa_fixture(str(root / "voa"))
    jcfg = J.CLIPConfig(**MODEL)
    params = J.init_params(jax.random.PRNGKey(3), jcfg)
    pth = str(root / "boot.pth")
    export_torch_checkpoint(pth, params, jcfg, epoch=0, task="boot")
    base = {
        "task": "cli", "constrastive_loss": "ce",
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "max_epoch": 2, "batch_size": 2, "lr": 1e-4, "optimizer": "adam",
        "lr_scheduler": "warmup", "compute_dtype": "float32", "remat": False,
        "num_workers": 2, "jit": True, "begin_ckpt": pth,
    }
    return root, voa, base, jax.tree.map(np.asarray, params)


def _scalars(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            out[rec["tag"], rec["step"]] = rec["value"]
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def test_loss_stream_matches_jax_cli_and_checkpoints_cross(corpus):
    root, voa, base, jax_params = corpus
    runs = {}
    for name, extra, cmd, env in [
        ("jax", {"use_pallas_attention": False}, [sys.executable, "train.py"],
         dict(os.environ, JAX_PLATFORMS="cpu",
              XLA_FLAGS="--xla_force_host_platform_device_count=1")),
        ("port", {"validate_every": 1, "val_image_caption_json": [voa["mapping_json"]],
                  "val_image_dir": [voa["image_dir"]]},
         [sys.executable, "-m", "clip_event_tpu_torch.train", "--device", "cpu"], dict(os.environ)),
    ]:
        cfg = dict(base, ckpt_dir=str(root / f"ckpt_{name}"), tb_log_dir=str(root / f"logs_{name}"),
                   **extra)
        path = root / f"{name}.json"
        path.write_text(json.dumps(cfg))
        runs[name] = subprocess.Popen(
            cmd + ["--cfg", str(path)], cwd=REPO, env=env, text=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
    for name, proc in runs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, err[-3000:])

    ours = _scalars(root / "logs_port" / "cli" / "tensorboard" / "scalars.jsonl")
    ref = _scalars(root / "logs_jax" / "cli" / "tensorboard" / "scalars.jsonl")
    for tag in TAGS:
        for epoch in (0, 1):
            assert abs(ours[tag, epoch] - ref[tag, epoch]) <= 1e-5, (tag, epoch, ours, ref)
    assert ("val_i2t_top1", 1) in ours
    assert (root / "logs_port" / "cli" / "tensorboard" / "config.json").exists()

    # the port's checkpoint reads into the JAX package with equal params...
    ckpt = TC.latest_checkpoint(str(root / "ckpt_port"), "cli")
    assert ckpt.endswith("cli_1") and TC.load_meta(ckpt)["step"] == 6
    params, opt_state, meta, mcfg = TC.restore_checkpoint(ckpt)
    assert meta["epoch"] == 1 and not meta["mid_epoch"] and int(opt_state["count"]) == 6
    jparams, jcfg = jax_import(ckpt)
    assert jcfg == J.CLIPConfig(**MODEL) and mcfg == TC.CLIPConfig(**MODEL)
    a, b = _flat(params), _flat(jparams)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # ...and the JAX package's export reads into the port with equal params
    np_params, _ = TC.import_initial_checkpoint(base["begin_ckpt"])
    a, b = _flat(np_params), _flat(jax_params)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _run(cfg, record):
    """The port's loop in this process, recording each step's loss."""
    params, mcfg, resume = initial_state(cfg, "cpu")
    state = train(cfg, mcfg, build_dataset(cfg, mcfg), params, "cpu",
                  on_step=lambda step, m: record.__setitem__(step, float(m["loss"])), **resume)
    return state


def test_mid_epoch_resume_reproduces_the_stream(corpus):
    """Stop after step 4 of 6 (inside epoch 1), resume from the mid-epoch
    checkpoint, finish: the same losses and params as one run. The LR is
    constant here: with a per-step warmup schedule a resume into a later
    epoch shifts the schedule by `begin_epoch`, in the JAX CLI as in the
    port (`train.py:216-225`), so no stream would match there."""
    root, _, base, _ = corpus
    base = dict(base, lr_scheduler="none")
    full, first, rest = {}, {}, {}
    a = _run(validate_config(dict(base, ckpt_dir=str(root / "ck_a"))), full)
    _run(validate_config(dict(base, ckpt_dir=str(root / "ck_b"), max_steps=4)), first)
    ckpt = str(root / "ck_b" / "cli" / "cli_1")
    assert TC.load_meta(ckpt) == {"epoch": 1, "model": "cli", "perf": 0.0, "step": 4,
                                  "mid_epoch": True}
    c = _run(validate_config(dict(base, ckpt_dir=str(root / "ck_b"), jit=False,
                                  begin_ckpt=ckpt)), rest)
    assert sorted(full) == list(range(6)) and sorted(first) == [0, 1, 2, 3]
    assert sorted(rest) == [4, 5]
    assert {**first, **rest} == full
    for x, y in zip(_flat(a.params).values(), _flat(c.params).values()):
        np.testing.assert_array_equal(x, y)


def test_diverging_run_aborts_with_debug_artifact(corpus):
    root, _, base, _ = corpus
    cfg = validate_config(dict(base, ckpt_dir=str(root / "ck_nan"), optimizer="sgd", lr=1e18,
                               lr_scheduler="none", max_epoch=50))
    with pytest.raises(SystemExit) as exc:
        _run(cfg, {})
    assert exc.value.code == 1
    names = [f for f in os.listdir(root / "ck_nan" / "cli") if f.startswith("nan_debug_step")]
    assert names
    with open(root / "ck_nan" / "cli" / names[0]) as fh:
        debug = json.load(fh)
    assert debug["metrics"]["finite"] == 0.0
    assert debug["recent_batches"] and all(b["image_ids"] for b in debug["recent_batches"])


def test_cli_raises_without_a_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    root, _, base, _ = corpus
    path = root / "nocard.json"
    path.write_text(json.dumps(dict(base, ckpt_dir=str(root / "ck_nocard"))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--cfg", str(path)])
