"""The port's framework-free tools and the train CLI's leftovers on the CPU,
against the JAX package where it has the same piece:

- `preprocess.ie_pipeline.plan` command for command JAX's, for every stage,
  all stages and the `text-ie` alias; the same refusal of an unknown stage;
  a dry `run` and an `--execute` without docker execute nothing;
  `run_ie_pipeline --plan` logs JAX's lines (the closing hint names the
  port's CLI);
- `tools.visualization` (`render_ie_pages`, `main`) on
  `tests/fixtures.py::make_voa_fixture`: every HTML page byte for byte;
- `async_save` (`engine/checkpoint.py`): the write waits on a gate on its
  thread while the state takes more eager steps; the file holds the state
  at the save step, equal to a synchronous save's, `latest_checkpoint`
  never names the `.tmp`, and a resume from either is the same; the train
  loop with `async_save` writes the files a synchronous loop writes,
  commits them before it returns, and saves synchronously on SIGTERM;
- `ScalarWriter`: `scalars.jsonl` byte for byte JAX's writer's for the same
  calls, and the TensorBoard event file's (tag, value, step) records equal
  (read back as tensorboard's `Event` protos);
- `--profile-dir`: a trace of the train step's forward and backward ops;
- the `length_buckets` line: JAX's shares, from JAX's dataset and loader.

Model: ViT towers of 2 layers, width 64, image 32; text width 64, 77
tokens, the real vocab."""

import glob
import json
import logging
import os
import signal
import struct
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from clip_event_tpu_torch.config import validate_config  # noqa: E402
from clip_event_tpu_torch.engine import checkpoint as TC  # noqa: E402
from tests.fixtures import make_voa_fixture  # noqa: E402

MODEL = {
    "embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
    "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 2,
}


# ------------------------------------------------------------ IE pipeline
STAGE_SETS = [None, ["text-ie"], ["setup", "text-ie", "vision-ie"]] + [
    [s] for s in ("setup", "preprocess", "oneie", "entity", "fillers", "event", "merge", "aif",
                  "vision-ie")
]


@pytest.mark.parametrize("stages", STAGE_SETS, ids=lambda s: "all" if s is None else "+".join(s))
def test_ie_plan_matches_jax(tmp_path, stages):
    from clip_event_tpu.preprocess import ie_pipeline as JI
    from clip_event_tpu_torch.preprocess import ie_pipeline as TI

    args = (str(tmp_path / "corpus"), "/opt/cu_toolbox", "")
    ours, ref = TI.plan(*args, stages=stages), JI.plan(*args, stages=stages)
    assert list(ours) == list(ref) and ours == ref
    assert sum(len(v) for v in ours.values()) >= 1


def test_ie_stage_table_and_refusals_match_jax(tmp_path, monkeypatch):
    from clip_event_tpu.preprocess import ie_pipeline as JI
    from clip_event_tpu_torch.preprocess import ie_pipeline as TI

    v = TI._vars(str(tmp_path), "", "")
    assert v == JI._vars(str(tmp_path), "", "")
    assert [(s.name, s.description, s.reference, s.produces(v)) for s in TI.STAGES] == \
        [(s.name, s.description, s.reference, s.produces(v)) for s in JI.STAGES]
    assert TI.TEXT_IE_STAGES == JI.TEXT_IE_STAGES
    for mod in (TI, JI):
        with pytest.raises(ValueError, match=r"unknown stages \['ocr'\]"):
            mod.plan(str(tmp_path), stages=["oneie", "ocr"])

    def refuse(*a, **k):
        raise AssertionError("a dry run executed a command")

    monkeypatch.setattr(TI.subprocess, "run", refuse)
    assert TI.run(str(tmp_path), stages=["text-ie"], dry_run=True)
    # --execute on a host without docker: prints the plan, runs nothing, fails
    monkeypatch.setattr(TI.shutil, "which", lambda name: None)
    assert not TI.docker_available()
    assert not TI.run(str(tmp_path), stages=["oneie"], dry_run=False)


def test_run_ie_pipeline_cli_logs_jax_lines(tmp_path, monkeypatch, caplog):
    import run_ie_pipeline as jax_cli
    from clip_event_tpu_torch import run_ie_pipeline as cli

    lines = {}
    argv = ["--data-root", str(tmp_path / "voa"), "--stages", "text-ie", "vision-ie", "--plan"]
    for name in ("jax", "port"):
        caplog.clear()
        with caplog.at_level(logging.INFO), pytest.raises(SystemExit) as exc:
            if name == "jax":
                monkeypatch.setattr(sys, "argv", ["run_ie_pipeline.py"] + argv)
                jax_cli.main()
            else:
                cli.main(argv)
        assert exc.value.code == 0
        lines[name] = [r.getMessage() for r in caplog.records if "ie_pipeline" in r.name]
    ours, ref = lines["port"], lines["jax"]
    assert len(ours) == len(ref) > 40 and ours[:-1] == ref[:-1]
    assert sum(x.startswith("DRY-RUN: docker run") for x in ours) > 30
    # the closing hint names the port's own CLI
    assert ours[-1] == ref[-1].replace("python preprocess_descriptions.py",
                                       "python -m clip_event_tpu_torch.preprocess_descriptions")


# --------------------------------------------------------- visualization
def test_visualization_pages_match_jax(tmp_path, monkeypatch):
    from clip_event_tpu.tools import visualization as JV
    from clip_event_tpu_torch.tools import visualization as TV

    voa = make_voa_fixture(str(tmp_path), num_docs=7)
    openie = tmp_path / "openie.tab"
    openie.write_text("".join(
        f"dir/VOA_EN_NW_2017_0{d}_0.rsd.txt\t1\tprotesters <{d}>\tmarch in\tcity & {d}\n" for d in range(4)
    ) + "short\tline\n")
    captions = {f"VOA_EN_NW_2017_0{d}_0": f"Caption <b>{d}</b> & more." for d in range(0, 7, 2)}
    cap_json = tmp_path / "captions.json"
    cap_json.write_text(json.dumps(captions))
    kw = dict(captions=captions, image_urls={"VOA_EN_NW_2017_00_0": ["http://e.com/a.jpg?x=1&y=2"]},
              openie_tab=str(openie), page_limit=3)
    n = [mod.render_ie_pages([voa["entity_cs"]], [voa["event_cs"]], str(tmp_path / f"html_{name}"), **kw)
         for name, mod in (("port", TV), ("jax", JV))]
    assert n == [7, 7]
    for name, mod in (("port", TV), ("jax", JV)):
        cfg = {"entity_cs": [voa["entity_cs"]], "event_cs": [voa["event_cs"]],
               "output_dir": str(tmp_path / f"cli_{name}"), "caption_clean_json": str(cap_json),
               "image_caption_json": voa["mapping_json"], "openie_tab": str(openie), "page_limit": 4}
        path = tmp_path / f"vis_{name}.json"
        path.write_text(json.dumps(cfg))
        if name == "port":
            mod.main(["--cfg", str(path)])
        else:
            monkeypatch.setattr(sys, "argv", ["visualization.py", "--cfg", str(path)])
            mod.main()
    for a, b in (("html_port", "html_jax"), ("cli_port", "cli_jax")):
        pages = sorted(os.listdir(tmp_path / b))
        assert pages == sorted(os.listdir(tmp_path / a)) and len(pages) >= 2
        for page in pages:
            assert (tmp_path / a / page).read_bytes() == (tmp_path / b / page).read_bytes(), (a, page)
    assert "&lt;b&gt;" in (tmp_path / "html_port" / "voa_events_0.html").read_text()


# -------------------------------------------------------------- training
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The VOA fixture with descriptions of varied lengths (so the length
    buckets split the instances), and a base train config."""
    root = tmp_path_factory.mktemp("tools_cli")
    voa = make_voa_fixture(str(root / "voa"), num_docs=8)
    with open(voa["descriptions_json"]) as fh:
        desc = json.load(fh)
    for i, image_id in enumerate(sorted(desc)):
        words = " ".join(["crowd"] * (3 * i))
        desc[image_id]["pos"] = [f"A protest event {words}."]
    with open(voa["descriptions_json"], "w") as fh:
        json.dump(desc, fh)
    base = {
        "task": "tools", "constrastive_loss": "ce", "model": MODEL, "seed": 5,
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "max_epoch": 1, "batch_size": 2, "lr": 1e-4, "optimizer": "adam",
        "lr_scheduler": "none", "compute_dtype": "float32", "remat": False, "num_workers": 2,
    }
    return root, voa, base


def _tree_equal(a, b, what=""):
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{what}.{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


def _clone(tree):
    return TC._map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)


def test_async_save_writes_the_state_at_the_save_step(corpus, tmp_path, monkeypatch):
    from clip_event_tpu_torch.data.common import DataLoader
    from clip_event_tpu_torch.data.prefetch import device_prefetch
    from clip_event_tpu_torch.engine.optim import build_optimizer, build_schedule
    from clip_event_tpu_torch.engine.train_step import create_train_state, make_train_step
    from clip_event_tpu_torch.train import build_dataset, initial_state

    _, _, base = corpus
    cfg = validate_config(dict(base, ckpt_dir=str(tmp_path)))
    params, mcfg, _ = initial_state(cfg, "cpu")
    ds = build_dataset(cfg, mcfg)
    loader = DataLoader(ds, batch_size=2, shuffle=False, drop_last=True, num_workers=0)
    batches = [b for b, _ in device_prefetch(loader, torch.device("cpu"), depth=1)]
    optimizer = build_optimizer("adam", build_schedule("none", 1e-4, 1))
    step = make_train_step(mcfg, optimizer, impl="plain")

    def state_from(params, opt_state=None):
        state = create_train_state(params, optimizer)
        return state if opt_state is None else state._replace(opt_state=opt_state, step=1)

    state, _ = step(state_from(params), batches[0])
    at_save = (_clone(state.params), _clone(state.opt_state))

    # the write renames its finished .tmp only when the gate opens
    gate, real_replace = threading.Event(), os.replace
    monkeypatch.setattr(TC.os, "replace", lambda a, b: (gate.wait(60), real_replace(a, b)))
    try:
        path = TC.save_checkpoint(str(tmp_path / "async"), "t", 0, state.params, state.opt_state, mcfg,
                                  step=1, mid_epoch=True, async_save=True)
        assert path.endswith("t_0") and TC._PENDING is not None and TC._PENDING.is_alive()
        for batch in batches[1:3]:
            state, _ = step(state, batch)  # the state moves on in place
        for _ in range(100):
            if os.path.exists(path + ".tmp"):
                break
            threading.Event().wait(0.05)
        assert os.path.exists(path + ".tmp") and not os.path.exists(path)
        assert TC.latest_checkpoint(str(tmp_path / "async"), "t") is None
        moved = _clone(state.params)
        with pytest.raises(AssertionError):
            _tree_equal(moved, at_save[0])
    finally:
        gate.set()
        TC.wait_for_saves()
    assert TC._PENDING is None and not os.path.exists(path + ".tmp")
    assert TC.latest_checkpoint(str(tmp_path / "async"), "t") == path

    sync = TC.save_checkpoint(str(tmp_path / "sync"), "t", 0, at_save[0], at_save[1], mcfg,
                              step=1, mid_epoch=True)
    a, b = (torch.load(p, map_location="cpu", weights_only=False) for p in (path, sync))
    _tree_equal(a, b)
    assert a["step"] == 1 and a["mid_epoch"]
    with open(path + ".meta.json") as fa, open(sync + ".meta.json") as fb:
        assert fa.read() == fb.read()
    # both resume to the state at the save step, and step on alike
    resumed = []
    for p in (path, sync):
        params_r, opt_r, meta, _ = TC.restore_checkpoint(p)
        _tree_equal(params_r, at_save[0])
        _tree_equal(opt_r, at_save[1])
        nxt, metrics = step(state_from(params_r, opt_r), batches[1])
        resumed.append((_clone(nxt.params), float(metrics["loss"])))
    _tree_equal(resumed[0][0], resumed[1][0])
    assert resumed[0][1] == resumed[1][1]


def _run_loop(cfg, **kw):
    from clip_event_tpu_torch.train import build_dataset, initial_state, train

    params, mcfg, resume = initial_state(cfg, "cpu")
    return train(cfg, mcfg, build_dataset(cfg, mcfg), params, "cpu", **resume, **kw)


def test_async_loop_writes_what_a_sync_loop_writes(corpus, monkeypatch):
    from clip_event_tpu_torch import train as train_mod

    root, _, base = corpus
    calls = []
    real = train_mod.save_checkpoint

    def spy(*args, **kw):
        calls.append(bool(kw.get("async_save")))
        return real(*args, **kw)

    monkeypatch.setattr(train_mod, "save_checkpoint", spy)
    for name, extra in (("sync", {}), ("async", {"async_save": True})):
        cfg = validate_config(dict(base, ckpt_dir=str(root / f"loop_{name}"), save_steps=2, **extra))
        _run_loop(cfg)
        assert TC._PENDING is None  # committed before the loop returned
    assert calls == [False] * 3 + [True] * 3  # steps 2 and 4 of 4, and the epoch's end
    a, b = (torch.load(str(root / f"loop_{n}" / "tools" / "tools_0"), map_location="cpu",
                       weights_only=False) for n in ("async", "sync"))
    _tree_equal(a, b)
    assert a["step"] == 4 and not a["mid_epoch"]
    assert not glob.glob(str(root / "loop_async" / "tools" / "*.tmp"))

    # SIGTERM: the preemption checkpoint is written synchronously
    calls.clear()

    def preempt(step, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    cfg = validate_config(dict(base, ckpt_dir=str(root / "loop_term"), save_steps=2, async_save=True))
    _run_loop(cfg, on_step=preempt)
    assert calls == [True, False]  # step 2's save, then step 3's on SIGTERM
    assert TC.load_meta(str(root / "loop_term" / "tools" / "tools_0"))["step"] == 3


def _events(logdir):
    """(tag, value, step) of every scalar in the directory's event files:
    TFRecord framing (length, its CRC, the record, its CRC) around
    tensorboard's `Event` protos (`tensorboard.compat.proto`, which loads
    no TensorFlow)."""
    from tensorboard.compat.proto.event_pb2 import Event

    out = []
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*"))):
        with open(path, "rb") as fh:
            data = fh.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            event = Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            out += [(v.tag, v.simple_value, event.step) for v in event.summary.value]
    return out


def test_scalar_writer_matches_jax(tmp_path):
    from clip_event_tpu.engine.metrics import ScalarWriter as JaxWriter
    from clip_event_tpu_torch.engine.metrics import ScalarWriter

    calls = [("train_loss", 1.25, 0), ("loss_i", np.float32(0.6123), 0), ("loss_t", 0.5, 1),
             ("val_i2t_top1", 0.875, 1), ("train_loss", np.float64(0.9921875), 2), ("lr", 3, 2)]
    for name, cls in (("port", ScalarWriter), ("jax", JaxWriter)):
        writer = cls(str(tmp_path / name))
        assert writer._tb is not None  # tensorboardX is installed here
        for tag, value, step in calls:
            writer.add_scalar(tag, value, step)
        writer.close()
    assert (tmp_path / "port" / "scalars.jsonl").read_bytes() == \
        (tmp_path / "jax" / "scalars.jsonl").read_bytes()
    ours, ref = _events(str(tmp_path / "port")), _events(str(tmp_path / "jax"))
    assert ours == ref
    assert ours == [(t, float(np.float32(v)), s) for t, v, s in calls]
    # another writer on the same directory appends to the jsonl
    writer = ScalarWriter(str(tmp_path / "port"))
    writer.add_scalar("train_loss", 0.5, 3)
    writer.close()
    assert len((tmp_path / "port" / "scalars.jsonl").read_text().splitlines()) == len(calls) + 1


@pytest.fixture(scope="module")
def profiled_cli(corpus, tmp_path_factory):
    """The train CLI in this process with --profile-dir and length buckets;
    returns (profile dir, the log records' messages)."""
    from clip_event_tpu_torch.train import main

    root, _, base = corpus
    cfg = dict(base, ckpt_dir=str(root / "ck_prof"), tb_log_dir=str(root / "logs_prof"),
               length_buckets=[12, 16], async_save=True)
    path = root / "prof.json"
    path.write_text(json.dumps(cfg))
    prof_dir = str(root / "profile")
    main(["--cfg", str(path), "--device", "cpu", "--profile-dir", prof_dir])
    # the run logs to its own file (create_logger)
    (log_file,) = glob.glob(str(root / "logs_prof" / "tools" / "log" / "*.txt"))
    with open(log_file) as fh:
        return prof_dir, fh.read().splitlines()


def test_profile_dir_traces_the_train_step(profiled_cli):
    prof_dir, records = profiled_cli
    (trace,) = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    with open(trace) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    # the step's forward GEMMs, the attention wrapper's backward (its plain
    # version on the CPU), the other backward ops, Adam's update
    assert {"aten::matmul", "aten::mm", "aten::_foreach_sqrt"} <= names
    assert "autograd::engine::evaluate_function: _FusedAttentionBackward" in names
    assert "autograd::engine::evaluate_function: MmBackward0" in names
    assert any("profiling the epoch" in r for r in records)


def test_length_buckets_line_matches_jax(profiled_cli, corpus):
    from clip_event_tpu.data.common import DataLoader as JaxLoader
    from clip_event_tpu.data.voa import VOADescriptionDataset as JaxDataset

    _, records = profiled_cli
    root, voa, _ = corpus
    # a copy of the descriptions: JAX computes its own widths (the
    # packages' width sidecars beside the json are interchangeable)
    desc = str(root / "jax_descriptions.json")
    with open(voa["descriptions_json"]) as src, open(desc, "w") as dst:
        dst.write(src.read())
    ds = JaxDataset(desc, [voa["mapping_json"]], [voa["image_dir"]], image_size=32)
    loader = JaxLoader(ds, batch_size=2, shuffle=True, drop_last=True, bucket_widths=[16, 12])
    # train.py:188-204
    widths, caps = ds.instance_widths(num_workers=2), loader.bucket_widths
    shares = [
        float(np.mean((widths <= hi) & (widths > (caps[i - 1] if i else 0))))
        for i, hi in enumerate(caps)
    ]
    want = "length_buckets %s: instance shares %s (narrow batches run the text tower at that width — lossless)" % (
        caps, ["%.0f%%" % (100 * s) for s in shares])
    lines = [r for r in records if "length_buckets [" in r]
    assert len(lines) == 1 and lines[0].endswith(want)
    assert 0 < shares[0] < 1  # the buckets split this corpus
