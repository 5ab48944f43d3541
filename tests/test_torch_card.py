"""The port's CLIs on the card at the presets this slice added (marker
`cuda`: each test skips without a CUDA device; on the card it builds the
kernels with nvcc at first use). Run them on a machine with an H100 with

    python -m pytest tests/test_torch_card.py -m cuda -q

- `python -m clip_event_tpu_torch.train` at full-width ViT-L/14 (vision
  through K2) with finetune_ot.json's OT keys (object crops, IE channel,
  alignment, `use_pallas_ot`, so K3) on the synthetic VOA fixture: the
  epoch's losses are finite, `loss_ot` > 0, and K2 and K3 launched;
- `python -m clip_event_tpu_torch.embed` at ViT-B/16 and `.eval_matching`
  at ViT-L/14, seeded weights: unit-norm features of the right shape and
  the matching metrics of the fixture's pairs;
- K5 (`ops.quant.quantized_matmul`) against its plain version at a few
  shapes, dynamic and static, fp32 and bf16;
- `.eval_m2e2` at ViT-L/14 in int8_static with argument grounding (K2 for
  the grid features, K5 in every dense layer), `.eval_vcr`,
  `.eval_visualcomet` and `.eval_retrieval` at ViT-B/32 (the last in
  int8): every metric finite and in [0, 1] where it is a rate;
- K4 (`ops.ln`: the fused LayerNorm forward, the add + LayerNorm forward
  and their shared backward) and K6 (`ops.attention.fused_ln_qkv_attention`)
  against their plain versions at a few shapes, fp32 and bf16;
- `python -m clip_event_tpu_torch.train` at ViT-B/32 with
  `use_pallas_ln: true`: K4a, K4b and K4c launched in every residual block
  of every step, finite losses, and the LayerNorm choice put back."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def voa(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (tests/test_torch_card.py docstring)")
    # tests/fixtures.py by path: `tests` has no __init__.py, so an installed
    # package named `tests` can shadow `tests.fixtures`
    spec = importlib.util.spec_from_file_location("voa_fixtures", os.path.join(HERE, "fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    return fixtures.make_voa_fixture(str(tmp_path_factory.mktemp("voa_card")), num_docs=4)


def _scalars(path):
    with open(path) as fh:
        return {(r["tag"], r["step"]): r["value"] for r in map(json.loads, fh)}


def test_train_cli_vit_l14_with_ot(voa, tmp_path):
    from clip_event_tpu_torch.ops import attention as A
    from clip_event_tpu_torch.ops import ot
    from clip_event_tpu_torch.train import main

    cfg = {
        "task": "card", "model": "ViT-L/14", "seed": 0, "constrastive_loss": "ce",
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "alignment": True, "alignment_chunks": 2, "use_pallas_ot": True,
        "load_object": True, "object_pickle": [voa["object_pickle"]],
        "object_ontology_file": voa["ontology_csv"], "max_objects": 4,
        "load_ie": True, "input_entities": [voa["entity_cs"]], "input_events": [voa["event_cs"]],
        "batch_size": 2, "max_epoch": 1, "lr": 1e-6, "optimizer": "adam",
        "compute_dtype": "bfloat16", "remat": True, "num_workers": 2,
        "ckpt_dir": str(tmp_path / "ckpt"), "tb_log_dir": str(tmp_path / "logs"),
    }
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    A.fused_attention_qkv_headgrid.launches = ot.ipot_kernel.launches = 0
    main(["--cfg", str(path)])
    # 4 images at batch 2; each of the 24 vision blocks runs its forward
    # twice for the image and three times in each of the 2 crop chunks
    steps = 2
    assert A.fused_attention_qkv_headgrid.launches == 24 * (2 + 3 * 2) * steps
    assert ot.ipot_kernel.launches == steps
    scalars = _scalars(tmp_path / "logs" / "card" / "tensorboard" / "scalars.jsonl")
    assert all(np.isfinite(scalars[tag, 0]) for tag in ("train_loss", "loss_i", "loss_t"))
    assert scalars["loss_ot", 0] > 0


def _cli(module, cfg, tmp_path):
    path = tmp_path / f"{module}.json"
    path.write_text(json.dumps(cfg))
    proc = subprocess.run([sys.executable, "-m", f"clip_event_tpu_torch.{module}", "--cfg", str(path)],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def test_embed_cli_vit_b16(voa, tmp_path):
    out = tmp_path / "out"
    summary = _cli("embed", {"model": "ViT-B/16", "seed": 0, "output_dir": str(out),
                             "image_dir": [voa["image_dir"]], "texts": ["a protest", "a wedding"],
                             "batch_size": 4, "num_workers": 2}, tmp_path)
    assert summary["images"]["count"] == 4 and summary["texts"]["count"] == 2
    with open(out / "manifest.json") as fh:
        manifest = json.load(fh)
    for kind, n in (("images", 4), ("texts", 2)):
        feats = np.concatenate([np.load(out / s)["features"] for s in manifest[kind]["shards"]])
        assert feats.shape == (n, 512) and np.isfinite(feats).all()
        np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-4)


def test_eval_matching_cli_vit_l14(voa, tmp_path):
    metrics = _cli("eval_matching", {"model": "ViT-L/14", "seed": 0, "dataset": "voa",
                                     "image_caption_json": [voa["mapping_json"]],
                                     "image_dir": [voa["image_dir"]], "batch_size": 4}, tmp_path)
    assert metrics["num_pairs"] == 4
    assert 0.0 <= metrics["i2t_top1"] <= metrics["i2t_top5"] <= 1.0


@pytest.fixture(scope="module")
def fixtures_mod():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (tests/test_torch_card.py docstring)")
    spec = importlib.util.spec_from_file_location("eval_fixtures", os.path.join(HERE, "fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(4928, 512, 1536), (1, 588, 1024), (37, 3, 7)])
def test_quant_kernel_matches_plain(fixtures_mod, m, k, n, dtype, static):
    from clip_event_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), device="cuda", generator=gen).to(dtype)
    w = quant.quantize_weight(torch.randn((k, n), device="cuda", generator=gen),
                              x.float().abs().amax() if static else None)
    b = torch.randn((n,), device="cuda", generator=gen)
    launches = quant.quantized_matmul.launches
    y = quant.quantized_matmul(x, w.q, w.scale, b, w.act_scale)
    ref = quant.quantized_matmul_plain(x, w.q, w.scale, b, w.act_scale)
    torch.cuda.synchronize()
    assert quant.quantized_matmul.launches == launches + quant.LAUNCHES_PER_CALL
    assert y.dtype == dtype and y.shape == (m, n)
    rel = ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    assert rel <= (1e-6 if dtype == torch.float32 else 8e-3), rel
    xq, rs = quant.quantize_rows(x, w.act_scale)
    pxq, prs = quant.quantize_rows_plain(x, w.act_scale)
    assert torch.equal(xq[:, :k], pxq) and not xq[:, k:].any() and torch.equal(rs, prs)


def _rates_ok(metrics):
    for k, v in metrics.items():
        if isinstance(v, dict):
            _rates_ok(v)
        elif isinstance(v, float) and k not in ("mean_rank",):
            assert np.isfinite(v) and 0.0 <= v <= 1.0, (k, v)


def test_eval_m2e2_cli_vit_l14_int8_static(fixtures_mod, tmp_path):
    p = fixtures_mod.make_m2e2_fixture(str(tmp_path))
    with open(p["ontology_json"]) as fh:
        ontology = json.load(fh)
    roles = {"Attacker": "the person attacking", "Place": "where it happens"}
    ont = tmp_path / "ontology_roles.json"
    ont.write_text(json.dumps({t: {"template": v, "roles": roles} for t, v in ontology.items()}))
    metrics = _cli("eval_m2e2", {"model": "ViT-L/14", "seed": 0, "image_anno": p["anno_json"],
                                 "image_dir": p["image_dir"], "ie_ontology_json": str(ont),
                                 "ground_arguments": True, "quantize": "int8_static",
                                 "batch_size": 4}, tmp_path)
    assert metrics["num_images"] == 8 and metrics["argument_mentions_gold"] == 8
    _rates_ok(metrics)


@pytest.mark.parametrize("module", ["eval_vcr", "eval_visualcomet", "eval_retrieval"])
def test_eval_clis_vit_b32(fixtures_mod, tmp_path, module):
    root = str(tmp_path)
    if module == "eval_vcr":
        p = fixtures_mod.make_vcr_fixture(root)
        cfg, key, n = {"qa_jsonl": p["qa_jsonl"], "image_dir": p["image_dir"]}, "num_questions", 5
    elif module == "eval_visualcomet":
        p = fixtures_mod.make_visualcomet_fixture(root)
        cfg, key, n = {"anno_json": p["anno_json"], "image_dir": p["image_dir"], "field": "intent"}, "num_images", 5
    else:
        p = fixtures_mod.make_retrieval_fixture(root)
        cfg = {"dataset": "coco", "caption_file": p["coco_json"], "image_dir": p["coco_dir"],
               "quantize": "int8"}
        key, n = "num_images", 4
    metrics = _cli(module, {"model": "ViT-B/32", "seed": 0, "batch_size": 4, **cfg}, tmp_path)
    assert metrics[key] == n
    _rates_ok(metrics)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,w", [(64 * 77, 512), (1001, 640), (1, 1280), (37, 100)])
def test_layer_norm_kernels_match_plain(fixtures_mod, n, w, dtype):
    from clip_event_tpu_torch.ops import ln

    gen = torch.Generator(device="cuda").manual_seed(0)
    x, delta, dy, dxo = (torch.randn((n, w), device="cuda", generator=gen).to(dtype) for _ in range(4))
    gamma = 1.0 + 0.1 * torch.randn((w,), device="cuda", generator=gen)
    beta = 0.1 * torch.randn((w,), device="cuda", generator=gen)
    counts = (ln.fused_layer_norm.launches, ln.fused_add_layer_norm.launches, ln.fused_layer_norm_bwd.launches)
    y = ln.fused_layer_norm(x, gamma, beta)
    xs, y2 = ln.fused_add_layer_norm(x, delta, gamma, beta)
    got = ln.fused_layer_norm_bwd(xs, gamma, dy, dxo)
    torch.cuda.synchronize()
    assert (ln.fused_layer_norm.launches, ln.fused_add_layer_norm.launches,
            ln.fused_layer_norm_bwd.launches) == (counts[0] + 1, counts[1] + 1,
                                                  counts[2] + ln.BWD_LAUNCHES_PER_CALL)
    ref_x, ref_y2 = ln.add_layer_norm_plain(x, delta, gamma, beta)
    assert torch.equal(xs, ref_x)
    fwd_tol = 1e-6 if dtype == torch.float32 else 2e-2
    for a, b in ((y, ln.layer_norm_plain(x, gamma, beta)), (y2, ref_y2)):
        assert a.dtype == dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= fwd_tol * max(1.0, b.float().abs().max().item()), err
    bwd_tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, ln.layer_norm_bwd_plain(xs, gamma, dy, dxo)):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()
        assert rel <= bwd_tol, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,w,h,causal", [(64, 77, 512, 8, True), (16, 50, 768, 12, False),
                                            (2, 19, 60, 3, True)])
def test_megakernel_matches_plain(fixtures_mod, b, s, w, h, causal, dtype):
    from clip_event_tpu_torch.models.layers import causal_mask
    from clip_event_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((b, s, w), device="cuda", generator=gen).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn((w,), device="cuda", generator=gen)
    beta = 0.1 * torch.randn((w,), device="cuda", generator=gen)
    qkv_w = torch.randn((w, 3 * w), device="cuda", generator=gen) * w ** -0.5
    qkv_b = 0.1 * torch.randn((3 * w,), device="cuda", generator=gen)
    bias = causal_mask(s, device="cuda") if causal else None
    args = (x, gamma, beta, qkv_w, qkv_b, bias, h, (w // h) ** -0.5)
    launches = A.fused_ln_qkv_attention.launches
    out = A.fused_ln_qkv_attention(*args)
    ref = A.fused_ln_qkv_attention_plain(*args)
    torch.cuda.synchronize()
    assert A.fused_ln_qkv_attention.launches == launches + 1
    assert out.dtype == dtype and out.shape == (b, s, w) and not out.requires_grad
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err
    with pytest.raises(ValueError, match="megakernel takes"):
        A.fused_ln_qkv_attention(torch.zeros((1, 129, 64), device="cuda"), gamma[:64], beta[:64],
                                 qkv_w[:64, :192], qkv_b[:192], None, 1, 1.0)


def test_train_cli_vit_b32_with_ln_kernels(voa, tmp_path):
    from clip_event_tpu_torch.models import layers
    from clip_event_tpu_torch.ops import attention as A
    from clip_event_tpu_torch.ops import ln
    from clip_event_tpu_torch.train import main

    cfg = {
        "task": "card_ln", "model": "ViT-B/32", "seed": 0, "constrastive_loss": "ce",
        "posneg_descriptions_json": voa["descriptions_json"],
        "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]],
        "use_pallas_ln": True, "batch_size": 2, "max_epoch": 1, "lr": 1e-6, "optimizer": "adam",
        "compute_dtype": "bfloat16", "remat": True, "num_workers": 2,
        "ckpt_dir": str(tmp_path / "ckpt"), "tb_log_dir": str(tmp_path / "logs"),
    }
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    counters = (A.fused_attention_qkv, ln.fused_layer_norm, ln.fused_add_layer_norm, ln.fused_layer_norm_bwd)
    for fn in counters:
        fn.launches = 0
    main(["--cfg", str(path)])
    # 4 images at batch 2; 12 + 12 blocks, each forward twice under remat,
    # each block's two LayerNorm backwards of 2 launches
    steps, blocks = 2, 24
    assert [fn.launches for fn in counters] == [2 * blocks * steps, 2 * blocks * steps,
                                                2 * blocks * steps, 2 * 2 * blocks * steps]
    assert layers._resolve_ln() == "xla"
    scalars = _scalars(tmp_path / "logs" / "card_ln" / "tensorboard" / "scalars.jsonl")
    assert all(np.isfinite(scalars[tag, 0]) for tag in ("train_loss", "loss_i", "loss_t"))
