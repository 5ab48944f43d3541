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
  shapes, dynamic and static, fp32 and bf16; and at every dense-layer shape
  of the int8 paths (batch 64) and every edge shape of `chip_smoke.py`,
  the whole call and the GEMM alone (`quantized_gemm` on the row pass's
  output) equal to their plain versions bit for bit, with exact launch
  counts, the all-zero row yielding the bias;
- `.eval_m2e2` at ViT-L/14 in int8_static with argument grounding (K2 for
  the grid features, K5 in every dense layer), `.eval_vcr`,
  `.eval_visualcomet` and `.eval_retrieval` at ViT-B/32 (the last in
  int8): every metric finite and in [0, 1] where it is a rate;
- K4 (`ops.ln`: the fused LayerNorm forward, the add + LayerNorm forward
  and their shared backward) and K6 (`ops.attention.fused_ln_qkv_attention`)
  against their plain versions at a few shapes, fp32 and bf16 (K6 in its
  tensor-core variants at head_dim 64 and 32, S = 1 and 128, and in its
  simt variant at head_dim 20);
- K3 (`ops.ot.ipot_kernel`) against the plain solver in its warp variant
  (up to 32 entities and 32 objects) and its block variant, on both sides
  of that boundary, with a row without entities (its plan 0);
- `python -m clip_event_tpu_torch.train` at ViT-B/32 with
  `use_pallas_ln: true`: K4a, K4b and K4c launched in every residual block
  of every step, finite losses, and the LayerNorm choice put back;
- K2's tensor-core variant (bf16, head_dim 64) against both of its plain
  versions (fp32 inside; rounded where the kernel rounds) at ViT-L/14's
  vision shape and at a ragged causal shape, forward and backward, with
  the backward's launch count, equal bits through autograd's saved
  residuals and on a second run;
- K2's fp32 tensor-core variant ("tf32x3", split TF32) at the three vision
  path shapes (ViT-L/14, ViT-B/16 train and serving), forward and
  backward, within the fp32 gates of the plain versions, with the same
  launch counts and bit checks;
- K1's tensor-core variant the same way, at the ViT-B/32 text tower's shape
  (S = 77, causal) and vision shape (S = 50), and at a ragged one (S = 65,
  head_dim 32): one backward launch a call;
- K1's fp32 tensor-core variant ("tf32x3") at the ViT-B/32 text and vision
  shapes and at head_dim 128 (two backward launches a call), within the
  fp32 gates, with the launch counts and bit checks;
- `.eval_retrieval` at ViT-B/32 with `"use_pallas_attention": false`: no
  attention kernel launches, and the process-wide choice is put back."""

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
    A.fused_attention_qkv_headgrid_bwd.launches = 0
    main(["--cfg", str(path)])
    # 4 images at batch 2; each of the 24 vision blocks runs its forward
    # twice for the image and three times in each of the 2 crop chunks, and
    # its backward once for the image and once per chunk
    steps = 2
    assert A.fused_attention_qkv_headgrid.launches == 24 * (2 + 3 * 2) * steps
    assert A.fused_attention_qkv_headgrid_bwd.launches == A.HG_BWD_LAUNCHES_PER_CALL * 24 * (1 + 2) * steps
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


# K5 at the int8 paths' dense layers at batch 64, (M, K, N): per tower QKV,
# out, MLP fc and MLP proj over B·S tokens, the patch embeds, the final
# projections (chip_smoke.py's QUANT_SHAPES); then its edge shapes
K5_PATH_SHAPES = [
    (64 * S, k * W, n * W)
    for S, W in ((50, 768), (257, 1024), (77, 512), (77, 768))
    for k, n in ((1, 3), (1, 1), (1, 4), (4, 1))
] + [(64 * 49, 3072, 768), (64 * 256, 588, 1024), (64, 768, 512), (64, 512, 512), (64, 1024, 768),
     (64, 768, 768)]
K5_EDGE_SHAPES = [(1, 768, 2304), (1, 588, 1024), (37, 3, 7), (130, 100, 131), (129, 200, 257)]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,k,n", K5_PATH_SHAPES + K5_EDGE_SHAPES)
def test_quant_gemm_bit_exact(fixtures_mod, m, k, n, dtype, static):
    from clip_event_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((m, k), device="cuda", generator=gen).to(dtype)
    if m > 1:
        x[0] = 0.0
    x[-1, k // 2] = 1e3
    w = quant.quantize_weight(torch.randn((k, n), device="cuda", generator=gen),
                              0.9 * x.float().abs().amax() if static else None)
    assert quant.is_k_major(w.q)
    b = torch.randn((n,), device="cuda", generator=gen)
    counts = (quant.quantized_matmul.launches, quant.quantize_rows.launches, quant.quantized_gemm.launches)
    y = quant.quantized_matmul(x, w.q, w.scale, b, w.act_scale)
    xq, rs = quant.quantize_rows(x, w.act_scale)
    g = quant.quantized_gemm(xq, rs, w.q, w.scale, b, dtype)
    torch.cuda.synchronize()
    assert (quant.quantized_matmul.launches, quant.quantize_rows.launches, quant.quantized_gemm.launches) == (
        counts[0] + quant.LAUNCHES_PER_CALL, counts[1] + 1, counts[2] + 1)
    assert y.dtype == dtype and y.shape == (m, n) and g.dtype == dtype
    assert torch.equal(y, quant.quantized_matmul_plain(x, w.q, w.scale, b, w.act_scale))
    assert torch.equal(g, quant.quantized_gemm_plain(xq, rs, w.q, w.scale, b, dtype))
    assert torch.equal(g, y)
    if m > 1:
        assert torch.equal(y[0], b.to(dtype))
    # without a bias, too
    assert torch.equal(quant.quantized_gemm(xq, rs, w.q, w.scale, None, dtype),
                       quant.quantized_gemm_plain(xq, rs, w.q, w.scale, None, dtype))


def test_quant_refuses_row_major_weight(fixtures_mod):
    from clip_event_tpu_torch.ops import quant

    x = torch.randn((8, 64), device="cuda")
    w = quant.quantize_weight(torch.randn((64, 32), device="cuda"))
    with pytest.raises(ValueError, match="K-major"):
        quant.quantized_matmul(x, w.q.contiguous(), w.scale)
    xq, rs = quant.quantize_rows(x)
    with pytest.raises(ValueError, match="K-major"):
        quant.quantized_gemm(xq, rs, w.q.contiguous(), w.scale)


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
                                            (2, 19, 60, 3, True), (2, 1, 128, 2, False),
                                            (2, 128, 128, 2, True), (3, 40, 256, 8, False)])
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


@pytest.mark.parametrize("B,M,N,empty_row,variant", [
    (64, 16, 7, False, "warp"), (64, 16, 7, True, "warp"), (64, 32, 32, False, "warp"),
    (64, 33, 32, False, "block"), (64, 32, 33, False, "block"), (64, 33, 32, True, "block"),
    (4, 128, 128, False, "block"),
])
def test_ipot_kernel_variants_match_plain(fixtures_mod, B, M, N, empty_row, variant):
    """K3 against the plain solver on each side of the warp variant's
    boundary (M, N <= 32), with a row without entities."""
    from clip_event_tpu_torch.ops import ot

    assert ot.ipot_variant(M, N) == variant
    gen = torch.Generator(device="cuda").manual_seed(M * 1000 + N)
    x = torch.randn((B, M, 64), device="cuda", generator=gen)
    y = torch.randn((B, N, 64), device="cuda", generator=gen)
    x_n = torch.randint(1, M + 1, (B,), device="cuda", generator=gen)
    y_n = torch.randint(1, N + 1, (B,), device="cuda", generator=gen)
    if empty_row:
        x_n[0] = 0
    x_pad = torch.arange(M, device="cuda")[None] >= x_n[:, None]
    y_pad = torch.arange(N, device="cuda")[None] >= y_n[:, None]
    joint = x_pad[:, :, None] | y_pad[:, None, :]
    cost = ot.cost_matrix_cosine(x, y).masked_fill(joint, 0.0)
    x_len, y_len = x_n.float().clamp_min(1.0), y_n.float().clamp_min(1.0)
    launches = ot.ipot_kernel.launches
    plan = ot.ipot_kernel(cost, x_len, x_pad, y_len, y_pad)
    ref = ot.ipot(cost, x_len, x_pad, y_len, y_pad, joint, 0.5, 50, 1)
    torch.cuda.synchronize()
    assert ot.ipot_kernel.launches == launches + 1
    assert plan.shape == (B, N, M) and bool(torch.isfinite(plan).all())
    rel = ((plan - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-5, rel
    if empty_row:
        assert float(plan[0].abs().max()) == 0.0


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


@pytest.mark.parametrize("tag,B,S,W,H,causal", [
    ("l14_vision", 64, 257, 1024, 16, False), ("ragged_causal", 2, 200, 256, 4, True),
])
def test_k2_mma_variant_matches_both_plain_versions(fixtures_mod, tag, B, S, W, H, causal):
    from clip_event_tpu_torch.models.layers import causal_mask
    from clip_event_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, S, 3 * W), device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn((B, S, W), device="cuda", generator=gen).to(torch.bfloat16)
    bias = causal_mask(S, device="cuda") if causal else None
    scale = (W // H) ** -0.5
    assert A.headgrid_variant(qkv.dtype, W // H) == "mma"
    assert A.library_variant(A.HG_KERNEL, qkv.dtype, W // H) == "mma"
    assert A.library_variant(A.HG_BWD_KERNEL, torch.float32, W // H) == "tf32x3"

    A.fused_attention_qkv_headgrid.launches = A.fused_attention_qkv_headgrid_bwd.launches = 0
    leaf = qkv.detach().requires_grad_(True)
    out = A.fused_attention_qkv_headgrid(leaf, bias, H, scale)
    (grad,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv_headgrid.launches == 1
    assert A.fused_attention_qkv_headgrid_bwd.launches == A.HG_BWD_LAUNCHES_PER_CALL
    # called directly, the backward has no saved residuals: it runs the
    # forward kernel for them and gives the same bits, twice
    direct = A.fused_attention_qkv_headgrid_bwd(qkv, bias, do, H, scale)
    again = A.fused_attention_qkv_headgrid_bwd(qkv, bias, do, H, scale)
    assert A.fused_attention_qkv_headgrid.launches == 3
    assert torch.equal(direct, grad) and torch.equal(again, grad)

    for got, plain in (
        (out, lambda **kw: A.fused_attention_qkv_plain(qkv, bias, H, scale, **kw)),
        (grad, lambda **kw: A.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, **kw)),
    ):
        ref = plain().float()
        rounded = plain(mma_rounding=True).float()
        top = ref.abs().max().item()
        assert bool(torch.isfinite(got).all())
        assert (got.float() - ref).abs().max().item() <= 1e-2 * top
        # at worst one bf16 ulp of the largest result (up to 2^-7 of it),
        # and far less in the mean
        diff = (got.float() - rounded).abs()
        assert diff.max().item() <= 8e-3 * top
        assert diff.mean().item() <= 5e-4 * top


@pytest.mark.parametrize("tag,B,S,W,H", [
    ("l14_vision", 64, 257, 1024, 16), ("b16_train_vision", 96, 197, 768, 12),
    ("b16_serving_vision", 64, 197, 768, 12),
])
def test_k2_tf32x3_variant_matches_the_plain_versions(fixtures_mod, tag, B, S, W, H):
    from clip_event_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, S, 3 * W), device="cuda", generator=gen)
    do = torch.randn((B, S, W), device="cuda", generator=gen)
    scale = (W // H) ** -0.5
    assert A.headgrid_variant(qkv.dtype, W // H) == "tf32x3"
    assert A.library_variant(A.HG_KERNEL, qkv.dtype, W // H) == "tf32x3"
    assert A.library_variant(A.HG_BWD_KERNEL, qkv.dtype, W // H) == "tf32x3"

    A.fused_attention_qkv_headgrid.launches = A.fused_attention_qkv_headgrid_bwd.launches = 0
    leaf = qkv.detach().requires_grad_(True)
    out = A.fused_attention_qkv_headgrid(leaf, None, H, scale)
    (grad,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv_headgrid.launches == 1
    assert A.fused_attention_qkv_headgrid_bwd.launches == A.HG_BWD_LAUNCHES_PER_CALL
    # the saved out and lse give the bits of the direct call, which runs
    # the forward kernel first; no atomics: the same bits twice
    direct = A.fused_attention_qkv_headgrid_bwd(qkv, None, do, H, scale)
    again = A.fused_attention_qkv_headgrid_bwd(qkv, None, do, H, scale)
    assert A.fused_attention_qkv_headgrid.launches == 3
    assert torch.equal(direct, grad) and torch.equal(again, grad)

    # the fp32 gates (PERF.md §2) against the unsplit plain versions
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(grad).all())
    assert (out - A.fused_attention_qkv_plain(qkv, None, H, scale)).abs().max().item() <= 1e-5
    ref = A.fused_attention_qkv_bwd_plain(qkv, None, do, H, scale)
    assert ((grad - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("tag,B,S,W,H,causal", [
    ("train_text", 96, 77, 512, 8, True), ("train_vision", 64, 50, 768, 12, False),
    ("ragged_d32_causal", 3, 65, 256, 8, True),
])
def test_k1_mma_variant_matches_both_plain_versions(fixtures_mod, tag, B, S, W, H, causal):
    from clip_event_tpu_torch.models.layers import causal_mask
    from clip_event_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, S, 3 * W), device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn((B, S, W), device="cuda", generator=gen).to(torch.bfloat16)
    bias = causal_mask(S, device="cuda") if causal else None
    scale = (W // H) ** -0.5
    assert A.k1_variant(qkv.dtype, W // H) == "mma"
    assert A.library_variant(A.KERNEL, qkv.dtype, W // H) == "mma"
    assert A.library_variant(A.BWD_KERNEL, qkv.dtype, W // H) == "mma"
    assert A.library_variant(A.BWD_KERNEL, torch.float32, W // H) == "tf32x3"

    A.fused_attention_qkv.launches = A.fused_attention_qkv_bwd.launches = 0
    leaf = qkv.detach().requires_grad_(True)
    out = A.fused_attention_qkv(leaf, bias, H, scale)
    (grad,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    assert A.fused_attention_qkv.launches == 1
    assert A.fused_attention_qkv_bwd.launches == A.bwd_launches_per_call("mma", W // H) == 1
    # called directly, the backward has no saved residuals: it runs the
    # forward kernel for them and gives the same bits, twice
    direct = A.fused_attention_qkv_bwd(qkv, bias, do, H, scale)
    again = A.fused_attention_qkv_bwd(qkv, bias, do, H, scale)
    assert A.fused_attention_qkv.launches == 3
    assert torch.equal(direct, grad) and torch.equal(again, grad)

    for got, plain in (
        (out, lambda **kw: A.fused_attention_qkv_plain(qkv, bias, H, scale, **kw)),
        (grad, lambda **kw: A.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, **kw)),
    ):
        ref = plain().float()
        rounded = plain(mma_rounding=True).float()
        top = ref.abs().max().item()
        assert bool(torch.isfinite(got).all())
        assert (got.float() - ref).abs().max().item() <= 1e-2 * top
        diff = (got.float() - rounded).abs()
        assert diff.max().item() <= 8e-3 * top
        assert diff.mean().item() <= 5e-4 * top


@pytest.mark.parametrize("tag,B,S,W,H,causal", [
    ("train_text", 96, 77, 512, 8, True), ("train_vision", 64, 50, 768, 12, False),
    ("edge_d128_causal", 3, 77, 384, 3, True),
])
def test_k1_tf32x3_variant_matches_the_plain_versions(fixtures_mod, tag, B, S, W, H, causal):
    from clip_event_tpu_torch.models.layers import causal_mask
    from clip_event_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, S, 3 * W), device="cuda", generator=gen)
    do = torch.randn((B, S, W), device="cuda", generator=gen)
    bias = causal_mask(S, device="cuda") if causal else None
    scale = (W // H) ** -0.5
    assert A.k1_variant(qkv.dtype, W // H) == "tf32x3"
    assert A.library_variant(A.KERNEL, qkv.dtype, W // H) == "tf32x3"
    assert A.library_variant(A.BWD_KERNEL, qkv.dtype, W // H) == "tf32x3"

    A.fused_attention_qkv.launches = A.fused_attention_qkv_bwd.launches = 0
    leaf = qkv.detach().requires_grad_(True)
    out = A.fused_attention_qkv(leaf, bias, H, scale)
    (grad,) = torch.autograd.grad(out, leaf, do)
    torch.cuda.synchronize()
    per_call = A.bwd_launches_per_call("tf32x3", W // H)
    assert A.fused_attention_qkv.launches == 1
    assert A.fused_attention_qkv_bwd.launches == per_call == (1 if W // H <= 64 else 2)
    # the saved out and lse give the bits of the direct call, which runs
    # the forward kernel first; no atomics: the same bits twice
    direct = A.fused_attention_qkv_bwd(qkv, bias, do, H, scale)
    again = A.fused_attention_qkv_bwd(qkv, bias, do, H, scale)
    assert A.fused_attention_qkv.launches == 3
    assert A.fused_attention_qkv_bwd.launches == 3 * per_call
    assert torch.equal(direct, grad) and torch.equal(again, grad)

    # the fp32 gates (PERF.md §2) against the unsplit plain versions
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(grad).all())
    assert (out - A.fused_attention_qkv_plain(qkv, bias, H, scale)).abs().max().item() <= 1e-5
    ref = A.fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale)
    assert ((grad - ref).abs().max() / ref.abs().max()).item() <= 1e-5


def test_eval_cli_with_plain_attention_launches_no_attention_kernel(fixtures_mod, tmp_path, monkeypatch, capsys):
    from clip_event_tpu_torch import eval_retrieval
    from clip_event_tpu_torch.evals.cli import run
    from clip_event_tpu_torch.models import layers
    from clip_event_tpu_torch.ops import attention as A

    p = fixtures_mod.make_retrieval_fixture(str(tmp_path))
    metrics = {}
    for key, setting in (("plain", False), ("kernel", True)):
        cfg = {"model": "ViT-B/32", "seed": 0, "dataset": "coco", "caption_file": p["coco_json"],
               "image_dir": p["coco_dir"], "batch_size": 4, "use_pallas_attention": setting}
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps(cfg))
        monkeypatch.setattr(sys, "argv", ["eval_retrieval", "--cfg", str(path)])
        A.fused_attention_qkv.launches = A.fused_attention_qkv_headgrid.launches = 0
        run("retrieval", eval_retrieval.evaluate)
        metrics[key] = json.loads(capsys.readouterr().out)
        launched = A.fused_attention_qkv.launches + A.fused_attention_qkv_headgrid.launches
        assert (launched == 0) == (not setting)
        assert layers._resolve_attention() == "kernel"
    assert metrics["plain"]["num_images"] == metrics["kernel"]["num_images"] == 4
