#!/usr/bin/env python3
"""Drive the PyTorch port's serving and fine-tuning paths once on one
NVIDIA GPU: ViT-B/32 zero-shot serving and contrastive fine-tuning, ViT-L/14
serving and fine-tuning (and one ViT-B/16 step), and the OT graph-alignment
fine-tuning of `configs/finetune_ot.json` at ViT-B/32.

    python3 chip_smoke.py

Phases, each printing JSON lines:

  1. device   the card's name; needs `torch.cuda.is_available()`
  2. build    compiles every kernel source in `clip_event_tpu_torch/csrc/`,
              one nvcc each, all started together
  3. kernels  each kernel against its plain PyTorch version at the shapes
              the paths give it and at edge shapes, fp32 and bf16, and its
              time beside the plain version's, one PyTorch library call's and
              the bound the card's peak rates give. The attention forwards
              (K1-fwd, K2-fwd) are held at max abs error 1e-5 (fp32) / 2e-2
              (bf16); the backwards (K1-bwd, K2-bwd) at max|kernel − plain| /
              max|plain| ≤ 1e-5 (fp32) / 1e-2 (bf16); the IPOT solver (K3)
              at max|kernel − plain| / max|plain| ≤ 1e-5 (fp32)
  4. serving  full-width ViT-B/32 from seed 0 (12 + 12 layers): embed_stream
              over 256 images and 256 token rows into shards and a manifest,
              in fp32 and in bf16, then evaluate_matching; the launch counts
              of that run, checks of the features against a plain-attention
              run of the same model, and images/s and texts/s at batch 64
  5. train    full-width ViT-B/32 from seed 0 through the train loop
              (`clip_event_tpu_torch.train.train`: loader → prefetch → step →
              metrics) on the bench workload: 384 uint8 images × 3
              descriptions (1 positive, 2 hard negatives) of 77 tokens, bf16,
              full remat, Adam at lr 1e-6; the launch counts of that run,
              contrastive pairs/s, step ms and peak memory; a kernel step
              against a plain-attention step from one state and batch (bf16
              at B=384 and fp32 at B=64); a profile of one step
  6. serving_l14  full-width ViT-L/14 from seed 0 (24 + 12 layers; vision
              S=257 through K2, text through K1): embed_stream over 128
              images and 128 token rows at batch 64, fp32 and bf16; launch
              counts, features against a plain-attention run, images/s and
              texts/s
  7. train_l14  7 full-width ViT-L/14 steps through the train loop at the
              bench's L/14 workload (64 uint8 images × 3 descriptions, bf16,
              full remat, Adam at lr 1e-6): exact K1/K2 launch counts, losses
              near chance, moved params, pairs/s, step ms, peak memory and a
              bf16 kernel-vs-plain step; then one ViT-B/16 kernel-path step
              at its bench batch (96)
  8. train_ot  7 steps of finetune_ot.json's settings at ViT-B/32 full width
              through the train loop (64 images × 3 descriptions, 8 float32
              object crops at 224² and 16 entity rows of 77 tokens per image,
              ragged, alignment_chunks 4, use_pallas_ot true, bf16, remat,
              Adam at lr 1e-6): loss_ot finite and > 0 every step, K3 once a
              step, the K1 counts of the nested chunk- and block-level
              checkpoints, pairs/s, step ms, peak memory, a profile of one
              step, and kernel-vs-plain steps (plain attention and plain
              IPOT; bf16 at B=64 and fp32 at B=16)
  9. serving_int8  ViT-L/14, then ViT-B/32, from seed 0 through
              `evals.cli.load_model_from_cfg` in three modes: "int8",
              "int8_static" (synthetic calibration, 2 batches) and
              "int8_static" with quantize_towers ["visual"]; each embeds 128
              images and 128 token rows at batch 64 in fp32 through
              embed_stream (the visual-only mode also in bf16): exact K5
              launch counts (98 dense layers per L/14 image batch, 49 per
              text batch, 50 and 49 at B/32; none in a float tower), images/s
              and texts/s beside the float phases', weight bytes on the card,
              the int8 kernel path against plain K5 under the same attention
              kernels at fp32 max abs error 1e-4, and against the int8 plain
              path (plain attention, plain K5) at 1e-4 where the attention
              kernel is K1, min cosine 0.999 where it is K2 (its ~1e-6 flips
              dynamic int8 roundings), and the cosine of int8 against float
              features (gated at >= 0.99 at ViT-B/32)
 10. evals    the M2E2, VCR, VisualCOMET and retrieval CLIs through
              `evals.cli.run` on synthetic annotation files (tests/fixtures.py):
              VCR, VisualCOMET and retrieval at ViT-B/32 fp32, M2E2 at
              ViT-L/14 with argument grounding in int8_static (grid features
              through K2, every dense layer through K5); metrics finite and
              in [0, 1], the expected keys, exact launch counts

K5, the int8 GEMM, is held in phase 3 against its plain version at the
paths' shapes (batch 64) and at edge shapes (M = 1, K = 588, K = 3, odd N,
an all-zero row, a row with one large value), dynamic and static, fp32
and bf16: max|kernel − plain| / max|plain| ≤ 1e-6 (fp32) / 8e-3 (bf16),
and the int8 payload and row scales of its first launch exactly equal.

then the `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi prints them, and a last line `{"ok": true, "device": {...}}`.
Any failed check raises, so the script exits non-zero. With no card it
exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from clip_event_tpu_torch.config import validate_config
from clip_event_tpu_torch.data.common import ExampleDataset
from clip_event_tpu_torch.data.labels import build_label_layout
from clip_event_tpu_torch.embed import embed_stream
from clip_event_tpu_torch.engine.optim import build_optimizer, build_schedule, tree_leaves
from clip_event_tpu_torch.engine.train_step import create_train_state, loss_fn, make_train_step
from clip_event_tpu_torch.evals.cli import load_model_from_cfg
from clip_event_tpu_torch.evals.common import Encoders
from clip_event_tpu_torch.evals.matching import evaluate_matching, matching_metrics
from clip_event_tpu_torch.models.clip import (
    VIT_B16,
    VIT_B32,
    VIT_L14,
    encode_image,
    encode_text,
    init_params,
    l2_normalize,
)
from clip_event_tpu_torch.models.layers import causal_mask
from clip_event_tpu_torch.ops import _build
from clip_event_tpu_torch.ops import ot
from clip_event_tpu_torch.ops import quant
from clip_event_tpu_torch.ops.attention import (
    BWD_KERNEL,
    BWD_LAUNCHES_PER_CALL,
    HG_BWD_KERNEL,
    HG_KERNEL,
    KERNEL,
    MAX_SEQ,
    fused_attention_qkv,
    fused_attention_qkv_bwd,
    fused_attention_qkv_bwd_plain,
    fused_attention_qkv_headgrid,
    fused_attention_qkv_headgrid_bwd,
    fused_attention_qkv_plain,
)
from clip_event_tpu_torch.train import train

REPO = os.path.dirname(os.path.abspath(__file__))
# the card's published peaks (H100 SXM data sheet, dense): memory, fp32 on
# the CUDA cores, bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_INT8_OPS = 1979e12
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # forward: max abs error
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # backward: error relative to max|plain|
OT_TOL = {"float32": 1e-5}  # IPOT plan: error relative to max|plain|
# K5: error relative to max|plain|; fp32 is exact by design, bf16 two ulps
QUANT_TOL = {"float32": 1e-6, "bfloat16": 8e-3}

SERVING_SHAPES = [  # (tag, B, S, W, H, causal)
    ("text", 64, 77, 512, 8, True),
    ("vision", 64, 50, 768, 12, False),
]
# the train step's calls at B=384 images × 3 descriptions
TRAIN_SHAPES = [
    ("train_text", 1152, 77, 512, 8, True),
    ("train_vision", 384, 50, 768, 12, False),
]
# K1 on this slice's paths: the ViT-L/14 text tower (768 wide, 12 heads) at
# the L/14 train batch (64 × 3 descriptions), and the finetune_ot chunks of
# the crop (64 × 8 / 4) and entity (64 × 16 / 4) encodes
NEW_K1_SHAPES = [
    ("l14_train_text", 192, 77, 768, 12, True),
    ("ot_crop_chunk", 128, 50, 768, 12, False),
    ("ot_entity_chunk", 256, 77, 512, 8, True),
]
EDGE_SHAPES = [
    ("edge_causal", 3, 13, 128, 2, True),
    ("edge_nobias", 3, 13, 128, 2, False),
    ("edge_s128_d128", 2, 128, 256, 2, True),
    ("edge_b1_s1", 1, 1, 64, 1, False),
]
# K2: the vision towers of ViT-L/14 (train and serving batch 64) and
# ViT-B/16 (train batch 96, serving batch 64), and edge shapes: S=129 (the
# first S K1 refuses), S=1, S=200 (not a multiple of the 64-row tile),
# head_dim 32 and 128, S=512
HG_SHAPES = [
    ("l14_vision", 64, 257, 1024, 16, False),
    ("b16_train_vision", 96, 197, 768, 12, False),
    ("b16_serving_vision", 64, 197, 768, 12, False),
]
HG_EDGE_SHAPES = [
    ("hg_edge_s129_causal", 3, 129, 128, 2, True),
    ("hg_edge_s1", 2, 1, 128, 2, False),
    ("hg_edge_s200_causal", 2, 200, 256, 4, True),
    ("hg_edge_s200", 2, 200, 256, 4, False),
    ("hg_edge_d32_causal", 2, 150, 256, 8, True),
    ("hg_edge_d128", 2, 257, 256, 2, False),
    ("hg_edge_s512_causal", 2, 512, 256, 4, True),
]
# K3: (tag, B, M entities, N objects, k, empty_row): finetune_ot's shape
# (16 entities, 8 object slots minus the whole image) with ragged counts,
# k = 2, one row without entities, and larger graphs up to the kernel's cap
OT_SHAPES = [
    ("ot_finetune", 64, 16, 7, 1, False),
    ("ot_finetune_k2", 64, 16, 7, 2, False),
    ("ot_empty_row", 64, 16, 7, 1, True),
    ("ot_256x16x10", 256, 16, 10, 1, False),
    ("ot_256x32x32", 256, 32, 32, 1, False),
    ("ot_256x128x128", 256, 128, 128, 1, False),
]
# K5: the dense layers of the int8 paths at batch 64, (tag, M, K, N): per
# tower the QKV, out, MLP fc and MLP proj projections over B·S tokens; the
# patch embeds over B·grid² patches (L/14's K = 588 = 14·14·3); the final
# projections over B rows
QUANT_SHAPES = [
    (f"{tower}_{name}", 64 * S, k * W, n * W)
    for tower, S, W in (("b32_vision", 50, 768), ("l14_vision", 257, 1024),
                        ("b32_text", 77, 512), ("l14_text", 77, 768))
    for name, k, n in (("qkv", 1, 3), ("out", 1, 1), ("fc", 1, 4), ("mlp_proj", 4, 1))
] + [
    ("b32_patch_embed", 64 * 49, 3072, 768), ("l14_patch_embed", 64 * 256, 588, 1024),
    ("b32_vision_proj", 64, 768, 512), ("b32_text_proj", 64, 512, 512),
    ("l14_vision_proj", 64, 1024, 768), ("l14_text_proj", 64, 768, 768),
]
# edge shapes, each with an all-zero first row and one large value in its
# last row: M = 1, M = 1 with K = 588, K = 3 with odd N, odd N, ragged M/K/N
QUANT_EDGE_SHAPES = [
    ("q_edge_m1", 1, 768, 2304), ("q_edge_m1_k588", 1, 588, 1024), ("q_edge_k3", 37, 3, 7),
    ("q_edge_n_odd", 130, 100, 131), ("q_edge_ragged", 129, 200, 257),
]
N_ITEMS = 256  # images and token rows served at ViT-B/32
BATCH = 64
SOT, EOT = 49406, 49407
# device kernels by family, for the profile's breakdown (first match wins)
KERNEL_FAMILIES = (
    ("attention (hand-written)", ("attention_fwd_kernel", "attention_bwd_", "attention_hg_")),
    ("ipot (hand-written)", ("ipot_kernel",)),
    ("int8 gemm (hand-written)", ("int8_gemm_kernel", "quant_rows_kernel")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("softmax / loss", ("softmax",)),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel", "Reduce", "norm_kernel")),
    ("elementwise", ("elementwise_kernel",)),
    ("copy / cast", ("copy", "cat", "index")),
)
TRAIN_BATCH, NUM_POS, NUM_NEG = 384, 1, 2
FP32_CHECK_BATCH = 64  # the fp32 kernel-vs-plain step
# kernel step vs plain-attention step: bf16 loss (abs) and grad_norm (rel);
# fp32 loss (abs) and each gradient tensor (rel. to its max). Both sides keep
# an fp32 softmax; measured 0 and ~2e-6 on the H100, so 10x that margin
BF16_STEP_TOL = 1e-3
FP32_STEP_TOL = 2e-5
WARMUP_STEPS, TIMED_STEPS = 2, 5
# ViT-L/14 (bench.py's L/14 workload) and ViT-B/16 (its bench batch)
L14_BATCH, B16_BATCH = 64, 96
L14_SERVING_ITEMS = 128
# finetune_ot.json: batch 64, 8 object slots (the whole image at slot 0),
# 16 entity and 8 event rows per image, alignment_chunks 4
OT_BATCH, OT_OBJECTS, OT_ENTITIES, OT_EVENTS, OT_CHUNKS = 64, 8, 16, 8, 4
OT_FP32_CHECK_BATCH = 16
# every kernel's launch counter, by the kernel's source name
COUNTERS = {
    KERNEL: fused_attention_qkv, BWD_KERNEL: fused_attention_qkv_bwd,
    HG_KERNEL: fused_attention_qkv_headgrid, HG_BWD_KERNEL: fused_attention_qkv_headgrid_bwd,
    ot.KERNEL: ot.ipot_kernel, quant.KERNEL: quant.quantized_matmul,
}


def reset_launches() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of fn() in ms, by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(B, S, W, H, causal, dtype_name):
    """Least time for one attention forward: qkv read once, the bias read
    once, the output written once, over the memory rate; 4·B·H·S²·D flops
    (q·kᵀ and p·v) over the peak rate for the input type. The larger wins."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = B * S * 3 * W * elt + B * S * W * elt + (S * S * 4 if causal else 0)
    flops = 4 * B * H * S * S * (W // H)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound_ms(B, S, W, H, causal, dtype_name):
    """Least time for one attention backward: qkv (3W) and do (W) read once
    and dqkv (3W) written once per token, the bias read once, over the
    memory rate; 10·B·H·S²·D flops (recompute q·kᵀ, dv, dp, dq, dk) over
    the peak rate for the input type. The larger wins."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = B * S * 7 * W * elt + (S * S * 4 if causal else 0)
    flops = 10 * B * H * S * S * (W // H)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _split(qkv, H):
    B, S, W3 = qkv.shape
    return qkv.view(B, S, 3, H, W3 // 3 // H).permute(2, 0, 3, 1, 4).unbind(0)


def library_fwd(qkv, bias, H, scale):
    """One PyTorch call for the same function, after a split (yardstick only)."""
    B, S, W3 = qkv.shape
    q, k, v = _split(qkv, H)
    mask = None if bias is None else bias.to(qkv.dtype)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    return out.transpose(1, 2).reshape(B, S, W3 // 3)


def check_attention(rows, errs, names, fns, gen, tag, B, S, W, H, causal, dtype, timed):
    """One attention kernel pair (forward, backward) against its plain
    versions at one shape and dtype; times, bound and library time when
    `timed`. Rows and the worst errors go under the kernels' names."""
    fwd_name, bwd_name = names
    fwd, bwd = fns
    name = str(dtype).split(".")[-1]
    qkv = torch.randn((B, S, 3 * W), device="cuda", generator=gen).to(dtype)
    do = torch.randn((B, S, W), device="cuda", generator=gen).to(dtype)
    bias = causal_mask(S, device="cuda") if causal else None
    scale = (W // H) ** -0.5
    iters = 20 if B > 64 or S > 128 else 50
    shape = {"shape": tag, "B": B, "S": S, "W": W, "H": H, "causal": causal, "dtype": name}

    out = fwd(qkv, bias, H, scale)
    ref = fused_attention_qkv_plain(qkv, bias, H, scale)
    torch.cuda.synchronize()
    check(out.dtype == dtype and out.shape == (B, S, W), f"{fwd_name} {tag} {name} shape/dtype")
    check(bool(torch.isfinite(out).all()), f"{fwd_name} {tag} {name} output finite")
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= TOL[name], f"{fwd_name} {tag} {name}: max abs err {err} > {TOL[name]}")
    errs[fwd_name][name] = max(errs[fwd_name].get(name, 0.0), err)
    row = {**shape, "max_abs_err": err, "tol": TOL[name]}
    if timed:
        row["ms"] = cuda_ms(lambda: fwd(qkv, bias, H, scale), iters)
        row["plain_ms"] = cuda_ms(lambda: fused_attention_qkv_plain(qkv, bias, H, scale), iters)
        lib = library_fwd(qkv, bias, H, scale)
        check((lib.float() - ref.float()).abs().max().item() <= 10 * TOL[name],
              f"{fwd_name} {tag} {name}: library yardstick disagrees")
        row["library_ms"] = cuda_ms(lambda: library_fwd(qkv, bias, H, scale), iters)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(B, S, W, H, causal, name)
    rows[fwd_name].append(row)
    emit({"phase": "kernel_check", "kernel": fwd_name, **row})

    dq = bwd(qkv, bias, do, H, scale)
    ref = fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale)
    torch.cuda.synchronize()
    check(dq.dtype == dtype and dq.shape == qkv.shape, f"{bwd_name} {tag} {name} shape/dtype")
    check(bool(torch.isfinite(dq).all()), f"{bwd_name} {tag} {name} output finite")
    err = (dq.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    check(rel <= BWD_TOL[name], f"{bwd_name} {tag} {name}: rel err {rel} > {BWD_TOL[name]}")
    errs[bwd_name][name] = max(errs[bwd_name].get(name, 0.0), err)
    row = {**shape, "max_abs_err": err, "max_rel_err": rel, "tol_rel": BWD_TOL[name]}
    if timed:
        row["ms"] = cuda_ms(lambda: bwd(qkv, bias, do, H, scale), iters)
        row["plain_ms"] = cuda_ms(lambda: fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale), iters)
        # the library yardstick: SDPA's backward alone, on a graph built
        # once (view-split of a leaf qkv, retained)
        leaf = qkv.detach().requires_grad_(True)
        lib_out = library_fwd(leaf, bias, H, scale)
        (lib,) = torch.autograd.grad(lib_out, leaf, do, retain_graph=True)
        lib_rel = (lib.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        check(lib_rel <= 5 * BWD_TOL[name], f"{bwd_name} {tag} {name}: library yardstick disagrees")
        row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(lib_out, leaf, do, retain_graph=True),
                                    iters)
        del lib_out, leaf
        row["bound_ms"], row["bound_by"] = attention_bwd_bound_ms(B, S, W, H, causal, name)
    rows[bwd_name].append(row)
    emit({"phase": "kernel_check", "kernel": bwd_name, **row})


def ot_inputs(gen, B, M, N, empty_row):
    """An IPOT input as `optimal_transport_dist` builds it in safe mode:
    the masked cosine cost of random embeddings, ragged node counts (row 0
    without entities when `empty_row`), lengths clamped to >= 1."""
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
    return cost, x_n.float().clamp_min(1.0), x_pad, y_n.float().clamp_min(1.0), y_pad, joint


def ipot_bound_ms(B, M, N, iterations, k):
    """Least time for one IPOT solve: the cost, the pad masks and lengths
    read once and the plan written once, over the memory rate; per item
    M·N exponentials and divisions for A, then per iteration M·N for
    Q = A∘T, k × 4·M·N for the two matvecs and 2·M·N for T, over the fp32
    peak. The larger wins."""
    nbytes = 4 * (2 * B * M * N + B * (M + N) + 2 * B)
    flops = B * (2 * M * N + iterations * (3 * M * N + k * 4 * M * N))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_ipot(rows, errs, gen, tag, B, M, N, k, empty_row):
    cost, x_len, x_pad, y_len, y_pad, joint = ot_inputs(gen, B, M, N, empty_row)
    plan = ot.ipot_kernel(cost, x_len, x_pad, y_len, y_pad, k=k)
    ref = ot.ipot(cost, x_len, x_pad, y_len, y_pad, joint, 0.5, 50, k)
    torch.cuda.synchronize()
    check(plan.shape == (B, N, M) and plan.dtype == torch.float32, f"ipot {tag} shape/dtype")
    check(bool(torch.isfinite(plan).all()), f"ipot {tag} plan finite")
    err = (plan - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    check(rel <= OT_TOL["float32"], f"ipot {tag}: rel err {rel} > {OT_TOL['float32']}")
    if empty_row:
        check(float(plan[0].abs().max()) == 0.0, f"ipot {tag}: the empty row's plan is 0")
    errs[ot.KERNEL]["float32"] = max(errs[ot.KERNEL].get("float32", 0.0), err)
    row = {"shape": tag, "B": B, "M": M, "N": N, "k": k, "iterations": 50, "empty_row": empty_row,
           "dtype": "float32", "max_abs_err": err, "max_rel_err": rel, "tol_rel": OT_TOL["float32"]}
    row["ms"] = cuda_ms(lambda: ot.ipot_kernel(cost, x_len, x_pad, y_len, y_pad, k=k), 50)
    row["plain_ms"] = cuda_ms(lambda: ot.ipot(cost, x_len, x_pad, y_len, y_pad, joint, 0.5, 50, k),
                              5, warmup=2)
    row["library_ms"] = None  # no one PyTorch call solves IPOT
    row["bound_ms"], row["bound_by"] = ipot_bound_ms(B, M, N, 50, k)
    rows[ot.KERNEL].append(row)
    emit({"phase": "kernel_check", "kernel": ot.KERNEL, **row})


def quant_bound_ms(M, K, N, dtype_name, static):
    """Least time for one K5 call: x read once, q read once, the output
    written once, the column scales and bias (and the static scale) read
    once, over the memory rate; 2·M·N·K int8 operations over the int8 peak.
    The larger wins."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = M * K * elt + K * N + M * N * elt + 2 * N * 4 + (4 if static else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * M * N * K / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_quant(rows, errs, gen, tag, M, K, N, dtype, static, timed, edge):
    """K5 against its plain version at one shape, dtype and mode: the output
    (QUANT_TOL, relative to max|plain|), and the row pass's int8 payload and
    row scales exactly. Times, the bound and two yardsticks when `timed`:
    torch._int_mm on the pre-quantised operands (the GEMM alone, where its
    shape rules allow: M > 16, K and N multiples of 8) and the bf16
    torch.matmul of the same shape (the float path int8 is meant to beat)."""
    name = str(dtype).split(".")[-1]
    x = torch.randn((M, K), device="cuda", generator=gen).to(dtype)
    if edge:
        if M > 1:
            x[0] = 0.0
        x[-1, K // 2] = 1e3
    w32 = torch.randn((K, N), device="cuda", generator=gen)
    # a static scale clips the largest activations, as one calibrated on
    # other batches may
    w = quant.quantize_weight(w32, 0.9 * x.float().abs().max() if static else None)
    bias = torch.randn((N,), device="cuda", generator=gen)
    args = (x, w.q, w.scale, bias, w.act_scale)
    y = quant.quantized_matmul(*args)
    ref = quant.quantized_matmul_plain(*args)
    xq, rs = quant.quantize_rows(x, w.act_scale)
    pxq, prs = quant.quantize_rows_plain(x, w.act_scale)
    torch.cuda.synchronize()
    mode = "static" if static else "dynamic"
    what = f"{quant.KERNEL} {tag} {name} {mode}"
    check(y.dtype == dtype and y.shape == (M, N), f"{what} shape/dtype")
    check(bool(torch.isfinite(y).all()), f"{what} output finite")
    check(torch.equal(xq[:, :K], pxq) and not bool(xq[:, K:].any()), f"{what}: int8 payload differs")
    check(torch.equal(rs, prs), f"{what}: row scales differ")
    err = (y.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    check(rel <= QUANT_TOL[name], f"{what}: rel err {rel} > {QUANT_TOL[name]}")
    if edge and M > 1:
        check(torch.equal(y[0], bias.to(dtype)), f"{what}: the all-zero row yields the bias")
    errs[quant.KERNEL][name] = max(errs[quant.KERNEL].get(name, 0.0), err)
    row = {"shape": tag, "M": M, "K": K, "N": N, "dtype": name, "mode": mode, "max_abs_err": err,
           "max_rel_err": rel, "tol_rel": QUANT_TOL[name]}
    if timed:
        iters = 10 if M * N * K > 1e10 else 30
        row["ms"] = cuda_ms(lambda: quant.quantized_matmul(*args), iters)
        row["plain_ms"] = cuda_ms(lambda: quant.quantized_matmul_plain(*args), 5, warmup=1)
        row["bound_ms"], row["bound_by"] = quant_bound_ms(M, K, N, name, static)
        row["library_ms"] = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            a = xq[:, :K].contiguous()
            lib = torch._int_mm(a, w.q)
            check(torch.equal(lib.double(), torch.matmul(a.double(), w.q.double())),
                  f"{what}: the _int_mm yardstick disagrees")
            row["library_ms"] = cuda_ms(lambda: torch._int_mm(a, w.q), iters)
        row["library"] = "torch._int_mm on the pre-quantised operands (the GEMM alone)"
        xb, wb = x.to(torch.bfloat16), w32.to(torch.bfloat16)
        row["bf16_matmul_ms"] = cuda_ms(lambda: torch.matmul(xb, wb), iters)
    rows[quant.KERNEL].append(row)
    emit({"phase": "kernel_check", "kernel": quant.KERNEL, **row})


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: [] for name in COUNTERS}
    errs = {name: {} for name in COUNTERS}
    k1 = ((KERNEL, BWD_KERNEL), (fused_attention_qkv, fused_attention_qkv_bwd))
    k2 = ((HG_KERNEL, HG_BWD_KERNEL), (fused_attention_qkv_headgrid, fused_attention_qkv_headgrid_bwd))
    timed = {"text", "vision", "train_text", "train_vision"} | {t[0] for t in NEW_K1_SHAPES + HG_SHAPES}
    for kernels, shapes in ((k1, SERVING_SHAPES + TRAIN_SHAPES + NEW_K1_SHAPES + EDGE_SHAPES),
                            (k2, HG_SHAPES + HG_EDGE_SHAPES)):
        for tag, B, S, W, H, causal in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                check_attention(rows, errs, *kernels, gen, tag, B, S, W, H, causal, dtype, tag in timed)
    for shape in OT_SHAPES:
        check_ipot(rows, errs, gen, *shape)
    for shapes, edge in ((QUANT_SHAPES, False), (QUANT_EDGE_SHAPES, True)):
        for tag, M, K, N in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                for static in (False, True):
                    check_quant(rows, errs, gen, tag, M, K, N, dtype, static, not edge, edge)
    torch.cuda.synchronize()
    return rows, errs


class _Arrays(ExampleDataset):
    """In-memory dataset over equal-length numpy arrays (one example per row)."""

    def __init__(self, **fields):
        self.fields = fields
        self.n = len(next(iter(fields.values())))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.fields.items()}, {"id": f"{i:05d}"}


def _read_shards(out_dir, entry):
    ids, feats = [], []
    for shard in entry["shards"]:
        with np.load(os.path.join(out_dir, shard)) as z:
            ids += [str(i) for i in z["ids"]]
            feats.append(z["features"])
    return ids, np.concatenate(feats)


def vision_kernels(mcfg):
    """The attention kernels of the vision tower: K2 when its sequence
    (grid² + CLS) is longer than K1's MAX_SEQ, else K1."""
    if mcfg.grid_size ** 2 + 1 > MAX_SEQ:
        return HG_KERNEL, HG_BWD_KERNEL
    return KERNEL, BWD_KERNEL


def serving_launches(mcfg, image_batches, text_batches):
    """Launches per kernel for encoding that many image and text batches:
    one forward per block of each tower per batch."""
    out = dict.fromkeys(COUNTERS, 0)
    out[vision_kernels(mcfg)[0]] += mcfg.vision_layers * image_batches
    out[KERNEL] += mcfg.transformer_layers * text_batches
    return out


def serving_inputs(mcfg, n_items):
    """uint8 images and token rows (SOT, random ids, EOT at a random width)
    from seed 0."""
    rng = np.random.default_rng(0)
    res = mcfg.image_resolution
    images = rng.integers(0, 256, size=(n_items, res, res, 3), dtype=np.uint8)
    tokens = np.zeros((n_items, mcfg.context_length), np.int32)
    for i, n in enumerate(rng.integers(3, mcfg.context_length - 1, n_items)):
        tokens[i, 0] = SOT
        tokens[i, 1:n] = rng.integers(1, SOT, n - 1)
        tokens[i, n] = EOT
    return images, tokens


def check_shards(out_dir, manifest, n_items, dim, norm_tol, tag):
    """The shards and manifest of an embed_stream run: the manifest round
    trip, ids in order, [n_items, dim], finite, rows of unit norm within
    `norm_tol`. Returns the features and the worst norm error by kind."""
    with open(os.path.join(out_dir, "manifest.json")) as fh:
        check(json.load(fh) == manifest, f"{tag} manifest round trip")
    feats_by, norm_errs = {}, {}
    for kind in ("images", "texts"):
        ids, feats = _read_shards(out_dir, manifest[kind])
        check(ids == [f"{i:05d}" for i in range(n_items)], f"{tag} {kind} ids in order")
        check(feats.shape == (n_items, dim), f"{tag} {kind} shape {feats.shape}")
        check(bool(np.isfinite(feats).all()), f"{tag} {kind} finite")
        norm_errs[kind] = float(np.abs(np.linalg.norm(feats, axis=1) - 1.0).max())
        check(norm_errs[kind] <= norm_tol, f"{tag} {kind} unit norm ({norm_errs[kind]})")
        feats_by[kind] = feats
    return feats_by, norm_errs


def phase_serving(out_root, model="ViT-B/32", n_items=N_ITEMS, matching=True, tag="serving"):
    """Serve `model` from seed 0: embed_stream over `n_items` images and
    token rows at batch 64 in fp32 and bf16 (and evaluate_matching when
    `matching`), counted; then checks of the output and throughput."""
    t0 = time.perf_counter()
    model_obj, mcfg = load_model_from_cfg({"model": model, "seed": 0})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model_obj.device.type == "cuda", "model on the card")

    images, tokens = serving_inputs(mcfg, n_items)
    image_ds, text_ds = _Arrays(image=images), _Arrays(text=tokens)
    pair_ds = _Arrays(image=images, text=tokens)

    encoders = {
        "float32": Encoders(model_obj, mcfg, batch_size=BATCH),
        "bfloat16": Encoders(model_obj, mcfg, batch_size=BATCH, compute_dtype=torch.bfloat16),
    }
    batches = -(-n_items // BATCH)

    # ---- the main path, counted: embed in fp32 and bf16 (then matching)
    manifests, wall = {}, {}
    reset_launches()
    for name, enc in encoders.items():
        out_dir = os.path.join(out_root, tag, name)
        t0 = time.perf_counter()
        m_img = embed_stream(image_ds, enc, "image", "image", out_dir, 100, BATCH, num_workers=4)
        m_txt = embed_stream(text_ds, enc, "text", "text", out_dir, 100, BATCH, num_workers=4)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        manifests[name] = {"images": m_img, "texts": m_txt}
        with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
            json.dump(manifests[name], fh, indent=2)
    if matching:
        metrics = evaluate_matching(model_obj, mcfg, pair_ds, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = read_launches()
    passes = 3 if matching else 2  # fp32 embed, bf16 embed(, matching)
    expected = serving_launches(mcfg, batches * passes, batches * passes)
    check(launches == expected, f"{tag} launches {launches} != {expected}")
    emit({"phase": f"{tag}_launches", "model": model, "launches": launches, "expected": expected,
          "per_batch": {"image": serving_launches(mcfg, 1, 0), "text": serving_launches(mcfg, 0, 1)}})

    # ---- what came out
    summary = {}
    feats_by = {}
    for name in encoders:
        feats, norm_errs = check_shards(os.path.join(out_root, tag, name), manifests[name], n_items,
                                        mcfg.embed_dim, 1e-4 if name == "float32" else 1e-2, name)
        for kind in ("images", "texts"):
            feats_by[name, kind] = feats[kind]
            summary[f"{name}_{kind}_norm_err"] = norm_errs[kind]
    if matching:
        check(matching_metrics(feats_by["float32", "images"], feats_by["float32", "texts"]) == metrics,
              "evaluate_matching agrees with the metrics of the embedded features")
        check(metrics["num_pairs"] == n_items, "matching pairs")
        summary["matching"] = metrics

    # ---- kernel path vs a plain-attention run of the same model, one batch
    params = encoders["float32"].params
    x_img = torch.from_numpy(images[:BATCH]).cuda()
    x_tok = torch.from_numpy(tokens[:BATCH]).cuda()
    with torch.inference_mode():
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for kind, fn, x in (("images", encode_image, x_img), ("texts", encode_text, x_tok)):
                k = l2_normalize(fn(params, mcfg, x, compute_dtype=dtype, impl="kernel")).float()
                p = l2_normalize(fn(params, mcfg, x, compute_dtype=dtype, impl="plain")).float()
                stream = torch.from_numpy(feats_by[name, kind][:BATCH]).cuda()
                if name == "float32":
                    err = (k - p).abs().max().item()
                    check(err <= 1e-4, f"fp32 {kind}: kernel vs plain max abs err {err}")
                    summary[f"float32_{kind}_kernel_vs_plain_max_abs_err"] = err
                    check((k - stream).abs().max().item() <= 1e-5, f"fp32 {kind}: stream vs direct")
                else:
                    # a true cosine: bf16-normalized rows are unit only to ~1e-2
                    cos = F.cosine_similarity(k, p, dim=-1).min().item()
                    check(cos >= 0.999, f"bf16 {kind}: kernel vs plain min cosine {cos}")
                    summary[f"bfloat16_{kind}_kernel_vs_plain_min_cos"] = cos
                    check(F.cosine_similarity(k, stream, dim=-1).min().item() >= 0.999,
                          f"bf16 {kind}: stream vs direct")
                    # information only: how far bf16 serving drifts from fp32
                    fp32 = torch.from_numpy(feats_by["float32", kind][:BATCH]).cuda()
                    summary[f"bfloat16_{kind}_vs_float32_min_cos"] = (
                        F.cosine_similarity(k, fp32, dim=-1).min().item()
                    )

    # ---- throughput at batch 64 (device time, CUDA events, after warm-up)
    rates = {}
    iters = 20 if mcfg.vision_layers <= 12 else 8
    with torch.inference_mode():
        for name, enc in encoders.items():
            ms_img = cuda_ms(lambda: enc.encode_images(x_img), iters=iters, warmup=3)
            ms_txt = cuda_ms(lambda: enc.encode_texts(x_tok), iters=iters, warmup=3)
            rates[name] = {
                "images_per_s": BATCH / ms_img * 1e3, "texts_per_s": BATCH / ms_txt * 1e3,
                "image_batch_ms": ms_img, "text_batch_ms": ms_txt,
                "embed_stream_wall_s": wall[name],
            }
    emit({"phase": tag, "model": model, "seed": 0, "init_s": init_s,
          "images": n_items, "texts": n_items, "batch": BATCH, "throughput": rates, **summary})
    needles = {"images": vision_kernels(mcfg)[0] + "_kernel", "texts": KERNEL + "_kernel"}
    with torch.inference_mode():
        for name, enc in encoders.items():
            for kind, fn, x in (("images", enc.encode_images, x_img), ("texts", enc.encode_texts, x_tok)):
                batch_ms = rates[name]["image_batch_ms" if kind == "images" else "text_batch_ms"]
                emit({"phase": f"{tag}_profile", "model": model, "dtype": name, "tower": kind,
                      **profile_one(lambda: fn(x), batch_ms, kernels=(("attention", needles[kind]),))})
    del encoders, model_obj, params
    torch.cuda.empty_cache()
    return launches, rates


INT8_MODES = (  # (tag, the CLI's keys, float towers)
    ("int8", {"quantize": "int8"}, ()),
    ("int8_static", {"quantize": "int8_static", "calibration_batches": 2}, ()),
    ("int8_static_visual", {"quantize": "int8_static", "calibration_batches": 2,
                            "quantize_towers": ["visual"]}, ("text",)),
)


def int8_launches(mcfg, image_batches, text_batches, float_towers=()):
    """Launches per kernel for encoding that many image and text batches
    with int8 dense layers: the attention forwards of `serving_launches`,
    and K5 once per dense layer of a quantized tower (4 a block, then the
    patch embed and the projection in the vision tower, the projection in
    the text tower), LAUNCHES_PER_CALL launches each."""
    out = serving_launches(mcfg, image_batches, text_batches)
    dense = {"image": 4 * mcfg.vision_layers + 2, "text": 4 * mcfg.transformer_layers + 1}
    calls = dense["image"] * image_batches
    if "text" not in float_towers:
        calls += dense["text"] * text_batches
    out[quant.KERNEL] = quant.LAUNCHES_PER_CALL * calls
    return out


def weight_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    if isinstance(params, quant.QuantWeight):
        return sum(t.numel() * t.element_size() for t in (params.q, params.scale, params.act_scale)
                   if t is not None)
    return params.numel() * params.element_size()


def phase_serving_int8(out_root, model, n_items, tag, float_rates, cos_gate=None):
    """Serve `model` from seed 0 in the three INT8_MODES through the CLI's
    `load_model_from_cfg`: embed_stream over `n_items` images and token rows
    at batch 64 in fp32 (and bf16 in the visual-only mode), counted; then the
    kernel path against the plain path (plain attention and plain K5), the
    cosine against the float model's features (gated at `cos_gate` in the
    modes that quantize both towers), throughput and one profiled batch."""
    float_model, mcfg = load_model_from_cfg({"model": model, "seed": 0})
    images, tokens = serving_inputs(mcfg, n_items)
    image_ds, text_ds = _Arrays(image=images), _Arrays(text=tokens)
    x_img = torch.from_numpy(images[:BATCH]).cuda()
    x_tok = torch.from_numpy(tokens[:BATCH]).cuda()
    float_enc = Encoders(float_model, mcfg, batch_size=BATCH)
    with torch.inference_mode():
        ref = {"images": float_enc.encode_images(x_img).float(), "texts": float_enc.encode_texts(x_tok).float()}
    float_bytes = weight_bytes(float_model.params())
    del float_enc, float_model
    torch.cuda.empty_cache()
    batches = -(-n_items // BATCH)
    all_launches = dict.fromkeys(COUNTERS, 0)
    for mode, qcfg, float_towers in INT8_MODES:
        t0 = time.perf_counter()
        model_obj, _ = load_model_from_cfg({"model": model, "seed": 0, **qcfg})
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params = model_obj.params()
        check(isinstance(params["visual"]["transformer"]["attn"]["qkv_w"], quant.QuantWeight)
              and isinstance(params["text_projection"], quant.QuantWeight) == (not float_towers),
              f"{tag} {mode}: the towers quantized as asked")
        encoders = {"float32": Encoders(model_obj, mcfg, batch_size=BATCH)}
        if float_towers:
            encoders["bfloat16"] = Encoders(model_obj, mcfg, batch_size=BATCH, compute_dtype=torch.bfloat16)

        # ---- the main path, counted
        reset_launches()
        manifests, wall = {}, {}
        for name, enc in encoders.items():
            out_dir = os.path.join(out_root, tag, mode, name)
            t0 = time.perf_counter()
            manifests[name] = {
                "images": embed_stream(image_ds, enc, "image", "image", out_dir, 100, BATCH, num_workers=4),
                "texts": embed_stream(text_ds, enc, "text", "text", out_dir, 100, BATCH, num_workers=4),
            }
            torch.cuda.synchronize()
            wall[name] = time.perf_counter() - t0
            with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
                json.dump(manifests[name], fh, indent=2)
        launches = read_launches()
        passes = len(encoders)
        expected = int8_launches(mcfg, batches * passes, batches * passes, float_towers)
        check(launches == expected, f"{tag} {mode} launches {launches} != {expected}")
        all_launches = {k: all_launches[k] + launches[k] for k in COUNTERS}

        # ---- what came out
        summary = {"weight_bytes": weight_bytes(params), "float_weight_bytes": float_bytes}
        for name in encoders:
            feats, norm_errs = check_shards(os.path.join(out_root, tag, mode, name), manifests[name], n_items,
                                            mcfg.embed_dim, 1e-4 if name == "float32" else 1e-2,
                                            f"{tag} {mode} {name}")
            summary[f"{name}_norm_err"] = max(norm_errs.values())
            for kind in ("images", "texts"):
                # information (and the B/32 gate below): int8 against float
                cos = F.cosine_similarity(torch.from_numpy(feats[kind][:BATCH]).cuda(), ref[kind], dim=-1)
                summary[f"{name}_{kind}_vs_float32_min_cos"] = cos.min().item()
                summary[f"{name}_{kind}_vs_float32_mean_cos"] = cos.mean().item()
                if cos_gate is not None and name == "float32" and not float_towers:
                    check(cos.min().item() >= cos_gate,
                          f"{tag} {mode} {kind}: int8 vs float min cosine {cos.min().item()} < {cos_gate}")

        # ---- kernel path vs the plain paths, fp32: plain K5 under the
        # kernel attention (K5 alone: exact by design), and plain K5 under
        # plain attention. K1 equals its plain version bit for bit, K2 to
        # ~1e-6, and a 1e-6 change can flip a dynamic int8 rounding, which
        # moves a feature by ~1e-3: where K2 runs (L/14 images) the all-plain
        # comparison is held by cosine, elsewhere at 1e-4
        p32 = encoders["float32"].params
        with torch.inference_mode():
            for kind, fn, x in (("images", encode_image, x_img), ("texts", encode_text, x_tok)):
                k = l2_normalize(fn(p32, mcfg, x, impl="kernel")).float()
                quant.set_gemm_impl("xla")
                try:
                    pk = l2_normalize(fn(p32, mcfg, x, impl="kernel")).float()
                    p = l2_normalize(fn(p32, mcfg, x, impl="plain")).float()
                finally:
                    quant.set_gemm_impl("auto")
                err = (k - pk).abs().max().item()
                check(err <= 1e-4, f"{tag} {mode} fp32 {kind}: K5 vs plain K5 max abs err {err}")
                summary[f"float32_{kind}_k5_vs_plain_k5_max_abs_err"] = err
                err = (k - p).abs().max().item()
                cos = F.cosine_similarity(k, p, dim=-1).min().item()
                if kind == "texts" or vision_kernels(mcfg)[0] == KERNEL:
                    check(err <= 1e-4, f"{tag} {mode} fp32 {kind}: kernel vs plain max abs err {err}")
                else:
                    check(cos >= 0.999, f"{tag} {mode} fp32 {kind}: kernel vs plain min cosine {cos}")
                summary[f"float32_{kind}_kernel_vs_plain_max_abs_err"] = err
                summary[f"float32_{kind}_kernel_vs_plain_min_cos"] = cos

        # ---- throughput at batch 64 and one profiled batch of each tower
        rates, profiles = {}, {}
        iters = 20 if mcfg.vision_layers <= 12 else 8
        with torch.inference_mode():
            for name, enc in encoders.items():
                ms_img = cuda_ms(lambda: enc.encode_images(x_img), iters=iters, warmup=3)
                ms_txt = cuda_ms(lambda: enc.encode_texts(x_tok), iters=iters, warmup=3)
                rates[name] = {"images_per_s": BATCH / ms_img * 1e3, "texts_per_s": BATCH / ms_txt * 1e3,
                               "image_batch_ms": ms_img, "text_batch_ms": ms_txt,
                               "embed_stream_wall_s": wall[name]}
            enc = encoders["float32"]
            needles = (("quant_matmul", "int8_gemm_kernel"), ("quant_rows", "quant_rows_kernel"),
                       ("attention", "attention_"))
            for kind, fn, x, ms in (("images", enc.encode_images, x_img, rates["float32"]["image_batch_ms"]),
                                    ("texts", enc.encode_texts, x_tok, rates["float32"]["text_batch_ms"])):
                profiles[kind] = profile_one(lambda: fn(x), ms, kernels=needles)
        emit({"phase": tag, "model": model, "mode": mode, "config": qcfg, "seed": 0, "init_s": init_s,
              "images": n_items, "texts": n_items, "batch": BATCH, "launches": launches,
              "per_batch": {"image": int8_launches(mcfg, 1, 0, float_towers),
                            "text": int8_launches(mcfg, 0, 1, float_towers)},
              "throughput": rates, "float_throughput": float_rates, **summary})
        for kind, prof in profiles.items():
            emit({"phase": f"{tag}_profile", "model": model, "mode": mode, "dtype": "float32",
                  "tower": kind, **prof})
        del encoders, model_obj, params, p32
        torch.cuda.empty_cache()
    return all_launches


def _load_fixtures():
    """tests/fixtures.py (numpy and PIL only) by path: the synthetic
    annotation files and images of the eval CLIs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("eval_fixtures", os.path.join(REPO, "tests", "fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _loader_batches(n, batch):
    return [min(batch, n - i) for i in range(0, n, batch)]


def _encoder_batches(n_items, batch):
    return -(-n_items // batch)


def phase_evals(out_root):
    """The M2E2, VCR, VisualCOMET and retrieval CLIs through `evals.cli.run`
    on synthetic annotation files: metrics finite and in [0, 1] (rates),
    the expected keys, and exact launch counts (Encoders pads every call to
    its fixed batch; M2E2 encodes the grid of each loader batch once more,
    unpadded)."""
    import contextlib
    import io

    from clip_event_tpu_torch import eval_m2e2, eval_retrieval, eval_vcr, eval_visualcomet
    from clip_event_tpu_torch.evals.cli import run

    fx = _load_fixtures()
    B = 4
    root = os.path.join(out_root, "evals")
    os.makedirs(root, exist_ok=True)
    results, all_launches = {}, dict.fromkeys(COUNTERS, 0)

    def run_cli(name, module, cfg, expected, keys):
        cfg = dict(cfg, seed=0, batch_size=B, output_json=os.path.join(root, f"{name}.json"))
        path = os.path.join(root, f"{name}_cfg.json")
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        argv, sys.argv = sys.argv, [f"{name}", "--cfg", path]
        reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                run(name, module.evaluate)
        finally:
            sys.argv = argv
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        with open(cfg["output_json"]) as fh:
            metrics = json.load(fh)
        check(json.loads(out.getvalue()) == metrics, f"{name}: printed and written metrics agree")
        check(launches == expected, f"{name} launches {launches} != {expected}")
        check(keys <= set(metrics), f"{name}: keys {sorted(keys - set(metrics))} missing")

        def rates_ok(m):
            for k, v in m.items():
                if isinstance(v, dict):
                    rates_ok(v)
                elif isinstance(v, float) and k != "mean_rank":
                    check(math.isfinite(v) and 0.0 <= v <= 1.0, f"{name}: {k} = {v}")
        rates_ok(metrics)
        results[name] = {"model": cfg["model"], "quantize": cfg.get("quantize"), "wall_s": wall,
                         "metrics": metrics, "launches": launches}
        for k in COUNTERS:
            all_launches[k] += launches[k]

    def launches_for(mcfg, image_batches, text_batches, quantized=False):
        if quantized:
            return int8_launches(mcfg, image_batches, text_batches)
        return serving_launches(mcfg, image_batches, text_batches)

    # VCR at ViT-B/32: 5 questions of 4 choices
    p = fx.make_vcr_fixture(os.path.join(root, "vcr"))
    sizes = _loader_batches(5, B)
    run_cli("eval_vcr", eval_vcr, {"model": "ViT-B/32", "qa_jsonl": p["qa_jsonl"], "image_dir": p["image_dir"]},
            launches_for(VIT_B32, sum(_encoder_batches(b, B) for b in sizes),
                         sum(_encoder_batches(4 * b, B) for b in sizes)),
            {"accuracy", "num_questions"})
    # VisualCOMET at ViT-B/32: 5 images against the pool of 10 intents
    p = fx.make_visualcomet_fixture(os.path.join(root, "visualcomet"))
    run_cli("eval_visualcomet", eval_visualcomet,
            {"model": "ViT-B/32", "anno_json": p["anno_json"], "image_dir": p["image_dir"], "field": "intent"},
            launches_for(VIT_B32, sum(_encoder_batches(b, B) for b in _loader_batches(5, B)),
                         _encoder_batches(10, B)),
            {"R@1", "R@5", "R@10", "mean_rank", "num_images", "num_candidates"})
    # retrieval (COCO layout) at ViT-B/32: 4 images of 5 captions
    p = fx.make_retrieval_fixture(os.path.join(root, "retrieval"))
    sizes = _loader_batches(4, B)
    run_cli("eval_retrieval", eval_retrieval,
            {"model": "ViT-B/32", "dataset": "coco", "caption_file": p["coco_json"], "image_dir": p["coco_dir"]},
            launches_for(VIT_B32, sum(_encoder_batches(b, B) for b in sizes),
                         sum(_encoder_batches(5 * b, B) for b in sizes)),
            {"t2i_R@1", "i2t_R@1", "t2i_R@10", "num_images"})
    # M2E2 at ViT-L/14 in int8_static with argument grounding: 8 images, 3
    # event types of 2 roles each
    p = fx.make_m2e2_fixture(os.path.join(root, "m2e2"))
    with open(p["ontology_json"]) as fh:
        ontology = json.load(fh)
    roles = {"Attacker": "the person attacking", "Place": "where it happens"}
    ont = os.path.join(root, "m2e2", "ontology_roles.json")
    with open(ont, "w") as fh:
        json.dump({t: {"template": v, "roles": roles} for t, v in ontology.items()}, fh)
    sizes = _loader_batches(8, B)
    image_batches = sum(_encoder_batches(b, B) for b in sizes) + len(sizes)  # + the grid encodes
    text_batches = _encoder_batches(len(ontology), B) + len(ontology) * _encoder_batches(len(roles), B)
    run_cli("eval_m2e2", eval_m2e2,
            {"model": "ViT-L/14", "quantize": "int8_static", "image_anno": p["anno_json"],
             "image_dir": p["image_dir"], "ie_ontology_json": ont, "ground_arguments": True},
            launches_for(VIT_L14, image_batches, text_batches, quantized=True),
            {"event_precision", "event_recall", "event_f1", "argument_precision", "argument_recall",
             "argument_f1", "per_type", "accuracy", "macro_f1", "num_images"})
    check(results["eval_m2e2"]["metrics"]["argument_mentions_gold"] == 8, "M2E2 gold arguments")
    emit({"phase": "evals", "batch_size": B, **results})
    return all_launches


class _BenchPairs(ExampleDataset):
    """The bench workload as a dataset: uint8 images from seed 0 (a pool,
    reused by index), and per image 1 + 2 description rows of 77 tokens
    built as `bench.py` builds them (random ids, EOT in the last slot);
    the label layout and the [B·D, 77] flattening of `VOADescriptionDataset`."""

    def __init__(self, n, res, context, vocab, seed=0, pool=512):
        rng = np.random.default_rng(seed)
        self.n = n
        self.images = rng.integers(0, 256, size=(pool, res, res, 3), dtype=np.uint8)
        D = NUM_POS + NUM_NEG
        self.text = rng.integers(1, 49000, size=(n, D, context)).astype(np.int32)
        self.text[:, :, -1] = vocab - 1

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return ({"image": self.images[i % len(self.images)], "text": self.text[i]},
                {"image_id": f"{i:06d}"})

    def batch_extras(self, batch_size):
        layout = build_label_layout(batch_size, NUM_POS, NUM_NEG)
        return {"labels_per_image": layout.labels_per_image,
                "labels_per_text": layout.labels_per_text, "index_pos": layout.index_pos}

    def finalize_batch(self, tensors):
        tensors["text"] = tensors["text"].reshape(-1, tensors["text"].shape[-1])
        return tensors


class _OTPairs(_BenchPairs):
    """finetune_ot.json's workload as a dataset: per image the 1 + 2
    description rows of `_BenchPairs`, OT_OBJECTS float32 crops at the
    model's resolution (a pool drawn from seed 1, reused by index; slot 0
    is the whole image, which is also `image`; the slots past a ragged
    count are zero), and OT_ENTITIES / OT_EVENTS token rows with ragged
    counts (zero rows past the count): the keys and masks of
    `VOADescriptionDataset` with `load_object` and `load_ie`."""

    def __init__(self, n, res, context, vocab, seed=0, pool=16):
        super().__init__(n, res, context, vocab, seed, pool=1)
        rng = np.random.default_rng(seed + 1)
        self.crops = rng.normal(size=(pool, OT_OBJECTS, res, res, 3)).astype(np.float32)
        self.counts = {
            "object": rng.integers(1, OT_OBJECTS + 1, n),
            "entity": rng.integers(0, OT_ENTITIES + 1, n),
            "event": rng.integers(0, OT_EVENTS + 1, n),
        }
        self.rows = {}
        for field, cap in (("entity", OT_ENTITIES), ("event", OT_EVENTS)):
            tok = np.zeros((n, cap, context), np.int32)
            for i in range(n):
                for r in range(self.counts[field][i]):
                    eot = int(rng.integers(3, context - 1))
                    tok[i, r, 0] = SOT
                    tok[i, r, 1:eot] = rng.integers(1, SOT, eot - 1)
                    tok[i, r, eot] = EOT
            self.rows[field] = tok

    def __getitem__(self, i):
        crops = self.crops[i % len(self.crops)].copy()
        crops[self.counts["object"][i]:] = 0.0
        tensors = {"image": crops[0], "text": self.text[i], "object_image": crops}
        for field, cap in (("object", OT_OBJECTS), ("entity", OT_ENTITIES), ("event", OT_EVENTS)):
            tensors[f"{field}_mask"] = (np.arange(cap) < self.counts[field][i]).astype(np.int32)
        tensors["entity_text"] = self.rows["entity"][i]
        tensors["event_text"] = self.rows["event"][i]
        return tensors, {"image_id": f"{i:06d}"}


def _device_batch(ds, b):
    """The first b examples of `ds` as one batch on the card."""
    ex = [ds[i][0] for i in range(b)]
    batch = {k: np.stack([e[k] for e in ex]) for k in ex[0]}
    batch = ds.finalize_batch({**batch, **ds.batch_extras(b)})
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in batch.items()}


def _chunks(nodes, requested):
    """sim_entity's effective chunk count: the smallest divisor of the node
    axis that is >= the requested count."""
    if requested <= 1:
        return 1
    return next(d for d in range(min(requested, nodes), nodes + 1) if nodes % d == 0)


def train_launches(mcfg, steps, alignment=False):
    """Launches per kernel for `steps` train steps under full remat. Each
    block's attention forward runs twice (forward, block recompute) and its
    backward once (BWD_LAUNCHES_PER_CALL launches). With alignment the crop
    and entity encodes run in chunks (`sim_entity`), each chunk under its
    own checkpoint around the per-block ones: a block inside a chunk runs
    its forward three times (forward, chunk recompute, block recompute)
    when there is more than one chunk, twice when there is one; and one
    IPOT solve per step (tests/test_torch_ot_train.py pins the rule on the
    CPU)."""
    vis_f, vis_b = vision_kernels(mcfg)
    Lv, Lt = mcfg.vision_layers, mcfg.transformer_layers
    out = dict.fromkeys(COUNTERS, 0)
    out[vis_f] += 2 * Lv
    out[vis_b] += BWD_LAUNCHES_PER_CALL * Lv
    out[KERNEL] += 2 * Lt
    out[BWD_KERNEL] += BWD_LAUNCHES_PER_CALL * Lt
    if alignment:
        for kf, kb, L, c in ((vis_f, vis_b, Lv, _chunks(OT_OBJECTS, OT_CHUNKS)),
                             (KERNEL, BWD_KERNEL, Lt, _chunks(OT_ENTITIES, OT_CHUNKS))):
            out[kf] += (3 if c > 1 else 2) * c * L
            out[kb] += BWD_LAUNCHES_PER_CALL * c * L
        out[ot.KERNEL] += 1
    return {k: v * steps for k, v in out.items()}


def run_train_loop(tag, mcfg, params, ds, batch, out_root, **cfg_extra):
    """The main path of a train phase, counted: `train.train` over `ds` for
    warm-up + timed steps (bf16, full remat, Adam at lr 1e-6). Checks the
    step count, finite losses, the launch counts and that the params moved;
    returns what the phase reports."""
    n_steps = WARMUP_STEPS + TIMED_STEPS
    cfg = validate_config({
        "task": f"chip_smoke_{tag}", "constrastive_loss": "ce", "batch_size": batch,
        "lr": 1e-6, "optimizer": "adam", "lr_scheduler": "none", "max_epoch": 1,
        "compute_dtype": "bfloat16", "remat": True, "use_pallas_attention": True,
        "seed": 0, "print_freq": n_steps + 1, "num_workers": 8, "prefetch": 2,
        "ckpt_dir": os.path.join(out_root, f"ckpt_{tag}"), **cfg_extra,
    })
    watch = params["visual"]["transformer"]["attn"]["qkv_w"].detach().clone()
    metrics, events = {}, {}

    def on_step(step, m):
        metrics[step] = m
        events[step] = torch.cuda.Event(enable_timing=True)
        events[step].record()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = train(cfg, mcfg, ds, params, "cuda", on_step=on_step)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(sorted(metrics) == list(range(n_steps)), f"{tag} steps {sorted(metrics)}")
    expected = train_launches(mcfg, n_steps, cfg["alignment"])
    check(launches == expected, f"{tag} launches {launches} != {expected}")
    values = {k: [float(metrics[i][k]) for i in range(n_steps)]
              for k in metrics[0] if k != "finite"}
    check(all(np.isfinite(values["loss"])), f"{tag} losses finite {values['loss']}")
    moved = (state.params["visual"]["transformer"]["attn"]["qkv_w"].detach() - watch).abs().max().item()
    check(moved > 0, f"{tag}: the params changed")
    step_ms = [events[i - 1].elapsed_time(events[i]) for i in range(WARMUP_STEPS, n_steps)]
    emit({"phase": f"{tag}_launches", **{f"{k}_launches": v for k, v in launches.items()},
          "expected": expected, "steps": n_steps,
          "per_step": {k: v // n_steps for k, v in expected.items()}})
    return {"state": state, "values": values, "step_ms": step_ms, "mean_ms": float(np.mean(step_ms)),
            "loop_s": loop_s, "peak_gib": peak_gib, "launches": launches, "n_steps": n_steps}


def _chance(batch, D):
    """CE of an untrained model, which scores every pair alike: over the
    B·D texts of an image plus over the B images of a positive text."""
    return math.log(batch * D) + math.log(batch)


def compare_bf16_step(mcfg, params, batch, keys=("loss",), **step_kwargs):
    """One bf16 step on the kernel path and one on the plain path (plain
    attention and, with alignment, the plain IPOT solver) from one state
    and batch: each of `keys` within BF16_STEP_TOL (abs), grad_norm within
    BF16_STEP_TOL (relative)."""
    sched = build_schedule("none", 1e-6, 1)
    metrics = {}
    for impl in ("kernel", "plain"):
        opt = build_optimizer("adam", sched)
        st = create_train_state(params, opt)
        step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True, impl=impl,
                               use_pallas_ot=impl == "kernel", **step_kwargs)
        _, m = step(st, batch)
        metrics[impl] = {k: float(v) for k, v in m.items()}
        del st, step
    out = {"batch": batch["image"].shape[0], "kernel": metrics["kernel"], "plain": metrics["plain"]}
    for key in keys:
        diff = abs(metrics["kernel"][key] - metrics["plain"][key])
        check(diff <= BF16_STEP_TOL, f"bf16 step: kernel vs plain {key} differs by {diff}")
        out[f"{key}_abs_diff"] = diff
    dg = abs(metrics["kernel"]["grad_norm"] - metrics["plain"]["grad_norm"]) / metrics["plain"]["grad_norm"]
    check(dg <= BF16_STEP_TOL, f"bf16 step: kernel vs plain grad_norm differs by {dg} (relative)")
    out["grad_norm_rel_diff"] = dg
    return out


def compare_fp32_grads(mcfg, params, batch, **loss_kwargs):
    """fp32 loss and every gradient tensor on the kernel path against the
    plain path from one state and batch: loss within FP32_STEP_TOL (abs),
    each gradient within FP32_STEP_TOL of its largest element."""
    sched = build_schedule("none", 1e-6, 1)
    grads, loss = {}, {}
    for impl in ("kernel", "plain"):
        st = create_train_state(params, build_optimizer("adam", sched))
        total, _ = loss_fn(st.params, batch, mcfg, compute_dtype=torch.float32, remat=True, impl=impl,
                           use_pallas_ot=impl == "kernel", **loss_kwargs)
        grads[impl] = torch.autograd.grad(total, tree_leaves(st.params))
        loss[impl] = total.item()
        del st
    dl = abs(loss["kernel"] - loss["plain"])
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(grads["kernel"], grads["plain"]))
    check(dl <= FP32_STEP_TOL, f"fp32 step: kernel vs plain loss differs by {dl}")
    check(worst <= FP32_STEP_TOL, f"fp32 step: a gradient differs by {worst} of its max")
    return {"batch": batch["image"].shape[0], "loss_abs_diff": dl, "max_grad_rel_diff": worst}


def profile_step(mcfg, params, batch, mean_ms, **step_kwargs):
    """One bf16 kernel-path step under the profiler (see `profile_one`)."""
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    st = {"state": create_train_state(params, opt)}
    step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True, **step_kwargs)

    def one_step():
        st["state"], _ = step(st["state"], batch)

    kernels = (("attention_fwd", "attention_fwd_kernel"), ("attention_bwd", "attention_bwd_"),
               ("attention_hg_fwd", "attention_hg_fwd_kernel"), ("attention_hg_bwd", "attention_hg_bwd_"),
               ("ipot", "ipot_kernel"))
    # the same step with its batch already on the card and no loader
    # behind it (host clock around synchronised steps): what is left of the
    # loop's step time once the data feed is out of the way. Taken before
    # the profiler runs: timed after it, the launch-bound OT step read 1.6x
    # its own steps in the loop on the H100
    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t0) / 2 * 1e3
    prof = profile_one(one_step, mean_ms, kernels=kernels)
    prof["resident_batch_step_ms"] = resident_ms
    return prof


def _train_report(tag, model, run, batch, D, init_s, **extra):
    pairs = batch * D
    emit({"phase": tag, "model": model, "seed": 0, "init_s": init_s, "batch_images": batch,
          "descriptions_per_image": D, "tokens": 77, "compute_dtype": "bfloat16", "remat": "full",
          "optimizer": "adam", "lr": 1e-6, "steps": run["n_steps"], "timed_steps": TIMED_STEPS,
          "losses": run["values"], "step_ms": run["step_ms"], "step_ms_mean": run["mean_ms"],
          "contrastive_pairs_per_sec_per_chip": pairs / run["mean_ms"] * 1e3,
          "loop_wall_s": run["loop_s"], "max_memory_allocated_gib": run["peak_gib"], **extra})


def phase_train(out_root):
    mcfg = VIT_B32
    D = NUM_POS + NUM_NEG
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_steps = WARMUP_STEPS + TIMED_STEPS
    ds = _BenchPairs(n_steps * TRAIN_BATCH, mcfg.image_resolution, mcfg.context_length,
                     mcfg.vocab_size)
    run = run_train_loop("train", mcfg, params, ds, TRAIN_BATCH, out_root)
    first = run["values"]["loss"][0]
    check(abs(first - _chance(TRAIN_BATCH, D)) < 0.5,
          f"first loss {first} vs chance {_chance(TRAIN_BATCH, D)}")
    del run["state"]

    compare = {
        "bfloat16": compare_bf16_step(mcfg, params, _device_batch(ds, TRAIN_BATCH)),
        "float32": compare_fp32_grads(mcfg, params, _device_batch(ds, FP32_CHECK_BATCH)),
    }
    prof = profile_step(mcfg, params, _device_batch(ds, TRAIN_BATCH), run["mean_ms"])
    _train_report("train", "ViT-B/32", run, TRAIN_BATCH, D, init_s, kernel_vs_plain=compare)
    emit({"phase": "train_profile", **prof})
    return run["launches"]


def phase_train_l14(out_root):
    """ViT-L/14 through the train loop at bench.py's L/14 workload, then one
    ViT-B/16 kernel-path step at its bench batch. bench.py runs L/14 with
    the "attn" remat policy, which the port does not have yet: full remat."""
    D = NUM_POS + NUM_NEG
    n_steps = WARMUP_STEPS + TIMED_STEPS
    mcfg = VIT_L14
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ds = _BenchPairs(n_steps * L14_BATCH, mcfg.image_resolution, mcfg.context_length, mcfg.vocab_size)
    run = run_train_loop("train_l14", mcfg, params, ds, L14_BATCH, out_root)
    first = run["values"]["loss"][0]
    check(abs(first - _chance(L14_BATCH, D)) < 0.5,
          f"L/14 first loss {first} vs chance {_chance(L14_BATCH, D)}")
    del run["state"]
    compare = {"bfloat16": compare_bf16_step(mcfg, params, _device_batch(ds, L14_BATCH))}
    prof = profile_step(mcfg, params, _device_batch(ds, L14_BATCH), run["mean_ms"])
    _train_report("train_l14", "ViT-L/14", run, L14_BATCH, D, init_s, remat_note=(
        "full remat; bench.py runs L/14 with the 'attn' policy, not ported yet"),
        kernel_vs_plain=compare)
    emit({"phase": "train_l14_profile", **prof})
    del params, ds
    torch.cuda.empty_cache()

    # ViT-B/16: one kernel-path step at its bench batch, counted
    mcfg = VIT_B16
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    batch = _device_batch(_BenchPairs(B16_BATCH, mcfg.image_resolution, mcfg.context_length,
                                      mcfg.vocab_size), B16_BATCH)
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    state = create_train_state(params, opt)
    step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    _, m = step(state, batch)
    loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    b16 = read_launches()
    expected = train_launches(mcfg, 1)
    check(b16 == expected, f"B/16 step launches {b16} != {expected}")
    check(math.isfinite(loss), f"B/16 step loss {loss}")
    emit({"phase": "train_b16", "model": "ViT-B/16", "batch_images": B16_BATCH,
          "descriptions_per_image": D, "loss": loss, "chance": _chance(B16_BATCH, D),
          "first_step_wall_s": step_s, "launches": b16, "expected": expected})
    del params, state, step, batch
    torch.cuda.empty_cache()
    return run["launches"], b16


def phase_train_ot(out_root):
    """finetune_ot.json's settings at ViT-B/32 full width through the train
    loop, with the alignment branch on the kernels (K1 in every encode, K3
    for the plan)."""
    mcfg = VIT_B32
    D = NUM_POS + NUM_NEG
    n_steps = WARMUP_STEPS + TIMED_STEPS
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ds = _OTPairs(n_steps * OT_BATCH, mcfg.image_resolution, mcfg.context_length, mcfg.vocab_size)
    with open(os.path.join(REPO, "configs", "finetune_ot.json")) as fh:
        finetune_ot = json.load(fh)
    ot_cfg = {k: finetune_ot[k] for k in (
        "alignment", "load_object", "load_ie", "object_ontology_file", "max_objects",
        "max_entities", "max_events", "use_pallas_ot")}
    check(ot_cfg == {**ot_cfg, "alignment": True, "use_pallas_ot": True, "max_objects": OT_OBJECTS,
                     "max_entities": OT_ENTITIES, "max_events": OT_EVENTS}
          and finetune_ot["batch_size"] == OT_BATCH and finetune_ot["lr"] == 1e-6,
          f"finetune_ot.json's settings {ot_cfg}")
    ot_cfg["alignment_chunks"] = OT_CHUNKS  # the config default, which finetune_ot.json keeps
    run = run_train_loop("train_ot", mcfg, params, ds, OT_BATCH, out_root, **ot_cfg)
    loss_ot = run["values"]["loss_ot"]
    check(all(np.isfinite(loss_ot)) and min(loss_ot) > 0, f"loss_ot finite and > 0: {loss_ot}")
    contrastive = run["values"]["loss_i"][0] + run["values"]["loss_t"][0]
    check(abs(contrastive - _chance(OT_BATCH, D)) < 0.5,
          f"OT first contrastive loss {contrastive} vs chance {_chance(OT_BATCH, D)}")
    del run["state"]
    step_kwargs = {"alignment": True, "alignment_chunks": OT_CHUNKS}
    compare = {
        "bfloat16": compare_bf16_step(mcfg, params, _device_batch(ds, OT_BATCH),
                                      keys=("loss", "loss_ot"), **step_kwargs),
        "float32": compare_fp32_grads(mcfg, params, _device_batch(ds, OT_FP32_CHECK_BATCH),
                                      **step_kwargs),
    }
    prof = profile_step(mcfg, params, _device_batch(ds, OT_BATCH), run["mean_ms"],
                        use_pallas_ot=True, **step_kwargs)
    _train_report("train_ot", "ViT-B/32", run, OT_BATCH, D, init_s, objects=OT_OBJECTS,
                  entities=OT_ENTITIES, alignment_chunks=OT_CHUNKS, kernel_vs_plain=compare)
    emit({"phase": "train_ot_profile", **prof})
    del params, ds
    torch.cuda.empty_cache()
    return run["launches"]


def profile_one(run, batch_ms, kernels=(("attention", "attention_fwd_kernel"),)):
    """Device time of one warm `run()` by kernel (torch.profiler): the busy
    time summed over the kernels themselves (not the aten ops that launch
    them), its share of `batch_ms` (the unprofiled time of one run), the
    time and busy share of each named kernel family (name substring), and
    the kernels that took most."""
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda k: -k[1],
    )
    if not rows:
        return {"device_busy_ms": "not measured"}
    busy_ms = sum(k[1] for k in rows)
    out = {
        "batch_ms": batch_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / batch_ms),
        "kernel_launches": sum(k[2] for k in rows),
    }
    for label, needle in kernels:
        ms = sum(k[1] for k in rows if needle in k[0])
        out[f"{label}_kernel_ms"] = ms
        out[f"{label}_kernel_share_of_busy"] = ms / busy_ms
    families = {}
    for key, ms, calls in rows:
        fam = next((f for f, needles in KERNEL_FAMILIES if any(n in key for n in needles)), "other")
        ms0, calls0 = families.get(fam, (0.0, 0))
        families[fam] = (ms0 + ms, calls0 + calls)
    out["by_family"] = {f: {"ms": ms, "calls": c, "share_of_busy": ms / busy_ms}
                        for f, (ms, c) in sorted(families.items(), key=lambda kv: -kv[1][0])}
    out["top"] = [{"kernel": k[0][:160], "ms": k[1], "calls": k[2]} for k in rows[:10]]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    check(set(COUNTERS) <= set(sources), f"kernel sources {sources}")
    seconds = _build.build(sources)
    ptxas = {name: [ln.strip() for ln in _build.BUILD_LOGS.get(name, "").splitlines() if "Used" in ln]
             for name in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": seconds, "ptxas": ptxas})

    rows, errs = phase_kernels()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_root:
        paths["serving"], float_rates = phase_serving(out_root)
        paths["train"] = phase_train(out_root)
        paths["serving_l14"], l14_rates = phase_serving(out_root, "ViT-L/14", L14_SERVING_ITEMS,
                                                        matching=False, tag="serving_l14")
        paths["train_l14"], paths["train_b16"] = phase_train_l14(out_root)
        paths["train_ot"] = phase_train_ot(out_root)
        paths["serving_int8_l14"] = phase_serving_int8(out_root, "ViT-L/14", L14_SERVING_ITEMS,
                                                       "serving_int8_l14", l14_rates)
        paths["serving_int8_b32"] = phase_serving_int8(out_root, "ViT-B/32", L14_SERVING_ITEMS,
                                                       "serving_int8_b32", float_rates, cos_gate=0.99)
        paths["evals"] = phase_evals(out_root)

    def entry(name, source, replaces, tol, head):
        by_path = {path: counts[name] for path, counts in paths.items()}
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "head_shape": " ".join(str(head[k]) for k in ("shape", "dtype", "mode") if k in head),
            "max_abs_err_by_dtype": errs[name], "tolerance_by_dtype": tol,
            "by_shape": [r for r in rows[name] if "ms" in r],
        }

    def head(name, shape, dtype, mode=None):
        return next(r for r in rows[name] if r["shape"] == shape and r["dtype"] == dtype
                    and r.get("mode") in (mode, None))

    # top-level numbers: K1's forward at the serving text shape in fp32 (the
    # CLI's dtype); the backwards and K2's forward at a train step's shape
    # in bf16 (the training dtype); K3 at finetune_ot's shape; K5 at L/14's
    # MLP fc in fp32, dynamic (the CLI's "int8"); by_shape holds every timed
    # shape in both dtypes (and K5's two modes)
    for name in COUNTERS:
        check(sum(counts[name] for counts in paths.values()) > 0, f"{name} launched on the main paths")
    emit({"kernels": [
        entry(KERNEL, "clip_event_tpu_torch/csrc/attention_fwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:93", TOL, head(KERNEL, "text", "float32")),
        entry(BWD_KERNEL, "clip_event_tpu_torch/csrc/attention_bwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:101", BWD_TOL,
              head(BWD_KERNEL, "train_text", "bfloat16")),
        entry(HG_KERNEL, "clip_event_tpu_torch/csrc/attention_hg_fwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:410", TOL,
              head(HG_KERNEL, "l14_vision", "bfloat16")),
        entry(HG_BWD_KERNEL, "clip_event_tpu_torch/csrc/attention_hg_bwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:421", BWD_TOL,
              head(HG_BWD_KERNEL, "l14_vision", "bfloat16")),
        entry(ot.KERNEL, "clip_event_tpu_torch/csrc/ipot.cu",
              "clip_event_tpu/ops/ot_pallas.py:40", OT_TOL, head(ot.KERNEL, "ot_finetune", "float32")),
        entry(quant.KERNEL, "clip_event_tpu_torch/csrc/quant_matmul.cu",
              "clip_event_tpu/ops/quant_pallas.py:64", QUANT_TOL,
              head(quant.KERNEL, "l14_vision_fc", "float32", "dynamic")),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
