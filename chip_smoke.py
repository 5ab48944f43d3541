#!/usr/bin/env python3
"""Drive the PyTorch port's zero-shot serving path and its contrastive
fine-tuning path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

  1. device   the card's name; needs `torch.cuda.is_available()`
  2. build    compiles every kernel source in `clip_event_tpu_torch/csrc/`,
              one nvcc each, all started together
  3. kernels  each kernel against its plain PyTorch version at the serving
              and training shapes and at edge shapes, fp32 and bf16, and its
              time beside the plain version's, one PyTorch library call's and
              the bound the card's peak rates give. The forward (K1-fwd) is
              held at max abs error 1e-5 (fp32) / 2e-2 (bf16); the backward
              (K1-bwd) at max|kernel − plain| / max|plain| ≤ 1e-5 (fp32) /
              1e-2 (bf16)
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
    VIT_B32,
    encode_image,
    encode_text,
    init_params,
    l2_normalize,
)
from clip_event_tpu_torch.models.layers import causal_mask
from clip_event_tpu_torch.ops import _build
from clip_event_tpu_torch.ops.attention import (
    BWD_KERNEL,
    BWD_LAUNCHES_PER_CALL,
    KERNEL,
    fused_attention_qkv,
    fused_attention_qkv_bwd,
    fused_attention_qkv_bwd_plain,
    fused_attention_qkv_plain,
)
from clip_event_tpu_torch.train import train

# the card's published peaks (H100 SXM data sheet, dense): memory, fp32 on
# the CUDA cores, bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # forward: max abs error
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # backward: error relative to max|plain|

SERVING_SHAPES = [  # (tag, B, S, W, H, causal)
    ("text", 64, 77, 512, 8, True),
    ("vision", 64, 50, 768, 12, False),
]
# the train step's calls at B=384 images × 3 descriptions
TRAIN_SHAPES = [
    ("train_text", 1152, 77, 512, 8, True),
    ("train_vision", 384, 50, 768, 12, False),
]
EDGE_SHAPES = [
    ("edge_causal", 3, 13, 128, 2, True),
    ("edge_nobias", 3, 13, 128, 2, False),
    ("edge_s128_d128", 2, 128, 256, 2, True),
    ("edge_b1_s1", 1, 1, 64, 1, False),
]
N_IMAGES = N_TEXTS = 256
BATCH = 64
SOT, EOT = 49406, 49407
# device kernels by family, for the profile's breakdown (first match wins)
KERNEL_FAMILIES = (
    ("attention (hand-written)", ("attention_fwd_kernel", "attention_bwd_")),
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


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, errs = {"fwd": [], "bwd": []}, {"fwd": {}, "bwd": {}}
    timed = ("text", "vision", "train_text", "train_vision")
    for tag, B, S, W, H, causal in SERVING_SHAPES + TRAIN_SHAPES + EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            qkv = torch.randn((B, S, 3 * W), device="cuda", generator=gen).to(dtype)
            do = torch.randn((B, S, W), device="cuda", generator=gen).to(dtype)
            bias = causal_mask(S, device="cuda") if causal else None
            scale = (W // H) ** -0.5
            iters = 20 if B > 64 else 50
            shape = {"shape": tag, "B": B, "S": S, "W": W, "H": H, "causal": causal, "dtype": name}

            # K1-fwd
            out = fused_attention_qkv(qkv, bias, H, scale)
            ref = fused_attention_qkv_plain(qkv, bias, H, scale)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == (B, S, W), f"fwd {tag} {name} shape/dtype")
            check(bool(torch.isfinite(out).all()), f"fwd {tag} {name} output finite")
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= TOL[name], f"fwd {tag} {name}: max abs err {err} > {TOL[name]}")
            errs["fwd"][name] = max(errs["fwd"].get(name, 0.0), err)
            row = {**shape, "max_abs_err": err, "tol": TOL[name]}
            if tag in timed:
                row["ms"] = cuda_ms(lambda: fused_attention_qkv(qkv, bias, H, scale), iters)
                row["plain_ms"] = cuda_ms(lambda: fused_attention_qkv_plain(qkv, bias, H, scale), iters)
                lib = library_fwd(qkv, bias, H, scale)
                check((lib.float() - ref.float()).abs().max().item() <= 10 * TOL[name],
                      f"fwd {tag} {name}: library yardstick disagrees")
                row["library_ms"] = cuda_ms(lambda: library_fwd(qkv, bias, H, scale), iters)
                row["bound_ms"], row["bound_by"] = attention_bound_ms(B, S, W, H, causal, name)
            rows["fwd"].append(row)
            emit({"phase": "kernel_check", "kernel": KERNEL, **row})

            # K1-bwd
            dq = fused_attention_qkv_bwd(qkv, bias, do, H, scale)
            ref = fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale)
            torch.cuda.synchronize()
            check(dq.dtype == dtype and dq.shape == qkv.shape, f"bwd {tag} {name} shape/dtype")
            check(bool(torch.isfinite(dq).all()), f"bwd {tag} {name} output finite")
            err = (dq.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            check(rel <= BWD_TOL[name], f"bwd {tag} {name}: rel err {rel} > {BWD_TOL[name]}")
            errs["bwd"][name] = max(errs["bwd"].get(name, 0.0), err)
            row = {**shape, "max_abs_err": err, "max_rel_err": rel, "tol_rel": BWD_TOL[name]}
            if tag in timed:
                row["ms"] = cuda_ms(lambda: fused_attention_qkv_bwd(qkv, bias, do, H, scale), iters)
                row["plain_ms"] = cuda_ms(
                    lambda: fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale), iters)
                # the library yardstick: SDPA's backward alone, on a graph
                # built once (view-split of a leaf qkv, retained)
                leaf = qkv.detach().requires_grad_(True)
                lib_out = library_fwd(leaf, bias, H, scale)
                (lib,) = torch.autograd.grad(lib_out, leaf, do, retain_graph=True)
                lib_rel = (lib.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
                check(lib_rel <= 5 * BWD_TOL[name], f"bwd {tag} {name}: library yardstick disagrees")
                row["library_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(lib_out, leaf, do, retain_graph=True), iters)
                del lib_out, leaf
                row["bound_ms"], row["bound_by"] = attention_bwd_bound_ms(B, S, W, H, causal, name)
            rows["bwd"].append(row)
            emit({"phase": "kernel_check", "kernel": BWD_KERNEL, **row})
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


def phase_serving(out_root):
    t0 = time.perf_counter()
    model, mcfg = load_model_from_cfg({"model": "ViT-B/32", "seed": 0})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.device.type == "cuda", "model on the card")

    rng = np.random.default_rng(0)
    res = mcfg.image_resolution
    images = rng.integers(0, 256, size=(N_IMAGES, res, res, 3), dtype=np.uint8)
    tokens = np.zeros((N_TEXTS, mcfg.context_length), np.int32)
    for i, n in enumerate(rng.integers(3, mcfg.context_length - 1, N_TEXTS)):
        tokens[i, 0] = SOT
        tokens[i, 1:n] = rng.integers(1, SOT, n - 1)
        tokens[i, n] = EOT
    image_ds, text_ds = _Arrays(image=images), _Arrays(text=tokens)
    pair_ds = _Arrays(image=images, text=tokens)

    encoders = {
        "float32": Encoders(model, mcfg, batch_size=BATCH),
        "bfloat16": Encoders(model, mcfg, batch_size=BATCH, compute_dtype=torch.bfloat16),
    }
    n_batches = -(-N_IMAGES // BATCH) + -(-N_TEXTS // BATCH)

    # ---- the main path, counted: embed in fp32 and bf16, then matching
    manifests, wall = {}, {}
    fused_attention_qkv.launches = 0
    for name, enc in encoders.items():
        out_dir = os.path.join(out_root, name)
        t0 = time.perf_counter()
        m_img = embed_stream(image_ds, enc, "image", "image", out_dir, 100, BATCH, num_workers=4)
        m_txt = embed_stream(text_ds, enc, "text", "text", out_dir, 100, BATCH, num_workers=4)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        manifests[name] = {"images": m_img, "texts": m_txt}
        with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
            json.dump(manifests[name], fh, indent=2)
    metrics = evaluate_matching(model, mcfg, pair_ds, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = fused_attention_qkv.launches
    layers = mcfg.vision_layers  # == transformer_layers for ViT-B/32
    expected = layers * n_batches * 3  # fp32 embed, bf16 embed, matching
    check(launches == expected, f"attention launches {launches} != {expected}")
    emit({"phase": "serving_launches", "launches": launches, "expected": expected,
          "per_tower_batch": layers})

    # ---- what came out
    summary = {}
    feats_by = {}
    for name in encoders:
        out_dir = os.path.join(out_root, name)
        with open(os.path.join(out_dir, "manifest.json")) as fh:
            check(json.load(fh) == manifests[name], f"{name} manifest round trip")
        for kind, n in (("images", N_IMAGES), ("texts", N_TEXTS)):
            ids, feats = _read_shards(out_dir, manifests[name][kind])
            check(ids == [f"{i:05d}" for i in range(n)], f"{name} {kind} ids in order")
            check(feats.shape == (n, mcfg.embed_dim), f"{name} {kind} shape {feats.shape}")
            check(bool(np.isfinite(feats).all()), f"{name} {kind} finite")
            norm_err = float(np.abs(np.linalg.norm(feats, axis=1) - 1.0).max())
            check(norm_err <= (1e-4 if name == "float32" else 1e-2), f"{name} {kind} unit norm ({norm_err})")
            feats_by[name, kind] = feats
            summary[f"{name}_{kind}_norm_err"] = norm_err
    check(matching_metrics(feats_by["float32", "images"], feats_by["float32", "texts"]) == metrics,
          "evaluate_matching agrees with the metrics of the embedded features")
    check(metrics["num_pairs"] == N_IMAGES, "matching pairs")

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
    with torch.inference_mode():
        for name, enc in encoders.items():
            ms_img = cuda_ms(lambda: enc.encode_images(x_img), iters=20, warmup=3)
            ms_txt = cuda_ms(lambda: enc.encode_texts(x_tok), iters=20, warmup=3)
            rates[name] = {
                "images_per_s": BATCH / ms_img * 1e3, "texts_per_s": BATCH / ms_txt * 1e3,
                "image_batch_ms": ms_img, "text_batch_ms": ms_txt,
                "embed_stream_wall_s": wall[name],
            }
    emit({"phase": "serving", "model": "ViT-B/32", "seed": 0, "init_s": init_s,
          "images": N_IMAGES, "texts": N_TEXTS, "batch": BATCH, "matching": metrics,
          "throughput": rates, **summary})
    with torch.inference_mode():
        for name, enc in encoders.items():
            for kind, fn, x in (("images", enc.encode_images, x_img), ("texts", enc.encode_texts, x_tok)):
                batch_ms = rates[name]["image_batch_ms" if kind == "images" else "text_batch_ms"]
                emit({"phase": "profile", "dtype": name, "tower": kind,
                      **profile_one(lambda: fn(x), batch_ms)})
    return launches


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


def _device_batch(ds, b):
    """The first b examples of `ds` as one batch on the card."""
    ex = [ds[i][0] for i in range(b)]
    batch = {k: np.stack([e[k] for e in ex]) for k in ex[0]}
    batch = ds.finalize_batch({**batch, **ds.batch_extras(b)})
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in batch.items()}


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
    cfg = validate_config({
        "task": "chip_smoke", "constrastive_loss": "ce", "batch_size": TRAIN_BATCH,
        "lr": 1e-6, "optimizer": "adam", "lr_scheduler": "none", "max_epoch": 1,
        "compute_dtype": "bfloat16", "remat": True, "use_pallas_attention": True,
        "seed": 0, "print_freq": n_steps + 1, "num_workers": 8, "prefetch": 2,
        "ckpt_dir": os.path.join(out_root, "ckpt"),
    })

    # ---- the main path, counted: the train loop for warm-up + timed steps
    watch = params["visual"]["transformer"]["attn"]["qkv_w"].detach().clone()
    losses, events = {}, {}

    def on_step(step, metrics):
        losses[step] = metrics["loss"]
        events[step] = torch.cuda.Event(enable_timing=True)
        events[step].record()

    torch.cuda.reset_peak_memory_stats()
    fused_attention_qkv.launches = fused_attention_qkv_bwd.launches = 0
    t0 = time.perf_counter()
    state = train(cfg, mcfg, ds, params, "cuda", on_step=on_step)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {"fwd": fused_attention_qkv.launches, "bwd": fused_attention_qkv_bwd.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    blocks = mcfg.vision_layers + mcfg.transformer_layers
    expected = {"fwd": 2 * blocks * n_steps, "bwd": blocks * BWD_LAUNCHES_PER_CALL * n_steps}
    check(sorted(losses) == list(range(n_steps)), f"train steps {sorted(losses)}")
    check(launches == expected, f"train launches {launches} != {expected}")
    loss_values = [float(losses[i]) for i in range(n_steps)]
    check(all(np.isfinite(loss_values)), f"train losses finite {loss_values}")
    # an untrained model scores every pair alike: CE over the B·D texts of
    # an image plus CE over the B images of a positive text
    chance = math.log(TRAIN_BATCH * D) + math.log(TRAIN_BATCH)
    check(abs(loss_values[0] - chance) < 0.5, f"first loss {loss_values[0]} vs chance {chance}")
    moved = (state.params["visual"]["transformer"]["attn"]["qkv_w"].detach() - watch).abs().max().item()
    check(moved > 0, "the params changed")
    step_ms = [events[i - 1].elapsed_time(events[i]) for i in range(WARMUP_STEPS, n_steps)]
    mean_ms = float(np.mean(step_ms))
    emit({"phase": "train_launches", **{f"{k}_launches": v for k, v in launches.items()},
          "expected": expected, "steps": n_steps, "per_step": {k: v // n_steps for k, v in expected.items()}})

    # ---- kernel step vs plain-attention step from one state and batch
    sched = build_schedule("none", 1e-6, 1)
    compare = {}
    for name, dtype, b in (("bfloat16", torch.bfloat16, TRAIN_BATCH), ("float32", torch.float32, FP32_CHECK_BATCH)):
        batch = _device_batch(ds, b)
        if name == "bfloat16":
            metrics = {}
            for impl in ("kernel", "plain"):
                opt = build_optimizer("adam", sched)
                st = create_train_state(params, opt)
                step = make_train_step(mcfg, opt, compute_dtype=dtype, remat=True, impl=impl)
                _, m = step(st, batch)
                metrics[impl] = {k: float(v) for k, v in m.items()}
                del st
            dl = abs(metrics["kernel"]["loss"] - metrics["plain"]["loss"])
            dg = abs(metrics["kernel"]["grad_norm"] - metrics["plain"]["grad_norm"]) / \
                metrics["plain"]["grad_norm"]
            check(dl <= BF16_STEP_TOL, f"bf16 step: kernel vs plain loss differs by {dl}")
            check(dg <= BF16_STEP_TOL, f"bf16 step: kernel vs plain grad_norm differs by {dg} (relative)")
            compare[name] = {"batch": b, "loss_abs_diff": dl, "grad_norm_rel_diff": dg,
                             "kernel": metrics["kernel"], "plain": metrics["plain"]}
        else:
            grads, loss = {}, {}
            for impl in ("kernel", "plain"):
                st = create_train_state(params, build_optimizer("adam", sched))
                total, _ = loss_fn(st.params, batch, mcfg, compute_dtype=dtype, remat=True, impl=impl)
                grads[impl] = torch.autograd.grad(total, tree_leaves(st.params))
                loss[impl] = total.item()
                del st
            dl = abs(loss["kernel"] - loss["plain"])
            worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                        for a, b in zip(grads["kernel"], grads["plain"]))
            check(dl <= FP32_STEP_TOL, f"fp32 step: kernel vs plain loss differs by {dl}")
            check(worst <= FP32_STEP_TOL, f"fp32 step: a gradient differs by {worst} of its max")
            compare[name] = {"batch": b, "loss_abs_diff": dl, "max_grad_rel_diff": worst}
            del grads

    # ---- one step under the profiler
    batch = _device_batch(ds, TRAIN_BATCH)
    opt = build_optimizer("adam", sched)
    st = {"state": create_train_state(params, opt)}
    step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True)

    def one_step():
        st["state"], _ = step(st["state"], batch)

    prof = profile_one(one_step, mean_ms, kernels=(("attention_fwd", "attention_fwd_kernel"),
                                                   ("attention_bwd", "attention_bwd_")))
    pairs = TRAIN_BATCH * D
    emit({"phase": "train", "model": "ViT-B/32", "seed": 0, "init_s": init_s,
          "batch_images": TRAIN_BATCH, "descriptions_per_image": D, "tokens": mcfg.context_length,
          "compute_dtype": "bfloat16", "remat": "full", "optimizer": "adam", "lr": 1e-6,
          "steps": n_steps, "timed_steps": TIMED_STEPS, "losses": loss_values,
          "step_ms": step_ms, "step_ms_mean": mean_ms,
          "contrastive_pairs_per_sec_per_chip": pairs / mean_ms * 1e3,
          "loop_wall_s": loop_s, "max_memory_allocated_gib": peak_gib,
          "kernel_vs_plain": compare})
    emit({"phase": "train_profile", **prof})
    return launches


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
    check({KERNEL, BWD_KERNEL} <= set(sources), f"kernel sources {sources}")
    seconds = _build.build(sources)
    ptxas = {name: [ln.strip() for ln in _build.BUILD_LOGS.get(name, "").splitlines() if "Used" in ln]
             for name in sources}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": seconds, "ptxas": ptxas})

    rows, errs = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_root:
        serving_launches = phase_serving(out_root)
        train_launches = phase_train(out_root)

    def entry(name, source, replaces, launches, by_path, rows, errs, tol, head):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "head_shape": f"{head['shape']} {head['dtype']}",
            "max_abs_err_by_dtype": errs, "tolerance_by_dtype": tol,
            "by_shape": [r for r in rows if "ms" in r],
        }

    # top-level numbers: the forward at the serving text shape in fp32 (the
    # CLI's dtype), the backward at the train step's text shape in bf16 (the
    # training dtype); by_shape holds every timed shape in both dtypes
    fwd_head = next(r for r in rows["fwd"] if r["shape"] == "text" and r["dtype"] == "float32")
    bwd_head = next(r for r in rows["bwd"] if r["shape"] == "train_text" and r["dtype"] == "bfloat16")
    emit({"kernels": [
        entry(KERNEL, "clip_event_tpu_torch/csrc/attention_fwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:93",
              serving_launches + train_launches["fwd"],
              {"serving": serving_launches, "train": train_launches["fwd"]},
              rows["fwd"], errs["fwd"], TOL, fwd_head),
        entry(BWD_KERNEL, "clip_event_tpu_torch/csrc/attention_bwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:101",
              train_launches["bwd"], {"serving": 0, "train": train_launches["bwd"]},
              rows["bwd"], errs["bwd"], BWD_TOL, bwd_head),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
