#!/usr/bin/env python3
"""Drive the PyTorch port's zero-shot serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   the card's name; needs `torch.cuda.is_available()`
  2. build    compiles every kernel from `clip_event_tpu_torch/csrc/`
  3. kernels  each kernel against its plain PyTorch version at the serving
              shapes and at edge shapes, fp32 (atol 1e-5) and bf16 (atol
              2e-2), and its time beside the plain version's, one PyTorch
              library call's and the bound the card's peak rates give
  4. serving  full-width ViT-B/32 from seed 0 (12 + 12 layers): embed_stream
              over 256 images and 256 token rows into shards and a manifest,
              in fp32 and in bf16, then evaluate_matching; the launch counts
              of that run, checks of the features against a plain-attention
              run of the same model, and images/s and texts/s at batch 64

then the `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi prints them, and a last line `{"ok": true, "device": {...}}`.
Any failed check raises, so the script exits non-zero. With no card it
exits non-zero before printing anything.
"""

from __future__ import annotations

import json
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

from clip_event_tpu_torch.data.common import ExampleDataset
from clip_event_tpu_torch.embed import embed_stream
from clip_event_tpu_torch.evals.cli import load_model_from_cfg
from clip_event_tpu_torch.evals.common import Encoders
from clip_event_tpu_torch.evals.matching import evaluate_matching, matching_metrics
from clip_event_tpu_torch.models.clip import encode_image, encode_text, l2_normalize
from clip_event_tpu_torch.models.layers import causal_mask
from clip_event_tpu_torch.ops import _build
from clip_event_tpu_torch.ops.attention import (
    KERNEL,
    fused_attention_qkv,
    fused_attention_qkv_plain,
)

# the card's published peaks (H100 SXM data sheet, dense): memory, fp32 on
# the CUDA cores, bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

SERVING_SHAPES = [  # (tag, B, S, W, H, causal)
    ("text", 64, 77, 512, 8, True),
    ("vision", 64, 50, 768, 12, False),
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


def phase_kernels():
    def library(qkv, bias, H, scale):
        """One PyTorch call for the same function, after a split (yardstick only)."""
        B, S, W3 = qkv.shape
        q, k, v = qkv.view(B, S, 3, H, W3 // 3 // H).permute(2, 0, 3, 1, 4).unbind(0)
        mask = None if bias is None else bias.to(qkv.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
        return out.transpose(1, 2).reshape(B, S, W3 // 3)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, errs = [], {"float32": 0.0, "bfloat16": 0.0}
    for tag, B, S, W, H, causal in SERVING_SHAPES + EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            qkv = torch.randn((B, S, 3 * W), device="cuda", generator=gen).to(dtype)
            bias = causal_mask(S, device="cuda") if causal else None
            scale = (W // H) ** -0.5
            out = fused_attention_qkv(qkv, bias, H, scale)
            ref = fused_attention_qkv_plain(qkv, bias, H, scale)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == (B, S, W), f"{tag} {name} output shape/dtype")
            check(bool(torch.isfinite(out).all()), f"{tag} {name} output finite")
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= TOL[name], f"{tag} {name}: max abs err {err} > {TOL[name]}")
            errs[name] = max(errs[name], err)
            row = {"shape": tag, "B": B, "S": S, "W": W, "H": H, "causal": causal,
                   "dtype": name, "max_abs_err": err, "tol": TOL[name]}
            if tag in ("text", "vision"):
                row["ms"] = cuda_ms(lambda: fused_attention_qkv(qkv, bias, H, scale))
                row["plain_ms"] = cuda_ms(lambda: fused_attention_qkv_plain(qkv, bias, H, scale))
                lib = library(qkv, bias, H, scale)
                check((lib.float() - ref.float()).abs().max().item() <= 10 * TOL[name],
                      f"{tag} {name}: library yardstick disagrees")
                row["library_ms"] = cuda_ms(lambda: library(qkv, bias, H, scale))
                row["bound_ms"], row["bound_by"] = attention_bound_ms(B, S, W, H, causal, name)
            rows.append(row)
            emit({"phase": "kernel_check", **row})
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
                      **profile_one(fn, x, batch_ms)})
    return launches


def profile_one(fn, x, batch_ms):
    """Device time of one warm fn(x) by kernel (torch.profiler): the busy
    time summed over the kernels themselves (not the aten ops that launch
    them), its share of `batch_ms` (the unprofiled time per batch), and the
    kernels that took most."""
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda k: -k[1],
    )
    if not kernels:
        return {"device_busy_ms": "not measured"}
    busy_ms = sum(k[1] for k in kernels)
    attn = sum(k[1] for k in kernels if "attention_fwd_kernel" in k[0])
    return {
        "batch_ms": batch_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / batch_ms),
        "kernel_launches": sum(k[2] for k in kernels),
        "attention_kernel_ms": attn, "attention_kernel_share_of_busy": attn / busy_ms,
        "top": [{"kernel": k[0][:90], "ms": k[1], "calls": k[2]} for k in kernels[:6]],
    }


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
    seconds = _build.build([KERNEL])
    ptxas = [ln.strip() for ln in _build.BUILD_LOGS.get(KERNEL, "").splitlines() if "Used" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": seconds, "ptxas": ptxas})

    rows, errs = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_root:
        launches = phase_serving(out_root)

    head = next(r for r in rows if r["shape"] == "text" and r["dtype"] == "float32")
    emit({"kernels": [{
        "name": KERNEL,
        "route": "cuda",
        "source": "clip_event_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "clip_event_tpu/ops/attention_pallas.py:93",
        "launches": launches,
        # the top-level numbers are the text-tower shape in fp32 (the CLI's
        # dtype); by_shape holds both serving shapes in both dtypes
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "max_abs_err_by_dtype": errs,
        "tolerance_by_dtype": TOL,
        "by_shape": [r for r in rows if "ms" in r],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
