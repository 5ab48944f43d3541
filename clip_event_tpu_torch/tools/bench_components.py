"""Component-level benchmark of the port: where the train step's and the
encoders' time goes, and which variant wins (counterpart of the repo's
`tools/bench_components.py`).

    python -m clip_event_tpu_torch.tools.bench_components [section ...] [--device cpu]

Sections (default: all), at the JAX tool's shapes: B = 256 images, D = 3
texts an image, ViT-B/32 unless `--model` names another:

  ln           the gradient of a 12-layer stack (text: 768 rows of 77
               tokens, W = 512, causal; vision: 256 rows of 50 tokens,
               W = 768), bf16 activations, every block recomputed in the
               backward pass, with the plain LayerNorm, with the fused
               LayerNorm kernels (K4), and with no LayerNorm at all (the
               ceiling a faster LayerNorm could reach)
  megakernel   the 12-layer forward of LayerNorm → QKV projection →
               attention core at the same shapes, bf16 weights, as the
               unfused chain (plain LayerNorm, `linear`, K1) and as the
               one-kernel fusion (K6)
  matmul       bf16 `torch.matmul` (cuBLAS: the JAX package computes these
               outside Pallas) at the hot shapes: the text fc and qkv
               products over B·D·77 rows, the vision fc over B·50 rows, and
               a square of side 32·B (8192³ at B = 256); ms, TFLOP/s and
               the share of the H100's 989 TFLOP/s dense bf16 peak
  quantgemm    at the vision qkv and fc and the text qkv products (B·50 and
               B·77 rows): a bf16 mm, the plain int8 composition
               (`set_gemm_impl("xla")`), `torch._int_mm` on the quantised
               rows (the library's int8 GEMM, a yardstick), K5 through
               `quantized_linear`, K5's GEMM alone (`quantized_gemm`) and
               its row pass alone (`quantize_rows`). JAX's block-size sweep
               has no counterpart: K5's tiles are fixed in
               `csrc/quant_matmul.cu`
  text         the text tower's gradient (`encode_text`, loss Σ out²·1e-6,
               the gradient of every param leaf) over B·D token rows, bf16,
               under remat False, "full", "dots" and "dots_nobatch" with
               the plain attention, then "full", "attn" and False with the
               kernel (K1)
  vision       the same for `encode_image` on B N(0, 1) float32 images
  visionsplit  the vision stack (B rows of grid² + 1 tokens) split into its
               parts, each block under full remat: the full block with the
               plain and with the kernel attention, the MLP half, the
               attention half (plain, kernel), the matmul skeleton; and the
               patch embedding alone
  step         the full train step (B images × D texts, bf16, full remat,
               Adam, `make_multi_step` with `--steps` steps a call, the
               JAX tool's 3 timed calls) with the plain attention and with
               the kernel: ms a step and pairs/s
  textsplit    the causal text stack (B·D rows of 77 tokens) split the same
               way, the attention through the kernel: the full block, the
               MLP half, the attention half, the matmul skeleton
  textwidth    the text encode forward over 4·B rows (1024 at B = 256) at
               widths 77, 48, 32 and 16 (those that fit the context), bf16,
               in texts/s
  latency      the image encode (normalized features) at B = 1, 8 and 64,
               bf16 and int8 static (the vision tower, calibrated on 8
               images as the JAX tool calibrates): the host p50 of 20
               synchronized calls, and the time a call of calls back to
               back
  quant        both towers' encode (images: B/4 and B; texts: B and 4·B) as
               bf16, int8 dynamic through the plain composition, int8
               static (plain, as in the JAX tool) and int8 through K5, with
               each one's speed-up over bf16; `--model ViT-B/16` or
               `ViT-L/14` in place of JAX's BENCH_QUANT_MODEL
  ot           `ops.ot.optimal_transport_dist` at B × 16 text nodes × 10
               object nodes × 512, 30 % pads, safe=True, as the plain loop
               and through K3
  alignment    the train step with the OT alignment branch on (the step
               section's batch, plus 16 entity texts and `--objects` N(0, 1)
               float32 crops an image, masks at < 0.4; the crops and
               entities encoded in `--align-chunks` slices; the plain OT
               loop, `use_pallas_ot=False`, as the JAX section runs it):
               ms a step, pairs/s and peak memory. `--objects 51` probes the
               JAX package's default object cap: an exception (out of
               memory) becomes a row with no time and the error, never a
               run of another path
  multiattention  the train step with the local-attention branch on
               (`--bboxes` R = 8 boxes an image, sorted corners, mask at <
               0.6, role descriptions and labels [B, R, 77]), in the modes
               "desc" and "desc_type"
  dedupe       the step on B·D text rows drawn from 96 distinct rows in the
               plain layout, against the deduped layout
               (`data/dedupe.py::dedupe_rows`: `text_unique`,
               `text_inverse`) at U of `--dedupe-unique` (96, 192, 384);
               then the multiattention step in both modes plain,
               "sr-deduped" (role and label rows from a 64-row vocabulary)
               and "all-deduped" (the text rows too)
  accum        the single step at B (ms a microbatch) against
               `make_accum_step` at K = 2 and 4 on the batch stacked K
               times, max(4, 3·steps // K) timed calls (3: `--calls`): ms
               a microbatch and the change against the single step. The
               accumulated step has no graph path (the train config
               refuses `steps_per_dispatch` with `grad_accum_steps`): it
               runs eager
  ckpt         the state's size (fp32 params and Adam's moments), then a
               warm step and a warm save, then `save_checkpoint` sync and
               with `async_save`: the save's return time, and the total of
               the save, `--steps` steps issued behind it and
               `wait_for_saves()`, on the host's clock (the steps end in a
               host fetch); the files go to a temporary directory that is
               removed after
  moments      Adam with fp32 and with bf16 first moments
               (`build_optimizer(moment_dtype=...)`): the optimizer state's
               MB and ms a step

Every attention, int8 GEMM and OT variant named "kernel" / K5 / K3 reaches
the kernel through the port's own switches (`layers.attention_impl`,
`quant.gemm_impl`, `use_pallas`); a shape a kernel does not take is
reported as unsupported, never run on another path under its label. The
six branch and engine sections (`alignment` to `moments`) run the train
step with the attention kernel (`impl="kernel"`), bf16, full remat, Adam
at lr 1e-6, as the step section does; the branch steps (alignment,
multiattention, and dedupe's multiattention rows) run min(`--steps`, 3)
steps a call over 2 timed calls (the JAX sections' 3 and 2); `--calls`
sets the timed calls of every step section (step, the branch steps, the
plain and deduped steps, accum's single step, moments). JAX's
`unroll` section has no counterpart: it tunes `lax.scan`'s unroll factor,
and the port's stacks are Python loops. Each section builds its timed
callable in a small function (`*_call`) that takes `dtype` (bf16 unless
the JAX section feeds fp32) and returns what it computes, so it can be held
against the JAX expression the JAX section times.

On the card a row is the mean device time of `--steps` iterations between
CUDA events after a warm-up call; on the CPU (a rehearsal of the path at a
small size, e.g. `--batch 2 --layers 1 --steps 1`) it is the host clock.
Prints one line per row, then one JSON line with all rows, the device and,
on the card, its name and power limit as `nvidia-smi` prints them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from clip_event_tpu_torch.config import model_config
from clip_event_tpu_torch.data.dedupe import dedupe_rows
from clip_event_tpu_torch.data.labels import build_label_layout
from clip_event_tpu_torch.engine.checkpoint import save_checkpoint, wait_for_saves
from clip_event_tpu_torch.engine.optim import build_optimizer, build_schedule, tree_leaves, tree_unflatten
from clip_event_tpu_torch.engine.train_step import create_train_state, make_accum_step, make_multi_step
from clip_event_tpu_torch.evals.common import Encoders
from clip_event_tpu_torch.models import layers, vit
from clip_event_tpu_torch.models.clip import encode_image, encode_text, init_params
from clip_event_tpu_torch.ops import ot, quant
from clip_event_tpu_torch.ops.attention import (
    core_kernel,
    fused_attention_qkv,
    fused_ln_qkv_attention,
    megakernel_supported,
)
from clip_event_tpu_torch.parallel.sharding import tree_bytes
from clip_event_tpu_torch.platform import resolve_device

B = 256
D = 3
STEPS = 10
CALLS = 3  # the step sections' timed calls (the JAX tool's CALLS; `--calls`)
SECTIONS = ("ln", "megakernel", "matmul", "quantgemm", "text", "vision", "visionsplit", "step",
            "textsplit", "textwidth", "latency", "quant", "ot", "alignment", "multiattention", "dedupe",
            "accum", "ckpt", "moments")
H100_BF16_TFLOPS = 989.0  # the H100 SXM's dense bf16 tensor-core peak
PEAK_SIDE = 32  # the matmul section's square: 32·B a side (8192 at B = 256)
TOWER_VARIANTS = (  # (label, remat, attention impl)
    ("no remat", False, "plain"), ("remat full", "full", "plain"), ("remat dots", "dots", "plain"),
    ("remat dots_nobatch", "dots_nobatch", "plain"), ("remat full + kernel", "full", "kernel"),
    ("remat attn + kernel", "attn", "kernel"), ("no remat + kernel", False, "kernel"),
)
VISIONSPLIT = ("full block (plain attn)", "full block (kernel attn)", "mlp half",
               "attention half (plain)", "attention half (kernel)", "matmul skeleton")
TEXTSPLIT = ("full block (kernel attn)", "mlp half", "attention half (kernel)", "matmul skeleton")
TEXT_WIDTHS = (77, 48, 32, 16)
LATENCY_BATCHES, LATENCY_CALLS = (1, 8, 64), 20
QUANT_VARIANTS = (("bf16", "xla"), ("int8 dynamic plain", "xla"), ("int8 static plain", "xla"),
                  ("int8 K5", "pallas"))  # (label, quant.gemm_impl)
OT_NODES, OT_PAD = (16, 10, 512), 0.3  # text nodes, object nodes, width; pad share
# the branch steps: at most 3 steps a call, 2 timed calls (the JAX sections';
# `--calls`)
BRANCH_STEPS, BRANCH_CALLS = 3, 2
# alignment: entity texts an image (the max_entities cap), crops an image
# (BENCH_OBJ), chunks (BENCH_ALIGN_CHUNKS); the masks' keep rates
ALIGN_ENTITIES, ALIGN_OBJECTS, ALIGN_CHUNKS, ALIGN_KEEP = 16, 11, 4, 0.4
BBOXES, BBOX_KEEP = 8, 0.6  # multiattention: boxes an image (BENCH_BBOXES)
MULTIATTENTION_MODES = ("desc", "desc_type")
# dedupe: the unique rows of the deduped layouts (BENCH_DEDUPE_UNIQUE), the
# plain layout's text vocabulary, the role and label vocabulary
DEDUPE_UNIQUE, DEDUPE_TEXT_VOCAB, DEDUPE_ROLE_VOCAB = (96, 192, 384), 96, 64
ACCUM_KS = (2, 4)
MOMENT_DTYPES = (None, "bfloat16")


def tower_shapes(mcfg, batch: int, n_layers: Optional[int] = None):
    """(tower, layers, W, heads, S, rows, causal) of the two stacks."""
    return [
        ("text", n_layers or mcfg.transformer_layers, mcfg.transformer_width,
         mcfg.transformer_heads, mcfg.context_length, batch * D, True),
        ("vision", n_layers or mcfg.vision_layers, mcfg.vision_width, mcfg.vision_heads,
         mcfg.grid_size ** 2 + 1, batch, False),
    ]


def _time_ms(fn: Callable[[], object], steps: int, device: torch.device) -> float:
    """Mean time of fn() in ms after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - t0) / steps * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_shape_error(S: int, W: int, H: int) -> Optional[str]:
    """Why no attention kernel takes this shape, or None when one does."""
    try:
        core_kernel(S, W, H)
    except ValueError as e:
        return str(e)
    return None


def _with_layers(mcfg, n_layers: Optional[int]):
    """The model with `n_layers` blocks a tower (the model's when None)."""
    if not n_layers:
        return mcfg
    return dataclasses.replace(mcfg, transformer_layers=n_layers,
                               vision_layers=n_layers if mcfg.is_vit else mcfg.vision_layers)


def _params(mcfg, device) -> dict:
    return init_params(torch.Generator().manual_seed(0), mcfg, device)


def _gen(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def text_tokens(mcfg, n: int, width: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, width] random token ids, EOT (the last id) in the last slot: the
    JAX tool's `_text_inputs`."""
    tokens = torch.randint(1, min(49000, mcfg.vocab_size - 1), (n, width), generator=gen,
                           device=device, dtype=torch.int32)
    tokens[:, -1] = mcfg.vocab_size - 1
    return tokens


def caption_tokens(mcfg, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, context] captions of 9 random ids between SOT and EOT (the last
    two ids), zeros after: the JAX quant section's token rows."""
    body = min(9, mcfg.context_length - 2)
    tokens = torch.zeros((n, mcfg.context_length), dtype=torch.int32, device=device)
    tokens[:, 0] = mcfg.vocab_size - 2
    tokens[:, 1:1 + body] = torch.randint(1, min(49000, mcfg.vocab_size - 2), (n, body),
                                          generator=gen, device=device, dtype=torch.int32)
    tokens[:, 1 + body] = mcfg.vocab_size - 1
    return tokens


def images(mcfg, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n, res, res, 3] N(0, 1) float32 images (the JAX tool's)."""
    res = mcfg.image_resolution
    return torch.randn((n, res, res, 3), generator=gen, device=device)


def _row(section, case, variant, ms, **extra) -> dict:
    return {"section": section, "case": case, "variant": variant, "ms_per_iter": ms, **extra}


def _unsupported(section, case, variant, reason, **extra) -> dict:
    return _row(section, case, variant, None, unsupported=reason, **extra)


# ------------------------------------------------------------------ ln


def _ln_free_block(x, params, num_heads, attn_bias):
    """`residual_block` with both LayerNorms taken out."""
    x = x + layers.multi_head_attention(x, params["attn"], num_heads, attn_bias)
    h = layers.quick_gelu(layers.linear(x, params["mlp"]["fc_w"], params["mlp"]["fc_b"]))
    return x + layers.linear(h, params["mlp"]["proj_w"], params["mlp"]["proj_b"])


def _ln_free_stack(x, stacked, num_heads, attn_bias):
    for i in range(stacked["attn"]["qkv_w"].shape[0]):
        x = checkpoint(_ln_free_block, x, layers._layer(stacked, i), num_heads, attn_bias,
                       use_reentrant=False)
    return x


def _leaves(tree) -> list:
    return [t for v in tree.values() for t in (_leaves(v) if isinstance(v, dict) else [v])]


def bench_ln(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    """The stack gradient (value and every param's gradient of
    sum(out²)·1e-6) with the plain LayerNorm, the fused kernels, and no
    LayerNorm, both towers."""
    device = resolve_device(device)
    rows = []
    for tower, L, W, H, S, n, causal in tower_shapes(mcfg, batch, n_layers):
        gen = torch.Generator().manual_seed(0)
        stacked = layers.init_transformer(gen, L, W)
        stacked = {k: {kk: vv.to(device).requires_grad_(True) for kk, vv in v.items()}
                   for k, v in stacked.items()}
        x = torch.randn((n, S, W), generator=gen).to(device=device, dtype=torch.bfloat16)
        bias = layers.causal_mask(S, device=device) if causal else None
        leaves = _leaves(stacked)
        variants = (
            ("plain LN", lambda: layers.transformer(x, stacked, H, bias, remat=True, ln="xla")),
            ("fused LN kernels", lambda: layers.transformer(x, stacked, H, bias, remat=True, ln="pallas")),
            ("LN-free ceiling", lambda: _ln_free_stack(x, stacked, H, bias)),
        )
        for name, fwd in variants:
            def grad_step(_fwd=fwd):
                loss = (_fwd().float() ** 2).sum() * 1e-6
                torch.autograd.grad(loss, leaves, allow_unused=True)

            rows.append({"section": "ln", "tower": tower, "variant": name, "layers": L, "rows": n,
                         "S": S, "W": W, "ms_per_iter": _time_ms(grad_step, steps, device)})
    return rows


def bench_megakernel(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    """The L-layer forward of LayerNorm → QKV projection → attention core,
    unfused (plain LayerNorm, `linear`, K1) against the megakernel (K6),
    bf16 weights and activations, both towers."""
    device = resolve_device(device)
    rows = []
    for tower, L, W, H, S, n, causal in tower_shapes(mcfg, batch, n_layers):
        if not megakernel_supported(S, W, H):
            rows.append({"section": "megakernel", "tower": tower, "variant": "unsupported shape",
                         "S": S, "W": W, "H": H, "ms_per_iter": None})
            continue
        gen = torch.Generator().manual_seed(0)
        stacked = layers.init_transformer(gen, L, W)
        stacked = {k: {kk: vv.to(device=device, dtype=torch.bfloat16) for kk, vv in v.items()}
                   for k, v in stacked.items()}
        x = torch.randn((n, S, W), generator=gen).to(device=device, dtype=torch.bfloat16)
        bias = layers.causal_mask(S, device=device) if causal else None
        scale = (W // H) ** -0.5

        def unfused(h, lp):
            qkv = layers.linear(layers.layer_norm(h, lp["ln_1"]), lp["attn"]["qkv_w"], lp["attn"]["qkv_b"])
            return fused_attention_qkv(qkv, bias, H, scale)

        def mega(h, lp):
            return fused_ln_qkv_attention(h, lp["ln_1"]["scale"], lp["ln_1"]["bias"],
                                          lp["attn"]["qkv_w"], lp["attn"]["qkv_b"], bias, H, scale)

        for name, layer in (("ln+qkv+core unfused", unfused), ("ln+qkv+core megakernel", mega)):
            def forward(_layer=layer):
                with torch.no_grad():
                    h = x
                    for i in range(L):
                        h = _layer(h, layers._layer(stacked, i))

            rows.append({"section": "megakernel", "tower": tower, "variant": name, "layers": L,
                         "rows": n, "S": S, "W": W, "H": H,
                         "ms_per_iter": _time_ms(forward, steps, device)})
    return rows


# ------------------------------------------------------------ products


def matmul_shapes(mcfg, batch: int = B):
    """(name, M, K, N) of the matmul section's four products."""
    text_rows, vis_rows = batch * D * mcfg.context_length, batch * (mcfg.grid_size ** 2 + 1)
    Wt, Wv, side = mcfg.transformer_width, mcfg.vision_width, PEAK_SIDE * batch
    return [("text fc", text_rows, Wt, 4 * Wt), ("text qkv", text_rows, Wt, 3 * Wt),
            ("vis fc", vis_rows, Wv, 4 * Wv), ("peak", side, side, side)]


def matmul_call(a: torch.Tensor, b: torch.Tensor, dtype=torch.bfloat16) -> Callable[[], torch.Tensor]:
    """a @ b in `dtype` (JAX: `jnp.dot`)."""
    a, b = a.to(dtype), b.to(dtype)
    return lambda: torch.matmul(a, b)


def bench_matmul(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    device = resolve_device(device)
    gen, rows = _gen(device), []
    for name, m, k, n in matmul_shapes(mcfg, batch):
        a = torch.randn((m, k), generator=gen, device=device)
        b = torch.randn((k, n), generator=gen, device=device)
        ms = _time_ms(matmul_call(a, b), steps, device)
        tflops = 2 * m * k * n / ms / 1e9
        rows.append(_row("matmul", name, "torch.matmul bf16", ms, shape=[m, k, n], tflops=tflops,
                         share_of_h100_bf16_peak=tflops / H100_BF16_TFLOPS if device.type == "cuda" else None))
        del a, b
    return rows


def quantgemm_shapes(mcfg, batch: int = B):
    """(name, M, K, N) of the quantgemm section's three products."""
    vis_rows, text_rows = batch * (mcfg.grid_size ** 2 + 1), batch * mcfg.context_length
    Wv, Wt = mcfg.vision_width, mcfg.transformer_width
    return [("vis qkv", vis_rows, Wv, 3 * Wv), ("vis fc", vis_rows, Wv, 4 * Wv),
            ("text qkv", text_rows, Wt, 3 * Wt)]


def quantgemm_calls(x: torch.Tensor, w: torch.Tensor, dtype=torch.bfloat16) -> Dict[str, Callable]:
    """The quantgemm section's callables on x [M, K] and a float weight w
    [K, N] (quantized per output channel), by variant. Building them runs
    K5's row pass once (the GEMM alone takes its rows)."""
    x, wd, qw = x.to(dtype), w.to(dtype), quant.quantize_weight(w.float())
    xq, row_scale = quant.quantize_rows(x)
    xq_k = xq[:, :w.shape[0]].contiguous()

    def linear(gemm):
        def call():
            with quant.gemm_impl(gemm):
                return quant.quantized_linear(x, qw)
        return call

    return {
        "mm": lambda: torch.matmul(x, wd),
        "int8 plain": linear("xla"),
        "torch._int_mm": lambda: torch._int_mm(xq_k, qw.q),
        "K5": linear("pallas"),
        "K5 GEMM alone": lambda: quant.quantized_gemm(xq, row_scale, qw.q, qw.scale, None, dtype),
        "K5 row pass": lambda: quant.quantize_rows(x),
    }


def bench_quantgemm(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    device = resolve_device(device)
    gen, rows = _gen(device), []
    for name, m, k, n in quantgemm_shapes(mcfg, batch):
        x = torch.randn((m, k), generator=gen, device=device)
        w = torch.randn((k, n), generator=gen, device=device)
        for variant, fn in quantgemm_calls(x, w).items():
            try:
                ms = _time_ms(fn, steps, device)
            except RuntimeError as e:  # the library call's own shape rules
                if variant != "torch._int_mm":
                    raise
                rows.append(_unsupported("quantgemm", name, variant, str(e).splitlines()[0], shape=[m, k, n]))
                continue
            ops = None if variant == "K5 row pass" else 2 * m * k * n / ms / 1e9
            rows.append(_row("quantgemm", name, variant, ms, shape=[m, k, n], tera_ops_per_s=ops))
    return rows


# -------------------------------------------------------------- towers


def tower_grad_call(params: dict, mcfg, inputs: torch.Tensor, tower: str, remat, impl: str,
                    dtype=torch.bfloat16) -> Callable:
    """The gradient of Σ out²·1e-6 of `encode_text` (tower "text", token
    rows) or `encode_image` ("vision", images) at `dtype`, over every leaf
    of `params` (fresh leaves on the same storage); the callable returns
    (loss, grads), None for a leaf the tower does not read."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    params = tree_unflatten(params, leaves)
    encode = encode_text if tower == "text" else encode_image

    def call():
        out = encode(params, mcfg, inputs, compute_dtype=dtype, impl=impl, remat=remat)
        loss = (out.float() ** 2).sum() * 1e-6
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)

    return call


def _bench_tower(tower, mcfg, batch, n_layers, steps, device) -> List[dict]:
    device = resolve_device(device)
    mcfg = _with_layers(mcfg, n_layers)
    gen = _gen(device)
    if tower == "text":
        inputs = text_tokens(mcfg, batch * D, mcfg.context_length, gen, device)
        S, W, H = mcfg.context_length, mcfg.transformer_width, mcfg.transformer_heads
    else:
        inputs = images(mcfg, batch, gen, device)
        S, W, H = mcfg.grid_size ** 2 + 1, mcfg.vision_width, mcfg.vision_heads
    params, why, rows = _params(mcfg, device), _kernel_shape_error(S, W, H), []
    for label, remat, impl in TOWER_VARIANTS:
        if impl == "kernel" and why:
            rows.append(_unsupported(tower, f"{tower} grad", label, why))
            continue
        ms = _time_ms(tower_grad_call(params, mcfg, inputs, tower, remat, impl), steps, device)
        rows.append(_row(tower, f"{tower} grad", label, ms, rows=int(inputs.shape[0]), S=S, W=W))
    return rows


def bench_text(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    return _bench_tower("text", mcfg, batch, n_layers, steps, device)


def bench_vision(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    return _bench_tower("vision", mcfg, batch, n_layers, steps, device)


# -------------------------------------------------------------- splits


def split_blocks(num_heads: int, attn_bias: Optional[torch.Tensor]) -> Dict[str, Callable]:
    """The parts of a residual block a split section times, each (h, layer
    params) → h, as the JAX tool builds them."""
    L = layers

    def mlp(h, lp):
        hh = L.linear(L.layer_norm(h, lp["ln_2"]), lp["mlp"]["fc_w"], lp["mlp"]["fc_b"])
        return h + L.linear(L.quick_gelu(hh), lp["mlp"]["proj_w"], lp["mlp"]["proj_b"])

    def skeleton(h, lp):
        """The block's matmuls with no LayerNorm, softmax or GELU (numerically
        meaningless, shape-identical)."""
        q = L.linear(h, lp["attn"]["qkv_w"], lp["attn"]["qkv_b"])[..., :h.shape[-1]]
        q = L.linear(q, lp["attn"]["out_w"], lp["attn"]["out_b"])
        hh = L.linear(h + q, lp["mlp"]["fc_w"], lp["mlp"]["fc_b"])
        return h + L.linear(hh, lp["mlp"]["proj_w"], lp["mlp"]["proj_b"])

    def block(impl):
        return lambda h, lp: L.residual_block(h, lp, num_heads, attn_bias, impl)

    def attention(impl):
        return lambda h, lp: h + L.multi_head_attention(L.layer_norm(h, lp["ln_1"]), lp["attn"],
                                                        num_heads, attn_bias, impl)

    return {"full block (plain attn)": block("plain"), "full block (kernel attn)": block("kernel"),
            "mlp half": mlp, "attention half (plain)": attention("plain"),
            "attention half (kernel)": attention("kernel"), "matmul skeleton": skeleton}


def stack_grad_call(stacked: dict, x: torch.Tensor, block: Callable, dtype=torch.bfloat16) -> Callable:
    """The gradient of Σ out²·1e-6 over the stack's params, each block
    under full remat (a checkpoint around it), on x cast to `dtype`; the
    callable returns (loss, grads), None for a leaf the block does not
    read."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(stacked)]
    stacked = tree_unflatten(stacked, leaves)
    x = x.to(dtype)
    n_layers = stacked["attn"]["qkv_w"].shape[0]

    def call():
        h = x
        for i in range(n_layers):
            h = checkpoint(block, h, layers._layer(stacked, i), use_reentrant=False,
                           preserve_rng_state=False)
        loss = (h.float() ** 2).sum() * 1e-6
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)

    return call


def patch_embed_grad_call(w: torch.Tensor, imgs: torch.Tensor, patch: int, dtype=torch.bfloat16) -> Callable:
    """The gradient of Σ out²·1e-6 of the patch embedding (`vit.patch_embed`
    on the images cast to `dtype`) over its weight; returns (loss, grad)."""
    w = w.detach().requires_grad_(True)
    imgs = imgs.to(dtype)

    def call():
        loss = (vit.patch_embed(imgs, w, patch).float() ** 2).sum() * 1e-6
        return loss, torch.autograd.grad(loss, [w])[0]

    return call


def _bench_split(section, names, tower, mcfg, batch, n_layers, steps, device) -> List[dict]:
    device = resolve_device(device)
    _, L, W, H, S, n, causal = next(t for t in tower_shapes(mcfg, batch, n_layers) if t[0] == tower)
    stacked = {k: {kk: vv.to(device) for kk, vv in v.items()}
               for k, v in layers.init_transformer(torch.Generator().manual_seed(0), L, W).items()}
    x = torch.randn((n, S, W), generator=_gen(device), device=device)
    blocks = split_blocks(H, layers.causal_mask(S, device=device) if causal else None)
    why, rows = _kernel_shape_error(S, W, H), []
    for name in names:
        if "kernel" in name and why:
            rows.append(_unsupported(section, f"{tower} stack", name, why))
            continue
        ms = _time_ms(stack_grad_call(stacked, x, blocks[name]), steps, device)
        rows.append(_row(section, f"{tower} stack", name, ms, layers=L, rows=n, S=S, W=W))
    return rows


def bench_visionsplit(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    rows = _bench_split("visionsplit", VISIONSPLIT, "vision", mcfg, batch, n_layers, steps, device)
    device = resolve_device(device)
    w = _params(mcfg, device)["visual"]["patch_embed_w"]
    call = patch_embed_grad_call(w, images(mcfg, batch, _gen(device), device), mcfg.vision_patch_size)
    rows.append(_row("visionsplit", "vision", "patch embed only", _time_ms(call, steps, device), rows=batch))
    return rows


def bench_textsplit(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    return _bench_split("textsplit", TEXTSPLIT, "text", mcfg, batch, n_layers, steps, device)


# ---------------------------------------------------------------- step


def step_batch(mcfg, batch: int, device) -> Dict[str, torch.Tensor]:
    """The step section's batch: `batch` N(0, 1) float32 images, batch·D
    token rows, the "ce" label layout (1 positive, D - 1 negatives)."""
    gen = _gen(device)
    layout = build_label_layout(batch, 1, D - 1, "ce", True)
    out = {"image": images(mcfg, batch, gen, device),
           "text": text_tokens(mcfg, batch * D, mcfg.context_length, gen, device)}
    for k in ("labels_per_image", "labels_per_text", "index_pos"):
        out[k] = torch.as_tensor(getattr(layout, k)).to(device)
    return out


def step_call(mcfg, params: dict, batch: Dict[str, torch.Tensor], impl: str, steps: int,
              dtype=torch.bfloat16, moment_dtype: Optional[str] = None, **step_kwargs) -> Callable:
    """`steps` train steps a call (`make_multi_step`'s `many_fixed` on one
    batch) from a fresh state of `params`: "ce", overbatch, full remat,
    Adam at lr 1e-6 (its first moment in `moment_dtype`), and
    `step_kwargs` (the alignment and multiattention branches); the
    callable returns the [steps] metrics, and its `state[0]` is the state
    it has stepped to."""
    optimizer = build_optimizer("adam", build_schedule("none", 1e-6, 30), moment_dtype=moment_dtype)
    state = [create_train_state(params, optimizer)]
    _, run_k = make_multi_step(mcfg, optimizer, steps, loss_type="ce", overbatch=True,
                               compute_dtype=dtype, remat=True, impl=impl, **step_kwargs)

    def call():
        state[0], metrics = run_k(state[0], batch)
        return metrics

    call.state = state
    return call


def _step_shape_error(mcfg) -> Optional[str]:
    """Why no attention kernel takes one of the train step's towers, or None."""
    why = _kernel_shape_error(mcfg.context_length, mcfg.transformer_width, mcfg.transformer_heads)
    if mcfg.is_vit:
        why = why or _kernel_shape_error(mcfg.grid_size ** 2 + 1, mcfg.vision_width, mcfg.vision_heads)
    return why


def _release(device) -> None:
    """Wait for the card and return its cached blocks: a step's graph pool
    goes with its graph."""
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def bench_step(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda", calls=None) -> List[dict]:
    device = resolve_device(device)
    calls = calls or CALLS
    mcfg = _with_layers(mcfg, n_layers)
    params, data, rows = _params(mcfg, device), step_batch(mcfg, batch, device), []
    why = _step_shape_error(mcfg)
    for impl in ("plain", "kernel"):
        label = f"train step ({impl} attention)"
        if impl == "kernel" and why:
            rows.append(_unsupported("step", "step", label, why))
            continue
        ms = _time_ms(step_call(mcfg, params, data, impl, steps), calls, device) / steps
        rows.append(_row("step", "step", label, ms, batch=batch, steps_per_call=steps, calls=calls,
                         pairs_per_s=batch * D / ms * 1e3))
        _release(device)
    return rows


# ------------------------------------------------------------- encodes


def text_encode_call(params: dict, mcfg, tokens: torch.Tensor, dtype=torch.bfloat16) -> Callable:
    """The text tower's forward (`encode_text`, no normalization) with the
    attention kernel, no autograd."""
    def call():
        with torch.no_grad():
            return encode_text(params, mcfg, tokens, compute_dtype=dtype, impl="kernel")

    return call


def bench_textwidth(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    device = resolve_device(device)
    mcfg = _with_layers(mcfg, n_layers)
    params, gen, rows, n = _params(mcfg, device), _gen(device), [], 4 * batch
    why = _kernel_shape_error(mcfg.context_length, mcfg.transformer_width, mcfg.transformer_heads)
    for width in [w for w in TEXT_WIDTHS if w <= mcfg.context_length] or [mcfg.context_length]:
        if why:
            rows.append(_unsupported("textwidth", f"B={n}", f"width {width}", why))
            continue
        tokens = text_tokens(mcfg, n, width, gen, device)
        ms = _time_ms(text_encode_call(params, mcfg, tokens), steps, device)
        rows.append(_row("textwidth", f"B={n}", f"width {width}", ms, rows=n, width=width,
                         items_per_s=n / ms * 1e3))
    return rows


def encode_call(params: dict, mcfg, x: torch.Tensor, tower: str, gemm: str = "pallas",
                dtype=torch.bfloat16) -> Callable:
    """The serving encode (`evals.common.Encoders`: normalized features) of
    images (tower "image") or token rows ("text"), with the attention
    kernel and the int8 GEMM `gemm` (`quant.gemm_impl`) for an int8 tree,
    under inference mode."""
    enc = Encoders(params, mcfg, batch_size=x.shape[0], compute_dtype=dtype, device=x.device)
    encode = enc.encode_images if tower == "image" else enc.encode_texts

    def call():
        with torch.inference_mode(), layers.attention_impl("kernel"), quant.gemm_impl(gemm):
            return encode(x)

    return call


def _encode_shape_error(mcfg, tower: str) -> Optional[str]:
    if tower == "text":
        return _kernel_shape_error(mcfg.context_length, mcfg.transformer_width, mcfg.transformer_heads)
    if not mcfg.is_vit:
        return None
    return _kernel_shape_error(mcfg.grid_size ** 2 + 1, mcfg.vision_width, mcfg.vision_heads)


def static_int8_params(params: dict, mcfg, calib_images, calib_tokens, towers=None) -> dict:
    """The int8 tree with static activation scales calibrated on one image
    and one token batch (`calibrate_act_scales`), as the JAX tool makes it."""
    stats = quant.calibrate_act_scales(params, mcfg, [calib_images],
                                       [] if calib_tokens is None else [calib_tokens])
    return quant.quantize_params(params, act_stats=stats, towers=towers)


def bench_latency(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    device = resolve_device(device)
    mcfg = _with_layers(mcfg, n_layers)
    params, gen, rows = _params(mcfg, device), _gen(device), []
    sparams = static_int8_params(params, mcfg, images(mcfg, 8, gen, device), None, towers=("visual",))
    why = _encode_shape_error(mcfg, "image")
    for label, p in (("bf16", params), ("int8 static", sparams)):
        for bs in LATENCY_BATCHES:
            if why:
                rows.append(_unsupported("latency", f"B={bs}", label, why))
                continue
            fn = encode_call(p, mcfg, images(mcfg, bs, gen, device), "image")
            fn()
            _sync(device)
            times = []
            for _ in range(LATENCY_CALLS):
                t0 = time.perf_counter()
                fn()
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            ms = _time_ms(fn, steps, device)
            rows.append(_row("latency", f"B={bs}", label, ms, rows=bs,
                             host_p50_ms=sorted(times)[len(times) // 2], items_per_s=bs / ms * 1e3))
    return rows


def bench_quant(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    device = resolve_device(device)
    mcfg = _with_layers(mcfg, n_layers)
    params, gen, rows = _params(mcfg, device), _gen(device), []
    trees = {"bf16": params, "int8 dynamic plain": quant.quantize_params(params),
             "int8 static plain": static_int8_params(params, mcfg, images(mcfg, 16, gen, device),
                                                     caption_tokens(mcfg, 16, gen, device))}
    trees["int8 K5"] = trees["int8 dynamic plain"]
    for tower, n in (("image", max(1, batch // 4)), ("image", batch), ("text", batch), ("text", 4 * batch)):
        case, why = f"{tower} B={n}", _encode_shape_error(mcfg, tower)
        if why:
            rows.extend(_unsupported("quant", case, label, why) for label, _ in QUANT_VARIANTS)
            continue
        x = images(mcfg, n, gen, device) if tower == "image" else caption_tokens(mcfg, n, gen, device)
        bf16_ms = None
        for label, gemm in QUANT_VARIANTS:
            ms = _time_ms(encode_call(trees[label], mcfg, x, tower, gemm), steps, device)
            bf16_ms = bf16_ms or ms
            rows.append(_row("quant", case, label, ms, rows=n, items_per_s=n / ms * 1e3,
                             speedup_vs_bf16=bf16_ms / ms))
    return rows


# ------------------------------------------------------------------ ot


def ot_inputs(batch: int, gen: torch.Generator, device):
    """txt [B, 16, 512], img [B, 10, 512] N(0, 1); pads with probability
    0.3, node 0 never padded."""
    M, N, E = OT_NODES
    txt = torch.randn((batch, M, E), generator=gen, device=device)
    img = torch.randn((batch, N, E), generator=gen, device=device)
    txt_pad = torch.rand((batch, M), generator=gen, device=device) < OT_PAD
    img_pad = torch.rand((batch, N), generator=gen, device=device) < OT_PAD
    txt_pad[:, 0] = False
    img_pad[:, 0] = False
    return txt, img, txt_pad, img_pad


def ot_call(txt, img, txt_pad, img_pad, use_kernel: bool, dtype=torch.float32) -> Callable:
    """`optimal_transport_dist(..., safe=True)` on embeddings in `dtype`
    (fp32: the JAX section's), the plain loop or K3."""
    txt, img = txt.to(dtype), img.to(dtype)
    return lambda: ot.optimal_transport_dist(txt, img, txt_pad, img_pad, safe=True, use_pallas=use_kernel)


def bench_ot(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    device = resolve_device(device)
    inputs = ot_inputs(batch, _gen(device), device)
    M, N, E = OT_NODES
    return [_row("ot", f"B={batch} M={M} N={N} E={E}", label,
                 _time_ms(ot_call(*inputs, use_kernel), steps, device))
            for label, use_kernel in (("ipot dist, plain loop", False), ("ipot dist, K3", True))]


# ------------------------------------------------- branches and engine


def branch_steps(steps: int) -> int:
    """Steps a call of a branch step: `steps`, at most BRANCH_STEPS."""
    return min(steps, BRANCH_STEPS)


def _peak_gib(device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None


def _error(e: Exception) -> str:
    """The error's type and first line (what the JAX sections print after
    FAILED)."""
    return f"{type(e).__name__}: {(str(e).splitlines() or [''])[0]}"


def _time_step(section, case, variant, make, steps, calls, batch, device, extra) -> dict:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ms = _time_ms(make(), calls, device) / steps
    return _row(section, case, variant, ms, batch=batch, steps_per_call=steps, calls=calls,
                pairs_per_s=batch * D / ms * 1e3, peak_gib=_peak_gib(device), **extra)


def _step_rows(section, mcfg, batch, device, cases, catch=False) -> List[dict]:
    """A row for each case (case, variant, make() → a step callable, steps
    a call, timed calls, extra fields): ms a step, pairs/s and the peak
    memory of the call (None on the CPU). A model that no attention kernel
    takes gives unsupported rows; with `catch`, a case that raises gives a
    row with no time and the error (the JAX sections print FAILED), never a
    run on another path."""
    why, rows = _step_shape_error(mcfg), []
    for case, variant, make, steps, calls, extra in cases:
        if why:
            rows.append(_unsupported(section, case, variant, why, **extra))
            continue
        try:
            rows.append(_time_step(section, case, variant, make, steps, calls, batch, device, extra))
        except Exception as e:  # noqa: BLE001 (any error, as the JAX sections catch)
            if not catch:
                raise
            rows.append(_row(section, case, variant, None, error=_error(e), **extra))
        _release(device)
    return rows


def alignment_batch(mcfg, batch: int, objects: int, device) -> Dict[str, torch.Tensor]:
    """The step section's batch and the OT branch's inputs: `objects`
    N(0, 1) float32 crops and ALIGN_ENTITIES entity token rows (random
    ids, EOT last) an image, and their masks (kept with probability
    ALIGN_KEEP)."""
    out = step_batch(mcfg, batch, device)
    gen = torch.Generator(device=device).manual_seed(1)
    res, ctx, M = mcfg.image_resolution, mcfg.context_length, ALIGN_ENTITIES
    out["object_image"] = torch.randn((batch, objects, res, res, 3), generator=gen, device=device)
    out["entity_text"] = text_tokens(mcfg, batch * M, ctx, gen, device).reshape(batch, M, ctx)
    out["entity_mask"] = torch.rand((batch, M), generator=gen, device=device) < ALIGN_KEEP
    out["object_mask"] = torch.rand((batch, objects), generator=gen, device=device) < ALIGN_KEEP
    return out


def alignment_call(mcfg, params: dict, batch: Dict[str, torch.Tensor], steps: int,
                   chunks: int = ALIGN_CHUNKS, dtype=torch.bfloat16) -> Callable:
    """`step_call` with the OT branch on: the crops and entities encoded in
    `chunks` slices, the plain OT loop (`use_pallas_ot=False`, the JAX
    section's)."""
    return step_call(mcfg, params, batch, "kernel", steps, dtype, alignment=True, use_pallas_ot=False,
                     alignment_chunks=chunks)


def bench_alignment(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda", objects=ALIGN_OBJECTS,
                    align_chunks=ALIGN_CHUNKS, calls=None) -> List[dict]:
    device = resolve_device(device)
    mcfg = _with_layers(mcfg, n_layers)
    params, n = _params(mcfg, device), branch_steps(steps)

    def make():
        return alignment_call(mcfg, params, alignment_batch(mcfg, batch, objects, device), n, align_chunks)

    case = f"B={batch} N={objects} M={ALIGN_ENTITIES}"
    extra = {"objects": objects, "entities": ALIGN_ENTITIES, "chunks": align_chunks}
    return _step_rows("alignment", mcfg, batch, device,
                      [(case, "align step (kernel attention)", make, n, calls or BRANCH_CALLS, extra)],
                      catch=True)


def multiattention_batch(mcfg, batch: int, bboxes: int, device) -> Dict[str, torch.Tensor]:
    """The step section's batch and the local-attention branch's inputs:
    `bboxes` boxes an image (corner pairs sorted per coordinate: x1 ≤ x2,
    y1 ≤ y2), kept with probability BBOX_KEEP (an int32 mask), and the
    role descriptions and labels [B, R, context] (random ids, EOT last)."""
    out = step_batch(mcfg, batch, device)
    gen = torch.Generator(device=device).manual_seed(2)
    ctx = mcfg.context_length
    corners = torch.rand((batch, bboxes, 2, 2), generator=gen, device=device)
    out["bbox"] = corners.sort(dim=2).values.reshape(batch, bboxes, 4)
    out["bbox_mask"] = (torch.rand((batch, bboxes), generator=gen, device=device) < BBOX_KEEP).to(torch.int32)
    for key in ("bbox_desc_text", "bbox_label_text"):
        out[key] = text_tokens(mcfg, batch * bboxes, ctx, gen, device).reshape(batch, bboxes, ctx)
    return out


def multiattention_call(mcfg, params: dict, batch: Dict[str, torch.Tensor], steps: int, mode: str,
                        dtype=torch.bfloat16) -> Callable:
    """`step_call` with the local-attention branch on in `mode`."""
    return step_call(mcfg, params, batch, "kernel", steps, dtype, multiattention=mode)


def bench_multiattention(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda",
                         bboxes=BBOXES, calls=None) -> List[dict]:
    device = resolve_device(device)
    mcfg = _with_layers(mcfg, n_layers)
    params, n = _params(mcfg, device), branch_steps(steps)
    data = multiattention_batch(mcfg, batch, bboxes, device)
    cases = [(f"B={batch} R={bboxes}", f"multiattn step ({mode})",
              lambda mode=mode: multiattention_call(mcfg, params, data, n, mode), n,
              calls or BRANCH_CALLS, {"bboxes": bboxes})
             for mode in MULTIATTENTION_MODES]
    return _step_rows("multiattention", mcfg, batch, device, cases, catch=True)


def texts_from_vocab(mcfg, n_rows: int, n_unique: int, seed: int = 1) -> np.ndarray:
    """[n_rows, context] token rows drawn from `n_unique` distinct random
    rows (EOT last), numpy's generator at `seed` (the JAX section's
    `_texts_from_vocab`)."""
    r = np.random.default_rng(seed)
    vocab = r.integers(1, min(49000, mcfg.vocab_size - 1),
                       size=(n_unique, mcfg.context_length)).astype(np.int32)
    vocab[:, -1] = mcfg.vocab_size - 1
    return vocab[r.integers(0, n_unique, size=n_rows)]


def deduped(rows: np.ndarray, cap: int, prefix: str, device) -> Dict[str, torch.Tensor]:
    """`{prefix}_unique` [cap, S] and `{prefix}_inverse` [N] of the token
    rows (`dedupe_rows`, strict: more unique rows than `cap` raise)."""
    unique, inverse = dedupe_rows(rows, cap=cap, strict=True, tag=prefix)
    return {f"{prefix}_unique": torch.from_numpy(unique).to(device),
            f"{prefix}_inverse": torch.from_numpy(inverse).to(device)}


def dedupe_layouts(mcfg, batch: int, uniques, device) -> List[tuple]:
    """(variant, batch) of the dedupe section's plain step: B·D text rows
    from DEDUPE_TEXT_VOCAB rows (seed 1) in the plain layout, then rows
    from U rows (seed U) in the deduped layout for each U of `uniques`."""
    base = step_batch(mcfg, batch, device)
    del base["text"]
    text = texts_from_vocab(mcfg, batch * D, DEDUPE_TEXT_VOCAB)
    out = [("step plain", dict(base, text=torch.from_numpy(text).to(device)))]
    for u in uniques:
        rows = texts_from_vocab(mcfg, batch * D, u, seed=u)
        out.append((f"step deduped (U={u} of {batch * D})", dict(base, **deduped(rows, u, "text", device))))
    return out


def dedupe_multiattention_layouts(mcfg, batch: int, bboxes: int, device) -> List[tuple]:
    """(variant, batch) of the dedupe section's multiattention step: text
    rows as the plain layout's, role descriptions and labels from
    DEDUPE_ROLE_VOCAB rows (seeds 7 and 8), plain; the role channels
    deduped ("sr-deduped"); the text rows too ("all-deduped")."""
    ma = multiattention_batch(mcfg, batch, bboxes, device)
    ctx, rows = mcfg.context_length, batch * bboxes
    text = texts_from_vocab(mcfg, batch * D, DEDUPE_TEXT_VOCAB)
    role = texts_from_vocab(mcfg, rows, DEDUPE_ROLE_VOCAB, seed=7)
    label = texts_from_vocab(mcfg, rows, DEDUPE_ROLE_VOCAB, seed=8)
    ma["text"] = torch.from_numpy(text).to(device)
    plain = dict(ma, bbox_desc_text=torch.from_numpy(role.reshape(batch, bboxes, ctx)).to(device),
                 bbox_label_text=torch.from_numpy(label.reshape(batch, bboxes, ctx)).to(device))
    sr = {k: v for k, v in ma.items() if k not in ("bbox_desc_text", "bbox_label_text")}
    sr.update(deduped(role, DEDUPE_ROLE_VOCAB, "bbox_desc", device))
    sr.update(deduped(label, DEDUPE_ROLE_VOCAB, "bbox_label", device))
    every = {k: v for k, v in sr.items() if k != "text"}
    every.update(deduped(text, DEDUPE_TEXT_VOCAB, "text", device))
    return [("plain", plain), (f"sr-deduped (U={DEDUPE_ROLE_VOCAB})", sr), ("all-deduped", every)]


def bench_dedupe(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda", bboxes=BBOXES,
                 dedupe_unique=DEDUPE_UNIQUE, calls=None) -> List[dict]:
    device = resolve_device(device)
    calls = calls or BRANCH_CALLS
    mcfg = _with_layers(mcfg, n_layers)
    params, n = _params(mcfg, device), branch_steps(steps)
    cases = [(f"B={batch} D={D}", variant, lambda data=data: step_call(mcfg, params, data, "kernel", steps),
              steps, calls, {}) for variant, data in dedupe_layouts(mcfg, batch, dedupe_unique, device)]
    layouts = dedupe_multiattention_layouts(mcfg, batch, bboxes, device)
    for mode in MULTIATTENTION_MODES:
        cases += [(f"multiattn {mode} R={bboxes}", variant,
                   lambda data=data, mode=mode: multiattention_call(mcfg, params, data, n, mode), n,
                   calls, {"bboxes": bboxes}) for variant, data in layouts]
    return _step_rows("dedupe", mcfg, batch, device, cases)


def accum_call(mcfg, params: dict, batch: Dict[str, torch.Tensor], k: int, dtype=torch.bfloat16) -> Callable:
    """One `make_accum_step` optimizer step a call over `batch` stacked `k`
    times (each field [k, ...]; "ce", overbatch, full remat, the kernel,
    Adam at lr 1e-6) from a fresh state of `params`; the callable returns
    the metrics, and its `state[0]` is the state it has stepped to."""
    optimizer = build_optimizer("adam", build_schedule("none", 1e-6, 30))
    state = [create_train_state(params, optimizer)]
    stacked = {key: torch.stack([v] * k) for key, v in batch.items()}
    step = make_accum_step(mcfg, optimizer, k, loss_type="ce", overbatch=True, compute_dtype=dtype,
                           remat=True, impl="kernel")

    def call():
        state[0], metrics = step(state[0], stacked)
        return metrics

    call.state = state
    return call


def accum_calls(k: int, steps: int, calls: int = CALLS) -> int:
    """Timed calls of the K-microbatch step: as many microbatches as the
    single step's `calls` · steps, at least 4 calls (the JAX section's)."""
    return max(4, calls * steps // k)


def bench_accum(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda", calls=None) -> List[dict]:
    device = resolve_device(device)
    calls = calls or CALLS
    mcfg = _with_layers(mcfg, n_layers)
    case, why = f"B={batch}", _step_shape_error(mcfg)
    variants = ["single step"] + [f"accum K={k} (eff {k * batch})" for k in ACCUM_KS]
    if why:
        return [_unsupported("accum", case, v, why) for v in variants]
    params, data = _params(mcfg, device), step_batch(mcfg, batch, device)
    single = _time_ms(step_call(mcfg, params, data, "kernel", steps), calls, device) / steps
    _release(device)
    rows = [_row("accum", case, variants[0], single, batch=batch, microbatches=1, calls=calls)]
    for k, variant in zip(ACCUM_KS, variants[1:]):
        n = accum_calls(k, steps, calls)
        ms = _time_ms(accum_call(mcfg, params, data, k), n, device) / k
        _release(device)
        rows.append(_row("accum", case, variant, ms, batch=batch, microbatches=k, calls=n,
                         pct_vs_single=ms / single * 100 - 100))
    return rows


def save_call(ckpt_dir: str, task: str, state, mcfg, async_save: bool) -> Callable[[], Optional[str]]:
    """The ckpt section's save of `state` (a TrainState):
    `save_checkpoint(ckpt_dir, task, 0, params, opt_state, mcfg,
    async_save=...)`; the callable returns the path."""
    return lambda: save_checkpoint(ckpt_dir, task, 0, state.params, state.opt_state, mcfg,
                                   async_save=async_save)


def bench_ckpt(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda") -> List[dict]:
    device = resolve_device(device)
    mcfg = _with_layers(mcfg, n_layers)
    why = _step_shape_error(mcfg)
    if why:
        return [_unsupported("ckpt", "save", f"{mode} save", why) for mode in ("sync", "async")]
    call = step_call(mcfg, _params(mcfg, device), step_batch(mcfg, batch, device), "kernel", steps)
    state = call.state
    size = tree_bytes(state[0].params, state[0].opt_state)
    rows, tmp = [], tempfile.mkdtemp(prefix="bench_ckpt_")
    try:
        float(call()["loss"][-1])  # the warm step, then a warm save
        if save_call(tmp, "warm", state[0], mcfg, False)() is None:
            raise RuntimeError("the warm save failed (logged)")
        for mode in ("sync", "async"):
            t0 = time.perf_counter()
            path = save_call(tmp, mode, state[0], mcfg, mode == "async")()
            t_ret = time.perf_counter() - t0
            float(call()["loss"][-1])  # `steps` steps issued behind the save
            wait_for_saves()
            t_total = time.perf_counter() - t0
            if path is None:
                raise RuntimeError(f"the {mode} save failed (logged)")
            rows.append(_row("ckpt", "save", f"{mode} save", t_ret * 1e3, total_ms=t_total * 1e3,
                             steps=steps, state_gb=size / 1e9))
    finally:
        wait_for_saves()
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def bench_moments(mcfg, batch=B, n_layers=None, steps=STEPS, device="cuda", calls=None) -> List[dict]:
    device = resolve_device(device)
    calls = calls or CALLS
    mcfg = _with_layers(mcfg, n_layers)
    why, rows = _step_shape_error(mcfg), []
    params, data = _params(mcfg, device), step_batch(mcfg, batch, device)
    for mdtype in MOMENT_DTYPES:
        variant = f"moments={mdtype}"
        if why:
            rows.append(_unsupported("moments", "adam", variant, why))
            continue
        call = step_call(mcfg, params, data, "kernel", steps, moment_dtype=mdtype)
        mb = tree_bytes(call.state[0].opt_state) / 1e6
        ms = _time_ms(call, calls, device) / steps
        del call
        _release(device)
        rows.append(_row("moments", "adam", variant, ms, opt_state_mb=mb, steps_per_call=steps, calls=calls))
    return rows


# ---------------------------------------------------------------- main

BENCHES = {"ln": bench_ln, "megakernel": bench_megakernel, "matmul": bench_matmul,
           "quantgemm": bench_quantgemm, "text": bench_text, "vision": bench_vision,
           "visionsplit": bench_visionsplit, "step": bench_step, "textsplit": bench_textsplit,
           "textwidth": bench_textwidth, "latency": bench_latency, "quant": bench_quant, "ot": bench_ot,
           "alignment": bench_alignment, "multiattention": bench_multiattention, "dedupe": bench_dedupe,
           "accum": bench_accum, "ckpt": bench_ckpt, "moments": bench_moments}
# the flags a section takes beyond the shared ones
OPTIONS = {"step": ("calls",), "alignment": ("objects", "align_chunks", "calls"),
           "multiattention": ("bboxes", "calls"), "dedupe": ("bboxes", "dedupe_unique", "calls"),
           "accum": ("calls",), "moments": ("calls",)}
UNITS = {"ln": "ms/iter (stack grad)", "megakernel": "ms/iter ({layers}-layer fwd)", "step": "ms/step",
         "text": "ms/iter (tower grad)", "vision": "ms/iter (tower grad)",
         "visionsplit": "ms/iter (grad)", "textsplit": "ms/iter (grad)", "alignment": "ms/step",
         "multiattention": "ms/step", "dedupe": "ms/step", "accum": "ms/microbatch",
         "ckpt": "ms (return)", "moments": "ms/step"}
EXTRAS = (("tflops", "{:.1f} TFLOP/s"), ("share_of_h100_bf16_peak", "{:.1%} of 989 TFLOP/s"),
          ("tera_ops_per_s", "{:.1f} TOP/s"), ("pairs_per_s", "{:,.0f} pairs/s"),
          ("host_p50_ms", "host p50 {:.3f} ms"), ("items_per_s", "{:,.1f} items/s"),
          ("speedup_vs_bf16", "{:.2f}x bf16"), ("peak_gib", "peak {:.2f} GiB"),
          ("pct_vs_single", "{:+.1f}% vs single"), ("total_ms", "save+{steps} steps total {:.1f} ms"),
          ("state_gb", "state {:.2f} GB"), ("opt_state_mb", "opt state {:.1f} MB"))


def format_row(row: dict) -> str:
    prefix = row.get("tower") or row.get("case")
    label = f"{prefix}: {row['variant']}"
    if row["ms_per_iter"] is None:
        if "error" in row:
            return f"{label:<44s} FAILED: {row['error']}"
        return f"{label:<44s} skipped" + (f" ({row['unsupported']})" if "unsupported" in row else "")
    unit = UNITS.get(row["section"], "ms/call").format(**row)
    extras = [fmt.format(row[k], **row) for k, fmt in EXTRAS if row.get(k) is not None]
    return "  ".join([f"{label:<44s} {row['ms_per_iter']:9.3f} {unit}"] + extras)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Component benchmark of the PyTorch port")
    parser.add_argument("sections", nargs="*", metavar="section",
                        help=f"any of {', '.join(SECTIONS)} (default: all)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--model", default="ViT-B/32",
                        help="a preset name or a JSON object of CLIPConfig fields")
    parser.add_argument("--batch", type=int, default=B, help="images (texts are 3 per image)")
    parser.add_argument("--layers", type=int, default=None, help="layers per stack (default: the model's)")
    parser.add_argument("--steps", type=int, default=STEPS,
                        help="timed iterations a row (the step sections: steps a call)")
    parser.add_argument("--calls", type=int, default=None,
                        help="timed calls of the step sections (default: the JAX sections' 3, "
                             "and 2 for the branch steps)")
    parser.add_argument("--objects", type=int, default=ALIGN_OBJECTS,
                        help="alignment: crops an image (51 probes the object cap)")
    parser.add_argument("--align-chunks", type=int, default=ALIGN_CHUNKS,
                        help="alignment: slices of the crop and entity encodes")
    parser.add_argument("--bboxes", type=int, default=BBOXES, help="multiattention, dedupe: boxes an image")
    parser.add_argument("--dedupe-unique", default=",".join(map(str, DEDUPE_UNIQUE)),
                        type=lambda v: tuple(int(u) for u in v.split(",")),
                        help="dedupe: the deduped layouts' unique rows, comma-separated")
    args = parser.parse_args(argv)
    unknown = [name for name in args.sections if name not in SECTIONS]
    if unknown:
        parser.error(f"unknown section(s) {unknown}; options: {list(SECTIONS)}")
    device = resolve_device(args.device)
    model = json.loads(args.model) if args.model.lstrip().startswith("{") else args.model
    mcfg = model_config({"model": model})
    rows = []
    for section in args.sections or SECTIONS:
        options = {k: getattr(args, k) for k in OPTIONS.get(section, ())}
        for row in BENCHES[section](mcfg, args.batch, args.layers, args.steps, device, **options):
            print(format_row(row), flush=True)
            rows.append(row)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    on_card = device.type == "cuda"
    smi = None
    if on_card:
        from clip_event_tpu_torch.bench import nvidia_smi

        smi = nvidia_smi()
    print(json.dumps({"rows": rows, "device": {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "nvidia_smi": smi}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
