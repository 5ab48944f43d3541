#!/usr/bin/env python3
"""Drive the PyTorch port's serving and fine-tuning paths once on one
NVIDIA GPU: ViT-B/32 zero-shot serving and contrastive fine-tuning (with
the plain LayerNorm and with the fused LayerNorm kernels of
`use_pallas_ln`), ViT-L/14 serving and fine-tuning (and one ViT-B/16 step),
the OT graph-alignment fine-tuning of `configs/finetune_ot.json` and the
full CLIP-Event fine-tuning of `configs/clip_event_full.json` (OT and
local attention) at ViT-B/32, RN50 and RN50x4 serving and RN50
fine-tuning, int8 serving, the serving bundle (`torch.export` programs
serving through the kernels' custom ops), the zero-shot evals (GSR among
them), the description pipeline's CLIP type scorer, and the bench entry
point and component bench.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --only k1   # device, build and K1's kernel checks
    python3 chip_smoke.py --only k2   # device, build and K2's kernel checks
    python3 chip_smoke.py --only k4   # device, build and K4's kernel checks
    python3 chip_smoke.py --only k5   # device, build and K5's kernel checks
    python3 chip_smoke.py --only k3 k6   # device, build, K3's and K6's checks
    # the same, with K3 and K6 of an earlier tree's csrc/ timed beside
    # these in turns (built here under the names old_ipot, old_ln_qkv_attention)
    python3 chip_smoke.py --only k3 k6 --old-csrc parent/clip_event_tpu_torch/csrc
    python3 chip_smoke.py --only graph   # device, build, the graphed B/32 step
    python3 chip_smoke.py --only b1      # device, build, the wrappers' host cost
    # device, build, then those phases alone (any of train_full,
    # serving_rn50, train_rn50, evals)
    python3 chip_smoke.py --only train_full serving_rn50 train_rn50 evals
    python3 chip_smoke.py --only serving_bundle   # the serving bundle alone
    python3 chip_smoke.py --only train_dp   # the data-parallel step alone
    python3 chip_smoke.py --only data_feed  # the host image path alone
    python3 chip_smoke.py --only tp_heads   # the tp = 2 head groups alone
    python3 chip_smoke.py --only pp_stages  # the pp = 2 stages alone
    python3 chip_smoke.py --only preprocess  # the description pipeline alone
    # the same for an earlier tree's package unpacked under DIR
    python3 chip_smoke.py --only b1 --package-root DIR

Phases, each printing JSON lines:

  1. device   the card's name; needs `torch.cuda.is_available()`
  2. build    compiles every kernel source in `clip_event_tpu_torch/csrc/`,
              one nvcc each, all started together; the tensor-core attention
              kernels (K1's and K2's) must not spill (`-Xptxas -v`), their
              bf16 forwards' SASS must hold HGMMA (the warpgroup MMA), and
              ptxas must serialize none of their wgmma products at the
              paths' head_dim (64)
  3. kernels  each kernel against its plain PyTorch version at the shapes
              the paths give it and at edge shapes, fp32 and bf16, and its
              time beside the plain version's, one PyTorch library call's and
              the bound the card's peak rates give. The attention forwards
              (K1-fwd, K2-fwd) are held at max abs error 1e-5 (fp32) / 2e-2
              (bf16); the backwards (K1-bwd, K2-bwd) at max|kernel − plain| /
              max|plain| ≤ 1e-5 (fp32) / 1e-2 (bf16); the IPOT solver (K3)
              at max|kernel − plain| / max|plain| ≤ 1e-5 (fp32). K1 and K2
              have three variants each, by one rule: "mma" (bf16 on the
              tensor cores), "tf32x3" (fp32 on the tensor cores in split
              TF32, held to the fp32 gates) and "simt" (the head dims no
              tensor-core tile takes): every K1 and K2 row says which, the
              Python rule and both libraries' rule must agree with it, a
              direct backward call launches what the rule says (K1's tf32x3
              two kernels at head_dim 128), and the mma rows are also held at
              forward ≤ 1e-2 of max|plain| and, against the plain versions
              that round where the kernel rounds, at ≤ 8e-3 (worst) and
              5e-4 (mean) of max|plain|; the tf32x3 rows also give their
              error against the plain versions that split where the kernel
              splits; a tensor-core backward through autograd's saved
              residuals and on a second run gives equal bits; a misaligned
              qkv view is refused; every timed K1 and K2 forward row gives
              its kernel's device ms (torch.profiler), and with --old-csrc
              the bf16 rows time the earlier tree's forward in turns
              against this one's
  4. serving  full-width ViT-B/32 from seed 0 (12 + 12 layers): embed_stream
              over 256 images and 256 token rows into shards and a manifest,
              in fp32 and in bf16, then evaluate_matching; the launch counts
              of that run, checks of the features against a plain-attention
              run of the same model, and images/s and texts/s at batch 64
  3b. b1     the host microseconds a call of each kernel wrapper takes
              (K1, K2 forward and backward, K4a/b/c, K3, K5, and K1, K2
              forward and K4a/b through their public entry points without a
              gradient; the
              median of 7 runs of 100 enqueued calls)
  5. train    full-width ViT-B/32 from seed 0 through the train loop
              (`clip_event_tpu_torch.train.train`: loader → prefetch → step →
              metrics) on the bench workload: 384 uint8 images × 3
              descriptions (1 positive, 2 hard negatives) of 77 tokens, bf16,
              full remat, Adam at lr 1e-6; the launch counts of that run,
              contrastive pairs/s, step ms and peak memory; a kernel step
              against plain-attention steps from one state and batch (bf16
              at B=384: loss and grad_norm 1e-3 against the plain step with
              the kernels' roundings, 2^-8 relative against the fp32-P
              one; fp32 at B=64); the step with the plain attention
              beside the kernel-path step in turns; a profile of one step
  5a. train_graph  phase 5's workload through the train loop with
              `steps_per_dispatch` 4: the step captured once as a CUDA graph
              and replayed (`make_multi_step`), exact launch counts (a
              replay adds what its capture counted); a 4-step dispatch
              against 4 eager steps bit for bit (params, optimizer state,
              metrics), twice (the first dispatch: one eager step, the
              capture, 3 replays; the second: 4 replays); the eager step
              against a 3-step dispatch (GRAPH_TIMING_K) in turns: ms a
              step, the device busy ms of an eager step and of one replay
              (torch.profiler, whose count of the hand kernels in the
              replay by name must equal the wrappers' counts), idle shares,
              peak memory and what stays reserved
  5d. train_dp  the data-parallel path at a world of one, on the card's
              NCCL: torchrun's environment (RANK 0, WORLD_SIZE 1,
              LOCAL_RANK 0, MASTER_ADDR 127.0.0.1, a free port) through
              `parallel.mesh.initialize_distributed`, backend "nccl" and
              device cuda:0 checked; phase 5's workload (ViT-B/32, 384 x 3,
              bf16, seed 0, its batches) through the train loop with the
              mesh, counted (K1-fwd 48 and K1-bwd 24 a step, as without
              one); the same loop with "zero": true (ZeRO-1: the moments
              sharded, `parallel/sharding.py`) and with "fsdp": true (the
              params too), each at one shard: every metric of every step
              bit for bit train_dp's, equal launches; 4 eager steps of the
              mesh's step and one 4-step graph dispatch of it (the gather,
              the gradient all-reduce, or the reduce-scatter, the
              all-gathers and FSDP's per-use gathers, and the rest
              captured), each on a plain, a ZeRO-1 and an FSDP state, each
              bit for bit against 4 steps without a mesh (params,
              optimizer state gathered, metrics) with equal launches, its
              state's bytes and peak memory; the mesh's step on the three
              states against the plain step in turns, ms a step, and the
              NCCL kernels' calls and device ms in one profiled step of
              each (read, not gated); the matching eval through
              `resolve_shard` equal to the unsharded call; the process
              group destroyed at the end
  5t. tp_heads  the attention core's head groups of Megatron tensor
              parallelism at tp = 2 (`parallel/sharding.py`: a rank's QKV
              slice is its H/2 heads, packed [B, S, 3W/2], reordered in the
              weight): at the train batches of the L/14 text (W 768, H 12,
              S 77, causal) and vision (1024, 16, 257) towers, the B/16
              vision tower (768, 12, 197) and the B/32 text (512, 8, 77,
              causal) and vision (768, 12, 50) towers, bf16 and fp32: each
              head-group shape's kernel (K1 or K2, by `core_kernel`) against
              its plain version with the kernel phase's gates (timed in
              bf16); then one attention sublayer through the port: whole
              weights split by `TPSpec` (the "qkv" reorder, the row-parallel
              `out_w`), each rank's `layers.head_group_attention` forward
              and backward through autograd, counted exactly (per rank: one
              forward, the backward's launches), the ranks' partial products
              summed by hand plus `out_b`, against the full-width
              `layers.multi_head_attention` on the kernel: the output, dx
              and the weights' gradients laid back whole by
              `TPSpec.from_shards`, each gap relative to the largest
              full-width value (`TP_SUM_TOL`: two roundings, bf16 2^-6;
              fp32 1e-5; the gaps printed, bit equality read); K4a (ln_1) and
              K4b (+ K4c) through autograd on the sequence-parallel local
              rows of the L/14 towers (B·⌈S/2⌉ rows), counted, with K4's
              checks at those shapes; the phase's seconds
  5p. pp_stages  GPipe at pp = 2 through the port's in-process driver
              (`parallel.pipeline.run_in_process`: both stages on the one
              card, in tick order, the schedule and stage function of a
              multi-rank run with a mailbox for the transport; the card's
              machine has one GPU, and NCCL takes one rank a GPU): K1 and K2
              at the microbatch shapes (B/32 vision 96 x 50 x 768, text 288
              x 77 x 512 causal, L/14 vision 16 x 257 x 1024) against their
              plain versions with the kernel phase's gates, timed in bf16;
              the ViT-B/32 train step's loss and every gradient (384 x 3,
              bf16, full remat, pp_microbatches 4; and fp32 at 64 x 3), the
              stacks cut into stages by `PPLayout` and run by
              `layers.transformer` as a list of stages, the stage leaves'
              gradients laid back by `PPSpec.from_shards`, against the plain
              step on the kernels from the same params and batch: relative
              to the largest plain value within bf16 2^-6 / fp32 1e-5, the
              forward's features' bit equality reported; one ViT-L/14
              vision stack call (64 x 257, K2, "attn") forward and backward
              against `layers.run_stack` on the whole batch, bf16 and fp32,
              the same gates; exact K1 / K2 launch counts by the rules the
              summary line states (full remat: 3 forwards a block and
              microbatch, "attn": 2); the fp32 Adam state one rank holds at
              pp = 2 and 4 (W = 8), alone and with zero / fsdp on top,
              counted from shapes; the phase's seconds (at most 60)
  5e. data_feed  `configs/finetune_template_fast.json` (ViT-B/32, 384 x 3,
              bf16, length buckets [32, 48], dedupe 768) fed from JPEG
              files through `train.build_dataset` and `train.train`: a
              synthetic VOA corpus written from seed 0 (768 JPEGs of 480 x
              640 at quality 90, smooth fields plus noise; repeated
              description templates); the native decoder's status (built,
              with libjpeg or decoding with PIL, the compiler's message)
              beside the host's cores, and on 32 files its u8 path equal to
              `preprocess_image_u8` bit for bit and its float path within
              1e-6; the image cache built (images/s); the loop from the
              cache, which `build_dataset` activates (1 warm-up + 4 timed
              steps, exact K1 counts, first loss near chance), then 2
              steps live with the cache cleared, bit for bit the cached
              run's first two (every metric), each live-decoded image equal
              to its cache row; the device time between steps, a resident
              step of the loop's first batch with its busy time and idle
              share, the loader alone cached (also at 1, 4, 8 and 16
              threads) and live; `preprocess_on_device`
              on 64 raw 480 x 640 images within the JAX test's bar of the
              host float path, images/s; the retrieval eval CLI with
              `image_cache` and without: equal metrics and launches, 4
              cache hits
  6. serving_l14  full-width ViT-L/14 from seed 0 (24 + 12 layers; vision
              S=257 through K2, text through K1): embed_stream over 128
              images and 128 token rows at batch 64, fp32 and bf16; launch
              counts, features against a plain-attention run, images/s and
              texts/s, and one bf16 image batch with the plain attention
              beside the kernel path's, in turns
  7. train_l14  12 full-width ViT-L/14 steps through the train loop at the
              bench's L/14 workload (64 uint8 images × 3 descriptions, bf16,
              the bench's "attn" remat policy, 4 steps a dispatch through
              the graph, Adam at lr 1e-6): exact K1/K2 launch counts (K2's
              forward 24 a step, K1's 12: once a block), losses near
              chance, moved params, pairs/s, step ms, peak memory; the
              "attn" step against full remat (loss and grad_norm within
              1e-3, bit equality reported; ms in turns, peak memory, exact
              counts); the eager "attn" step against a 3-step graph
              dispatch (as phase 5a); under full remat a bf16
              kernel-vs-plain step, and the step with the plain
              attention beside the kernel-path step in turns
              (`plain_attention_step_ms`); one fp32 L/14 step at 16 × 3
              (K2's and K1's tf32x3 variants, forward and backward): loss
              and every gradient within 2e-5 of the plain step, exact
              launch counts,
              and its ms beside the plain attention's in turns; then one
              ViT-B/16 kernel-path step
              at its bench batch (96), with the same two comparisons
  8. train_ot  7 steps of finetune_ot.json's settings at ViT-B/32 full width
              through the train loop (64 images × 3 descriptions, 8 float32
              object crops at 224² and 16 entity rows of 77 tokens per image,
              ragged, alignment_chunks 4, use_pallas_ot true, bf16, remat,
              Adam at lr 1e-6): loss_ot finite and > 0 every step, K3 once a
              step, the K1 counts of the nested chunk- and block-level
              checkpoints, pairs/s, step ms, peak memory, a profile of one
              step, and kernel-vs-plain steps (plain attention and plain
              IPOT; bf16 at B=64 and fp32 at B=16); then the graphed step
              as in phase 5a, at less depth (its eager step takes ~1 s):
              one 4-step dispatch against eager steps bit for bit, and the
              eager step against a 2-step dispatch (OT_GRAPH_TIMING_K)
  8b. train_full  configs/clip_event_full.json's settings at ViT-B/32 full
              width (64 images × 3 descriptions, finetune_ot's object and
              entity channels, 8 boxes an image with role descriptions and
              labels deduped to 256 unique rows, multiattention "desc_type"
              with attention pooling; bf16, full remat, Adam at lr 1e-6)
              through the train loop with 4 steps a dispatch: losses finite
              (loss_ot, loss_bbox, loss_arg > 0), exact K1 and K3 launch
              counts (the image batch encoded twice, the role texts twice),
              a 4-step dispatch bit for bit against 4 eager steps with the
              ms of each, a bf16 kernel step against the all-plain steps
  8c. serving_rn50  RN50 and RN50x4 from seed 0 through the CLI's loader:
              one batch of 64 images and of 64 token rows in fp32 and
              bf16, exact counts (K1 12 a text batch, none an image
              batch), text features against the plain attention's, image
              features equal to them, images/s and texts/s; RN50 in int8:
              K5 on the text tower's 49 dense layers, the image tower float,
              cosine 0.999 against the all-plain path
  8d. train_rn50  RN50 at 128 × 3 (the bench's batch), bf16, through the
              train loop with 4 steps a dispatch, counted; a 4-step
              dispatch bit for bit against 4 eager steps; a `sync_bn` step
              (batch statistics) beside a frozen one, counted; pairs/s
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
              path (plain attention, plain K5) at min cosine 0.999 where the
              attention kernel takes its tf32x3 variant (its ~1e-6 flips
              dynamic int8 roundings), else at 1e-4, and the cosine of int8
              against float features (gated at >= 0.99 at ViT-B/32)
  9b. serving_bundle  `engine/export.py` at full width from seed 0: a
              ViT-B/32 bundle in fp32, bf16 and int8 and a ViT-L/14 int8
              bundle (the fp32 and int8 B/32 ones exported on the CPU), each
              exported by a process of its own, the four started beside the
              kernels' build and read after it; each loaded in a fresh
              process (load seconds; `models.clip` and the layers must stay
              out of its sys.modules; the four run together, beside this
              process's own load and checks) and here, then
              serving batches of 1, 7 and 64 on the card, counted: K1 12 a
              tower batch, K2 24 an L/14 image batch, K5 100 / 98 (B/32) and
              196 / 98 (L/14) an image / text batch, equal to the live
              model's a batch; features against the live model (fp32 max abs
              1e-5, bf16 cosine 0.999, int8 1e-4; bit equality reported) and
              the first 2 rows of the batch of 7 against the same bundle
              serving those rows on the CPU through the ops' plain versions
              (fp32 1e-4, else cosine 0.999); export and load seconds, bundle bytes, images/s and
              texts/s at batch 64, bundle and live in turns
 10. evals    the M2E2, VCR, VisualCOMET and retrieval CLIs through
              `evals.cli.run` on synthetic annotation files (tests/fixtures.py):
              VCR, VisualCOMET and retrieval at ViT-B/32 fp32, M2E2 at
              ViT-L/14 with argument grounding in int8_static (grid features
              through K2, every dense layer through K5); metrics finite and
              in [0, 1], the expected keys, exact launch counts; then
              retrieval again with `"use_pallas_attention": false`: no
              attention kernel launches, equal metrics, the choice put back;
              GSR at ViT-B/32 with the value metrics (6 grounded roles, 6
              frames), counted, and again with the plain attention: equal
              metrics
 10b. preprocess  the description pipeline's CLI
              (`clip_event_tpu_torch.preprocess_descriptions`) at ViT-B/32
              full width from seed 0, fp32, with `add_clip_sim` on a
              synthetic corpus written from seed 0 (64 docs of 1-4 ACE
              events, 61 JPEGs of 320 x 480, 2 docs without a file, 1 with
              a file that is no image; the 33 ACE event types' descriptions)
              and a cold `clip_cache_dir`: exactly 24 K1-fwd launches (one
              text batch, one image batch) and no other kernel, pred_idx -1
              for the 3 bad docs; the cached scores against the plain path
              (the images decoded again by threads, both towers with the
              plain attention) within PP_PROB_GATE (0.5 · 100 · 1e-4: the
              fp32 serving gate through the logit scale), pred_idx equal
              where the plain top-two margin is above it; the CLI again on
              the warm cache: 12 K1-fwd launches (the text batch alone),
              every output file byte for byte the cold run's; images
              scored a second and the phase's seconds

  5b. train_ln  phase 5's workload through the train loop with
              `use_pallas_ln: true`: exact launch counts of K1 and of K4a,
              K4b and K4c in every residual block (twice each under remat),
              loss near chance, moved params, the LayerNorm choice put back;
              a bf16 step with all kernels against the all-plain steps (as
              phase 5) and an fp32 step (loss and every gradient
              2e-5); the step with the plain attention beside the
              kernel-path step in turns; a profile of one step; pairs/s and
              step ms beside phase 5's from the same run; then ViT-L/14
              steps (64 x 3) with the
              LayerNorm kernels on and off, counted, and a bf16
              kernel-vs-plain step there (W = 1024, K2 beside K4)
  5c. serving_ln  one ViT-B/32 image batch and one text batch of 64 under
              `set_ln_impl("pallas")`, fp32 (1e-4 against the plain-LN
              features) and bf16 (cosine 0.999); K4a and K4b once a block,
              no K4c; batch ms with and without the kernels
 11. bench_tools  `clip_event_tpu_torch.bench` at full width (ViT-B/32,
              384 x 3; its protocol through the graphed step, one warm-up
              call, here with 2 steps a call and one timed call) with the
              plain LayerNorm and with `--ln pallas`, then
              with `--images uint8` and `--images float32`, once each, and
              the `ln` and `megakernel` sections of
              `clip_event_tpu_torch.tools.bench_components` at their default
              shapes (256 images x 3 texts, 12 layers; `--steps 1`),
              through their `main`:
              the JSON lines parsed, metrics finite and positive, exact launch
              counts (K6 runs here); then its eleven encoder, kernel and
              train-step sections (matmul, quantgemm, text, vision,
              visionsplit, step, textsplit, textwidth, latency, quant, ot)
              once each at their default shapes with `--steps 1` (and
              `--calls 1`: the step sections' timed calls), and
              `quant` once more at ViT-L/14 (`--batch 64`: K2 in its
              vision tower): every row finite and positive, exact launches
              of K1 / K2 (none in a plain-attention row), K3 and K5 (the
              whole call, and the GEMM alone and the row pass apart); then
              its six branch and engine sections (alignment with 11 crops
              and 16 entities an image and the plain OT loop,
              multiattention in "desc" and "desc_type", dedupe's plain and
              deduped layouts, accum at K = 2 and 4, ckpt sync and async,
              moments fp32 and bf16) the same way, with `train_launches`'
              counts; then `clip_event_tpu_torch.tools.bench_presets` on
              ViT-B/16:96:attn (K2 forward and backward) and RN50:128:1 (a
              ResNet tower, K1 in the text tower alone) at `--steps 2
              --calls 1`: the rows finite and positive, exact launches.
              The depths (`SECTION_STEPS`, `SECTION_CALLS`, `BENCH_STEPS`)
              are the script's time limit's, not the tools' defaults

K4, the fused LayerNorm, is held in phase 3 at the LayerNorm shapes of the
ViT-B/32 and ViT-L/14 train steps and of ViT-B/32 serving, and at edge
shapes (N = 1, an N that fills no row block, W = 640, 1280, 100 and 3072,
a row of equal values, a 1e3 spike), fp32 and bf16: the forwards (K4a,
K4b) at max|kernel - plain| <= 1e-6 (fp32) / 2e-2 (bf16) times max(1,
max|plain|), K4b's sum exactly equal, the backward (K4c, alone and with
the sum's cotangent) at dx, dgamma and dbeta each <= 1e-5 / 1e-2 of
max|plain|, and equal bits from a second call and from two replays of a
CUDA graph that captured it. Each row names its path (registers at the
preset widths, generic at W = 100 and 3072); a view that starts one
element into its buffer runs the generic kernels at W = 768. The timed
rows carry the kernels' device ms (torch.profiler) and the wrapper's host
µs beside the wall ms; K4c's its grid. The build phase prints every K4
kernel's registers and spills (any spill fails). K6, the LayerNorm -> QKV -> attention megakernel, at the
component bench's two shapes and at edge shapes (B = 1, S = 1, S = 128,
head_dim 32, 16 and 20, a width that fills no k tile, bf16 widths whose
rows do not stay resident): max abs error 1e-4 / 2e-2 against its plain
version and 1e-4 / 5e-2 against the unfused chain, in the variant
(`mega_variant`: "mma", "tf32x3" or "simt") and layout (`mega_layout`:
"resident" or "stream") each row names; the bf16 path shapes also in the
other layout; the Python and C shared-memory counts agree; the build
phase prints K6's registers and spills (a spill in a tensor-core kernel
fails) and checks for HMMA in its SASS. K3 runs its "warp" variant up to
32 entities and 32 objects and its "block" variant past them (both sides
of the boundary are shapes), each row naming its variant, with the
latency floor beside the roofline bound.

K5, the int8 GEMM, is held in phase 3 against its plain version at the
paths' shapes (batch 64) and at edge shapes (M = 1, K = 588, K = 3, odd N,
an all-zero row, a row with one large value), dynamic and static, fp32
and bf16: max|kernel − plain| / max|plain| ≤ 1e-6 (fp32) / 8e-3 (bf16)
and, as its design promises, equal bits; the GEMM alone
(`quant.quantized_gemm` on the row pass's output) equal to
`quantized_gemm_plain`, and the int8 payload and row scales of the row
pass exactly equal. It times the whole call, the GEMM alone and the row
pass alone, beside each one's bound, `torch._int_mm` on the same operands
and the bf16 `torch.matmul` of the same shape. The build phase prints
K5's registers, shared memory and spills by kernel (any spill fails),
the GEMM's blocks an SM, and checks that the GEMM's SASS holds the
warpgroup int8 MMA (IGMMA).

Every phase line carries `t_s`, the seconds since the script started.
Then the `{"kernels": [...]}` line, the card's name and power limit as
nvidia-smi prints them, and a last line `{"ok": true, "device": {...}}`.
Any failed check raises, so the script exits non-zero. With no card it
exits non-zero before printing anything.
"""

from __future__ import annotations

import collections
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

if __name__ == "__main__" and "--package-root" in sys.argv:
    # `--only b1 --package-root DIR`: the wrappers of another tree's package
    # (an earlier commit unpacked under DIR), timed by this script
    sys.path.insert(0, os.path.abspath(sys.argv[sys.argv.index("--package-root") + 1]))

from clip_event_tpu_torch import bench as port_bench
from clip_event_tpu_torch.config import validate_config
from clip_event_tpu_torch.data.common import ExampleDataset
from clip_event_tpu_torch.data.transform import CLIP_MEAN, CLIP_STD
from clip_event_tpu_torch.data.labels import build_label_layout
from clip_event_tpu_torch.embed import embed_stream
from clip_event_tpu_torch.engine.optim import build_optimizer, build_schedule, tree_leaves, tree_unflatten
from clip_event_tpu_torch.engine.train_step import create_train_state, loss_fn, make_train_step
from clip_event_tpu_torch.evals.cli import load_model_from_cfg
from clip_event_tpu_torch.evals.common import Encoders
from clip_event_tpu_torch.evals.matching import evaluate_matching, matching_metrics
from clip_event_tpu_torch.models.clip import (
    RN50,
    VIT_B16,
    VIT_B32,
    VIT_L14,
    encode_image,
    encode_text,
    init_params,
    l2_normalize,
)
from clip_event_tpu_torch.models import layers, resnet
from clip_event_tpu_torch.models.layers import causal_mask
from clip_event_tpu_torch.ops import _build
from clip_event_tpu_torch.ops import attention as attention_ops
from clip_event_tpu_torch.ops import ln
from clip_event_tpu_torch.ops import ot
from clip_event_tpu_torch.ops import quant
from clip_event_tpu_torch.ops.attention import (
    BWD_KERNEL,
    HG_BWD_KERNEL,
    HG_BWD_LAUNCHES_PER_CALL,
    HG_KERNEL,
    KERNEL,
    MAX_SEQ,
    MEGA_KERNEL,
    MMA_HEAD_DIMS,
    TENSOR_CORE_VARIANTS,
    bwd_launches_per_call,
    fused_attention_qkv,
    fused_attention_qkv_bwd,
    fused_attention_qkv_bwd_plain,
    fused_attention_qkv_fwd,
    fused_attention_qkv_headgrid,
    fused_attention_qkv_headgrid_bwd,
    fused_attention_qkv_headgrid_fwd,
    fused_attention_qkv_plain,
    fused_ln_qkv_attention,
    fused_ln_qkv_attention_plain,
    headgrid_variant,
    k1_variant,
    library_variant,
    mega_layout,
    mega_smem_bytes,
    mega_variant,
)
from clip_event_tpu_torch.parallel.sharding import TPSpec, full_params, gather_state, shard_state, tree_bytes
from clip_event_tpu_torch.tools import bench_components, bench_presets
from clip_event_tpu_torch.train import train

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
# the card's published peaks (H100 SXM data sheet, dense): memory, fp32 on
# the CUDA cores, bf16 and TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_TF32_FLOPS = 495e12
# fp32 work to fp32 accuracy on the tensor cores: three TF32 products a
# term (split TF32, the tf32x3 variant)
TF32X3_PRODUCTS = 3
PEAK_INT8_OPS = 1979e12
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # forward: max abs error
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # backward: error relative to max|plain|
# K1's and K2's tensor-core ("mma") variants, bf16: the forward also relative to
# max|plain| (2e-2 absolute is weak where outputs are ~0.1), and forward and
# backward against the plain versions that round where the kernel rounds
# (`mma_rounding=True`): one bf16 ulp of the largest result, which is up to
# 2^-7 of it (an element just under a power of two: the H100 read 1/240 =
# 4.17e-3 at max|plain| = 1.875, one ulp of 2^-7), and the mean error over
# all elements, which a one-ulp flip here and there leaves far smaller
MMA_FWD_REL_TOL = 1e-2
MMA_ROUNDED_TOL = 8e-3
MMA_ROUNDED_MEAN_TOL = 5e-4
OT_TOL = {"float32": 1e-5}  # IPOT plan: error relative to max|plain|
# K5: error relative to max|plain|; fp32 is exact by design, bf16 two ulps
QUANT_TOL = {"float32": 1e-6, "bfloat16": 8e-3}

# K4 forward: max abs error over max(1, max|plain|); K4 backward (dx, dgamma,
# dbeta): error relative to max|plain|; K6: max abs error against its plain version, and against
# the port's unfused chain (plain LN -> linear -> K1), whose bf16 projection
# is rounded to bf16 before the attention core where K6 keeps it in fp32
LN_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
LN_BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
MEGA_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MEGA_CHAIN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}

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
    # the tile edges of K1's tensor-core variant (16 query rows a warp,
    # ceil(S/16) warps, 16-key chunks): S = 16 (one warp), 17 (one row
    # past it), 64, 65, 127 and 128 (eight warps), some with a bias;
    # head_dim 16 and 32; more (b, h) blocks than a grid's y or z
    # dimension holds (72,000); head_dims no tensor-core tile takes (simt
    # in both dtypes: 40, 8); head_dim 128 with a ragged 64-row split (the
    # tf32x3 backward's two launches)
    ("edge_s16_causal", 3, 16, 256, 4, True),
    ("edge_s17", 3, 17, 256, 4, False),
    ("edge_s64", 2, 64, 256, 4, False),
    ("edge_s65_causal", 2, 65, 256, 4, True),
    ("edge_s127_causal", 2, 127, 256, 4, True),
    ("edge_s128", 2, 128, 256, 4, False),
    ("edge_s1_d16", 2, 1, 64, 4, False),
    ("edge_d16_causal", 3, 77, 128, 8, True),
    ("edge_d32", 3, 50, 256, 8, False),
    ("edge_blocks_d16", 9000, 20, 128, 8, False),
    ("edge_d40_causal", 2, 33, 80, 2, True),
    ("edge_d8_causal", 2, 77, 64, 8, True),
    ("edge_s77_d128_causal", 3, 77, 384, 3, True),
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
    # the tile edges of the tensor-core variant: one full 64-row tile, one
    # row more, one row short of two tiles (with a bias); S = 16 k + 1 (one
    # row past a warp's 16); head_dim 32 without a bias and head_dim 16;
    # more blocks than a grid's y or z dimension holds (72,000)
    ("hg_edge_s64_causal", 2, 64, 256, 4, True),
    ("hg_edge_s65_causal", 2, 65, 256, 4, True),
    ("hg_edge_s127_causal", 2, 127, 256, 4, True),
    ("hg_edge_s17", 2, 17, 256, 4, False),
    ("hg_edge_s49", 2, 49, 256, 4, False),
    ("hg_edge_s193", 2, 193, 256, 4, False),
    ("hg_edge_d32", 2, 150, 256, 8, False),
    ("hg_edge_d16_causal", 2, 150, 128, 8, True),
    ("hg_edge_blocks_d16", 3000, 130, 128, 8, False),
    # head_dim 8: no tensor-core tile, the simt variant in both dtypes
    ("hg_edge_d8_causal", 2, 150, 128, 16, True),
]
# heads longer than the bf16 mma forward's ring of K / V chunks (11 at
# head_dim 64, 5 at 128): walked in passes, the chunks loaded again. bf16,
# and S = 1000 in fp32 too, (tag, B, S, W, H, causal, dtypes)
HG_STREAM_EDGE_SHAPES = [
    ("hg_edge_s1000_causal", 2, 1000, 256, 4, True, (torch.bfloat16, torch.float32)),
    ("hg_edge_d128_s400", 2, 400, 256, 2, False, (torch.bfloat16,)),
]
# (backward kernel, shape, dtype) whose relative error is reported beside
# its gate, not held to it, and the fault it shows: ROADMAP C names it
KNOWN_FAULTS = {
    (HG_BWD_KERNEL, "hg_edge_s1000_causal", "float32"):
        "ROADMAP C: the tf32x3 K2 backward's error grows with S (1.59e-5 of max|plain| at S = 1000)",
}
# K3: (tag, B, M entities, N objects, k, empty_row): finetune_ot's shape
# (16 entities, 8 object slots minus the whole image) with ragged counts,
# k = 2, one row without entities, and larger graphs up to the kernel's cap;
# then the boundary of the warp variant (M <= 32 and N <= 32) from both
# sides at B = 64, the block variant's empty row among them
OT_SHAPES = [
    ("ot_finetune", 64, 16, 7, 1, False),
    ("ot_finetune_k2", 64, 16, 7, 2, False),
    ("ot_empty_row", 64, 16, 7, 1, True),
    ("ot_256x16x10", 256, 16, 10, 1, False),
    ("ot_256x32x32", 256, 32, 32, 1, False),
    ("ot_256x128x128", 256, 128, 128, 1, False),
    ("ot_m32_n32", 64, 32, 32, 1, False),
    ("ot_m33_n32", 64, 33, 32, 1, False),
    ("ot_m32_n33", 64, 32, 33, 1, False),
    ("ot_m33_n32_empty_row", 64, 33, 32, 1, True),
]
OT_BOUNDARY = {"ot_m32_n32", "ot_m33_n32", "ot_m32_n33", "ot_m33_n32_empty_row"}
OT_TIMED = {"ot_finetune", "ot_finetune_k2", "ot_256x16x10", "ot_256x32x32", "ot_256x128x128",
            "ot_m32_n32", "ot_m33_n32"}
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
# K4: (tag, N rows, W) of the residual blocks' LayerNorms: the ViT-B/32 and
# ViT-L/14 train steps (384 x 3 and 64 x 3), ViT-B/32 serving at batch 64
LN_SHAPES = [
    ("b32_train_text", 1152 * 77, 512), ("b32_train_vision", 384 * 50, 768),
    ("l14_train_vision", 64 * 257, 1024), ("l14_train_text", 192 * 77, 768),
    ("b32_serving_text", 64 * 77, 512), ("b32_serving_vision", 64 * 50, 768),
]
# edge shapes, each with a 1e3 spike in its last row and (N > 1) a first row
# of equal values (var = 0): N = 1, an N that fills no whole row block, the
# other preset widths, a width that is no multiple of 4, the widest
LN_EDGE_SHAPES = [
    ("ln_edge_n1", 1, 512), ("ln_edge_n1001_w640", 1001, 640), ("ln_edge_w1280", 333, 1280),
    ("ln_edge_w100", 37, 100), ("ln_edge_w3072", 9, 3072),
]
# rows of the misaligned-view check (`check_ln_misaligned`), and the
# profiled calls behind each K4 row's device ms
LN_MISALIGNED_ROWS = 1001
LN_DEVICE_ITERS = 10
# K6: the component bench's shapes (B = 256 images x 3 texts), then edges:
# B = 1, S = 1, S = 128, head_dim 32, and a width that fills no whole k tile
MEGA_SHAPES = [  # (tag, B, S, W, H, causal)
    ("mega_text", 768, 77, 512, 8, True),
    ("mega_vision", 256, 50, 768, 12, False),
]
MEGA_EDGE_SHAPES = [
    ("mega_edge_b1", 1, 13, 128, 2, True),
    ("mega_edge_s1", 2, 1, 128, 2, False),
    ("mega_edge_s128", 2, 128, 128, 2, True),
    ("mega_edge_d32", 3, 40, 256, 8, False),
    ("mega_edge_w60_d20", 2, 19, 60, 3, True),
    # head_dim 16; the L/14 text width (bf16 rows too wide to stay
    # resident); S = 128 at 768 wide (the same, at the most rows)
    ("mega_edge_d16", 2, 33, 128, 8, True),
    ("mega_edge_w1024", 2, 77, 1024, 16, True),
    ("mega_edge_s128_w768", 2, 128, 768, 12, False),
]
N_ITEMS = 256  # images and token rows served at ViT-B/32
BATCH = 64
SOT, EOT = 49406, 49407
# device kernels by family, for the profile's breakdown (first match wins)
KERNEL_FAMILIES = (
    ("layer norm (hand-written)", ("layer_norm_fwd", "layer_norm_bwd")),
    ("megakernel (hand-written)", ("ln_qkv_attention_kernel",)),
    ("attention (hand-written)", ("attention_fwd_kernel", "attention_bwd_", "attention_hg_")),
    ("ipot (hand-written)", ("ipot_kernel",)),
    ("int8 gemm (hand-written)", ("int8_gemm_wgmma_kernel", "quant_rows_kernel")),
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
# fp32 loss (abs) and each gradient tensor (rel. to its max). fp32: both
# sides keep an fp32 softmax, the kernels' products in split TF32 (PR 8's
# reading at ViT-L/14: loss 4.8e-7, gradients <= 5.5e-6 of their max on
# the H100). bf16: the tensor-core variants of K1 and
# K2 round P and dS to bf16, so the kernel step is held at 1e-3 against the
# plain step that rounds where they round (impl "rounded"), and against the
# fp32-P plain step at one bf16 rounding, u = 2^-8, relative to the value
# (to max(1, |loss|) for a loss): every attention product's operand carries
# one such rounding (PERF.md §2)
BF16_STEP_TOL = 1e-3
BF16_ROUNDING_TOL = 2 ** -8
FP32_STEP_TOL = 2e-5
WARMUP_STEPS, TIMED_STEPS = 2, 5
# the graphed train step (`make_multi_step`, `steps_per_dispatch`): steps a
# dispatch in the train loops (one warm-up dispatch, GRAPH_TIMED_DISPATCHES
# timed), in the bit-for-bit check against eager steps (two dispatches), and
# in the eager-against-graph timing (3 of the JAX bench's 10 steps a call:
# the script's time limit; a replay's ms does not depend on K)
GRAPH_LOOP_K, GRAPH_TIMED_DISPATCHES = 4, 2
GRAPH_CHECK_K = 4
GRAPH_TIMING_K = 3
# the data-parallel phase: synchronised steps a turn, and the matching
# eval's pairs
DP_TIMING_STEPS, DP_EVAL_ITEMS = 2, 256
# kernel names a profile counts for each counter (K4a and K4b run one
# kernel, `layer_norm_fwd_reg_kernel` or the generic `layer_norm_fwd_kernel`;
# K4c one, `layer_norm_bwd_reg_kernel` or `layer_norm_bwd_kernel`; K1's and
# K2's backwards one or two)
PROFILE_NEEDLES = {
    KERNEL: ("attention_fwd_kernel",), BWD_KERNEL: ("attention_bwd_",),
    HG_KERNEL: ("attention_hg_fwd_kernel",), HG_BWD_KERNEL: ("attention_hg_bwd_",),
    "ipot": ("ipot_kernel",), "layer_norm+add_layer_norm": ("layer_norm_fwd",),
    "layer_norm_bwd": ("layer_norm_bwd",),
}
# ViT-L/14 (bench.py's L/14 workload) and ViT-B/16 (its bench batch)
L14_BATCH, B16_BATCH = 64, 96
L14_FP32_BATCH = 16  # the fp32 L/14 step (kernel vs plain, in turns)
L14_SERVING_ITEMS = 128
# finetune_ot.json: batch 64, 8 object slots (the whole image at slot 0),
# 16 entity and 8 event rows per image, alignment_chunks 4
OT_BATCH, OT_OBJECTS, OT_ENTITIES, OT_EVENTS, OT_CHUNKS = 64, 8, 16, 8, 4
# steps a dispatch in train_ot's graph-against-eager timing (the script's
# time limit: its eager steps take ~1 s each)
OT_GRAPH_TIMING_K = 2
OT_FP32_CHECK_BATCH = 16
# every kernel's launch counter, by the kernel's source name (K4b shares
# K4a's source)
ADD_LN_KERNEL = "add_layer_norm"
COUNTERS = {
    KERNEL: fused_attention_qkv, BWD_KERNEL: fused_attention_qkv_bwd,
    HG_KERNEL: fused_attention_qkv_headgrid, HG_BWD_KERNEL: fused_attention_qkv_headgrid_bwd,
    ot.KERNEL: ot.ipot_kernel, quant.KERNEL: quant.quantized_matmul,
    ln.KERNEL: ln.fused_layer_norm, ADD_LN_KERNEL: ln.fused_add_layer_norm,
    ln.BWD_KERNEL: ln.fused_layer_norm_bwd, MEGA_KERNEL: fused_ln_qkv_attention,
}
SOURCES = {name: ln.KERNEL if name == ADD_LN_KERNEL else name for name in COUNTERS}


def reset_launches() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started (`t_s`)."""
    print(json.dumps({**obj, "t_s": time.perf_counter() - T_START}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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


def device_ms(fn, needles, iters=20) -> dict:
    """{needle: mean device time in ms of the kernel whose name holds the
    needle, one launch a call of fn()}, by torch.profiler over `iters` warm
    calls: the kernel's own time, without the host's time between launches
    that `cuda_ms` reads where a call's device work is shorter than its host
    work. The mean is over the launches the trace kept; a trace that kept
    fewer than `iters` is taken again, once. None for a needle the trace
    shows no time for."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # once more if the trace lost a kernel's records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        kept = {n: [(e.self_device_time_total, e.count) for e in events if n in e.key] for n in needles}
        out = {n: sum(t for t, _ in k) / sum(c for _, c in k) / 1e3 if k else None for n, k in kept.items()}
        if all(sum(c for _, c in k) >= iters for k in kept.values()):
            return out
    return out


def _attention_bound(nbytes, flops, dtype_name):
    """(bound ms, what bounds it, the CUDA-core route's ms or None): the
    larger of bytes over the memory rate and flops over the peak rate. bf16
    at the tensor cores' rate; fp32 at the least of the card's two routes to
    fp32 accuracy, three TF32 products a flop on the tensor cores (the
    least) or one FMA on the CUDA cores, whose bound is returned beside."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    if dtype_name == "float32":
        t_ops = TF32X3_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3
        cuda_cores = max(t_bytes, flops / PEAK_FLOPS["float32"] * 1e3)
    else:
        t_ops, cuda_cores = flops / PEAK_FLOPS[dtype_name] * 1e3, None
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), cuda_cores


def attention_bound_ms(B, S, W, H, causal, dtype_name):
    """Least time for one attention forward: qkv read once, the bias read
    once, the output written once, over the memory rate; 4·B·H·S²·D flops
    (q·kᵀ and p·v) over the peak rate (`_attention_bound`)."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = B * S * 3 * W * elt + B * S * W * elt + (S * S * 4 if causal else 0)
    return _attention_bound(nbytes, 4 * B * H * S * S * (W // H), dtype_name)


def attention_bwd_bound_ms(B, S, W, H, causal, dtype_name):
    """Least time for one attention backward: qkv (3W) and do (W) read once
    and dqkv (3W) written once per token, the bias read once, over the
    memory rate; 10·B·H·S²·D flops (recompute q·kᵀ, dv, dp, dq, dk) over
    the peak rate (`_attention_bound`)."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = B * S * 7 * W * elt + (S * S * 4 if causal else 0)
    return _attention_bound(nbytes, 10 * B * H * S * S * (W // H), dtype_name)


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


def check_against_rounded(row, got, rounded, ref_max, what):
    """An mma variant (K1's or K2's) against the plain version that rounds where it
    rounds: the worst and the mean error, relative to max|plain|."""
    diff = (got.float() - rounded.float()).abs()
    row["max_rel_err_vs_rounded_plain"] = diff.max().item() / ref_max
    row["mean_rel_err_vs_rounded_plain"] = diff.mean().item() / ref_max
    row["tol_rel_vs_rounded_plain"] = MMA_ROUNDED_TOL
    row["tol_mean_rel_vs_rounded_plain"] = MMA_ROUNDED_MEAN_TOL
    check(row["max_rel_err_vs_rounded_plain"] <= MMA_ROUNDED_TOL,
          f"{what}: {row['max_rel_err_vs_rounded_plain']} from the rounded plain version > {MMA_ROUNDED_TOL}")
    check(row["mean_rel_err_vs_rounded_plain"] <= MMA_ROUNDED_MEAN_TOL,
          f"{what}: mean {row['mean_rel_err_vs_rounded_plain']} from the rounded plain version > "
          f"{MMA_ROUNDED_MEAN_TOL}")


# one attention kernel pair: its counter names, autograd entry point,
# backward, forward with lse, variant rule, the path shape where two
# backward runs must give equal bits, and the kernels a backward call
# launches, by (variant, head_dim)
AttentionKernels = collections.namedtuple(
    "AttentionKernels", "names fn bwd fwd_lse variant deterministic_at bwd_launches")
K1 = AttentionKernels((KERNEL, BWD_KERNEL), fused_attention_qkv, fused_attention_qkv_bwd,
                      fused_attention_qkv_fwd, k1_variant, "train_text", bwd_launches_per_call)
K2 = AttentionKernels((HG_KERNEL, HG_BWD_KERNEL), fused_attention_qkv_headgrid,
                      fused_attention_qkv_headgrid_bwd, fused_attention_qkv_headgrid_fwd,
                      headgrid_variant, "l14_vision", lambda variant, head_dim: HG_BWD_LAUNCHES_PER_CALL)


# the forward kernels of K1 and K2 as a profile names them (every variant),
# and their C entry points
FWD_NEEDLES = {KERNEL: "attention_fwd_kernel", HG_KERNEL: "attention_hg_fwd_kernel"}
FWD_SYMBOLS = {KERNEL: "clip_attention_fwd", HG_KERNEL: "clip_attention_hg_fwd"}
DEVICE_MS_CALLS = 10  # warm calls a forward row's profile averages (K4's rows: 10)


def old_fwd_in_turns(row, name, qkv, bias, H, scale, out, iters):
    """The earlier tree's bf16 forward of K1 or K2 (`name`; `--old-csrc`,
    built as old_<name>) beside this tree's, both through their C entry
    points on the same operands: its output against this one's (`out`, the
    wrapper's), the two timed in turns (old, new, new, old) and each
    kernel's device ms."""
    B, S, W3 = qkv.shape
    W = W3 // 3
    o = torch.empty((B, S, W), device="cuda", dtype=qkv.dtype)
    lse = torch.empty((B, H, S), device="cuda")
    b = None if bias is None else bias.float().contiguous()
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        def launch():
            check(fn(qkv.data_ptr(), None if b is None else b.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, H,
                     W // H, float(scale), 1, stream) == 0, f"{name}: a forward launch")
        return launch

    old = call(getattr(OLD_LIBS[name], FWD_SYMBOLS[name]))
    new = call(_build.entry(name, FWD_SYMBOLS[name], attention_ops._FWD_ARGS)[1])
    new()
    torch.cuda.synchronize()
    check(torch.equal(o, out), f"{name}: the C entry point and the wrapper differ")
    old()
    torch.cuda.synchronize()
    row["old_max_abs_diff"] = (o.float() - out.float()).abs().max().item()
    readings = {}
    t = in_turns_many({"old": old, "new": new}, iters, readings=readings)
    row["old_ms"], row["new_kernel_ms"], row["old_new_readings_ms"] = t["old"], t["new"], readings
    needle = FWD_NEEDLES[name]
    row["old_device_ms"] = device_ms(old, (needle,), DEVICE_MS_CALLS)[needle]


def check_attention(rows, errs, k, gen, tag, B, S, W, H, causal, dtype, timed):
    """One attention kernel pair `k` (forward, backward) against its plain
    versions at one shape and dtype; times, bound and library time when
    `timed`. Rows and the worst errors go under the kernels' names."""
    fwd_name, bwd_name = k.names
    fwd, bwd = k.fn, k.bwd
    name = str(dtype).split(".")[-1]
    qkv = torch.randn((B, S, 3 * W), device="cuda", generator=gen).to(dtype)
    do = torch.randn((B, S, W), device="cuda", generator=gen).to(dtype)
    bias = causal_mask(S, device="cuda") if causal else None
    scale = (W // H) ** -0.5
    iters = 20 if B > 64 or S > 128 else 50
    # the Python rule and both libraries' rule pick one variant, the rule
    # of both pairs: the path shapes take the tensor cores in both dtypes
    variant = k.variant(dtype, W // H)
    check(library_variant(fwd_name, dtype, W // H) == variant
          and library_variant(bwd_name, dtype, W // H) == variant,
          f"{fwd_name} {tag} {name}: the libraries' variant differs from {variant}")
    expected = "simt"
    if W // H in MMA_HEAD_DIMS:
        expected = "mma" if name == "bfloat16" else "tf32x3"
    check(variant == expected, f"{fwd_name} {tag} {name}: variant {variant}, not {expected}")
    tensor_cores = variant in TENSOR_CORE_VARIANTS
    shape = {"shape": tag, "B": B, "S": S, "W": W, "H": H, "causal": causal, "dtype": name,
             "variant": variant}

    out = fwd(qkv, bias, H, scale)
    ref = fused_attention_qkv_plain(qkv, bias, H, scale)
    torch.cuda.synchronize()
    check(out.dtype == dtype and out.shape == (B, S, W), f"{fwd_name} {tag} {name} shape/dtype")
    check(bool(torch.isfinite(out).all()), f"{fwd_name} {tag} {name} output finite")
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= TOL[name], f"{fwd_name} {tag} {name}: max abs err {err} > {TOL[name]}")
    errs[fwd_name][name] = max(errs[fwd_name].get(name, 0.0), err)
    row = {**shape, "max_abs_err": err, "tol": TOL[name]}
    if variant == "mma":
        ref_max = max(ref.float().abs().max().item(), 1e-30)
        row["max_rel_err"], row["tol_rel"] = err / ref_max, MMA_FWD_REL_TOL
        check(row["max_rel_err"] <= MMA_FWD_REL_TOL,
              f"{fwd_name} {tag} {name}: rel err {row['max_rel_err']} > {MMA_FWD_REL_TOL}")
        rounded = fused_attention_qkv_plain(qkv, bias, H, scale, mma_rounding=True)
        check_against_rounded(row, out, rounded, ref_max, f"{fwd_name} {tag} {name}")
        del rounded
    if variant == "tf32x3":
        # against the plain version that splits where the kernel splits:
        # what is left is the sum order (a bug would show here first)
        split = fused_attention_qkv_plain(qkv, bias, H, scale, tf32x3=True)
        row["max_abs_err_vs_tf32x3_plain"] = (out - split).abs().max().item()
        del split
    if timed:
        row["ms"] = cuda_ms(lambda: fwd(qkv, bias, H, scale), iters)
        row["plain_ms"] = cuda_ms(lambda: fused_attention_qkv_plain(qkv, bias, H, scale), iters)
        lib = library_fwd(qkv, bias, H, scale)
        check((lib.float() - ref.float()).abs().max().item() <= 10 * TOL[name],
              f"{fwd_name} {tag} {name}: library yardstick disagrees")
        row["library_ms"] = cuda_ms(lambda: library_fwd(qkv, bias, H, scale), iters)
        row["bound_ms"], row["bound_by"], cuda_cores = attention_bound_ms(B, S, W, H, causal, name)
        if cuda_cores is not None:
            row["bound_ms_cuda_cores"] = cuda_cores
        # the kernel's own time (a small call's wall ms is the wrapper's)
        needle = FWD_NEEDLES[fwd_name]
        row["device_ms"] = device_ms(lambda: fwd(qkv, bias, H, scale), (needle,), DEVICE_MS_CALLS)[needle]
        if variant == "mma" and fwd_name in OLD_LIBS:
            old_fwd_in_turns(row, fwd_name, qkv, bias, H, scale, out, iters)
    rows[fwd_name].append(row)
    emit({"phase": "kernel_check", "kernel": fwd_name, **row})

    # a direct backward call: a tensor-core variant runs the forward kernel
    # for the output and lse first
    before = read_launches()
    dq = bwd(qkv, bias, do, H, scale)
    launched = {n: read_launches()[n] - before[n] for n in k.names}
    per_call = {fwd_name: int(tensor_cores), bwd_name: k.bwd_launches(variant, W // H)}
    check(launched == per_call, f"{bwd_name} {tag} {name}: a direct call launched {launched}, not {per_call}")
    ref = fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale)
    torch.cuda.synchronize()
    check(dq.dtype == dtype and dq.shape == qkv.shape, f"{bwd_name} {tag} {name} shape/dtype")
    check(bool(torch.isfinite(dq).all()), f"{bwd_name} {tag} {name} output finite")
    err = (dq.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    fault = KNOWN_FAULTS.get((bwd_name, tag, name))
    if fault is None:
        check(rel <= BWD_TOL[name], f"{bwd_name} {tag} {name}: rel err {rel} > {BWD_TOL[name]}")
        errs[bwd_name][name] = max(errs[bwd_name].get(name, 0.0), err)
    row = {**shape, "max_abs_err": err, "max_rel_err": rel, "tol_rel": BWD_TOL[name],
           "bwd_launches_per_call": per_call[bwd_name]}
    if fault is not None:
        row["known_fault"], row["within_tol_rel"] = fault, rel <= BWD_TOL[name]
    ref_max = max(ref.float().abs().max().item(), 1e-30)
    if variant == "mma":
        rounded = fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, mma_rounding=True)
        check_against_rounded(row, dq, rounded, ref_max, f"{bwd_name} {tag} {name}")
        del rounded
    if variant == "tf32x3":
        split = fused_attention_qkv_bwd_plain(qkv, bias, do, H, scale, tf32x3=True)
        row["max_rel_err_vs_tf32x3_plain"] = (dq - split).abs().max().item() / ref_max
        del split
    if tensor_cores:
        # through autograd the forward's output and row log-sum-exp are
        # saved and the backward reads them: the same bits as the direct
        # call, which runs the forward kernel for them first
        leaf = qkv.detach().requires_grad_(True)
        (via_autograd,) = torch.autograd.grad(fwd(leaf, bias, H, scale), leaf, do)
        check(torch.equal(via_autograd, dq), f"{bwd_name} {tag} {name}: saved residuals change the bits")
        del leaf, via_autograd
        if timed:
            saved_out, lse = k.fwd_lse(qkv, bias, H, scale, with_lse=True)
            row["ms_with_saved_residuals"] = cuda_ms(
                lambda: bwd(qkv, bias, do, H, scale, out=saved_out, lse=lse), iters)
            del saved_out, lse
        if tag == k.deterministic_at:
            # no atomics: the same bits on every run
            again = bwd(qkv, bias, do, H, scale)
            check(torch.equal(again, dq), f"{bwd_name} {tag} {name}: two runs differ")
            row["deterministic"] = True
            del again
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
        row["bound_ms"], row["bound_by"], cuda_cores = attention_bwd_bound_ms(B, S, W, H, causal, name)
        if cuda_cores is not None:
            row["bound_ms_cuda_cores"] = cuda_cores
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


# the latency floor of one IPOT solve (a model, not a measurement): cycles
# of a dependent shuffle level, of an IEEE reciprocal and of an FMA, the SM
# clock of the H100 SXM at its full power limit, and one kernel launch
SHFL_CYCLES, RCP_CYCLES, FMA_CYCLES = 30, 20, 4
SM_CLOCK_HZ = 1.98e9
LAUNCH_MS = 0.003


def ipot_bound_ms(B, M, N, iterations, k):
    """Least time for one IPOT solve: the cost, the pad masks and lengths
    read once and the plan written once, over the memory rate; per item
    M·N exponentials and divisions for A, then per iteration M·N for
    Q = A∘T, k × 4·M·N for the two matvecs and 2·M·N for T, over the fp32
    peak. The larger wins. Beside it, the latency floor: `iterations` × k
    dependent updates, each a reduction over m (5 shuffle levels), a
    reciprocal, a broadcast (a shuffle), a sum over n (N dependent FMAs)
    and a reciprocal, plus a launch."""
    nbytes = 4 * (2 * B * M * N + B * (M + N) + 2 * B)
    flops = B * (2 * M * N + iterations * (3 * M * N + k * 4 * M * N))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    step = 6 * SHFL_CYCLES + 2 * RCP_CYCLES + N * FMA_CYCLES
    floor = LAUNCH_MS + iterations * k * step / SM_CLOCK_HZ * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), floor


def in_turns(old, new, iters, warmup=5):
    """(old ms, new ms): each timed twice by `cuda_ms`, in the order old,
    new, new, old, and averaged."""
    t = in_turns_many({"old": old, "new": new}, iters, warmup)
    return t["old"], t["new"]


def in_turns_many(fns, iters, warmup=5, readings=None):
    """{name: ms} of each of `fns`, timed by `cuda_ms` in their order and
    then in the reverse order, the two readings averaged; `readings`, a
    dict, receives both readings of each."""
    t = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        t[name].append(cuda_ms(fns[name], iters, warmup))
    if readings is not None:
        readings.update(t)
    return {name: float(np.mean(ms)) for name, ms in t.items()}


def build_libraries(specs):
    """{key: library} of (key, source directory, source name, extra nvcc
    flags) specs: each csrc `name`.cu of that directory (its headers beside
    it) built by nvcc under the name `key`, all started together."""
    import subprocess

    procs = {}
    for key, src_dir, name, flags in specs:
        out = os.path.join(_build.BUILD_DIR, f"{key}-{os.getpid()}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", src_dir, "-o", out,
               os.path.join(src_dir, name + ".cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"{key}: nvcc failed:\n{log}")
        libs[key] = ctypes.CDLL(out)
    return libs


def build_old_kernels(old_csrc):
    """K3's, K6's and K1's and K2's forward sources of an earlier tree
    (`old_csrc`: its csrc/, headers beside them), built under the names
    old_ipot, old_ln_qkv_attention, old_attention_fwd and
    old_attention_hg_fwd: {source name: library}."""
    names = (ot.KERNEL, MEGA_KERNEL, KERNEL, HG_KERNEL)
    built = build_libraries([(f"old_{name}", old_csrc, name, ()) for name in names])
    libs = {name: built[f"old_{name}"] for name in names}
    for name in (KERNEL, HG_KERNEL):
        fn = getattr(libs[name], FWD_SYMBOLS[name])
        fn.argtypes, fn.restype = attention_ops._FWD_ARGS, ctypes.c_int
    libs[ot.KERNEL].clip_ipot.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    libs[MEGA_KERNEL].clip_ln_qkv_attention.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for lib, fn in ((libs[ot.KERNEL], "clip_ipot"), (libs[MEGA_KERNEL], "clip_ln_qkv_attention")):
        getattr(lib, fn).restype = ctypes.c_int
    return libs


# the earlier tree's K3, K6 and K1's and K2's forwards (`--old-csrc`), timed
# beside these in turns
OLD_LIBS = {}


def check_ipot(rows, errs, gen, tag, B, M, N, k, empty_row, timed=True):
    """K3 against the plain solver at one shape (OT_TOL relative), in the
    variant `ot.ipot_variant` picks; times, the bound and the latency floor
    when `timed`, the other variant's time where it takes the shape too, and
    the earlier tree's kernel in turns (`--old-csrc`)."""
    cost, x_len, x_pad, y_len, y_pad, joint = ot_inputs(gen, B, M, N, empty_row)
    variant = ot.ipot_variant(M, N)
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
           "dtype": "float32", "variant": variant, "max_abs_err": err, "max_rel_err": rel,
           "tol_rel": OT_TOL["float32"]}
    if timed:
        row["ms"] = cuda_ms(lambda: ot.ipot_kernel(cost, x_len, x_pad, y_len, y_pad, k=k), 50)
        row["plain_ms"] = cuda_ms(lambda: ot.ipot(cost, x_len, x_pad, y_len, y_pad, joint, 0.5, 50, k),
                                  5, warmup=2)
        row["library_ms"] = None  # no one PyTorch call solves IPOT
        row["bound_ms"], row["bound_by"], row["latency_floor_ms"] = ipot_bound_ms(B, M, N, 50, k)
        # the kernels alone on the wrapper's operands: this variant, the
        # block variant where the warp one took the shape, the earlier tree's
        # (the earlier tree's kernel reads fp32 pads, these read bytes)
        args = [t.contiguous() for t in (cost, x_pad, y_pad, x_len, y_len)]
        old_args = [t.float().contiguous() for t in args]
        out = torch.empty((B, N, M), device="cuda")
        fn = _build.load(ot.KERNEL).clip_ipot
        stream = torch.cuda.current_stream().cuda_stream

        def call(f, *extra, operands=args):
            return lambda: f(*(t.data_ptr() for t in operands), out.data_ptr(), B, M, N, 0.5, 50, k,
                             *extra, stream)

        new = call(fn, ot.IPOT_VARIANTS.index(variant))
        if variant == "warp":
            block = call(fn, ot.IPOT_VARIANTS.index("block"))
            block()
            torch.cuda.synchronize()
            row["block_variant_max_abs_diff"] = diff = (out - plan).abs().max().item()
            check(diff <= OT_TOL["float32"] * max(ref.abs().max().item(), 1e-30),
                  f"ipot {tag}: the block variant is {diff} from the warp one")
            row["block_variant_ms"], row["kernel_ms"] = in_turns(block, new, 50)
        if ot.KERNEL in OLD_LIBS:
            old = call(OLD_LIBS[ot.KERNEL].clip_ipot, operands=old_args)
            old()
            torch.cuda.synchronize()
            row["old_max_abs_diff"] = (out - plan).abs().max().item()
            row["old_ms"], row["kernel_ms"] = in_turns(old, new, 50)
    rows[ot.KERNEL].append(row)
    emit({"phase": "kernel_check", "kernel": ot.KERNEL, **row})


def check_k3(rows, errs, gen):
    """K3's two variants at every OT shape; each variant takes at least one.
    The boundary shapes draw from a generator of their own, so that the
    checks after K3's (K5, K4, K6) see the inputs they saw before them."""
    boundary = torch.Generator(device="cuda").manual_seed(1)
    for shape in OT_SHAPES:
        g = boundary if shape[0] in OT_BOUNDARY else gen
        check_ipot(rows, errs, g, *shape, timed=shape[0] in OT_TIMED)
    taken = {r["variant"] for r in rows[ot.KERNEL]}
    check(taken == set(ot.IPOT_VARIANTS), f"ipot: every variant ran, got {taken}")


def quant_bound_ms(M, K, N, dtype_name, static):
    """Least time for one K5 call: x read once, q read once, the output
    written once, the column scales and bias (and the static scale) read
    once, over the memory rate; 2·M·N·K int8 operations over the int8 peak.
    The larger wins."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = M * K * elt + K * N + M * N * elt + 2 * N * 4 + (4 if static else 0)
    return _quant_bound(nbytes, 2 * M * N * K)


def quant_gemm_bound_ms(M, K, N, dtype_name):
    """Least time for K5's GEMM alone: the int8 rows and q read once, the
    row and column scales and the bias read once, the output written once;
    2·M·N·K int8 operations."""
    elt = 4 if dtype_name == "float32" else 2
    return _quant_bound(M * K + K * N + 4 * M + 2 * N * 4 + M * N * elt, 2 * M * N * K)


def quant_rows_bound_ms(M, K, dtype_name):
    """Least time for K5's row pass alone: x read once, its int8 rows and
    the row scales written once (bytes bound: a few operations a byte)."""
    elt = 4 if dtype_name == "float32" else 2
    return M * (K * elt + K + 4) / PEAK_BYTES_PER_S * 1e3


def _quant_bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_quant(rows, errs, gen, tag, M, K, N, dtype, static, timed, edge):
    """K5 against its plain version at one shape, dtype and mode: the output
    (QUANT_TOL, relative to max|plain|, and equal bits), the GEMM alone on
    the row pass's output against `quantized_gemm_plain` (equal bits), and
    the row pass's int8 payload and row scales exactly. Times of the whole
    call, the GEMM alone and the row pass alone, their bounds and two
    yardsticks when `timed`: torch._int_mm on the pre-quantised operands
    (the GEMM alone, where its shape rules allow: M > 16, K and N multiples
    of 8) and the bf16 torch.matmul of the same shape (the float path int8
    is meant to beat)."""
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
    mode = "static" if static else "dynamic"
    what = f"{quant.KERNEL} {tag} {name} {mode}"
    check(quant.is_k_major(w.q), f"{what}: quantize_weight stores q K-major")
    y = quant.quantized_matmul(*args)
    ref = quant.quantized_matmul_plain(*args)
    xq, rs = quant.quantize_rows(x, w.act_scale)
    pxq, prs = quant.quantize_rows_plain(x, w.act_scale)
    gemm_args = (xq, rs, w.q, w.scale, bias, dtype)
    g = quant.quantized_gemm(*gemm_args)
    gref = quant.quantized_gemm_plain(*gemm_args)
    torch.cuda.synchronize()
    check(y.dtype == dtype and y.shape == (M, N), f"{what} shape/dtype")
    check(bool(torch.isfinite(y).all()), f"{what} output finite")
    check(torch.equal(xq[:, :K], pxq) and not bool(xq[:, K:].any()), f"{what}: int8 payload differs")
    check(torch.equal(rs, prs), f"{what}: row scales differ")
    err = (y.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    check(rel <= QUANT_TOL[name], f"{what}: rel err {rel} > {QUANT_TOL[name]}")
    check(torch.equal(y, ref), f"{what}: not bit-exact against the plain version (max abs err {err})")
    gerr = (g.float() - gref.float()).abs().max().item()
    check(torch.equal(g, gref) and torch.equal(g, y),
          f"{what}: the GEMM alone differs from its plain version (max abs err {gerr})")
    if edge and M > 1:
        check(torch.equal(y[0], bias.to(dtype)), f"{what}: the all-zero row yields the bias")
    errs[quant.KERNEL][name] = max(errs[quant.KERNEL].get(name, 0.0), err, gerr)
    row = {"shape": tag, "M": M, "K": K, "N": N, "dtype": name, "mode": mode, "max_abs_err": err,
           "max_rel_err": rel, "tol_rel": QUANT_TOL[name], "gemm_max_abs_err": gerr}
    if timed:
        iters = 10 if M * N * K > 1e10 else 30
        row["ms"] = cuda_ms(lambda: quant.quantized_matmul(*args), iters)
        row["gemm_ms"] = cuda_ms(lambda: quant.quantized_gemm(*gemm_args), iters)
        row["rows_ms"] = cuda_ms(lambda: quant.quantize_rows(x, w.act_scale), iters)
        # the kernels' own times in the whole call (below ~0.05 ms the
        # wrapper's host time sets the three wall times above); the GEMM's
        # tile traffic from L2 (128 x 128 output tiles, 32 KB a 128-deep k
        # step) and its share of the int8 rate
        dev = device_ms(lambda: quant.quantized_matmul(*args), ("int8_gemm", "quant_rows"), iters)
        row["gemm_device_ms"], row["rows_device_ms"] = dev["int8_gemm"], dev["quant_rows"]
        if dev["int8_gemm"]:
            tiles = -(-M // 128) * -(-N // 128) * -(-K // 128)
            row["gemm_tile_bytes_per_s"] = tiles * 32768 / (dev["int8_gemm"] * 1e-3)
            row["gemm_int8_rate_share"] = 2 * M * N * K / (dev["int8_gemm"] * 1e-3) / PEAK_INT8_OPS
        row["plain_ms"] = cuda_ms(lambda: quant.quantized_matmul_plain(*args), 5, warmup=1)
        row["gemm_plain_ms"] = cuda_ms(lambda: quant.quantized_gemm_plain(*gemm_args), 5, warmup=1)
        row["bound_ms"], row["bound_by"] = quant_bound_ms(M, K, N, name, static)
        row["gemm_bound_ms"], row["gemm_bound_by"] = quant_gemm_bound_ms(M, K, N, name)
        row["rows_bound_ms"] = quant_rows_bound_ms(M, K, name)
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


def check_k5(rows, errs, gen):
    for shapes, edge in ((QUANT_SHAPES, False), (QUANT_EDGE_SHAPES, True)):
        for tag, M, K, N in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                for static in (False, True):
                    check_quant(rows, errs, gen, tag, M, K, N, dtype, static, not edge, edge)


def sass_has(source, kernel_needle, opcode) -> dict:
    """{kernel: whether its SASS holds `opcode`} for every kernel of the
    library built from csrc/`source`.cu whose name holds `kernel_needle`
    (`cuobjdump -sass`), so a build that fell back to another instruction
    cannot pass unseen."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.library_path(source)], capture_output=True,
                          text=True, check=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if kernel_needle in name:
                found[name] = False
        elif name in found and opcode in line:
            found[name] = True
    return found


def k5_sass_has_igmma() -> dict:
    """{kernel: whether its SASS holds IGMMA, the warpgroup int8 MMA} for
    every GEMM kernel of K5's library."""
    return sass_has(quant.KERNEL, "int8_gemm", "IGMMA")


def ln_bound_ms(N, W, dtype_name, streams, vectors, flops_per_elt):
    """Least time for one LayerNorm call: `streams` [N, W] tensors in the
    I/O type and `vectors` fp32 [W] vectors, each moved once, over the memory
    rate; `flops_per_elt`·N·W flops over the fp32 peak. The larger wins."""
    elt = 4 if dtype_name == "float32" else 2
    t_bytes = (streams * N * W * elt + vectors * W * 4) / PEAK_BYTES_PER_S * 1e3
    t_ops = flops_per_elt * N * W / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ln_graph_replays(fn):
    """fn()'s outputs from a CUDA graph that captured it, replayed twice:
    (first replay's outputs cloned, second's). The capture runs on a side
    stream after one warm-up call there, as `torch.cuda.graph` wants."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    graph.replay()
    torch.cuda.synchronize()
    first = [t.clone() for t in outs]
    graph.replay()
    torch.cuda.synchronize()
    del graph
    return first, list(outs)


def check_ln(rows, errs, gen, tag, N, W, dtype, timed, edge):
    """K4a, K4b and K4c (alone, and with the cotangent of K4b's sum added)
    against their plain versions at one shape and dtype, each row naming
    its path (`ln.register_path`). Forward: max abs error (LN_TOL), K4b's
    sum exactly equal. Backward: dx, dgamma and dbeta each relative to
    max|plain| (LN_BWD_TOL); a second call, and two replays of a CUDA graph
    that captured the call, equal to the first call bit for bit. When
    `timed`: times, device times (`device_ms`), the wrapper's host µs a call
    (`wrapper_host_us`), the bound and the library yardsticks
    (`F.layer_norm`, the add then `F.layer_norm`, their backward by
    `torch.autograd.grad` on a retained graph)."""
    name = str(dtype).split(".")[-1]
    x = torch.randn((N, W), device="cuda", generator=gen).to(dtype)
    delta = torch.randn((N, W), device="cuda", generator=gen).to(dtype)
    dy = torch.randn((N, W), device="cuda", generator=gen).to(dtype)
    dx_out = torch.randn((N, W), device="cuda", generator=gen).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn((W,), device="cuda", generator=gen)
    beta = 0.1 * torch.randn((W,), device="cuda", generator=gen)
    if edge:
        x[-1, W // 2] = 1e3
        if N > 1:
            x[0] = 0.5
            delta[0] = 0.25
    path = "registers" if ln.register_path(W, x.data_ptr(), gamma.data_ptr(), beta.data_ptr()) else "generic"
    shape = {"shape": tag, "N": N, "W": W, "dtype": name, "path": path}
    iters = 20 if N * W > 2e7 else 50

    def forward_row(kernel_name, y, ref, extra):
        check(y.dtype == dtype and y.shape == (N, W), f"{kernel_name} {tag} {name} shape/dtype")
        check(bool(torch.isfinite(y).all()), f"{kernel_name} {tag} {name} output finite")
        err = (y.float() - ref.float()).abs().max().item()
        # LN_TOL is for outputs of unit size: the gate scales with the
        # largest output (~6 over 4e7 normal values, where one fp32 ulp is
        # 4.8e-7 and the two row reductions differ by 2-3 ulps of rstd;
        # ~sqrt(W) in the row with the spike)
        tol = LN_TOL[name] * max(1.0, ref.float().abs().max().item())
        check(err <= tol, f"{kernel_name} {tag} {name}: max abs err {err} > {tol}")
        errs[kernel_name][name] = max(errs[kernel_name].get(name, 0.0), err)
        return {**shape, "max_abs_err": err, "tol": tol, **extra}

    # ---- K4a
    y = ln.fused_layer_norm(x, gamma, beta)
    ref = ln.layer_norm_plain(x, gamma, beta)
    torch.cuda.synchronize()
    row = forward_row(ln.KERNEL, y, ref, {})
    if edge and N > 1:
        check(torch.equal(y[0].float(), beta.to(dtype).float()), f"{ln.KERNEL} {tag} {name}: var = 0 row yields beta")
    g_lib, b_lib = gamma.to(dtype), beta.to(dtype)  # F.layer_norm wants one dtype
    if timed:
        row["ms"] = cuda_ms(lambda: ln.fused_layer_norm(x, gamma, beta), iters)
        row["device_ms"] = device_ms(lambda: ln.fused_layer_norm(x, gamma, beta), ("layer_norm_fwd",),
                                     LN_DEVICE_ITERS)["layer_norm_fwd"]
        row["host_us"] = wrapper_host_us(lambda: ln.fused_layer_norm(x, gamma, beta))
        row["plain_ms"] = cuda_ms(lambda: ln.layer_norm_plain(x, gamma, beta), iters)
        lib = F.layer_norm(x, (W,), g_lib, b_lib)
        check((lib.float() - ref.float()).abs().max().item() <= (1e-5 if name == "float32" else 1e-1),
              f"{ln.KERNEL} {tag} {name}: library yardstick disagrees")
        row["library_ms"] = cuda_ms(lambda: F.layer_norm(x, (W,), g_lib, b_lib), iters)
        row["bound_ms"], row["bound_by"] = ln_bound_ms(N, W, name, 2, 2, 8)
    rows[ln.KERNEL].append(row)
    emit({"phase": "kernel_check", "kernel": ln.KERNEL, **row})

    # ---- K4b
    xs, y = ln.fused_add_layer_norm(x, delta, gamma, beta)
    ref_x, ref = ln.add_layer_norm_plain(x, delta, gamma, beta)
    torch.cuda.synchronize()
    check(xs.dtype == dtype and torch.equal(xs, ref_x), f"{ADD_LN_KERNEL} {tag} {name}: the sum differs")
    row = forward_row(ADD_LN_KERNEL, y, ref, {"sum_exact": True})
    if timed:
        row["ms"] = cuda_ms(lambda: ln.fused_add_layer_norm(x, delta, gamma, beta), iters)
        row["device_ms"] = device_ms(lambda: ln.fused_add_layer_norm(x, delta, gamma, beta),
                                     ("layer_norm_fwd",), LN_DEVICE_ITERS)["layer_norm_fwd"]
        row["host_us"] = wrapper_host_us(lambda: ln.fused_add_layer_norm(x, delta, gamma, beta))
        row["plain_ms"] = cuda_ms(lambda: ln.add_layer_norm_plain(x, delta, gamma, beta), iters)
        row["library_ms"] = cuda_ms(lambda: F.layer_norm(x + delta, (W,), g_lib, b_lib), iters)
        row["bound_ms"], row["bound_by"] = ln_bound_ms(N, W, name, 4, 2, 9)
    rows[ADD_LN_KERNEL].append(row)
    emit({"phase": "kernel_check", "kernel": ADD_LN_KERNEL, **row})

    # ---- K4c, alone and with the sum's cotangent folded in
    for variant, dxo in (("ln", None), ("add_ln", dx_out)):
        got = ln.fused_layer_norm_bwd(x, gamma, dy, dxo)
        want = ln.layer_norm_bwd_plain(x, gamma, dy, dxo)
        torch.cuda.synchronize()
        what = f"{ln.BWD_KERNEL} {tag} {name} {variant}"
        check(got[0].dtype == dtype and got[0].shape == (N, W) and got[1].dtype == torch.float32
              and got[1].shape == (W,) and got[2].shape == (W,), f"{what} shape/dtype")
        rels, err = {}, 0.0
        for part, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
            check(bool(torch.isfinite(a).all()), f"{what} {part} finite")
            e = (a.float() - b.float()).abs().max().item()
            rels[part] = e / max(b.float().abs().max().item(), 1e-30)
            check(rels[part] <= LN_BWD_TOL[name], f"{what}: {part} rel err {rels[part]} > {LN_BWD_TOL[name]}")
            err = max(err, e)
        errs[ln.BWD_KERNEL][name] = max(errs[ln.BWD_KERNEL].get(name, 0.0), err)
        # the same bits from a second call and from a graph's replays (the
        # grid's counters left at 0 by every launch)
        again = ln.fused_layer_norm_bwd(x, gamma, dy, dxo)
        replays = ln_graph_replays(lambda: ln.fused_layer_norm_bwd(x, gamma, dy, dxo))
        for part, a, b, r1, r2 in zip(("dx", "dgamma", "dbeta"), got, again, *replays):
            check(torch.equal(a, b), f"{what}: {part} differs between two calls")
            check(torch.equal(a, r1) and torch.equal(a, r2), f"{what}: {part} of a graph replay differs")
        del again, replays
        row = {**shape, "variant": variant, "max_abs_err": err, "max_rel_err": rels,
               "tol_rel": LN_BWD_TOL[name], "equal_bits_two_calls": True, "equal_bits_graph_replays": 2}
        if timed:
            row["ms"] = cuda_ms(lambda: ln.fused_layer_norm_bwd(x, gamma, dy, dxo), iters)
            row["device_ms"] = device_ms(lambda: ln.fused_layer_norm_bwd(x, gamma, dy, dxo),
                                         ("layer_norm_bwd",), LN_DEVICE_ITERS)["layer_norm_bwd"]
            row["host_us"] = wrapper_host_us(lambda: ln.fused_layer_norm_bwd(x, gamma, dy, dxo))
            sm_count, per_sm, warps = ln._blocks_per_sm(x.get_device(), W, ln._DTYPES[dtype], dxo is not None,
                                                        ln.REGISTERS if path == "registers" else ln.GENERIC)
            row["blocks_per_sm"], row["warps_per_block"] = per_sm, warps
            row["blocks"] = ln.bwd_blocks(N, sm_count, per_sm, warps)
            row["plain_ms"] = cuda_ms(lambda: ln.layer_norm_bwd_plain(x, gamma, dy, dxo), iters)
            # the library yardstick: F.layer_norm's backward alone (for the
            # add variant through the add, with both cotangents), on a graph
            # built once and retained
            # (x is the saved sum: the graph adds zeros to it)
            leaves = [t.detach().requires_grad_(True) for t in (x, torch.zeros_like(x), g_lib, b_lib)]
            if dxo is None:
                outs, cots = (F.layer_norm(leaves[0], (W,), leaves[2], leaves[3]),), (dy,)
                wrt = (leaves[0], leaves[2], leaves[3])
            else:
                total = leaves[0] + leaves[1]
                outs, cots = (total, F.layer_norm(total, (W,), leaves[2], leaves[3])), (dxo, dy)
                wrt = tuple(leaves)
            lib = torch.autograd.grad(outs, wrt, cots, retain_graph=True)
            lib_rel = ((lib[0].float() - want[0].float()).abs().max() / want[0].float().abs().max()).item()
            check(lib_rel <= 10 * LN_BWD_TOL[name], f"{what}: library yardstick disagrees ({lib_rel})")
            row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(outs, wrt, cots, retain_graph=True), iters)
            del outs, leaves, wrt, lib
            row["bound_ms"], row["bound_by"] = ln_bound_ms(N, W, name, 3 if dxo is None else 4, 3, 16)
        rows[ln.BWD_KERNEL].append(row)
        emit({"phase": "kernel_check", "kernel": ln.BWD_KERNEL, **row})


def k4_step_bound_ms(mcfg, images, texts, dtype_name="bfloat16"):
    """(forward, backward) least ms of K4 in one ViT train step with
    `use_pallas_ln` under full remat, by `ln_bound_ms` with `check_ln`'s
    streams: per block K4a and K4b twice (forward, recompute), K4c once
    alone and once with the sum's cotangent."""
    tokens = (mcfg.image_resolution // mcfg.vision_patch_size) ** 2 + 1
    fwd = bwd = 0.0
    for L, N, W in ((mcfg.vision_layers, images * tokens, mcfg.vision_width),
                    (mcfg.transformer_layers, texts * mcfg.context_length, mcfg.transformer_width)):
        fwd += 2 * L * (ln_bound_ms(N, W, dtype_name, 2, 2, 8)[0] + ln_bound_ms(N, W, dtype_name, 4, 2, 9)[0])
        bwd += L * (ln_bound_ms(N, W, dtype_name, 3, 3, 16)[0] + ln_bound_ms(N, W, dtype_name, 4, 3, 16)[0])
    return fwd, bwd


def check_ln_misaligned(gen, dtype, N=LN_MISALIGNED_ROWS, W=768):
    """K4a, K4b and K4c at a preset width on views that start one element
    into their buffers (2 or 4 bytes off 16): the generic kernels run, by
    `ln.register_path`, and are held to the kernel phase's gates."""
    name = str(dtype).split(".")[-1]

    def view():
        buf = torch.randn((N * W + 1,), device="cuda", generator=gen).to(dtype)
        return buf[1:].view(N, W)

    x, delta, dy, dx_out = view(), view(), view(), view()
    gamma = 1.0 + 0.1 * torch.randn((W,), device="cuda", generator=gen)
    beta = 0.1 * torch.randn((W,), device="cuda", generator=gen)
    check(x.is_contiguous() and not ln.register_path(W, x.data_ptr()), "a misaligned contiguous view")
    before = read_launches()
    y = ln.fused_layer_norm(x, gamma, beta)
    xs, y2 = ln.fused_add_layer_norm(x, delta, gamma, beta)
    got = ln.fused_layer_norm_bwd(x, gamma, dy, dx_out)
    torch.cuda.synchronize()
    after = read_launches()
    check(after[ln.KERNEL] - before[ln.KERNEL] == 1 and after[ADD_LN_KERNEL] - before[ADD_LN_KERNEL] == 1
          and after[ln.BWD_KERNEL] - before[ln.BWD_KERNEL] == ln.BWD_LAUNCHES_PER_CALL,
          f"K4 misaligned {name}: launches {before} -> {after}")
    ref_x, ref_y2 = ln.add_layer_norm_plain(x, delta, gamma, beta)
    check(torch.equal(xs, ref_x), f"{ADD_LN_KERNEL} misaligned {name}: the sum differs")
    out = {"shape": "ln_misaligned_w768", "N": N, "W": W, "dtype": name, "path": "generic"}
    for what, a, b in ((ln.KERNEL, y, ln.layer_norm_plain(x, gamma, beta)), (ADD_LN_KERNEL, y2, ref_y2)):
        err = (a.float() - b.float()).abs().max().item()
        tol = LN_TOL[name] * max(1.0, b.float().abs().max().item())
        check(err <= tol, f"{what} misaligned {name}: max abs err {err} > {tol}")
        out[f"{what}_max_abs_err"] = err
    for part, a, b in zip(("dx", "dgamma", "dbeta"), got, ln.layer_norm_bwd_plain(x, gamma, dy, dx_out)):
        rel = (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
        check(rel <= LN_BWD_TOL[name], f"{ln.BWD_KERNEL} misaligned {name}: {part} rel err {rel}")
        out[f"{ln.BWD_KERNEL}_{part}_rel_err"] = rel
    emit({"phase": "kernel_check", "kernel": "layer_norm_misaligned", **out})


def check_k4(rows, errs, gen):
    """K4a, K4b and K4c at the paths' and the edge shapes, fp32 and bf16,
    then at a misaligned view of a preset width; the seconds it took."""
    t0 = time.perf_counter()
    for shapes, edge in ((LN_SHAPES, False), (LN_EDGE_SHAPES, True)):
        for tag, N, W in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                check_ln(rows, errs, gen, tag, N, W, dtype, not edge, edge)
    for dtype in (torch.float32, torch.bfloat16):
        check_ln_misaligned(gen, dtype)
    torch.cuda.synchronize()
    emit({"phase": "k4_checks", "seconds": time.perf_counter() - t0})


def mega_bound_ms(B, S, W, H, causal, dtype_name):
    """Least time for one K6 call: x, the weight, the vectors and the bias
    read once and the output written once, over the memory rate; the
    projection's 2·B·S·W·3W flops plus the attention core's 4·B·H·S²·D over
    the peak rate for the input type (`_attention_bound`: fp32 at three
    TF32 products a flop, the CUDA-core bound returned beside). The larger
    wins."""
    elt = 4 if dtype_name == "float32" else 2
    nbytes = (2 * B * S * W + 3 * W * W + 5 * W) * elt + (S * S * 4 if causal else 0)
    flops = 2 * B * S * W * 3 * W + 4 * B * H * S * S * (W // H)
    return _attention_bound(nbytes, flops, dtype_name)


def check_mega(rows, errs, gen, tag, B, S, W, H, causal, dtype, timed):
    """K6 against its plain version at one shape and dtype (MEGA_TOL, max
    abs), and against the port's unfused chain, plain LayerNorm -> `linear`
    -> K1 on weights in the I/O type (MEGA_CHAIN_TOL); times, the bound and
    the chain's time when `timed`. No one PyTorch call computes it."""
    name = str(dtype).split(".")[-1]
    x = torch.randn((B, S, W), device="cuda", generator=gen).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn((W,), device="cuda", generator=gen)
    beta = 0.1 * torch.randn((W,), device="cuda", generator=gen)
    qkv_w = torch.randn((W, 3 * W), device="cuda", generator=gen) * W ** -0.5
    qkv_b = 0.1 * torch.randn((3 * W,), device="cuda", generator=gen)
    bias = causal_mask(S, device="cuda") if causal else None
    scale = (W // H) ** -0.5
    args = (x, gamma, beta, qkv_w, qkv_b, bias, H, scale)
    variant, layout = mega_variant(dtype, W // H), mega_layout(dtype, S, W, H)
    smem = mega_smem_bytes(dtype, S, W, H, layout)
    c_smem = _build.entry(MEGA_KERNEL, "clip_ln_qkv_attention_smem_bytes", [ctypes.c_int] * 6)[1]
    c_smem.restype = ctypes.c_longlong
    codes = {"simt": 0, "mma": 1, "tf32x3": 2}
    check(c_smem(S, H, W // H, int(dtype == torch.bfloat16), codes[variant],
                 int(layout == "stream")) == smem,
          f"{MEGA_KERNEL} {tag} {name}: the C and Python shared-memory counts agree ({smem})")
    out = fused_ln_qkv_attention(*args)
    ref = fused_ln_qkv_attention_plain(*args)
    torch.cuda.synchronize()
    check(out.dtype == dtype and out.shape == (B, S, W), f"{MEGA_KERNEL} {tag} {name} shape/dtype")
    check(bool(torch.isfinite(out).all()), f"{MEGA_KERNEL} {tag} {name} output finite")
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= MEGA_TOL[name], f"{MEGA_KERNEL} {tag} {name}: max abs err {err} > {MEGA_TOL[name]}")
    errs[MEGA_KERNEL][name] = max(errs[MEGA_KERNEL].get(name, 0.0), err)

    ln_p = {"scale": gamma.to(dtype), "bias": beta.to(dtype)}
    w_t, b_t = qkv_w.to(dtype), qkv_b.to(dtype)

    def chain():
        return fused_attention_qkv(layers.linear(layers.layer_norm(x, ln_p), w_t, b_t), bias, H, scale)

    with torch.no_grad():
        chain_err = (out.float() - chain().float()).abs().max().item()
    check(chain_err <= MEGA_CHAIN_TOL[name],
          f"{MEGA_KERNEL} {tag} {name}: {chain_err} from the unfused chain > {MEGA_CHAIN_TOL[name]}")
    row = {"shape": tag, "B": B, "S": S, "W": W, "H": H, "causal": causal, "dtype": name,
           "variant": variant, "layout": layout, "smem_bytes": smem,
           "warps": 16 if layout == "resident" and -(-S // 16) * 16 <= attention_ops.MEGA_SPLIT_MAX_ROWS
           else 8, "max_abs_err": err,
           "tol": MEGA_TOL[name], "unfused_chain_max_abs_err": chain_err,
           "unfused_chain_tol": MEGA_CHAIN_TOL[name]}
    # the kernel alone on operands already in x's dtype (the wrapper casts
    # the fp32 weights on every call otherwise): this layout, bf16's other
    # layout where it fits (checked too), the earlier tree's kernel
    g, b_, w, wb = (t.to(dtype).contiguous() for t in (gamma, beta, qkv_w, qkv_b))
    cast = (x, g, b_, w, wb, bias, H, scale, 1e-5)
    other = "stream" if layout == "resident" else "resident"
    other_fits = (variant == "mma" and
                  mega_smem_bytes(dtype, S, W, H, other) <= attention_ops.MEGA_SMEM_LIMIT)
    if timed and other_fits:
        alt = attention_ops._launch_mega(*cast, layout=other)
        torch.cuda.synchronize()
        alt_err = (alt.float() - ref.float()).abs().max().item()
        check(alt_err <= MEGA_TOL[name], f"{MEGA_KERNEL} {tag} {name} {other}: max abs err {alt_err}")
        row[f"{other}_max_abs_err"] = alt_err
    if timed:
        with torch.no_grad():
            row["ms"] = cuda_ms(lambda: fused_ln_qkv_attention(*args), 10, warmup=2)
            row["plain_ms"] = cuda_ms(lambda: fused_ln_qkv_attention_plain(*args), 10, warmup=2)
            row["unfused_chain_ms"] = cuda_ms(chain, 20)
            new = lambda: attention_ops._launch_mega(*cast)  # noqa: E731
            if other_fits:
                row[f"{other}_ms"], row["kernel_ms"] = in_turns(
                    lambda: attention_ops._launch_mega(*cast, layout=other), new, 10, warmup=2)
            if MEGA_KERNEL in OLD_LIBS:
                old_out = torch.empty_like(x)
                stream = torch.cuda.current_stream().cuda_stream

                def old():
                    OLD_LIBS[MEGA_KERNEL].clip_ln_qkv_attention(
                        x.data_ptr(), g.data_ptr(), b_.data_ptr(), w.data_ptr(), wb.data_ptr(),
                        None if bias is None else bias.data_ptr(), old_out.data_ptr(), B, S, H, W // H,
                        scale, 1e-5, int(dtype == torch.bfloat16), stream)

                row["old_ms"], row["kernel_ms"] = in_turns(old, new, 10, warmup=2)
                row["old_max_abs_err"] = (old_out.float() - ref.float()).abs().max().item()
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"], cuda_cores = mega_bound_ms(B, S, W, H, causal, name)
        if cuda_cores is not None:
            row["bound_ms_cuda_cores"] = cuda_cores
    rows[MEGA_KERNEL].append(row)
    emit({"phase": "kernel_check", "kernel": MEGA_KERNEL, **row})


def k6_split(gen):
    """Where K6's time goes: its tensor-core launches at the component
    bench's shapes (both dtypes, both bf16 layouts) beside two diagnostic
    builds of the same source, one without the attention core
    (LN_QKV_ATTENTION_PHASES=1: LayerNorm, weight ring, projection, q, k, v
    to shared memory), one without the projection's products
    (LN_QKV_ATTENTION_PHASES=2), one with neither (0: the LayerNorm, the
    ring's copies and barriers, the q, k, v stores), and the projection
    alone and both without the ring's copies (5, 7: the products on stale
    tiles), timed in turns."""
    libs = build_libraries([(f"{MEGA_KERNEL}_phases{p}", _build.CSRC_DIR, MEGA_KERNEL,
                             (f"-DLN_QKV_ATTENTION_PHASES={p}",)) for p in (0, 1, 2, 5, 7)])
    libs["full"] = _build.load(MEGA_KERNEL)
    for lib in libs.values():
        lib.clip_ln_qkv_attention.argtypes = attention_ops._MEGA_ARGS
        lib.clip_ln_qkv_attention.restype = ctypes.c_int
    codes = {"mma": 1, "tf32x3": 2}
    for tag, B, S, W, H, causal in MEGA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((B, S, W), device="cuda", generator=gen).to(dtype)
            g, b_, w, wb = (t.to(dtype) for t in (
                1.0 + 0.1 * torch.randn((W,), device="cuda", generator=gen),
                0.1 * torch.randn((W,), device="cuda", generator=gen),
                torch.randn((W, 3 * W), device="cuda", generator=gen) * W ** -0.5,
                0.1 * torch.randn((3 * W,), device="cuda", generator=gen)))
            bias = causal_mask(S, device="cuda") if causal else None
            out = torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream
            variant = mega_variant(dtype, W // H)
            layouts = attention_ops.MEGA_LAYOUTS if variant == "mma" else ("stream",)
            for layout in layouts:
                def call(lib):
                    return lambda: lib.clip_ln_qkv_attention(
                        x.data_ptr(), g.data_ptr(), b_.data_ptr(), w.data_ptr(), wb.data_ptr(),
                        None if bias is None else bias.data_ptr(), out.data_ptr(), B, S, H, W // H,
                        (W // H) ** -0.5, 1e-5, int(dtype == torch.bfloat16), codes[variant],
                        int(layout == "stream"), stream)

                fns = {"full": call(libs["full"]), "projection_only": call(libs[f"{MEGA_KERNEL}_phases1"]),
                       "core_only": call(libs[f"{MEGA_KERNEL}_phases2"]),
                       "neither": call(libs[f"{MEGA_KERNEL}_phases0"]),
                       "projection_without_copies": call(libs[f"{MEGA_KERNEL}_phases5"]),
                       "both_without_copies": call(libs[f"{MEGA_KERNEL}_phases7"])}
                for fn in fns.values():
                    check(fn() == 0, f"{MEGA_KERNEL} split {tag} launch")
                ms = in_turns_many(fns, 10, warmup=2)
                emit({"phase": "k6_split", "shape": tag, "dtype": str(dtype).split(".")[-1],
                      "variant": variant, "layout": layout, **{f"{k}_ms": v for k, v in ms.items()}})


def check_k6(rows, errs, gen):
    """K6's three variants at the component bench's shapes and the edges."""
    for shapes, edge in ((MEGA_SHAPES, False), (MEGA_EDGE_SHAPES, True)):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                check_mega(rows, errs, gen, *shape, dtype, not edge)
    taken = {(r["variant"], r["layout"]) for r in rows[MEGA_KERNEL]}
    check({("mma", "resident"), ("mma", "stream"), ("tf32x3", "stream"), ("simt", "simt")} <= taken,
          f"{MEGA_KERNEL}: every variant and layout ran, got {taken}")


def check_misaligned_view(k, B, S, W, H, dtype=torch.bfloat16):
    """The tensor-core variants copy 16 bytes at a time: a contiguous view
    whose storage offset leaves it one element past a boundary is refused
    by the wrapper of `k`, forward and backward, before anything launches;
    its clone runs."""
    flat = torch.randn(B * S * 3 * W + 1, device="cuda").to(dtype)
    qkv = flat[1:].view(B, S, 3 * W)
    do = torch.randn((B, S, W), device="cuda").to(dtype)
    check(qkv.is_contiguous() and qkv.data_ptr() % 16 != 0, "the view is contiguous and misaligned")
    variant = k.variant(qkv.dtype, W // H)
    check(variant in TENSOR_CORE_VARIANTS, f"the misaligned view takes a tensor-core variant, not {variant}")
    before = read_launches()
    for what, call in (("forward", lambda: k.fn(qkv, None, H, 0.125)),
                       ("backward", lambda: k.bwd(qkv, None, do, H, 0.125))):
        try:
            call()
        except ValueError as e:
            check("aligned to 16 bytes" in str(e), f"misaligned {what}: {e}")
        else:
            raise RuntimeError(f"check failed: {k.names[0]} {what} took a misaligned qkv")
    check(read_launches() == before, "a refused call launches nothing")
    out = k.fn(qkv.clone(), None, H, 0.125)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "the aligned clone runs")
    emit({"phase": "kernel_check", "kernel": k.names[0], "shape": "misaligned_view",
          "dtype": str(dtype).split(".")[-1], "variant": variant, "refused": True})


def check_k1(rows, errs, gen):
    """K1's three variants, forward and backward, at the path and edge shapes."""
    timed = {"text", "vision", "train_text", "train_vision"} | {t[0] for t in NEW_K1_SHAPES}
    for tag, B, S, W, H, causal in SERVING_SHAPES + TRAIN_SHAPES + NEW_K1_SHAPES + EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(rows, errs, K1, gen, tag, B, S, W, H, causal, dtype, tag in timed)
    for dtype in (torch.bfloat16, torch.float32):
        check_misaligned_view(K1, 2, 77, 512, 8, dtype)


def check_k2(rows, errs, gen):
    """K2's three variants, forward and backward, at the path and edge shapes."""
    timed = {t[0] for t in HG_SHAPES}
    for tag, B, S, W, H, causal in HG_SHAPES + HG_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(rows, errs, K2, gen, tag, B, S, W, H, causal, dtype, tag in timed)
    for tag, B, S, W, H, causal, dtypes in HG_STREAM_EDGE_SHAPES:
        for dtype in dtypes:
            check_attention(rows, errs, K2, gen, tag, B, S, W, H, causal, dtype, False)
    for dtype in (torch.bfloat16, torch.float32):
        check_misaligned_view(K2, 2, 130, 256, 4, dtype)


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: [] for name in COUNTERS}
    errs = {name: {} for name in COUNTERS}
    check_k1(rows, errs, gen)
    check_k2(rows, errs, gen)
    check_k3(rows, errs, gen)
    check_k5(rows, errs, gen)
    check_k4(rows, errs, gen)
    check_k6(rows, errs, gen)
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
    (grid² + CLS) is longer than K1's MAX_SEQ, else K1; none in a ResNet
    tower."""
    if not mcfg.is_vit:
        return None, None
    if mcfg.grid_size ** 2 + 1 > MAX_SEQ:
        return HG_KERNEL, HG_BWD_KERNEL
    return KERNEL, BWD_KERNEL


def serving_launches(mcfg, image_batches, text_batches):
    """Launches per kernel for encoding that many image and text batches:
    one forward per block of each tower per batch."""
    out = dict.fromkeys(COUNTERS, 0)
    if mcfg.is_vit:
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
    if vision_kernels(mcfg)[0] == HG_KERNEL:
        # one bf16 image batch with the plain attention beside the kernel
        # path's, in turns within this run
        turns = {"kernel": [], "plain": []}
        with torch.inference_mode():
            for impl in ("kernel", "plain", "plain", "kernel"):
                turns[impl].append(cuda_ms(
                    lambda: encode_image(params, mcfg, x_img, compute_dtype=torch.bfloat16, impl=impl),
                    iters=iters, warmup=2))
        summary["bfloat16_image_batch_ms_in_turns"] = turns
        summary["plain_attention_image_batch_ms"] = float(np.mean(turns["plain"]))
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
    # (a ResNet tower has no dense layer that quantizes: its convolutions
    # and attention pool stay float)
    dense = {"image": 4 * mcfg.vision_layers + 2 if mcfg.is_vit else 0,
             "text": 4 * mcfg.transformer_layers + 1}
    calls = dense["image"] * image_batches
    if "text" not in float_towers:
        calls += dense["text"] * text_batches
    out[quant.KERNEL] = quant.LAUNCHES_PER_CALL * calls
    return out


def weight_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(weight_bytes(v) for v in params)
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
        # plain attention. The tf32x3 variants of K1 and K2 (fp32 at head_dim
        # 16-128: every tower of these models) differ from their plain
        # version by ~1e-6, and a 1e-6 change can flip a dynamic int8
        # rounding, which moves a feature by ~1e-3: where a tf32x3 variant
        # runs the all-plain comparison is held by cosine, elsewhere at 1e-4
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
                width, heads = ((mcfg.transformer_width, mcfg.transformer_heads) if kind == "texts"
                                else (mcfg.vision_width, mcfg.vision_heads))
                if headgrid_variant(torch.float32, width // heads) == "tf32x3":
                    check(cos >= 0.999, f"{tag} {mode} fp32 {kind}: kernel vs plain min cosine {cos}")
                else:
                    check(err <= 1e-4, f"{tag} {mode} fp32 {kind}: kernel vs plain max abs err {err}")
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
            needles = (("quant_matmul", "int8_gemm_wgmma_kernel"), ("quant_rows", "quant_rows_kernel"),
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
    """The M2E2, VCR, VisualCOMET, retrieval and GSR CLIs through
    `evals.cli.run` on synthetic annotation files: metrics finite and in [0, 1] (rates),
    the expected keys, and exact launch counts (Encoders pads every call to
    its fixed batch; M2E2 encodes the grid of each loader batch once more,
    unpadded)."""
    import contextlib
    import io

    from clip_event_tpu_torch import eval_gsr, eval_m2e2, eval_retrieval, eval_vcr, eval_visualcomet
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
    # `"use_pallas_attention": false`: the retrieval CLI again with the plain
    # attention in every encoder call: no attention kernel launches, the
    # same metrics (ranks of well-separated scores), the choice put back
    p = fx.make_retrieval_fixture(os.path.join(root, "retrieval_plain"))
    run_cli("eval_retrieval_plain_attention", eval_retrieval,
            {"model": "ViT-B/32", "dataset": "coco", "caption_file": p["coco_json"],
             "image_dir": p["coco_dir"], "use_pallas_attention": False},
            dict.fromkeys(COUNTERS, 0),
            {"t2i_R@1", "i2t_R@1", "t2i_R@10", "num_images"})
    check(layers._resolve_attention() == "kernel", "the eval put the attention choice back")
    check(results["eval_retrieval_plain_attention"]["metrics"] == results["eval_retrieval"]["metrics"],
          "retrieval metrics with the plain attention equal the kernel path's")
    # GSR at ViT-B/32 with the noun value metrics: 6 images of 2 verbs, 6
    # role rows an image (2 annotated, 1 with a gold box), 2 noun glosses;
    # per loader batch the image encode, the grid encode and the role texts,
    # then the nouns and the candidate verbs; again with the plain attention
    p = fx.make_swig_fixture(os.path.join(root, "swig"))
    sizes = _loader_batches(6, B)
    gsr_cfg = {"model": "ViT-B/32", "anno_json": p["anno_json"], "image_dir": p["image_dir"],
               "ontology_json": p["ontology_json"]}
    gsr_keys = {"verb_top1", "verb_top5", "num_images", "grounding_acc", "grounded_args", "value",
                "value_all", "grounded_value", "grounded_value_all", "value_roles", "value_frames"}
    run_cli("eval_gsr", eval_gsr, gsr_cfg,
            launches_for(VIT_B32, sum(_encoder_batches(b, B) for b in sizes) + len(sizes),
                         1 + sum(_encoder_batches(6 * b, B) for b in sizes) + 1),
            gsr_keys)
    gsr = results["eval_gsr"]["metrics"]
    check(gsr["num_images"] == 6 and gsr["grounded_args"] == 6 and gsr["value_frames"] == 6
          and gsr["value_roles"] == 12, f"GSR counts {gsr}")
    run_cli("eval_gsr_plain_attention", eval_gsr, dict(gsr_cfg, use_pallas_attention=False),
            dict.fromkeys(COUNTERS, 0), gsr_keys)
    check(results["eval_gsr_plain_attention"]["metrics"] == gsr,
          "GSR metrics with the plain attention equal the kernel path's")
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
    return _device_batches(ds, b, 1)[0]


def _chunks(nodes, requested):
    """sim_entity's effective chunk count: the smallest divisor of the node
    axis that is >= the requested count."""
    if requested <= 1:
        return 1
    return next(d for d in range(min(requested, nodes), nodes + 1) if nodes % d == 0)


def k1_bwd_launches(width, heads, dtype=torch.bfloat16):
    """Launches of one K1 backward call (bf16: the train steps' dtype) in a
    tower of that width: per variant and head_dim."""
    return bwd_launches_per_call(k1_variant(dtype, width // heads), width // heads)


def train_launches(mcfg, steps, alignment=False, fused_ln=False, dtype=torch.bfloat16, remat="full",
                   multiattention=None, ot_nodes=(OT_OBJECTS, OT_ENTITIES), ot_chunks=OT_CHUNKS,
                   ot_kernel=True):
    """Launches per kernel for `steps` train steps (bf16, or `dtype`) under
    full remat, or under the "attn" policy with `remat="attn"`.
    Each block's attention forward runs twice (forward, block recompute;
    once under "attn", which keeps the core's output and lse across the
    recompute)
    and its backward once (K1: `k1_bwd_launches`, one on the tensor-core
    variant; K2: HG_BWD_LAUNCHES_PER_CALL in every variant); the recompute
    saves the output and log-sum-exp a tensor-core backward reads, so no
    backward runs a forward of its own. With `fused_ln`
    (`use_pallas_ln`) each block also runs K4a (`ln_1`) and K4b (the
    mid-block add + `ln_2`) twice and K4c twice (once per LayerNorm,
    ln.BWD_LAUNCHES_PER_CALL launches each). With alignment the crop
    and entity encodes run in chunks (`sim_entity`), each chunk under its
    own checkpoint around the per-block ones: a block inside a chunk runs
    its forward three times (forward, chunk recompute, block recompute)
    when there is more than one chunk, twice when there is one (one fewer
    under "attn"); and one IPOT solve per step through K3
    (tests/test_torch_ot_train.py pins the rule on the CPU), none with
    `ot_kernel=False` (the plain OT loop). `ot_nodes` are the (object,
    entity) slots an image and `ot_chunks` the requested chunks
    (finetune_ot.json's by default). With `multiattention` the image batch is
    encoded once more (its grid tokens) and the role texts once ("desc")
    or twice (descriptions and labels, "desc_type" and
    "desc_type_text"), each encode counted as the towers' own. A ResNet
    tower launches no kernel (its `vision_layers` is a tuple of stages)."""
    check(remat in ("full", "attn"), f"train_launches: remat {remat!r}")
    fwd_per_block = 1 if remat == "attn" else 2
    vis_f, vis_b = vision_kernels(mcfg)
    if vis_b == HG_BWD_KERNEL:
        vis_bwd_launches = HG_BWD_LAUNCHES_PER_CALL
    elif mcfg.is_vit:
        vis_bwd_launches = k1_bwd_launches(mcfg.vision_width, mcfg.vision_heads, dtype)
    text_bwd_launches = k1_bwd_launches(mcfg.transformer_width, mcfg.transformer_heads, dtype)
    Lv, Lt = (mcfg.vision_layers if mcfg.is_vit else 0), mcfg.transformer_layers
    image_encodes = 2 if multiattention else 1
    text_encodes = 1 + {None: 0, "desc": 1}.get(multiattention, 2)
    out = dict.fromkeys(COUNTERS, 0)
    if mcfg.is_vit:
        out[vis_f] += fwd_per_block * Lv * image_encodes
        out[vis_b] += vis_bwd_launches * Lv * image_encodes
    out[KERNEL] += fwd_per_block * Lt * text_encodes
    out[BWD_KERNEL] += text_bwd_launches * Lt * text_encodes
    if alignment:
        for kf, kb, n, L, c in (
                (vis_f, vis_b, vis_bwd_launches, Lv, _chunks(ot_nodes[0], ot_chunks)),
                (KERNEL, BWD_KERNEL, text_bwd_launches, Lt, _chunks(ot_nodes[1], ot_chunks))):
            out[kf] += (fwd_per_block + (c > 1)) * c * L
            out[kb] += n * c * L
        out[ot.KERNEL] += int(ot_kernel)
    if fused_ln:
        out[ln.KERNEL] = out[ADD_LN_KERNEL] = 2 * (Lv + Lt)
        out[ln.BWD_KERNEL] = 2 * ln.BWD_LAUNCHES_PER_CALL * (Lv + Lt)
    return {k: v * steps for k, v in out.items()}


def loop_steps(k=1):
    """(warm-up steps, all steps) of a train-loop phase: WARMUP_STEPS +
    TIMED_STEPS eager steps, or with `k` steps a dispatch one warm-up
    dispatch (the eager first step, the capture, k - 1 replays) and
    GRAPH_TIMED_DISPATCHES timed ones."""
    if k == 1:
        return WARMUP_STEPS, WARMUP_STEPS + TIMED_STEPS
    return k, k * (1 + GRAPH_TIMED_DISPATCHES)


def run_train_loop(tag, mcfg, params, ds, batch, out_root, mesh=None, **cfg_extra):
    """The main path of a train phase, counted: `train.train` over `ds` for
    warm-up + timed steps (bf16, full remat or `cfg_extra`'s, Adam at lr
    1e-6), one step a dispatch or `steps_per_dispatch` (the CUDA graph of
    the step, `loop_steps`). Checks the step count, finite losses, the
    launch counts and that the params moved; returns what the phase
    reports. A step's ms is the mean over the timed steps, between CUDA
    events recorded as each step's metrics arrive (with K steps a dispatch,
    K at a time: `step_ms` then lists each timed dispatch's ms / K)."""
    k = int(cfg_extra.get("steps_per_dispatch", 1))
    warmup, n_steps = loop_steps(k)
    cfg = validate_config({
        "task": f"chip_smoke_{tag}", "constrastive_loss": "ce", "batch_size": batch,
        "lr": 1e-6, "optimizer": "adam", "lr_scheduler": "none", "max_epoch": 1,
        "compute_dtype": "bfloat16", "remat": True, "use_pallas_attention": True,
        "seed": 0, "print_freq": n_steps + 1, "num_workers": 8, "prefetch": 2,
        "ckpt_dir": os.path.join(out_root, f"ckpt_{tag}"), **cfg_extra,
    })
    remat = layers.remat_policy(cfg["remat"])
    # a transformer weight the step must move: the vision tower's (ViT) or
    # the text tower's (ResNet)
    tower = ("visual", "transformer") if mcfg.is_vit else ("text_transformer",)

    def watched(p):
        for key in tower:
            p = p[key]
        return p["attn"]["qkv_w"].detach()

    watch = watched(params).clone()
    metrics, events = {}, {}

    def on_step(step, m):
        metrics[step] = m
        events[step] = torch.cuda.Event(enable_timing=True)
        events[step].record()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state = train(cfg, mcfg, ds, params, mesh.device if mesh else "cuda", on_step=on_step, mesh=mesh)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(sorted(metrics) == list(range(n_steps)), f"{tag} steps {sorted(metrics)}")
    expected = train_launches(mcfg, n_steps, cfg["alignment"], cfg["use_pallas_ln"], remat=remat,
                              multiattention=cfg["multiattention"])
    check(launches == expected, f"{tag} launches {launches} != {expected}")
    check(layers._resolve_ln() == "xla", f"{tag}: the train loop put the LayerNorm choice back")
    values = {k: [float(metrics[i][k]) for i in range(n_steps)]
              for k in metrics[0] if k != "finite"}
    check(all(np.isfinite(values["loss"])), f"{tag} losses finite {values['loss']}")
    moved = (watched(full_params(state)) - watch).abs().max().item()
    check(moved > 0, f"{tag}: the params changed")
    step_ms = [events[i - k].elapsed_time(events[i]) / k for i in range(warmup - 1 + k, n_steps, k)]
    emit({"phase": f"{tag}_launches", **{f"{name}_launches": v for name, v in launches.items()},
          "expected": expected, "steps": n_steps, "steps_per_dispatch": k, "remat": remat,
          "per_step": {name: v // n_steps for name, v in expected.items()}})
    return {"state": state, "values": values, "step_ms": step_ms, "mean_ms": float(np.mean(step_ms)),
            "loop_s": loop_s, "peak_gib": peak_gib, "launches": launches, "n_steps": n_steps,
            "timed_steps": n_steps - warmup, "steps_per_dispatch": k, "remat": remat}


def _chance(batch, D):
    """CE of an untrained model, which scores every pair alike: over the
    B·D texts of an image plus over the B images of a positive text."""
    return math.log(batch * D) + math.log(batch)


def compare_bf16_step(mcfg, params, batch, keys=("loss",), fused_ln=False, summed_keys=(),
                      **step_kwargs):
    """One bf16 step on the kernel path and two on plain paths (plain
    attention as it is and with the kernels' roundings, "rounded"; with
    alignment the plain IPOT solver; the plain LayerNorm; the kernel path
    takes the LayerNorm kernels when `fused_ln`) from one state and batch:
    against "rounded", each of `keys` within BF16_STEP_TOL (abs) and
    grad_norm within BF16_STEP_TOL (relative); against "plain", each within
    BF16_ROUNDING_TOL relative (of max(1, |plain|) for `keys`).
    `summed_keys` are losses summed over the batch's images (the
    local-attention terms, and a total that holds them): each is held at
    the same tolerances relative to max(1, |reference|) against both
    references. Every difference is emitted before a failed check
    raises."""
    sched = build_schedule("none", 1e-6, 1)
    metrics = {}
    for impl in ("kernel", "rounded", "plain"):
        opt = build_optimizer("adam", sched)
        st = create_train_state(params, opt)
        step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True, impl=impl,
                               use_pallas_ot=impl == "kernel", **step_kwargs)
        with layers.ln_impl("pallas" if fused_ln and impl == "kernel" else "xla"):
            _, m = step(st, batch)
        metrics[impl] = {k: float(v) for k, v in m.items()}
        del st, step
    out = {"batch": batch["image"].shape[0], **metrics, "tol": BF16_STEP_TOL,
           "rounding_tol": BF16_ROUNDING_TOL}
    kernel = metrics["kernel"]
    failed = []
    for ref, tol in (("rounded", BF16_STEP_TOL), ("plain", BF16_ROUNDING_TOL)):
        for key in tuple(keys) + tuple(summed_keys):
            diff = abs(kernel[key] - metrics[ref][key])
            relative = ref == "plain" or key in summed_keys
            bound = tol * max(1.0, abs(metrics[ref][key])) if relative else tol
            if diff > bound:
                failed.append(f"kernel vs {ref} {key} differs by {diff} > {bound}")
            out[f"{key}_abs_diff_vs_{ref}"] = diff
        dg = abs(kernel["grad_norm"] - metrics[ref]["grad_norm"]) / metrics[ref]["grad_norm"]
        if dg > tol:
            failed.append(f"kernel vs {ref} grad_norm differs by {dg} (relative) > {tol}")
        out[f"grad_norm_rel_diff_vs_{ref}"] = dg
    if failed:
        emit({"phase": "compare_bf16_step_failed", **out})
    check(not failed, f"bf16 step: {failed}")
    return out


def compare_fp32_grads(mcfg, params, batch, fused_ln=False, **loss_kwargs):
    """fp32 loss and every gradient tensor on the kernel path (with the
    LayerNorm kernels when `fused_ln`) against the all-plain path from one
    state and batch: loss within FP32_STEP_TOL (abs), each gradient within
    FP32_STEP_TOL of its largest element."""
    sched = build_schedule("none", 1e-6, 1)
    grads, loss = {}, {}
    for impl in ("kernel", "plain"):
        st = create_train_state(params, build_optimizer("adam", sched))
        with layers.ln_impl("pallas" if fused_ln and impl == "kernel" else "xla"):
            total, _ = loss_fn(st.params, batch, mcfg, compute_dtype=torch.float32, remat=True,
                               impl=impl, use_pallas_ot=impl == "kernel", **loss_kwargs)
            grads[impl] = torch.autograd.grad(total, tree_leaves(st.params))
        loss[impl] = total.item()
        del st
    dl = abs(loss["kernel"] - loss["plain"])
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(grads["kernel"], grads["plain"]))
    check(dl <= FP32_STEP_TOL, f"fp32 step: kernel vs plain loss differs by {dl}")
    check(worst <= FP32_STEP_TOL, f"fp32 step: a gradient differs by {worst} of its max")
    return {"batch": batch["image"].shape[0], "loss_abs_diff": dl, "max_grad_rel_diff": worst}


def step_ms_in_turns(mcfg, params, batch, fused_ln=False, dtype=torch.bfloat16):
    """One train step (bf16, or `dtype`) with its batch on the card, timed
    in turns (kernel, plain, plain, kernel attention; host clock around a
    synchronised step, after one warm-up step of each): the plain-attention
    step beside the kernel-path step within one run, both with the
    LayerNorm kernels when `fused_ln`."""
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    steps, states, ms = {}, {}, {"kernel": [], "plain": []}
    with layers.ln_impl("pallas" if fused_ln else "xla"):
        for impl in ("kernel", "plain"):
            states[impl] = create_train_state(params, opt)
            steps[impl] = make_train_step(mcfg, opt, compute_dtype=dtype, remat=True, impl=impl)
            steps[impl](states[impl], batch)
        for impl in ("kernel", "plain", "plain", "kernel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[impl](states[impl], batch)
            torch.cuda.synchronize()
            ms[impl].append((time.perf_counter() - t0) * 1e3)
    del steps, states
    torch.cuda.empty_cache()
    return ms


def profile_step(mcfg, params, batch, mean_ms, fused_ln=False, **step_kwargs):
    """One bf16 kernel-path step under the profiler (see `profile_one`)."""
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    st = {"state": create_train_state(params, opt)}
    step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True, **step_kwargs)

    def one_step():
        with layers.ln_impl("pallas" if fused_ln else "xla"):
            st["state"], _ = step(st["state"], batch)

    kernels = (("attention_fwd", "attention_fwd_kernel"), ("attention_bwd", "attention_bwd_"),
               ("attention_hg_fwd", "attention_hg_fwd_kernel"), ("attention_hg_bwd", "attention_hg_bwd_"),
               ("ipot", "ipot_kernel"), ("layer_norm_fwd", "layer_norm_fwd"),
               ("layer_norm_bwd", "layer_norm_bwd"))
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


def _device_batches(ds, b, n):
    """n batches of b consecutive examples of `ds` each, on the card."""
    out = []
    for j in range(n):
        ex = [ds[j * b + i][0] for i in range(b)]
        batch = {k: np.stack([e[k] for e in ex]) for k in ex[0]}
        batch = ds.finalize_batch({**batch, **ds.batch_extras(b)})
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in batch.items()})
    return out


def _state_equal(a, b) -> list:
    """The leaves of two train states' params and optimizer state whose
    bits differ, by index."""
    la = tree_leaves(a.params) + tree_leaves(a.opt_state)
    lb = tree_leaves(b.params) + tree_leaves(b.opt_state)
    return [i for i, (x, y) in enumerate(zip(la, lb)) if not torch.equal(x, y)]


def graph_equals_eager(mcfg, params, batches, dispatches=2, **step_kwargs):
    """`dispatches` GRAPH_CHECK_K-step dispatches of `make_multi_step` (the
    first: its eager first step, the capture and K - 1 replays; a second: K
    replays) against as many eager steps of `make_train_step` on the same
    batches from equal states (bf16, Adam at lr 1e-6): params, optimizer
    state and every metric equal bit for bit after each dispatch, and the
    per-step launch counts of a replay equal an eager step's; the ms of
    each dispatch and of its eager steps (host clock, synchronised). Where
    the bits differ it first asks whether two eager runs agree (the step's
    own determinism), then fails."""
    from clip_event_tpu_torch.engine.train_step import make_multi_step

    K = GRAPH_CHECK_K
    check(len(batches) == dispatches * K, f"graph_equals_eager: {len(batches)} batches")
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    kw = dict(compute_dtype=torch.bfloat16, remat=True, **step_kwargs)
    step = make_train_step(mcfg, opt, **kw)
    many, _ = make_multi_step(mcfg, opt, K, **kw)
    eager, graph = create_train_state(params, opt), create_train_state(params, opt)
    out = {"steps_per_dispatch": K, "dispatches": dispatches, "eager_ms": [], "dispatch_ms": []}
    for d in range(dispatches):
        chunk = batches[d * K:(d + 1) * K]
        reset_launches()
        rows = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in chunk:
            eager, m = step(eager, b)
            rows.append(m)
        torch.cuda.synchronize()
        out["eager_ms"].append((time.perf_counter() - t0) * 1e3)
        eager_launches = read_launches()
        reset_launches()
        stacked = {k: torch.stack([b[k] for b in chunk]) for k in chunk[0]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph, mk = many(graph, stacked)
        torch.cuda.synchronize()
        out["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        graph_launches = read_launches()
        differ = _state_equal(eager, graph)
        metrics_differ = [k for k in rows[0] if not torch.equal(mk[k], torch.stack([m[k] for m in rows]))]
        if differ or metrics_differ:
            again = create_train_state(params, opt)
            for b in batches[:(d + 1) * K]:
                again, _ = step(again, b)
            emit({"phase": "graph_equals_eager_diagnosis", "dispatch": d, "leaves_differ": differ,
                  "metrics_differ": metrics_differ,
                  "eager_rerun_leaves_differ": _state_equal(eager, again),
                  "loss_graph": mk["loss"].tolist(), "loss_eager": [float(m["loss"]) for m in rows]})
        check(not differ and not metrics_differ,
              f"graph dispatch {d} vs eager steps: leaves {differ}, metrics {metrics_differ} differ")
        check(graph_launches == eager_launches,
              f"graph dispatch {d} launches {graph_launches} != eager {eager_launches}")
        out[f"dispatch_{d}"] = {"loss": mk["loss"].tolist(), "launches": graph_launches}
        out["graph_launches"] = {k: out.get("graph_launches", {}).get(k, 0) + v
                                 for k, v in graph_launches.items()}
    out["bit_equal"] = True
    graph_obj = next(iter(many.graphs.values()))
    out["launches_per_replay"] = {k: v for k, v in graph_obj.launches.items() if v}
    del eager, graph, many, step
    torch.cuda.empty_cache()
    return out


PROFILE_REPLAYS = 3  # a trace can lose kernel records (30k kernels a finetune_ot replay)


def profile_replay(graph_obj):
    """One replay of a captured step under torch.profiler: the device busy
    ms of the replay and its kernel launches by name, held against the
    wrappers' counts the capture recorded (`launches`: PROFILE_NEEDLES).
    A replay launches the same kernels every time and a trace can lose
    records but not add them, so every profiled replay must show no more
    than the counts, and one of up to PROFILE_REPLAYS must show exactly
    them; the shortfalls of the others are returned."""
    counted = graph_obj.launches
    want = {KERNEL: counted["attention_fwd"], BWD_KERNEL: counted["attention_bwd"],
            HG_KERNEL: counted["attention_hg_fwd"], HG_BWD_KERNEL: counted["attention_hg_bwd"],
            "ipot": counted["ipot"], "layer_norm+add_layer_norm": counted["layer_norm"] + counted["add_layer_norm"],
            "layer_norm_bwd": counted["layer_norm_bwd"]}
    graph_obj.replay()
    torch.cuda.synchronize()
    lost = []
    for _ in range(PROFILE_REPLAYS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph_obj.replay()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        check(bool(rows), "the profiler shows no kernel of a graph replay")
        seen = {name: sum(c for key, _, c in rows if any(n in key for n in needles))
                for name, needles in PROFILE_NEEDLES.items()}
        check(all(seen[k] <= want[k] for k in want),
              f"profiled replay's kernels {seen} exceed the wrappers' counts {want}")
        if seen == want:
            break
        lost.append({k: want[k] - seen[k] for k in want if seen[k] != want[k]})
    check(seen == want, f"profiled replays' kernels {seen} != the wrappers' counts {want} "
                        f"in {PROFILE_REPLAYS} replays (records lost: {lost})")
    return {"replay_busy_ms": sum(r[1] for r in rows), "replay_kernel_launches": sum(r[2] for r in rows),
            "replay_hand_kernels_by_profile": seen, "replay_profile_records_lost": lost}


def graph_vs_eager(mcfg, params, batch, k=GRAPH_TIMING_K, **step_kwargs):
    """The eager step against a `k`-step graph dispatch (`make_multi_step`'s
    `many_fixed`; GRAPH_TIMING_K, the bench's call) on one resident bf16
    batch, each from a fresh state (Adam at lr 1e-6; full remat unless
    `step_kwargs` say otherwise): the peak memory of each one's first K
    steps (the graph's: its eager first step, the capture, K - 1 replays)
    above what was allocated before, and what stays reserved after (the
    graph's pool); the launch counts of those K steps, equal; ms a step in
    turns (eager, graph, graph, eager: host clock around synchronised runs
    of K steps); the device busy ms of one eager step and of one replay
    (torch.profiler), and each one's idle share against its ms a step; the
    replay's kernels by name against the wrappers' counts."""
    from clip_event_tpu_torch.engine.train_step import make_multi_step

    K = k
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    kw = dict(compute_dtype=torch.bfloat16, remat=True)
    kw.update(step_kwargs)
    step = make_train_step(mcfg, opt, **kw)
    _, fixed = make_multi_step(mcfg, opt, K, **kw)
    st = {}

    def run_eager():
        for _ in range(K):
            st["eager"], _ = step(st["eager"], batch)

    def run_graph():
        st["graph"], _ = fixed(st["graph"], batch)

    runs = {"eager": run_eager, "graph": run_graph}
    memory, launches = {}, {}
    for mode in ("eager", "graph"):
        st[mode] = create_train_state(params, opt)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        runs[mode]()
        torch.cuda.synchronize()
        launches[mode] = read_launches()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        memory[mode] = {"peak_gib": peak / 2**30, "peak_above_start_gib": (peak - start) / 2**30,
                        "reserved_after_gib": torch.cuda.memory_reserved() / 2**30}
    check(launches["graph"] == launches["eager"],
          f"graph launches {launches['graph']} != eager {launches['eager']} over {K} steps")
    graph_obj = next(iter(fixed.graphs.values()))
    per_step = {k: v // K for k, v in launches["eager"].items()}
    ms = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[mode]()
        torch.cuda.synchronize()
        ms[mode].append((time.perf_counter() - t0) * 1e3 / K)
    eager_prof = profile_one(lambda: step(st["eager"], batch), float(np.mean(ms["eager"])))
    replay = profile_replay(graph_obj)
    graph_ms = float(np.mean(ms["graph"]))
    out = {"steps_per_dispatch": K, "step_ms": ms,
           "graph_to_eager_step_ms": graph_ms / float(np.mean(ms["eager"])),
           "eager_device_busy_ms": eager_prof.get("device_busy_ms"),
           "eager_device_idle_share": eager_prof.get("device_idle_share"),
           "eager_kernel_launches": eager_prof.get("kernel_launches"),
           **replay, "graph_device_idle_share": max(0.0, 1.0 - replay["replay_busy_ms"] / graph_ms),
           "memory": memory, "launches_per_step": per_step}
    del st, step, fixed, graph_obj
    torch.cuda.empty_cache()
    return out


def policy_compare(mcfg, params, batch):
    """The bf16 step under full remat against the "attn" policy from one
    state and batch: the loss and every gradient (loss within BF16_STEP_TOL,
    grad_norm within BF16_STEP_TOL relative; whether each is bit-equal is
    reported); the peak memory of a first step from a fresh state above
    what was allocated before it, in turns (full, attn, attn, full), with
    exact launch counts; then the step's ms in turns (host clock around
    synchronised steps, after one warm-up step of each)."""
    out = {"loss": {}, "grad_norm": {}, "step_ms": {"full": [], "attn": []}, "memory": {}}
    grads = {}
    for policy in ("full", "attn"):
        st = create_train_state(params, build_optimizer("adam", build_schedule("none", 1e-6, 1)))
        total, _ = loss_fn(st.params, batch, mcfg, compute_dtype=torch.bfloat16, remat=policy)
        grads[policy] = torch.autograd.grad(total, tree_leaves(st.params))
        out["loss"][policy] = total.item()
        out["grad_norm"][policy] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads[policy]])).item()
        del st, total
    out["loss_bit_equal"] = out["loss"]["full"] == out["loss"]["attn"]
    out["gradients_bit_equal"] = all(torch.equal(a, b) for a, b in zip(grads["full"], grads["attn"]))
    out["max_grad_rel_diff"] = max(((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()
                                   for a, b in zip(grads["attn"], grads["full"]))
    del grads
    dl = abs(out["loss"]["attn"] - out["loss"]["full"])
    dg = abs(out["grad_norm"]["attn"] - out["grad_norm"]["full"]) / out["grad_norm"]["full"]
    check(dl <= BF16_STEP_TOL and dg <= BF16_STEP_TOL,
          f"'attn' vs full remat: loss differs by {dl}, grad_norm by {dg} (relative)")
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    steps = {policy: make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=policy)
             for policy in ("full", "attn")}
    for policy in ("full", "attn", "attn", "full"):
        st = create_train_state(params, opt)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        steps[policy](st, batch)
        torch.cuda.synchronize()
        expected = train_launches(mcfg, 1, remat=policy)
        check(read_launches() == expected, f"{policy} step launches {read_launches()} != {expected}")
        out["memory"].setdefault(policy, []).append(
            {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "peak_above_start_gib": (torch.cuda.max_memory_allocated() - start) / 2**30})
        out[f"launches_{policy}"] = expected
        del st
    states = {policy: create_train_state(params, opt) for policy in ("full", "attn")}
    for policy in ("full", "attn"):
        steps[policy](states[policy], batch)
    for policy in ("full", "attn", "attn", "full"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[policy](states[policy], batch)
        torch.cuda.synchronize()
        out["step_ms"][policy].append((time.perf_counter() - t0) * 1e3)
    del steps, states
    torch.cuda.empty_cache()
    return out


def _train_report(tag, model, run, batch, D, init_s, **extra):
    pairs = batch * D
    emit({"phase": tag, "model": model, "seed": 0, "init_s": init_s, "batch_images": batch,
          "descriptions_per_image": D, "tokens": 77, "compute_dtype": "bfloat16", "remat": run["remat"],
          "steps_per_dispatch": run["steps_per_dispatch"],
          "optimizer": "adam", "lr": 1e-6, "steps": run["n_steps"], "timed_steps": run["timed_steps"],
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
    turns = step_ms_in_turns(mcfg, params, _device_batch(ds, TRAIN_BATCH))
    prof = profile_step(mcfg, params, _device_batch(ds, TRAIN_BATCH), run["mean_ms"])
    _train_report("train", "ViT-B/32", run, TRAIN_BATCH, D, init_s, kernel_vs_plain=compare,
                  kernel_attention_step_ms=turns["kernel"], plain_attention_step_ms=turns["plain"])
    emit({"phase": "train_profile", **prof})
    return run["launches"], run["mean_ms"], prof


def phase_train_graph(out_root):
    """`phase_train`'s workload (ViT-B/32, 384 x 3, bf16, full remat)
    through the train loop with `steps_per_dispatch` GRAPH_LOOP_K (a CUDA
    graph of the step, replayed), counted; a GRAPH_CHECK_K-step dispatch
    against as many eager steps, bit for bit, twice; the eager step against
    a GRAPH_TIMING_K-step dispatch in turns (`graph_vs_eager`)."""
    mcfg = VIT_B32
    D = NUM_POS + NUM_NEG
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _, n_steps = loop_steps(GRAPH_LOOP_K)
    check(n_steps >= 2 * GRAPH_CHECK_K, f"the loop's {n_steps} batches serve the bit-for-bit check")
    ds = _BenchPairs(n_steps * TRAIN_BATCH, mcfg.image_resolution, mcfg.context_length, mcfg.vocab_size)
    run = run_train_loop("train_graph", mcfg, params, ds, TRAIN_BATCH, out_root,
                         steps_per_dispatch=GRAPH_LOOP_K)
    first = run["values"]["loss"][0]
    check(abs(first - _chance(TRAIN_BATCH, D)) < 0.5,
          f"graph loop first loss {first} vs chance {_chance(TRAIN_BATCH, D)}")
    del run["state"]
    torch.cuda.empty_cache()
    equal = graph_equals_eager(mcfg, params, _device_batches(ds, TRAIN_BATCH, 2 * GRAPH_CHECK_K))
    timing = graph_vs_eager(mcfg, params, _device_batch(ds, TRAIN_BATCH))
    _train_report("train_graph", "ViT-B/32", run, TRAIN_BATCH, D, init_s, graph_equals_eager=equal,
                  graph_vs_eager=timing)
    del params, ds
    torch.cuda.empty_cache()
    return run["launches"]


def only_graph():
    """`--only graph`: `phase_train_graph` alone (the quick look after an
    edit to the train step or the graph), in a directory of its own."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_root:
        phase_train_graph(out_root)


# calls a run and runs of each wrapper's host timing (the heavy kernels'
# device time bounds each run: the script's time limit sets the calls)
B1_CALLS, B1_REPEATS = 100, 7


class _CaptionPairs(_BenchPairs):
    """`_BenchPairs` with one caption an image (its first description
    row): the matching eval's dataset."""

    def __getitem__(self, i):
        tensors, meta = super().__getitem__(i)
        return {"image": tensors["image"], "text": tensors["text"][0]}, meta


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


DP_MODES = ("dp", "graph", "zero", "zero_graph", "fsdp", "fsdp_graph")


def reckoned_rank_state_gib(mcfg, world) -> dict:
    """The GiB one rank of `world` would hold of an fp32 Adam state of
    `mcfg` (params, mu, nu), unsharded, under ZeRO-1 and under FSDP, by the
    layout's own rule (`parallel/sharding.py`, padding included); counted
    from the shapes on the meta device, nothing allocated."""
    from clip_event_tpu_torch.parallel.mesh import Mesh
    from clip_event_tpu_torch.parallel.sharding import ShardLayout

    with torch.device("meta"):
        params = init_params(torch.Generator(), mcfg, "meta")
    specs = ShardLayout(params, Mesh(0, world, torch.device("meta")), "fsdp").specs
    full = sum(math.prod(s.shape) for s in specs) * 4 / 2**30
    shard = sum(math.prod(s.shard_shape) for s in specs) * 4 / 2**30
    return {"world": world, "unsharded": 3 * full, "zero": full + 2 * shard, "fsdp": 3 * shard}


def reckoned_tp_rank_state_gib(mcfg, tp) -> dict:
    """The GiB one rank of a tp group of `tp` would hold of an fp32 Adam
    state of `mcfg` (params, mu, nu: its slices of the split leaves, every
    whole leaf), against the unsharded state, by `parallel.sharding.
    TPLayout`'s rule; counted from the shapes on the meta device."""
    from clip_event_tpu_torch.parallel.mesh import Mesh
    from clip_event_tpu_torch.parallel.sharding import TPLayout

    with torch.device("meta"):
        params = init_params(torch.Generator(), mcfg, "meta")
    leaves = tree_leaves(params)
    layout = TPLayout(params, mcfg, Mesh(0, tp, torch.device("meta"), tp=tp))
    full = sum(t.numel() for t in leaves) * 4 / 2**30
    rank = sum(t.numel() for t in layout.shard_leaves(leaves)) * 4 / 2**30
    return {"tp": tp, "unsharded": 3 * full, "tp_rank": 3 * rank}


def dp_equals_plain(mcfg, params, batches, mesh):
    """GRAPH_CHECK_K steps of the mesh's step, eagerly and as one graphed
    dispatch (`make_multi_step`), each on a plain, a ZeRO-1 and an FSDP
    state (`DP_MODES`), against as many steps without a mesh on the same
    batches from equal states (bf16, Adam at lr 1e-6): params, optimizer
    state (a sharded one gathered) and every metric bit for bit, and the
    launch counts equal the plain steps'. Each mode's wall ms (host clock,
    synchronised; a graph mode's first dispatch holds its eager first step
    and its capture), its state's bytes and its peak memory."""
    from clip_event_tpu_torch.engine.train_step import make_multi_step

    K = GRAPH_CHECK_K
    check(len(batches) == K, f"dp_equals_plain: {len(batches)} batches")
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    kw = dict(compute_dtype=torch.bfloat16, remat=True)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    ref, rows = create_train_state(params, opt), []
    step = make_train_step(mcfg, opt, **kw)
    reset_launches()
    for b in batches:
        ref, m = step(ref, b)
        rows.append(m)
    torch.cuda.synchronize()
    plain_launches = read_launches()
    want = {k: torch.stack([m[k] for m in rows]) for k in rows[0]}
    out = {"steps": K, "loss": want["loss"].tolist(), "modes": {},
           "launches_per_step": {k: v // K for k, v in plain_launches.items() if v}}
    dp = make_train_step(mcfg, opt, mesh=mesh, **kw)
    for mode in DP_MODES:
        sharding = mode.split("_")[0] if mode.startswith(("zero", "fsdp")) else None
        state = create_train_state(params, opt)
        if sharding:
            state = shard_state(state, mesh, sharding)
        many = make_multi_step(mcfg, opt, K, mesh=mesh, **kw)[0] if mode.endswith("graph") else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        if many is not None:
            state, metrics = many(state, stacked)
        else:
            got = []
            for b in batches:
                state, m = dp(state, b)
                got.append(m)
            metrics = {k: torch.stack([m[k] for m in got]) for k in want}
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        differ = _state_equal(ref, gather_state(state))
        metrics_differ = [k for k in want if not torch.equal(metrics[k], want[k])]
        check(not differ and not metrics_differ,
              f"train_dp {mode} vs the plain steps: leaves {differ}, metrics {metrics_differ} differ")
        check(launches == plain_launches, f"train_dp {mode} launches {launches} != plain {plain_launches}")
        out["modes"][mode] = {"bit_equal": True, "wall_ms": wall_ms, "state_gib": tree_bytes(state.params, state.opt_state) / 2**30,
                              "max_memory_allocated_gib": peak / 2**30,
                              "peak_over_start_gib": (peak - start) / 2**30}
        del state, many, metrics
        torch.cuda.empty_cache()
    del ref, step, dp
    torch.cuda.empty_cache()
    return out


def dp_step_timing(mcfg, params, batch, mesh):
    """The mesh's step on a plain, a ZeRO-1 and an FSDP state against the
    step without a mesh on one resident batch, in turns (plain, dp, zero,
    fsdp, fsdp, zero, dp, plain: host clock around DP_TIMING_STEPS
    synchronised steps, after one warm-up step each), and one profiled
    step of each: device busy ms and the NCCL kernels' calls and ms."""
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    kw = dict(compute_dtype=torch.bfloat16, remat=True)
    dp = make_train_step(mcfg, opt, mesh=mesh, **kw)
    steps = {"plain": make_train_step(mcfg, opt, **kw), "dp": dp, "zero": dp, "fsdp": dp}
    st = {m: create_train_state(params, opt) for m in steps}
    for m in ("zero", "fsdp"):
        st[m] = shard_state(st[m], mesh, m)
    for m in steps:
        st[m], _ = steps[m](st[m], batch)
    ms = {m: [] for m in steps}
    for mode in ("plain", "dp", "zero", "fsdp", "fsdp", "zero", "dp", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMING_STEPS):
            st[mode], _ = steps[mode](st[mode], batch)
        torch.cuda.synchronize()
        ms[mode].append((time.perf_counter() - t0) * 1e3 / DP_TIMING_STEPS)
    prof = {}
    for mode in steps:
        def one():
            st[mode], _ = steps[mode](st[mode], batch)

        p = profile_one(one, float(np.mean(ms[mode])), kernels=(("nccl", "nccl"),))
        prof[mode] = {k: p.get(k) for k in ("device_busy_ms", "device_idle_share", "kernel_launches",
                                              "nccl_kernel_calls", "nccl_kernel_ms")}
        prof[mode]["top"] = p.get("top", [])[:5]
    del st, steps
    torch.cuda.empty_cache()
    return {"step_ms": ms, **{f"{m}_to_plain_step_ms": float(np.mean(ms[m]) / np.mean(ms["plain"]))
                              for m in ("dp", "zero", "fsdp")},
            "profile": prof}


def phase_train_dp(out_root):
    """Phase 5d (module docstring): the data-parallel path at a world of
    one on NCCL."""
    import torch.distributed as dist

    from clip_event_tpu_torch.evals.common import resolve_shard
    from clip_event_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        spec = initialize_distributed("cuda")
        mesh = make_mesh("cuda")
        init_group_s = time.perf_counter() - t0
        check(spec is not None and spec.source == "torchrun", f"train_dp: cluster {spec}")
        check(dist.get_backend() == "nccl", f"train_dp: backend {dist.get_backend()}")
        check(mesh.device == torch.device("cuda", 0) and (mesh.rank, mesh.world_size) == (0, 1),
              f"train_dp: mesh {mesh}")
        check(resolve_shard(None, None) == (0, 1), "train_dp: the eval shard of a world of one")
        mcfg = VIT_B32
        D = NUM_POS + NUM_NEG
        t0 = time.perf_counter()
        params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_steps = WARMUP_STEPS + TIMED_STEPS
        ds = _BenchPairs(n_steps * TRAIN_BATCH, mcfg.image_resolution, mcfg.context_length,
                         mcfg.vocab_size)
        run = run_train_loop("train_dp", mcfg, params, ds, TRAIN_BATCH, out_root, mesh=mesh)
        per_step = {k: v // run["n_steps"] for k, v in run["launches"].items()}
        check((per_step[KERNEL], per_step[BWD_KERNEL]) == (48, 24),
              f"train_dp: K1 a step {per_step[KERNEL]} / {per_step[BWD_KERNEL]}, not 48 / 24")
        first = run["values"]["loss"][0]
        check(abs(first - _chance(TRAIN_BATCH, D)) < 0.5,
              f"train_dp first loss {first} vs chance {_chance(TRAIN_BATCH, D)}")
        dp_state_gib = tree_bytes(run["state"].params, run["state"].opt_state) / 2**30
        del run["state"]
        torch.cuda.empty_cache()
        # the loop under "zero" and "fsdp": the same loss stream, bit for bit
        sharded_loops = {}
        for mode in ("zero", "fsdp"):
            srun = run_train_loop(f"train_dp_{mode}", mcfg, params, ds, TRAIN_BATCH, out_root, mesh=mesh,
                                  **{mode: True})
            check(srun["state"].sharding is not None and srun["state"].sharding.mode == mode,
                  f"train_dp_{mode}: the loop's state is sharded")
            check(srun["values"] == run["values"],
                  f"train_dp_{mode} metrics {srun['values']} != train_dp's {run['values']}")
            check(srun["launches"] == run["launches"],
                  f"train_dp_{mode} launches {srun['launches']} != train_dp's {run['launches']}")
            sharded_loops[mode] = {"values_equal_train_dp": True, "step_ms_mean": srun["mean_ms"],
                                   "step_ms": srun["step_ms"], "loop_wall_s": srun["loop_s"],
                                   "max_memory_allocated_gib": srun["peak_gib"],
                                   "state_gib": tree_bytes(srun["state"].params, srun["state"].opt_state) / 2**30}
            del srun
            torch.cuda.empty_cache()
        equal = dp_equals_plain(mcfg, params, _device_batches(ds, TRAIN_BATCH, GRAPH_CHECK_K), mesh)
        timing = dp_step_timing(mcfg, params, _device_batch(ds, TRAIN_BATCH), mesh)
        captions = _CaptionPairs(DP_EVAL_ITEMS, mcfg.image_resolution, mcfg.context_length,
                                 mcfg.vocab_size)
        sharded = evaluate_matching(params, mcfg, captions, batch_size=64, device=mesh.device)
        single = evaluate_matching(params, mcfg, captions, batch_size=64, device=mesh.device,
                                   rank=0, world_size=1)
        check(sharded == single, f"train_dp: sharded matching {sharded} != unsharded {single}")
        _train_report("train_dp", "ViT-B/32", run, TRAIN_BATCH, D, init_s, backend=dist.get_backend(),
                      device=str(mesh.device), world_size=mesh.world_size,
                      init_process_group_s=init_group_s, launches_per_step=per_step,
                      dp_equals_plain=equal, dp_vs_plain=timing, matching_sharded_equal=True,
                      matching=sharded, sharded_loops=sharded_loops,
                      state_gib=dp_state_gib,
                      reckoned_rank_state_gib={name: reckoned_rank_state_gib(m, 8)
                                               for name, m in (("ViT-B/32", VIT_B32), ("ViT-L/14", VIT_L14))})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del params, ds
    torch.cuda.empty_cache()
    return run["launches"]


def wrapper_host_us(fn, calls=B1_CALLS, repeats=B1_REPEATS, warmup=20) -> float:
    """Host microseconds a call of fn() takes to return, after a warm-up:
    the calls are only enqueued (no synchronise among them, fewer launches
    than the launch queue holds), so this is the wrapper's host time. The
    median of `repeats` runs of `calls` calls: the host is shared, and one
    run can read a neighbour's load."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(runs))


def phase_b1():
    """Host microseconds a call of each kernel wrapper (ROADMAP B1) at a
    serving or train shape of its path, bf16 unless named: K1 forward (with
    lse) and backward (with the saved out and lse) at the B/32 text batch
    (64 x 77, W 512, 8 heads, causal); K2's at the L/14 image batch (64 x
    257, W 1024, 16 heads); K4a, K4b and K4c at the B/32 text rows (4928 x
    512), and K4a and K4b through their public entry points with no input
    that requires a gradient (`-public`); K3 at finetune_ot's shape (64 x 16 x 7, fp32); K5 at the B/32 int8
    image batch's qkv projection (3200 x 768 -> 2304, fp32, dynamic). With
    `--package-root` the wrappers are another tree's."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    us = {}
    qkv = torch.randn((64, 77, 3 * 512), device="cuda", generator=gen).to(bf)
    bias = causal_mask(77, "cuda")
    out, lse = fused_attention_qkv_fwd(qkv, bias, 8, 64 ** -0.5, with_lse=True)
    do = torch.randn_like(out)
    us["K1-fwd"] = wrapper_host_us(lambda: fused_attention_qkv_fwd(qkv, bias, 8, 64 ** -0.5, with_lse=True))
    us["K1-fwd-public"] = wrapper_host_us(lambda: fused_attention_qkv(qkv, bias, 8, 64 ** -0.5))
    us["K1-bwd"] = wrapper_host_us(lambda: fused_attention_qkv_bwd(qkv, bias, do, 8, 64 ** -0.5, out, lse))
    qkv = torch.randn((64, 257, 3 * 1024), device="cuda", generator=gen).to(bf)
    out, lse = fused_attention_qkv_headgrid_fwd(qkv, None, 16, 64 ** -0.5, with_lse=True)
    do = torch.randn_like(out)
    us["K2-fwd"] = wrapper_host_us(
        lambda: fused_attention_qkv_headgrid_fwd(qkv, None, 16, 64 ** -0.5, with_lse=True))
    us["K2-fwd-public"] = wrapper_host_us(lambda: fused_attention_qkv_headgrid(qkv, None, 16, 64 ** -0.5))
    us["K2-bwd"] = wrapper_host_us(
        lambda: fused_attention_qkv_headgrid_bwd(qkv, None, do, 16, 64 ** -0.5, out, lse))
    del qkv, out, lse, do
    x = torch.randn((64 * 77, 512), device="cuda", generator=gen).to(bf)
    delta, dy = torch.randn_like(x), torch.randn_like(x)
    gamma = torch.randn((512,), device="cuda", generator=gen)
    beta = torch.randn((512,), device="cuda", generator=gen)
    us["K4a"] = wrapper_host_us(lambda: ln._ln_fwd(x, gamma, beta, 1e-5))
    us["K4b"] = wrapper_host_us(lambda: ln._add_ln_fwd(x, delta, gamma, beta, 1e-5))
    us["K4c"] = wrapper_host_us(lambda: ln.fused_layer_norm_bwd(x, gamma, dy))
    # the public entry points as serving calls them (no input requires a
    # gradient)
    us["K4a-public"] = wrapper_host_us(lambda: ln.fused_layer_norm(x, gamma, beta))
    us["K4b-public"] = wrapper_host_us(lambda: ln.fused_add_layer_norm(x, delta, gamma, beta))
    cost, x_len, x_pad, y_len, y_pad, _ = ot_inputs(gen, OT_BATCH, 16, 7, False)
    us["K3"] = wrapper_host_us(lambda: ot.ipot_kernel(cost, x_len, x_pad, y_len, y_pad))
    xq = torch.randn((64 * 50, 768), device="cuda", generator=gen)
    w = quant.quantize_weight(torch.randn((768, 2304), device="cuda", generator=gen))
    wb = torch.randn((2304,), device="cuda", generator=gen)
    us["K5"] = wrapper_host_us(lambda: quant.quantized_matmul(xq, w.q, w.scale, wb, None))
    emit({"phase": "wrapper_host_cost", "package": os.path.dirname(os.path.dirname(_build.CSRC_DIR)),
          "calls": B1_CALLS, "repeats": B1_REPEATS, "us_per_call_median": us})
    return us


def phase_train_ln(out_root, plain_ln_ms, plain_ln_prof):
    """`phase_train`'s workload through the train loop with
    `use_pallas_ln: true` (K4a, K4b and K4c in every residual block beside
    K1), its pairs/s beside `phase_train`'s from this run; then one
    ViT-L/14 step (64 x 3) with the LayerNorm kernels on (W = 1024, K2
    beside K4)."""
    mcfg = VIT_B32
    D = NUM_POS + NUM_NEG
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_steps = WARMUP_STEPS + TIMED_STEPS
    ds = _BenchPairs(n_steps * TRAIN_BATCH, mcfg.image_resolution, mcfg.context_length,
                     mcfg.vocab_size)
    run = run_train_loop("train_ln", mcfg, params, ds, TRAIN_BATCH, out_root, use_pallas_ln=True)
    first = run["values"]["loss"][0]
    check(abs(first - _chance(TRAIN_BATCH, D)) < 0.5,
          f"train_ln first loss {first} vs chance {_chance(TRAIN_BATCH, D)}")
    del run["state"]
    compare = {
        "bfloat16": compare_bf16_step(mcfg, params, _device_batch(ds, TRAIN_BATCH), fused_ln=True),
        "float32": compare_fp32_grads(mcfg, params, _device_batch(ds, FP32_CHECK_BATCH), fused_ln=True),
    }
    turns = step_ms_in_turns(mcfg, params, _device_batch(ds, TRAIN_BATCH), fused_ln=True)
    prof = profile_step(mcfg, params, _device_batch(ds, TRAIN_BATCH), run["mean_ms"], fused_ln=True)
    pairs = TRAIN_BATCH * D

    def non_gemm_share(p):
        fam = p.get("by_family", {})
        return sum(fam.get(f, {}).get("share_of_busy", 0.0) for f in ("elementwise", "reduction", "copy / cast"))

    _train_report("train_ln", "ViT-B/32", run, TRAIN_BATCH, D, init_s, use_pallas_ln=True,
                  kernel_vs_plain=compare, plain_ln={
                      "step_ms_mean": plain_ln_ms,
                      "contrastive_pairs_per_sec_per_chip": pairs / plain_ln_ms * 1e3,
                      "elementwise_reduction_copy_share_of_busy": non_gemm_share(plain_ln_prof),
                      "device_busy_ms": plain_ln_prof.get("device_busy_ms")},
                  step_ms_ratio_to_plain_ln=run["mean_ms"] / plain_ln_ms,
                  kernel_attention_step_ms=turns["kernel"], plain_attention_step_ms=turns["plain"],
                  elementwise_reduction_copy_share_of_busy=non_gemm_share(prof))
    bound_fwd, bound_bwd = k4_step_bound_ms(mcfg, TRAIN_BATCH, TRAIN_BATCH * D)
    k4_ms = {k: prof.get(f"layer_norm_{k}_kernel_ms") for k in ("fwd", "bwd")}
    emit({"phase": "train_ln_profile", **prof, "k4_device_ms": k4_ms,
          "k4_bound_ms": {"fwd": bound_fwd, "bwd": bound_bwd}})
    del params, ds
    torch.cuda.empty_cache()

    # ViT-L/14: one step with the LayerNorm kernels on, counted
    mcfg = VIT_L14
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    batch = _device_batch(_BenchPairs(L14_BATCH, mcfg.image_resolution, mcfg.context_length,
                                      mcfg.vocab_size), L14_BATCH)
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    state = create_train_state(params, opt)
    step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True)
    # the step updates its state in place, so these are four consecutive
    # steps on one batch (the first of each setting warms up); the launch
    # counts are exact each time
    walls, losses = {"xla": [], "pallas": []}, []
    for impl in ("xla", "pallas", "pallas", "xla"):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with layers.ln_impl(impl):
            _, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls[impl].append(time.perf_counter() - t0)
        expected = train_launches(mcfg, 1, fused_ln=impl == "pallas")
        check(read_launches() == expected, f"L/14 {impl} LN step launches {read_launches()} != {expected}")
        if impl == "pallas":
            l14 = read_launches()
    check(all(math.isfinite(v) and abs(v - _chance(L14_BATCH, D)) < 0.5 for v in losses),
          f"L/14 step losses {losses} vs chance {_chance(L14_BATCH, D)}")
    del state, step
    compare = compare_bf16_step(mcfg, params, batch, fused_ln=True)
    emit({"phase": "train_ln_l14", "model": "ViT-L/14", "batch_images": L14_BATCH,
          "descriptions_per_image": D, "losses": losses, "chance": _chance(L14_BATCH, D),
          "step_wall_s": walls, "launches": l14, "expected": train_launches(mcfg, 1, fused_ln=True),
          "kernel_vs_plain": {"bfloat16": compare}})
    del params, batch
    torch.cuda.empty_cache()
    return run["launches"], l14


def phase_serving_ln():
    """One ViT-B/32 image batch and one text batch of 64 under
    `set_ln_impl("pallas")`, fp32 and bf16, against the plain-LN features of
    the same model: K4a and K4b once per block, no K4c."""
    model_obj, mcfg = load_model_from_cfg({"model": "ViT-B/32", "seed": 0})
    images, tokens = serving_inputs(mcfg, BATCH)
    x_img, x_tok = torch.from_numpy(images).cuda(), torch.from_numpy(tokens).cuda()
    params = model_obj.params()
    cases = [(name, dtype, kind, fn, x)
             for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16))
             for kind, fn, x in (("images", encode_image, x_img), ("texts", encode_text, x_tok))]
    with torch.inference_mode():
        plain = {(name, kind): l2_normalize(fn(params, mcfg, x, compute_dtype=dtype)).float()
                 for name, dtype, kind, fn, x in cases}
        torch.cuda.synchronize()
        reset_launches()
        with layers.ln_impl("pallas"):
            fused = {(name, kind): l2_normalize(fn(params, mcfg, x, compute_dtype=dtype)).float()
                     for name, dtype, kind, fn, x in cases}
        torch.cuda.synchronize()
    launches = read_launches()
    blocks = 2 * (mcfg.vision_layers + mcfg.transformer_layers)  # two dtypes
    expected = {**dict.fromkeys(COUNTERS, 0), KERNEL: blocks, ln.KERNEL: blocks, ADD_LN_KERNEL: blocks}
    check(launches == expected, f"serving_ln launches {launches} != {expected}")
    summary = {}
    for (name, kind), k in fused.items():
        check(k.shape == (BATCH, mcfg.embed_dim) and bool(torch.isfinite(k).all()),
              f"serving_ln {name} {kind} shape/finite")
        if name == "float32":
            err = (k - plain[name, kind]).abs().max().item()
            check(err <= 1e-4, f"serving_ln fp32 {kind}: LN kernels vs plain LN max abs err {err}")
            summary[f"float32_{kind}_max_abs_err"] = err
        else:
            cos = F.cosine_similarity(k, plain[name, kind], dim=-1).min().item()
            check(cos >= 0.999, f"serving_ln bf16 {kind}: LN kernels vs plain LN min cosine {cos}")
            summary[f"bfloat16_{kind}_min_cos"] = cos
    # batch ms in turns (plain, kernels, kernels, plain): the bf16 batches
    # are bound by the host's launch rate, which drifts within a run
    rates = {}
    with torch.inference_mode():
        for impl in ("xla", "pallas", "pallas", "xla"):
            with layers.ln_impl(impl):
                for name, dtype, kind, fn, x in cases:
                    ms = cuda_ms(lambda: fn(params, mcfg, x, compute_dtype=dtype), iters=20, warmup=3)
                    rates.setdefault(f"{impl}_{name}_{kind}_batch_ms", []).append(ms)
    emit({"phase": "serving_ln", "model": "ViT-B/32", "batch": BATCH, "launches": launches,
          "expected": expected, **summary, **rates})
    del model_obj, params
    torch.cuda.empty_cache()
    return launches


def phase_bench_tools():
    """The port's bench entry point at full width (ViT-B/32, 384 x 3; its
    protocol, the graphed step after one warm-up call, here with
    BENCH_STEPS steps a call and one timed call), with
    the plain LayerNorm and with `--ln pallas` (once each), and
    the `ln` and `megakernel`
    sections of the component bench at their default shapes (B = 256, D = 3,
    12 layers), then its other sections (`BENCH_SECTIONS`) and the preset
    sweep on `PRESET_ENTRIES`, each through its `main`: the JSON lines
    parsed, the metric finite and positive, exact launch counts."""
    import contextlib
    import io

    def run_main(main_fn, argv):
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            check(main_fn(argv) == 0, f"{main_fn.__module__} {argv} exit code")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # a bench run's graph pool goes with its graph
        return out.getvalue().splitlines(), read_launches()

    all_launches = dict.fromkeys(COUNTERS, 0)
    torch.cuda.empty_cache()
    # both settings within one run, once each (the script's time: the
    # graphed step's host share is small)
    results = {"xla": [], "pallas": []}
    for impl in ("xla", "pallas"):
        lines, launches = run_main(port_bench.main, ["--ln", impl, "--calls", "1", "--steps", str(BENCH_STEPS)])
        check(len(lines) == 1, f"bench --ln {impl}: one line, got {len(lines)}")
        result = json.loads(lines[0])
        check(result["metric"] == "contrastive_pairs_per_sec_per_chip"
              and math.isfinite(result["value"]) and result["value"] > 0
              and result["device"]["nvidia_smi"] and "vs_baseline" not in result,
              f"bench --ln {impl}: {result}")
        steps = result["steps"] + result["warmup_steps"]
        per_step = train_launches(VIT_B32, 1, fused_ln=impl == "pallas")
        check(launches == {k: v * steps for k, v in per_step.items()}
              and result["launches_per_step"] == {k: per_step[k] for k in result["launches_per_step"]},
              f"bench --ln {impl} launches {launches} over {steps} steps")
        results[impl].append(result)
        for k in COUNTERS:
            all_launches[k] += launches[k]
    step_ms = {impl: [r["step_ms"] for r in runs] for impl, runs in results.items()}
    emit({"phase": "bench_tools", "tool": "clip_event_tpu_torch.bench", "plain_ln": results["xla"],
          "fused_ln": results["pallas"], "step_ms": step_ms,
          "step_ms_ratio_fused_to_plain": float(np.mean(step_ms["pallas"]) / np.mean(step_ms["xla"]))})

    # the JAX bench's input (float32 N(0, 1) images) beside the train loop's
    # (uint8 pixels normalized on the device: the default, which the plain
    # LayerNorm's run above read)
    by_images = {"uint8": list(step_ms["xla"]), "float32": []}
    for images in ("float32",):
        lines, launches = run_main(port_bench.main, ["--images", images, "--calls", "1",
                                                     "--steps", str(BENCH_STEPS)])
        result = json.loads(lines[0])
        check(len(lines) == 1 and result["images"] == images and math.isfinite(result["value"])
              and result["value"] > 0, f"bench --images {images}: {result}")
        steps = result["steps"] + result["warmup_steps"]
        check(launches == {k: v * steps for k, v in train_launches(VIT_B32, 1).items()},
              f"bench --images {images} launches {launches}")
        by_images[images].append(result["step_ms"])
        for k in COUNTERS:
            all_launches[k] += launches[k]
    emit({"phase": "bench_tools", "tool": "clip_event_tpu_torch.bench --images", "step_ms": by_images,
          "step_ms_ratio_float32_to_uint8": float(np.mean(by_images["float32"]) / np.mean(by_images["uint8"]))})

    lines, launches = run_main(bench_components.main, ["ln", "megakernel", "--steps", str(SECTION_STEPS)])
    summary = json.loads(lines[-1])
    check(len(summary["rows"]) == 10 and len(lines) == 11, f"bench_components rows {len(summary['rows'])}")
    check(all(r["ms_per_iter"] is not None and math.isfinite(r["ms_per_iter"]) and r["ms_per_iter"] > 0
              for r in summary["rows"]), f"bench_components times {summary['rows']}")
    L = VIT_B32.transformer_layers + VIT_B32.vision_layers
    runs = 1 + SECTION_STEPS  # the warm-up call and the timed ones
    # ln: three variants of the stack gradient under remat, K1 in each (its
    # bf16 backward too, at head_dim 64), K4 in one; megakernel: K1 in the
    # unfused forward, K6 in the fused one
    expected = {**dict.fromkeys(COUNTERS, 0),
                KERNEL: (3 * 2 + 1) * L * runs, BWD_KERNEL: 3 * k1_bwd_launches(64, 1) * L * runs,
                ln.KERNEL: 2 * L * runs, ADD_LN_KERNEL: 2 * L * runs,
                ln.BWD_KERNEL: 2 * ln.BWD_LAUNCHES_PER_CALL * L * runs, MEGA_KERNEL: L * runs}
    check(launches == expected, f"bench_components launches {launches} != {expected}")
    emit({"phase": "bench_tools", "tool": "clip_event_tpu_torch.tools.bench_components",
          "lines": lines[:-1], **summary, "launches": launches})
    for k in COUNTERS:
        all_launches[k] += launches[k]

    # the encoder, kernel and train-step sections, then quant at ViT-L/14
    runs = [([section], VIT_B32) for section in BENCH_SECTIONS]
    runs.append((["quant", "--model", "ViT-L/14", "--batch", str(L14_BATCH)], VIT_L14))
    for argv, mcfg in runs:
        t0 = time.perf_counter()
        quant.quantize_rows.launches = quant.quantized_gemm.launches = 0
        lines, launches = run_main(bench_components.main,
                                   argv + ["--steps", str(SECTION_STEPS), "--calls", str(SECTION_CALLS)])
        alone = {"quantize_rows": quant.quantize_rows.launches, "quantized_gemm": quant.quantized_gemm.launches}
        summary = json.loads(lines[-1])
        rows = summary["rows"]
        check(rows and len(lines) == len(rows) + 1 and summary["device"]["nvidia_smi"],
              f"bench_components {argv}: {len(rows)} rows, {len(lines)} lines")
        check(all(r["ms_per_iter"] is not None and math.isfinite(r["ms_per_iter"]) and r["ms_per_iter"] > 0
                  for r in rows), f"bench_components {argv} times {rows}")
        expected, expected_alone = section_launches(argv[0], mcfg, SECTION_STEPS, SECTION_CALLS)
        check(launches == expected and alone == expected_alone,
              f"bench_components {argv} launches {launches} {alone} != {expected} {expected_alone}")
        emit({"phase": "bench_tools", "tool": "clip_event_tpu_torch.tools.bench_components",
              "argv": argv, "steps": SECTION_STEPS, "calls": SECTION_CALLS, "lines": lines[:-1], **summary,
              "launches": launches,
              "launches_alone": alone, "seconds": time.perf_counter() - t0})
        for k in COUNTERS:
            all_launches[k] += launches[k]

    # the preset sweep on two entries: K2 in ViT-B/16's vision tower under
    # "attn", and a ResNet tower (K1 in the text tower alone)
    for entry, mcfg, remat in PRESET_ENTRIES:
        t0 = time.perf_counter()
        lines, launches = run_main(bench_presets.main, [entry, "--steps", str(BENCH_STEPS), "--calls", "1"])
        summary = json.loads(lines[-1])
        rows = summary["rows"]
        check(len(rows) == 1 and len(lines) == 2 and summary["device"]["nvidia_smi"],
              f"bench_presets {entry}: {len(rows)} rows, {len(lines)} lines")
        check("error" not in rows[0] and all(math.isfinite(rows[0][k]) and rows[0][k] > 0
                                             for k in ("step_ms", "pairs_per_s")),
              f"bench_presets {entry}: {rows[0]}")
        expected = train_launches(mcfg, 2 * BENCH_STEPS, remat=remat)  # the warm-up call, one timed
        check(launches == expected, f"bench_presets {entry} launches {launches} != {expected}")
        emit({"phase": "bench_tools", "tool": "clip_event_tpu_torch.tools.bench_presets", "entry": entry,
              "lines": lines[:-1], **summary, "launches": launches, "seconds": time.perf_counter() - t0})
        for k in COUNTERS:
            all_launches[k] += launches[k]
    return all_launches


# the component bench's encoder, kernel, train-step, branch and engine
# sections, the timed iterations a row they run here (the step sections:
# steps a call) and the step sections' timed calls; the bench entry point's
# and the preset sweep's steps a call (one warm-up call, one timed); the
# script's time limit sets these depths
BENCH_SECTIONS = ("matmul", "quantgemm", "text", "vision", "visionsplit", "step", "textsplit",
                  "textwidth", "latency", "quant", "ot", "alignment", "multiattention", "dedupe",
                  "accum", "ckpt", "moments")
SECTION_STEPS, SECTION_CALLS, BENCH_STEPS = 1, 1, 2
# the preset sweep's entries here: (entry, model, remat policy)
PRESET_ENTRIES = (("ViT-B/16:96:attn", VIT_B16, "attn"), ("RN50:128:1", RN50, "full"))


def section_launches(section, mcfg, steps, calls):
    """Launches per kernel of one component-bench section at its default
    shapes (B = 256 for `mcfg`'s shapes, the preset's layers) with `steps`
    timed iterations a row after one warm-up call (the step sections:
    `calls` timed calls of `steps` steps), and the launches of K5's
    GEMM alone and row pass (their own counters). A row with the plain
    attention or the plain int8 composition launches nothing. text /
    vision: the kernel under full remat (two forwards a block), "attn" and
    no remat (one each), a backward each; the splits: the full block and
    the attention half, each under full remat; step: `train_launches` over
    (1 + calls) calls of `steps` steps; textwidth: one forward a block a
    width; latency: 1 + LATENCY_CALLS + 1 + steps calls a batch size, K5 in
    the int8 static vision tower; quant: 1 + steps calls of each variant,
    K5 in the "int8 K5" one; ot: one K3 launch a call; quantgemm: K5's
    whole call, the GEMM alone and the row pass (once more as each shape is
    set up) at three shapes. The branch and engine sections:
    `train_launches` over their steps, each call of min(steps, 3) steps
    (`branch_steps`) or `steps`, one warm-up call and `calls` timed ones
    (accum's K-microbatch steps `accum_calls`);
    alignment with its crops and entities (11 and 16 an image, 4 chunks
    requested) and no K3 (the plain OT loop); multiattention in both modes;
    dedupe's deduped layouts at the plain layout's count (an encode of the
    unique rows launches what an encode of all of them does); accum's K
    microbatches a call at K single steps' count; ckpt the warm call and
    the two behind the saves; moments two variants."""
    runs = 1 + steps
    out = dict.fromkeys(COUNTERS, 0)
    alone = {"quantize_rows": 0, "quantized_gemm": 0}
    Lt, Lv = mcfg.transformer_layers, mcfg.vision_layers
    vis_f, vis_b = vision_kernels(mcfg)
    text_bwd = k1_bwd_launches(mcfg.transformer_width, mcfg.transformer_heads)
    vis_bwd = (HG_BWD_LAUNCHES_PER_CALL if vis_b == HG_BWD_KERNEL
               else k1_bwd_launches(mcfg.vision_width, mcfg.vision_heads))

    branch = (1 + calls) * bench_components.branch_steps(steps)  # a branch step's steps in all

    def add(counts, times=1):
        for k, v in counts.items():
            out[k] += v * times

    if section == "quantgemm":
        out[quant.KERNEL] = 3 * runs * quant.LAUNCHES_PER_CALL
        alone = {"quantize_rows": 3 * (1 + runs), "quantized_gemm": 3 * runs}
    elif section in ("text", "textsplit"):
        out[KERNEL] += 4 * Lt * runs
        out[BWD_KERNEL] += (3 if section == "text" else 2) * text_bwd * Lt * runs
    elif section in ("vision", "visionsplit"):
        out[vis_f] += 4 * Lv * runs
        out[vis_b] += (3 if section == "vision" else 2) * vis_bwd * Lv * runs
    elif section == "step":
        add(train_launches(mcfg, (1 + calls) * steps))
    elif section == "textwidth":
        widths = [w for w in bench_components.TEXT_WIDTHS if w <= mcfg.context_length]
        out[KERNEL] += len(widths) * Lt * runs
    elif section == "latency":
        calls = len(bench_components.LATENCY_BATCHES) * (2 + bench_components.LATENCY_CALLS + steps)
        add(serving_launches(mcfg, calls, 0))
        add(int8_launches(mcfg, calls, 0, float_towers=("text",)))
    elif section == "quant":
        add(serving_launches(mcfg, 2 * runs, 2 * runs), len(bench_components.QUANT_VARIANTS) - 1)
        add(int8_launches(mcfg, 2 * runs, 2 * runs))
    elif section == "ot":
        out[ot.KERNEL] = runs
    elif section == "alignment":
        add(train_launches(mcfg, branch, alignment=True, ot_kernel=False,
                           ot_nodes=(bench_components.ALIGN_OBJECTS, bench_components.ALIGN_ENTITIES),
                           ot_chunks=bench_components.ALIGN_CHUNKS))
    elif section == "multiattention":
        for mode in bench_components.MULTIATTENTION_MODES:
            add(train_launches(mcfg, branch, multiattention=mode))
    elif section == "dedupe":
        add(train_launches(mcfg, (1 + calls) * steps), 1 + len(bench_components.DEDUPE_UNIQUE))
        for mode in bench_components.MULTIATTENTION_MODES:  # plain, sr-deduped, all-deduped
            add(train_launches(mcfg, branch, multiattention=mode), 3)
    elif section == "accum":
        add(train_launches(mcfg, (1 + calls) * steps))
        for k in bench_components.ACCUM_KS:
            add(train_launches(mcfg, (1 + bench_components.accum_calls(k, steps, calls)) * k))
    elif section == "ckpt":
        add(train_launches(mcfg, 3 * steps))
    elif section == "moments":
        add(train_launches(mcfg, (1 + calls) * steps), len(bench_components.MOMENT_DTYPES))
    else:
        check(section == "matmul", f"section_launches: unknown section {section!r}")
    return out, alone


def phase_train_l14(out_root):
    """ViT-L/14 through the train loop at bench.py's L/14 workload, with its
    remat policy ("attn") and GRAPH_LOOP_K steps a dispatch (the CUDA graph
    of the step), counted: K2's forward once a vision block a step (24),
    K1's once a text block (12); the step under "attn" against full remat
    (`policy_compare`) and the eager "attn" step against a graph dispatch
    (`graph_vs_eager`); the full-remat kernel step against the plain
    attention (the gates of the earlier phases, in turns); then one
    ViT-B/16 kernel-path step at its bench batch."""
    D = NUM_POS + NUM_NEG
    _, n_steps = loop_steps(GRAPH_LOOP_K)
    mcfg = VIT_L14
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ds = _BenchPairs(n_steps * L14_BATCH, mcfg.image_resolution, mcfg.context_length, mcfg.vocab_size)
    per_step = train_launches(mcfg, 1, remat="attn")
    check(per_step[HG_KERNEL] == 24 and per_step[KERNEL] == 12
          and per_step[HG_BWD_KERNEL] == train_launches(mcfg, 1)[HG_BWD_KERNEL]
          and per_step[BWD_KERNEL] == train_launches(mcfg, 1)[BWD_KERNEL],
          f"L/14 'attn' launches a step {per_step}")
    run = run_train_loop("train_l14", mcfg, params, ds, L14_BATCH, out_root, remat="attn",
                         steps_per_dispatch=GRAPH_LOOP_K)
    first = run["values"]["loss"][0]
    check(abs(first - _chance(L14_BATCH, D)) < 0.5,
          f"L/14 first loss {first} vs chance {_chance(L14_BATCH, D)}")
    del run["state"]
    torch.cuda.empty_cache()
    batch = _device_batch(ds, L14_BATCH)
    policies = policy_compare(mcfg, params, batch)
    timing = graph_vs_eager(mcfg, params, batch, remat="attn")
    compare = {"bfloat16": compare_bf16_step(mcfg, params, batch)}
    turns = step_ms_in_turns(mcfg, params, batch)
    prof = profile_step(mcfg, params, batch, run["mean_ms"])
    _train_report("train_l14", "ViT-L/14", run, L14_BATCH, D, init_s, full_vs_attn=policies,
                  graph_vs_eager=timing, kernel_vs_plain=compare,
                  full_remat_kernel_attention_step_ms=turns["kernel"],
                  full_remat_plain_attention_step_ms=turns["plain"])
    emit({"phase": "train_l14_profile", "remat": "full", **prof})

    # fp32 steps (`compute_dtype: "float32"`): the vision tower's K2 and the
    # text tower's K1 on their tf32x3 variants, forward and backward. The
    # train steps timed beside the plain attention in turns are the path,
    # counted (one warm-up step and two timed ones on the kernels); then one
    # step's loss and gradients against the plain step
    batch = _device_batch(ds, L14_FP32_BATCH)
    reset_launches()
    turns = step_ms_in_turns(mcfg, params, batch, dtype=torch.float32)
    launches = read_launches()
    expected = train_launches(mcfg, 1 + len(turns["kernel"]), dtype=torch.float32)
    check(launches == expected, f"fp32 L/14 step launches {launches} != {expected}")
    fp32 = compare_fp32_grads(mcfg, params, batch)
    emit({"phase": "train_l14_fp32", "model": "ViT-L/14", "batch_images": L14_FP32_BATCH,
          "descriptions_per_image": D, "compute_dtype": "float32", "remat": "full",
          "vision_attention_variant": headgrid_variant(torch.float32, mcfg.vision_width // mcfg.vision_heads),
          "text_attention_variant": k1_variant(torch.float32, mcfg.transformer_width // mcfg.transformer_heads),
          "kernel_vs_plain": fp32, "tol": FP32_STEP_TOL, "launches": launches,
          "kernel_attention_step_ms": turns["kernel"], "plain_attention_step_ms": turns["plain"]})
    fp32_launches = launches
    del params, ds, batch
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
    del state, step
    compare = {"bfloat16": compare_bf16_step(mcfg, params, batch)}
    turns = step_ms_in_turns(mcfg, params, batch)
    emit({"phase": "train_b16", "model": "ViT-B/16", "batch_images": B16_BATCH,
          "descriptions_per_image": D, "loss": loss, "chance": _chance(B16_BATCH, D),
          "first_step_wall_s": step_s, "launches": b16, "expected": expected,
          "kernel_vs_plain": compare, "kernel_attention_step_ms": turns["kernel"],
          "plain_attention_step_ms": turns["plain"]})
    del params, batch
    torch.cuda.empty_cache()
    return run["launches"], b16, fp32_launches


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
    del run["state"]
    torch.cuda.empty_cache()
    graph_kw = {"alignment": True, "alignment_chunks": OT_CHUNKS, "use_pallas_ot": True}
    check_ds = _OTPairs(GRAPH_CHECK_K * OT_BATCH, mcfg.image_resolution, mcfg.context_length,
                        mcfg.vocab_size)
    equal = graph_equals_eager(mcfg, params, _device_batches(check_ds, OT_BATCH, GRAPH_CHECK_K),
                               dispatches=1, **graph_kw)
    del check_ds
    timing = graph_vs_eager(mcfg, params, _device_batch(ds, OT_BATCH), k=OT_GRAPH_TIMING_K, **graph_kw)
    loss_ot = run["values"]["loss_ot"]
    check(all(np.isfinite(loss_ot)) and min(loss_ot) > 0, f"loss_ot finite and > 0: {loss_ot}")
    contrastive = run["values"]["loss_i"][0] + run["values"]["loss_t"][0]
    check(abs(contrastive - _chance(OT_BATCH, D)) < 0.5,
          f"OT first contrastive loss {contrastive} vs chance {_chance(OT_BATCH, D)}")
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
                  entities=OT_ENTITIES, alignment_chunks=OT_CHUNKS, kernel_vs_plain=compare,
                  graph_equals_eager=equal, graph_vs_eager=timing)
    emit({"phase": "train_ot_profile", **prof})
    del params, ds
    torch.cuda.empty_cache()
    return run["launches"], equal["graph_launches"]


# configs/clip_event_full.json at ViT-B/32: finetune_ot's channels (batch
# 64, 8 object slots, 16 entity and 8 event rows) plus the bbox channel of
# load_sr (8 boxes an image) whose role texts are deduped to 256 unique rows
# a batch; the boxes' labels are drawn from FULL_LABELS synthetic labels
FULL_BATCH, FULL_BBOXES, FULL_DEDUPE, FULL_LABELS = 64, 8, 256, 40
RN_SERVING_ITEMS = 64
RN_TRAIN_BATCH = 128  # the bench's RN50 batch (the JAX bench's table)


class _FullPairs(_OTPairs):
    """configs/clip_event_full.json's workload as a dataset: the channels of
    `_OTPairs` plus the bbox channel of `load_sr`, from seed 2: per image a
    ragged count (0 to FULL_BBOXES) of normalized xyxy boxes, each with the
    token rows of a role description and of a role-type label (one of
    FULL_LABELS synthetic labels), zero past the count, as
    `VOADescriptionDataset._sr_channel` pads them; `finalize_batch` dedupes
    both role-text channels to FULL_DEDUPE unique rows, strictly (a graph
    dispatch takes one shape), as `dedupe_sr_texts` does."""

    def __init__(self, n, res, context, vocab, seed=0):
        super().__init__(n, res, context, vocab, seed)
        rng = np.random.default_rng(seed + 2)
        R = FULL_BBOXES
        self.bbox_n = rng.integers(0, R + 1, n)
        lo = rng.uniform(0, 0.7, size=(n, R, 2))
        hi = np.minimum(lo + rng.uniform(0.1, 0.6, size=(n, R, 2)), 1.0)
        self.bbox = np.concatenate([lo, hi], -1).astype(np.float32)
        self.label_of = rng.integers(0, FULL_LABELS, size=(n, R))

        def rows(longest):
            tok = np.zeros((FULL_LABELS, context), np.int32)
            for i in range(FULL_LABELS):
                eot = int(rng.integers(3, longest))
                tok[i, 0] = SOT
                tok[i, 1:eot] = rng.integers(1, SOT, eot - 1)
                tok[i, eot] = EOT
            return tok

        self.desc_rows, self.label_rows = rows(12), rows(6)

    def __getitem__(self, i):
        tensors, meta = super().__getitem__(i)
        mask = (np.arange(FULL_BBOXES) < self.bbox_n[i]).astype(np.int32)
        tensors["bbox"] = self.bbox[i] * mask[:, None]
        tensors["bbox_mask"] = mask
        tensors["bbox_desc_text"] = self.desc_rows[self.label_of[i]] * mask[:, None]
        tensors["bbox_label_text"] = self.label_rows[self.label_of[i]] * mask[:, None]
        return tensors, meta

    def finalize_batch(self, tensors):
        from clip_event_tpu_torch.data.dedupe import dedupe_rows

        tensors = super().finalize_batch(tensors)
        for field, prefix in (("bbox_desc_text", "bbox_desc"), ("bbox_label_text", "bbox_label")):
            rows = tensors.pop(field)
            tensors[f"{prefix}_unique"], tensors[f"{prefix}_inverse"] = dedupe_rows(
                rows.reshape(-1, rows.shape[-1]), FULL_DEDUPE, strict=True, tag=field)
        return tensors


def phase_train_full(out_root):
    """configs/clip_event_full.json's settings at ViT-B/32 full width through
    the train loop with GRAPH_LOOP_K steps a dispatch (the CUDA graph of the
    step): the OT branch and the local-attention branch ("desc_type",
    attention pooling) over the object, IE and bbox channels, bf16, full
    remat, Adam at lr 1e-6, counted (K1 in every encode: the image batch
    twice, the role descriptions and labels once each; K3 once a step); a
    GRAPH_CHECK_K-step dispatch against as many eager steps bit for bit,
    with the ms of each; the bf16 kernel step against the all-plain ones."""
    mcfg = VIT_B32
    D = NUM_POS + NUM_NEG
    with open(os.path.join(REPO, "configs", "clip_event_full.json")) as fh:
        full = json.load(fh)
    full_cfg = {k: full[k] for k in (
        "alignment", "multiattention", "multiattention_pooling", "load_object", "load_ie", "load_sr",
        "object_ontology_file", "max_objects", "max_entities", "max_events", "max_bboxes",
        "dedupe_sr_texts")}
    check(full_cfg == {**full_cfg, "alignment": True, "load_sr": True, "max_objects": OT_OBJECTS,
                       "max_entities": OT_ENTITIES, "max_events": OT_EVENTS,
                       "max_bboxes": FULL_BBOXES, "dedupe_sr_texts": FULL_DEDUPE}
          and full["batch_size"] == FULL_BATCH and full["lr"] == 1e-6,
          f"clip_event_full.json's settings {full_cfg}")
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    k = GRAPH_LOOP_K
    ds = _FullPairs(loop_steps(k)[1] * FULL_BATCH, mcfg.image_resolution, mcfg.context_length,
                    mcfg.vocab_size)
    run = run_train_loop("train_full", mcfg, params, ds, FULL_BATCH, out_root, steps_per_dispatch=k,
                         **full_cfg)
    del run["state"]
    torch.cuda.empty_cache()
    for key in ("loss_ot", "loss_bbox", "loss_arg"):
        check(all(np.isfinite(run["values"][key])) and min(run["values"][key]) > 0,
              f"train_full {key} finite and > 0: {run['values'][key]}")
    contrastive = run["values"]["loss_i"][0] + run["values"]["loss_t"][0]
    check(abs(contrastive - _chance(FULL_BATCH, D)) < 0.5,
          f"train_full first contrastive loss {contrastive} vs chance {_chance(FULL_BATCH, D)}")
    step_kwargs = {"alignment": True, "alignment_chunks": OT_CHUNKS,
                   "multiattention": full["multiattention"],
                   "multiattention_pooling": full["multiattention_pooling"]}
    check_ds = _FullPairs(GRAPH_CHECK_K * FULL_BATCH, mcfg.image_resolution, mcfg.context_length,
                          mcfg.vocab_size, seed=1)
    equal = graph_equals_eager(mcfg, params, _device_batches(check_ds, FULL_BATCH, GRAPH_CHECK_K),
                               dispatches=1, use_pallas_ot=True, **step_kwargs)
    del check_ds
    compare = compare_bf16_step(mcfg, params, _device_batch(ds, FULL_BATCH),
                                keys=("loss_i", "loss_t", "loss_ot"),
                                summed_keys=("loss", "loss_bbox", "loss_arg"), **step_kwargs)
    eager_ms = equal["eager_ms"][0] / GRAPH_CHECK_K
    graph_ms = equal["dispatch_ms"][0] / GRAPH_CHECK_K  # with the eager first step and the capture
    _train_report("train_full", "ViT-B/32", run, FULL_BATCH, D, init_s, objects=OT_OBJECTS,
                  entities=OT_ENTITIES, bboxes=FULL_BBOXES, dedupe_sr_texts=FULL_DEDUPE,
                  multiattention=full["multiattention"], pooling=full["multiattention_pooling"],
                  kernel_vs_plain={"bfloat16": compare}, graph_equals_eager=equal,
                  eager_step_ms=eager_ms, first_dispatch_step_ms=graph_ms,
                  graph_step_ms=run["mean_ms"],
                  per_step_launches={name: v // run["n_steps"] for name, v in run["launches"].items()})
    del params, ds
    torch.cuda.empty_cache()
    return run["launches"]


def phase_serving_rn50(out_root):
    """RN50, then RN50x4, from seed 0 through the CLI's `load_model_from_cfg`
    and the eval encoders: one batch of 64 images and one of 64 token rows
    in fp32 and in bf16, counted (K1 once a text-tower block a text batch,
    nothing in the ResNet tower); the kernel path against the plain
    attention's (texts: fp32 1e-4, bf16 cosine 0.999; images: equal bits);
    images/s and texts/s. Then RN50 in int8 (the text tower's dense layers
    through K5; the convolutions and the attention pool stay float),
    counted, against the all-plain path (plain attention, plain K5) at
    cosine 0.999."""
    all_launches = dict.fromkeys(COUNTERS, 0)
    for model in ("RN50", "RN50x4"):
        t0 = time.perf_counter()
        model_obj, mcfg = load_model_from_cfg({"model": model, "seed": 0})
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(not mcfg.is_vit and model_obj.device.type == "cuda", f"{model} on the card")
        images, tokens = serving_inputs(mcfg, RN_SERVING_ITEMS)
        x_img, x_tok = torch.from_numpy(images).cuda(), torch.from_numpy(tokens).cuda()
        encoders = {"float32": Encoders(model_obj, mcfg, batch_size=BATCH),
                    "bfloat16": Encoders(model_obj, mcfg, batch_size=BATCH, compute_dtype=torch.bfloat16)}
        reset_launches()
        feats = {name: {"images": enc.images(images), "texts": enc.texts(tokens)}
                 for name, enc in encoders.items()}
        torch.cuda.synchronize()
        launches = read_launches()
        batches = _encoder_batches(RN_SERVING_ITEMS, BATCH) * len(encoders)
        expected = serving_launches(mcfg, batches, batches)
        check(launches == expected, f"serving {model} launches {launches} != {expected}")
        all_launches = {k: all_launches[k] + launches[k] for k in COUNTERS}
        summary = {}
        for name, by_kind in feats.items():
            for kind, f in by_kind.items():
                check(f.shape == (RN_SERVING_ITEMS, mcfg.embed_dim) and bool(np.isfinite(f).all()),
                      f"{model} {name} {kind}: shape {f.shape}, finite")
                err = float(np.abs(np.linalg.norm(f, axis=1) - 1.0).max())
                check(err <= (1e-4 if name == "float32" else 1e-2), f"{model} {name} {kind} unit norm {err}")
        params = encoders["float32"].params
        with torch.inference_mode():
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                ki, pi = (encode_image(params, mcfg, x_img, compute_dtype=dtype, impl=impl)
                          for impl in ("kernel", "plain"))
                check(torch.equal(ki, pi), f"{model} {name} images: no kernel in the ResNet tower")
                k = l2_normalize(encode_text(params, mcfg, x_tok, compute_dtype=dtype, impl="kernel")).float()
                p = l2_normalize(encode_text(params, mcfg, x_tok, compute_dtype=dtype, impl="plain")).float()
                if name == "float32":
                    err = (k - p).abs().max().item()
                    check(err <= 1e-4, f"{model} fp32 texts: kernel vs plain max abs err {err}")
                    summary["float32_texts_kernel_vs_plain_max_abs_err"] = err
                else:
                    cos = F.cosine_similarity(k, p, dim=-1).min().item()
                    check(cos >= 0.999, f"{model} bf16 texts: kernel vs plain min cosine {cos}")
                    summary["bfloat16_texts_kernel_vs_plain_min_cos"] = cos
                    fp32 = torch.from_numpy(feats["float32"]["images"]).cuda()
                    summary["bfloat16_images_vs_float32_min_cos"] = F.cosine_similarity(
                        torch.from_numpy(feats["bfloat16"]["images"]).cuda(), fp32, dim=-1).min().item()
            rates = {}
            for name, enc in encoders.items():
                ms_img = cuda_ms(lambda: enc.encode_images(x_img), iters=20, warmup=3)
                ms_txt = cuda_ms(lambda: enc.encode_texts(x_tok), iters=20, warmup=3)
                rates[name] = {"images_per_s": BATCH / ms_img * 1e3, "texts_per_s": BATCH / ms_txt * 1e3,
                               "image_batch_ms": ms_img, "text_batch_ms": ms_txt}
        emit({"phase": "serving_rn50", "model": model, "seed": 0, "init_s": init_s,
              "images": RN_SERVING_ITEMS, "texts": RN_SERVING_ITEMS, "batch": BATCH,
              "image_resolution": mcfg.image_resolution, "launches": launches,
              "per_batch": {"image": serving_launches(mcfg, 1, 0), "text": serving_launches(mcfg, 0, 1)},
              "throughput": rates, **summary})
        if model == "RN50":
            # where an image batch's time goes: cuDNN's convolutions, the
            # BatchNorm and ReLU elementwise kernels, the pools
            with torch.inference_mode():
                for name, enc in encoders.items():
                    emit({"phase": "serving_rn50_profile", "model": model, "dtype": name, "tower": "images",
                          **profile_one(lambda: enc.encode_images(x_img), rates[name]["image_batch_ms"],
                                        kernels=(("conv", "conv"), ("gemm", "gemm")))})
        del encoders, model_obj, params
        torch.cuda.empty_cache()

    # RN50 in int8 (the CLI's "int8": dynamic activation scales)
    model_obj, mcfg = load_model_from_cfg({"model": "RN50", "seed": 0, "quantize": "int8"})
    params = model_obj.params()
    check(isinstance(params["text_projection"], quant.QuantWeight)
          and not quant.is_quantized(params["visual"]), "RN50 int8: the text tower quantized, the image tower float")
    images, tokens = serving_inputs(mcfg, RN_SERVING_ITEMS)
    x_img, x_tok = torch.from_numpy(images).cuda(), torch.from_numpy(tokens).cuda()
    enc = Encoders(model_obj, mcfg, batch_size=BATCH)
    reset_launches()
    feats = {"images": enc.images(images), "texts": enc.texts(tokens)}
    torch.cuda.synchronize()
    launches = read_launches()
    expected = int8_launches(mcfg, 1, 1)
    check(launches == expected, f"serving RN50 int8 launches {launches} != {expected}")
    all_launches = {k: all_launches[k] + launches[k] for k in COUNTERS}
    summary = {"weight_bytes": weight_bytes(params)}
    p32 = enc.params
    with torch.inference_mode():
        k = torch.from_numpy(feats["texts"]).cuda()
        quant.set_gemm_impl("xla")
        try:
            p = l2_normalize(encode_text(p32, mcfg, x_tok, impl="plain")).float()
        finally:
            quant.set_gemm_impl("auto")
        cos = F.cosine_similarity(k, p, dim=-1).min().item()
        check(cos >= 0.999, f"RN50 int8 texts: kernel vs all-plain min cosine {cos}")
        summary["float32_texts_kernel_vs_plain_min_cos"] = cos
        ms_img = cuda_ms(lambda: enc.encode_images(x_img), iters=20, warmup=3)
        ms_txt = cuda_ms(lambda: enc.encode_texts(x_tok), iters=20, warmup=3)
    emit({"phase": "serving_rn50", "model": "RN50", "mode": "int8", "seed": 0, "launches": launches,
          "per_batch": {"image": int8_launches(mcfg, 1, 0), "text": int8_launches(mcfg, 0, 1)},
          "throughput": {"float32": {"images_per_s": BATCH / ms_img * 1e3, "texts_per_s": BATCH / ms_txt * 1e3,
                                     "image_batch_ms": ms_img, "text_batch_ms": ms_txt}}, **summary})
    del enc, model_obj, params, p32
    torch.cuda.empty_cache()
    return all_launches


def phase_train_rn50(out_root):
    """RN50 at the bench's batch (128 images × 3 descriptions), bf16, full
    remat of the text tower (the ResNet tower takes none), Adam at lr 1e-6,
    through the train loop with GRAPH_LOOP_K steps a dispatch, counted (K1
    in the text tower alone); a GRAPH_CHECK_K-step dispatch against as many
    eager steps bit for bit; one `sync_bn` step (the batch's BatchNorm
    statistics) beside a frozen one from one state and batch, counted, with
    their ms; pairs/s."""
    mcfg = RN50
    D = NUM_POS + NUM_NEG
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    k = GRAPH_LOOP_K
    ds = _BenchPairs(loop_steps(k)[1] * RN_TRAIN_BATCH, mcfg.image_resolution, mcfg.context_length,
                     mcfg.vocab_size)
    run = run_train_loop("train_rn50", mcfg, params, ds, RN_TRAIN_BATCH, out_root, steps_per_dispatch=k)
    del run["state"]
    torch.cuda.empty_cache()
    first = run["values"]["loss"][0]
    check(abs(first - _chance(RN_TRAIN_BATCH, D)) < 0.5,
          f"RN50 first loss {first} vs chance {_chance(RN_TRAIN_BATCH, D)}")
    equal = graph_equals_eager(mcfg, params, _device_batches(ds, RN_TRAIN_BATCH, GRAPH_CHECK_K),
                               dispatches=1)
    batch = _device_batch(ds, RN_TRAIN_BATCH)
    sync_bn = {}
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True)
    for mode in ("frozen", "batch", "batch", "frozen"):
        st = create_train_state(params, opt)
        with resnet.bn_mode(mode):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            _, m = step(st, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        check(read_launches() == train_launches(mcfg, 1), f"RN50 {mode} step launches {read_launches()}")
        row = sync_bn.setdefault(mode, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                        "step_ms": []})
        row["step_ms"].append(ms)
        check(math.isfinite(row["loss"]) and row["loss"] == float(m["loss"]), f"RN50 {mode} step: loss {m['loss']}")
        del st
    check(resnet.get_bn_mode() == "frozen", "the BatchNorm mode put back")
    check(sync_bn["batch"]["loss"] != sync_bn["frozen"]["loss"], "sync_bn takes the batch's statistics")
    del step
    _train_report("train_rn50", "RN50", run, RN_TRAIN_BATCH, D, init_s, graph_equals_eager=equal,
                  sync_bn_vs_frozen=sync_bn,
                  per_step_launches={name: v // run["n_steps"] for name, v in run["launches"].items()})
    del params, ds, batch
    torch.cuda.empty_cache()
    return run["launches"]


BUNDLES = (  # (tag, model, compute dtype, quantize, the device the export traces on)
    ("b32_fp32", "ViT-B/32", torch.float32, None, "cpu"),
    ("b32_bf16", "ViT-B/32", torch.bfloat16, None, "cuda"),
    ("b32_int8", "ViT-B/32", torch.float32, "int8", "cpu"),
    ("l14_int8", "ViT-L/14", torch.float32, "int8", "cuda"),
)
BUNDLE_MODELS = {"ViT-B/32": VIT_B32, "ViT-L/14": VIT_L14}
BUNDLE_BATCHES = (1, 7, 64)
# the served batch whose first rows are served again on the CPU's plain
# versions (a row's features depend on that row alone; the CPU's plain
# encode, the phase's largest host cost after the export, grows with the rows)
BUNDLE_PLAIN_BATCH, BUNDLE_PLAIN_ROWS = 7, 2
# the bundle against the live model on the card (max abs error, or min
# cosine for bf16), and the bundle on the card against the same bundle on
# the CPU (the plain versions; min cosine, but fp32 max abs error)
BUNDLE_LIVE_TOL = {"float32": 1e-5, "int8": 1e-4}
BUNDLE_COS = 0.999
BUNDLE_PLAIN_TOL = 1e-4
# each bundle is exported by a process of its own, all of them started
# together beside the kernels' build (`start_bundle_exports`): the
# torch.export trace is host work, the largest of the phase
BUNDLE_EXPORT = r"""
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_num_threads(2)
from clip_event_tpu_torch.engine.export import save_serving_bundle
from clip_event_tpu_torch.models.clip import VIT_B32, VIT_L14, init_params, tree_to
model, dtype, quantize, device, out_dir = sys.argv[1:6]
mcfg = {"ViT-B/32": VIT_B32, "ViT-L/14": VIT_L14}[model]
params = tree_to(init_params(torch.Generator().manual_seed(0), mcfg, "cuda"), device)
t0 = time.perf_counter()
save_serving_bundle(out_dir, params, mcfg, compute_dtype=getattr(torch, dtype), quantize=quantize or None)
print(json.dumps({"export_s": time.perf_counter() - t0}))
"""
# a fresh process loads a bundle on the card and serves one batch: the
# load's seconds, and whether the model code stayed out of sys.modules
BUNDLE_LOAD_CHECK = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
from clip_event_tpu_torch.engine.export import load_serving_bundle
torch.cuda.init()
torch.zeros(1, device="cuda")
t1 = time.perf_counter()
model = load_serving_bundle(sys.argv[1], device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
res, ctx = model.meta["image_resolution"], model.meta["context_length"]
f = model.encode_image(torch.zeros((1, res, res, 3), device="cuda"))
t = model.encode_text(torch.ones((1, ctx), dtype=torch.int32, device="cuda"))
torch.cuda.synchronize()
t3 = time.perf_counter()
code = ("clip_event_tpu_torch.models.clip", "clip_event_tpu_torch.models.layers",
        "clip_event_tpu_torch.models.vit", "clip_event_tpu_torch.models.resnet")
print(json.dumps({"import_and_cuda_init_s": t1 - t0, "load_s": t2 - t1, "first_batch_s": t3 - t2,
                  "process_s": t3 - t0, "finite": bool(torch.isfinite(f).all() and torch.isfinite(t).all()),
                  "model_code_in_sys_modules": [m for m in code if m in sys.modules]}))
"""


def spawn(code, args, log_base):
    """A child `python -c code args...` in the repo's root, its stdout and
    stderr into log_base.out / log_base.err (files: a full pipe would stall
    a child while another is read)."""
    with open(log_base + ".out", "w") as out, open(log_base + ".err", "w") as err:
        return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO, stdout=out, stderr=err), log_base


def collect(child, what, timeout=600) -> dict:
    """The JSON object a `spawn`ed child printed last; fails on its exit code."""
    proc, log_base = child
    rc = proc.wait(timeout=timeout)
    with open(log_base + ".err") as fh:
        check(rc == 0, f"{what} failed (exit code {rc}):\n{fh.read()[-3000:]}")
    with open(log_base + ".out") as fh:
        return json.loads(fh.read().strip().splitlines()[-1])


def stop(children) -> None:
    """Kill every `spawn`ed child still running."""
    for proc, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def bundle_dir(out_root, tag):
    return os.path.join(out_root, "serving_bundle", tag)


def start_bundle_exports(out_root) -> dict:
    """Start the export of every bundle of BUNDLES, one process each
    (BUNDLE_EXPORT), into `bundle_dir(out_root, tag)`: {tag: child}."""
    os.makedirs(os.path.join(out_root, "serving_bundle"), exist_ok=True)
    return {tag: spawn(BUNDLE_EXPORT, [model, str(dtype).replace("torch.", ""), quantize or "", device,
                                       bundle_dir(out_root, tag)],
                       os.path.join(out_root, "serving_bundle", f"export_{tag}"))
            for tag, model, dtype, quantize, device in BUNDLES}


def bundle_inputs(mcfg, n):
    """fp32 images (serving_inputs' uint8 images, CLIP-normalised on the
    host) and token rows, on the card."""
    images, tokens = serving_inputs(mcfg, n)
    x = (images.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    return torch.from_numpy(x).cuda(), torch.from_numpy(tokens).cuda()


def _compare(got, ref, gate, what):
    """max abs error, min cosine and bit equality of two feature batches;
    `gate` is ("abs", tol) or ("cos", min)."""
    got, ref = got.float().cpu(), ref.float().cpu()
    err = (got - ref).abs().max().item()
    cos = F.cosine_similarity(got, ref, dim=-1).min().item()
    kind, bar = gate
    check(err <= bar if kind == "abs" else cos >= bar, f"{what}: max abs err {err}, min cosine {cos} ({gate})")
    return {"max_abs_err": err, "min_cos": cos, "bit_equal": bool(torch.equal(got, ref))}


def phase_serving_bundle(out_root, exports):
    """The serving bundle (`engine/export.py`) at full width from seed 0:
    ViT-B/32 in fp32, bf16 and int8 and ViT-L/14 in int8, the fp32 and int8
    B/32 bundles exported on the CPU, the others on the card, each by a
    process of its own beside the kernels' build (`exports`: their export
    seconds, read there). Each bundle is loaded in a fresh process (load
    seconds; the model code must stay out of its sys.modules; the four run
    together, beside this process's own load and checks of the first
    bundle, and are read before the first timed rates) and here, then
    serves batches of 1, 7 and 64 on the card, counted: K1 12 a tower batch
    (K2 24 an L/14 image batch), K5 once a dense layer of an int8 tower, the
    live model's counts. The features are held against the live model (fp32
    1e-5, bf16 cosine 0.999, int8 1e-4), and the first BUNDLE_PLAIN_ROWS
    rows of the batch of 7 against the same bundle serving those rows on the
    CPU through the ops' plain versions (fp32 1e-4, else cosine 0.999);
    export and load seconds, bundle bytes, and images/s and texts/s at
    batch 64, bundle and live in turns."""
    from clip_event_tpu_torch.engine.export import load_serving_bundle
    from clip_event_tpu_torch.ops.quant import quantize_params

    all_launches = dict.fromkeys(COUNTERS, 0)
    fresh_children = {tag: spawn(BUNDLE_LOAD_CHECK, [bundle_dir(out_root, tag)],
                                 os.path.join(out_root, "serving_bundle", f"fresh_{tag}"))
                      for tag, *_ in BUNDLES}
    fresh_all = None
    try:
        for tag, model, dtype, quantize, export_device in BUNDLES:
            t_bundle = time.perf_counter()
            mcfg = BUNDLE_MODELS[model]
            dtype_name = str(dtype).replace("torch.", "")
            live_params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
            if quantize:
                live_params = quantize_params(live_params)
            out_dir = bundle_dir(out_root, tag)
            files = {f: os.path.getsize(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))}

            t0 = time.perf_counter()
            bundle = load_serving_bundle(out_dir, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            x_img, x_tok = bundle_inputs(mcfg, max(BUNDLE_BATCHES))

            # ---- the main path, counted: batches of 1, 7 and 64 through both programs
            reset_launches()
            served = {}
            for b in BUNDLE_BATCHES:
                served[b] = (bundle.encode_image(x_img[:b]), bundle.encode_text(x_tok[:b]))
            torch.cuda.synchronize()
            launches = read_launches()
            per_batch = int8_launches(mcfg, 1, 1) if quantize else serving_launches(mcfg, 1, 1)
            n = len(BUNDLE_BATCHES)
            expected = {k: v * n for k, v in per_batch.items()}
            check(launches == expected, f"{tag} launches {launches} != {expected}")
            all_launches = {k: all_launches[k] + launches[k] for k in COUNTERS}

            # ---- the live model: its launches a batch, its features
            def live_image(x):
                return l2_normalize(encode_image(live_params, mcfg, x, compute_dtype=dtype, impl="kernel")).float()

            def live_text(t):
                return l2_normalize(encode_text(live_params, mcfg, t, compute_dtype=dtype, impl="kernel")).float()

            with torch.inference_mode():
                reset_launches()
                live64 = (live_image(x_img), live_text(x_tok))
                torch.cuda.synchronize()
                live_launches = read_launches()
                check(live_launches == per_batch, f"{tag}: the live model's launches a batch {live_launches} "
                                                  f"!= the bundle's {per_batch}")
                gate = ("cos", BUNDLE_COS) if dtype == torch.bfloat16 else (
                    "abs", BUNDLE_LIVE_TOL["int8" if quantize else "float32"])
                vs_live = {}
                for b in BUNDLE_BATCHES:
                    live = live64 if b == max(BUNDLE_BATCHES) else (live_image(x_img[:b]), live_text(x_tok[:b]))
                    for kind, got, ref in zip(("images", "texts"), served[b], live):
                        check(got.shape == (b, mcfg.embed_dim) and got.dtype == torch.float32
                              and bool(torch.isfinite(got).all()), f"{tag} {kind} batch {b}: shape / finite")
                        vs_live[f"{kind}_b{b}"] = _compare(got, ref, gate, f"{tag} {kind} batch {b} vs live")

            # ---- the same bundle on the CPU: the ops' plain versions
            t0 = time.perf_counter()
            on_cpu = load_serving_bundle(out_dir, device="cpu")
            cpu_load_s = time.perf_counter() - t0
            r = BUNDLE_PLAIN_ROWS
            plain = (on_cpu.encode_image(x_img[:r].cpu()), on_cpu.encode_text(x_tok[:r].cpu()))
            gate = ("abs", BUNDLE_PLAIN_TOL) if dtype == torch.float32 and not quantize else ("cos", BUNDLE_COS)
            vs_plain = {kind: _compare(got, ref, gate, f"{tag} {kind} card vs CPU plain")
                        for kind, got, ref in zip(("images", "texts"),
                                                  (f[:r] for f in served[BUNDLE_PLAIN_BATCH]), plain)}
            cpu_plain_s = time.perf_counter() - t0
            del on_cpu, plain

            if fresh_all is None:
                fresh_all = {t: collect(c, f"{t}: loading in a fresh process") for t, c in fresh_children.items()}
            fresh = fresh_all[tag]
            check(fresh["finite"], f"{tag}: fresh process features finite")
            check(not fresh["model_code_in_sys_modules"],
                  f"{tag}: loading imported the model code {fresh['model_code_in_sys_modules']}")

            # ---- throughput at batch 64, bundle and live in turns (the
            # script's time limit sets the iterations)
            iters = 10 if mcfg.vision_layers <= 12 else 4
            readings = {}
            with torch.inference_mode():
                ms = in_turns_many({
                    "bundle_image": lambda: bundle.encode_image(x_img), "live_image": lambda: live_image(x_img),
                    "bundle_text": lambda: bundle.encode_text(x_tok), "live_text": lambda: live_text(x_tok),
                }, iters, warmup=3, readings=readings)
            B = max(BUNDLE_BATCHES)
            rates = {who: {"images_per_s": B / ms[f"{who}_image"] * 1e3, "texts_per_s": B / ms[f"{who}_text"] * 1e3,
                           "image_batch_ms": ms[f"{who}_image"], "text_batch_ms": ms[f"{who}_text"]}
                     for who in ("bundle", "live")}
            emit({"phase": "serving_bundle", "bundle": tag, "model": model, "compute_dtype": dtype_name,
                  "quantize": quantize, "seed": 0, "exported_on": export_device, "served_on": "cuda",
                  "export": exports[tag], "load_s": load_s, "cpu_load_s": cpu_load_s, "fresh_process": fresh,
                  "cpu_plain_s": cpu_plain_s, "cpu_plain_rows": r, "phase_s": time.perf_counter() - t_bundle,
                  "bundle_bytes": sum(files.values()), "files": files, "batches": list(BUNDLE_BATCHES),
                  "launches": launches, "per_batch": per_batch, "live_per_batch": live_launches,
                  "vs_live": vs_live, "vs_cpu_plain": vs_plain, "throughput_b64": rates,
                  "batch_ms_readings_in_turns": readings})
            del bundle, live_params, served, live64
            torch.cuda.empty_cache()
    finally:
        stop(fresh_children.values())
    return all_launches


# ------------------------------------------------------------- tp heads

# Megatron tensor parallelism's head groups at tp = 2: (tag, B, S, W, H,
# causal) of the full tower at its train batch (L/14 64 x 3, B/16 96, B/32
# 384 x 3); a rank's attention core runs on W/2 lanes and H/2 heads
TP_HEADS = 2
TP_HEAD_SHAPES = [
    ("l14_train_text", 192, 77, 768, 12, True),
    ("l14_vision", 64, 257, 1024, 16, False),
    ("b16_train_vision", 96, 197, 768, 12, False),
    ("b32_train_text", 1152, 77, 512, 8, True),
    ("b32_train_vision", 384, 50, 768, 12, False),
]
# K4a (ln_1) and K4b (the mid-block add + ln_2) under sequence parallelism
# at tp = 2: a rank's local rows of the L/14 towers, B·⌈S/2⌉
TP_LN_SHAPES = [("l14_sp_text", 192 * 39, 768), ("l14_sp_vision", 64 * 129, 1024)]
# the attention sublayer's leaves that split, by the port's rule (`TPSpec`)
TP_ATTN_SPECS = {"qkv_w": TPSpec("qkv"), "qkv_b": TPSpec("qkv"), "out_w": TPSpec("row")}
# the ranks' sum against the full width, relative to the largest full-width
# value: a rank rounds its partial product and the sum rounds again where
# the full width rounds once, so bf16 may differ by two roundings of 2^-7
# at most; fp32 at the backward's gate
TP_SUM_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}


def _rel(got, want) -> float:
    return (got.float() - want.float()).abs().max().item() / max(want.float().abs().max().item(), 1e-30)


def tp_attention_check(k, gen, tag, B, S, W, H, causal, dtype) -> dict:
    """One attention sublayer of a full tower at tp = TP_HEADS through the
    port: whole weights split by `TPSpec` (the "qkv" head-group reorder,
    the row-parallel `out_w`), each rank's `layers.head_group_attention`
    (its QKV slice, K1 or K2 on its H/tp heads at the full head_dim's
    scale, its rows of `out_w`), the ranks' partial products summed by hand
    (the all-reduce of one GPU's two ranks) plus `out_b`, forward and
    backward through autograd, counted; against the full-width
    `layers.multi_head_attention` on the kernel (not counted): the output,
    dx and the weights' gradients laid back whole by `TPSpec.from_shards`."""
    name = str(dtype).split(".")[-1]
    wl, hl = W // TP_HEADS, H // TP_HEADS
    bias = causal_mask(S, device="cuda") if causal else None
    params = {"qkv_w": torch.randn((W, 3 * W), device="cuda", generator=gen) * W ** -0.5,
              "qkv_b": 0.1 * torch.randn((3 * W,), device="cuda", generator=gen),
              "out_w": torch.randn((W, W), device="cuda", generator=gen) * W ** -0.5,
              "out_b": 0.1 * torch.randn((W,), device="cuda", generator=gen)}
    params = {n: v.to(dtype) for n, v in params.items()}
    x = torch.randn((B, S, W), device="cuda", generator=gen).to(dtype)
    do = torch.randn((B, S, W), device="cuda", generator=gen).to(dtype)
    wanted = ("qkv_w", "qkv_b", "out_w")
    # the full width, the comparison (not counted)
    whole = {n: v.detach().requires_grad_(n in wanted) for n, v in params.items()}
    leaf = x.detach().requires_grad_(True)
    full_out = layers.multi_head_attention(leaf, whole, H, bias, "kernel")
    full_grads = torch.autograd.grad(full_out, [leaf] + [whole[n] for n in wanted], do)
    torch.cuda.synchronize()
    # the ranks' slices and their sublayers, as the tp step runs them
    shards = [{n: spec.shard_of(params[n], TP_HEADS, g).requires_grad_(True)
               for n, spec in TP_ATTN_SPECS.items()} for g in range(TP_HEADS)]
    leaf = x.detach().requires_grad_(True)
    reset_launches()
    parts = [layers.head_group_attention(leaf, s, H, bias, "kernel", TP_HEADS) for s in shards]
    out = sum(parts[1:], parts[0]) + params["out_b"]
    grads = torch.autograd.grad(out, [leaf] + [s[n] for s in shards for n in wanted], do)
    torch.cuda.synchronize()
    launched = read_launches()
    variant = k.variant(dtype, wl // hl)
    want = dict.fromkeys(COUNTERS, 0)
    want[k.names[0]] = TP_HEADS
    want[k.names[1]] = TP_HEADS * k.bwd_launches(variant, wl // hl)
    check(launched == want, f"tp_heads {tag} {name}: launched {launched}, not {want}")
    check(out.shape == full_out.shape and bool(torch.isfinite(out).all()), f"tp_heads {tag} {name}: output")
    rank_grads = iter(grads[1:])
    by_rank = [{n: next(rank_grads) for n in wanted} for _ in range(TP_HEADS)]
    laid = [TP_ATTN_SPECS[n].from_shards(torch.stack([r[n] for r in by_rank])) for n in wanted]
    gaps = {n: _rel(g, f) for n, g, f in zip(("out", "dx") + tuple(f"d{n}" for n in wanted),
                                             [out, grads[0]] + laid, (full_out,) + full_grads)}
    for n, gap in gaps.items():
        check(gap <= TP_SUM_TOL[name], f"tp_heads {tag} {name}: ranks vs full width {n} {gap} > {TP_SUM_TOL[name]}")
    return {"variant": variant, "launched": {n: v for n, v in launched.items() if v},
            "vs_full_width": {"max_rel_gap": gaps,
                              "fwd_max_abs_gap": (out.float() - full_out.float()).abs().max().item(),
                              "full_max_abs": full_out.float().abs().max().item(),
                              "fwd_bit_equal": bool(torch.equal(out, full_out)),
                              "dx_bit_equal": bool(torch.equal(grads[0], full_grads[0]))}}


def phase_tp_heads(out_root=None, rows=None, errs=None):
    """Phase 5t (module docstring). Returns the launch counts of the
    counted sublayers; `rows` / `errs` (the kernel phase's) take the
    head-group shapes' check rows."""
    t_phase = time.perf_counter()
    if rows is None:
        rows = {name: [] for name in COUNTERS}
        errs = {name: {} for name in COUNTERS}
    gen = torch.Generator(device="cuda").manual_seed(18)
    total = dict.fromkeys(COUNTERS, 0)
    blocks = []
    for tag, B, S, W, H, causal in TP_HEAD_SHAPES:
        wl, hl = W // TP_HEADS, H // TP_HEADS
        pair = attention_ops.core_kernel(S, wl, hl)
        check(pair == attention_ops.core_kernel(S, W, H), f"tp_heads {tag}: the head group takes {pair}")
        k = K1 if pair == "k1" else K2
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            # the head group's shape against its plain version, the gates of
            # the kernel phase (timed in bf16, the training dtype)
            check_attention(rows, errs, k, gen, f"tp{TP_HEADS}_{tag}", B, S, wl, hl, causal, dtype,
                            dtype == torch.bfloat16)
            row = {"shape": tag, "B": B, "S": S, "W": W, "H": H, "tp": TP_HEADS, "dtype": name,
                   "kernel": pair, "head_group": [B, S, wl, hl],
                   **tp_attention_check(k, gen, tag, B, S, W, H, causal, dtype)}
            total = {n: total[n] + row["launched"].get(n, 0) for n in COUNTERS}
            blocks.append(row)
            emit({"phase": "tp_heads", **row})
    # K4a (ln_1) and K4b (+ K4c) on a rank's sequence-parallel local rows
    for tag, N, W in TP_LN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            check_ln(rows, errs, gen, tag, N, W, dtype, dtype == torch.bfloat16, False)
            res, delta, dh, dy, dx = (torch.randn((N, W), device="cuda", generator=gen).to(dtype)
                                      .requires_grad_(i < 2) for i in range(5))
            ln_params = [((1.0 + 0.1 * torch.randn((W,), device="cuda", generator=gen)).requires_grad_(True),
                          (0.1 * torch.randn((W,), device="cuda", generator=gen)).requires_grad_(True))
                         for _ in range(2)]
            reset_launches()
            h = ln.fused_layer_norm(res, *ln_params[0])
            x, y = ln.fused_add_layer_norm(res, delta, *ln_params[1])
            grads = torch.autograd.grad((h, x, y), (res, delta) + ln_params[0] + ln_params[1], (dh, dx, dy))
            torch.cuda.synchronize()
            launched = read_launches()
            want = dict.fromkeys(COUNTERS, 0)
            want[ln.KERNEL], want[ADD_LN_KERNEL], want[ln.BWD_KERNEL] = 1, 1, 2 * ln.BWD_LAUNCHES_PER_CALL
            check(launched == want, f"tp_heads {tag} {str(dtype)}: launched {launched}, not {want}")
            check(all(bool(torch.isfinite(g).all()) for g in grads), f"tp_heads {tag}: K4 grads finite")
            total = {n: total[n] + launched[n] for n in COUNTERS}
            del res, delta, dh, dy, dx, h, x, y, grads
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "tp_heads_summary", "tp": TP_HEADS, "launches": total, "seconds": seconds,
          "reckoned_tp_rank_state_gib": {f"{name} tp={tp}": reckoned_tp_rank_state_gib(m, tp)
                                         for name, m in (("ViT-B/32", VIT_B32), ("ViT-L/14", VIT_L14))
                                         for tp in (2, 4)},
          "bit_equal_to_full_width": {f"{r['shape']}_{r['dtype']}": [r["vs_full_width"]["fwd_bit_equal"],
                                                                     r["vs_full_width"]["dx_bit_equal"]]
                                      for r in blocks}})
    return total


# ------------------------------------------------------------- pp stages

# GPipe at pp = 2 with the in-process driver (`parallel.pipeline.
# run_in_process`: both stages on the one card, in tick order): the B/32
# train step at its bench batch with pp_microbatches 4 (vision microbatches
# 96 x 50 x 768, text 288 x 77 x 512), bf16, full remat, and in fp32 at 64
# x 3; one ViT-L/14 vision stack call (64 x 257 x 1024, K2, microbatches
# of 16) under "attn", bf16 and fp32
PP_STAGES, PP_MICRO = 2, 4
PP_MB_SHAPES = [  # (tag, B, S, W, H, causal) of one microbatch
    ("pp_b32_vision_mb", TRAIN_BATCH // PP_MICRO, 50, 768, 12, False),
    ("pp_b32_text_mb", TRAIN_BATCH * 3 // PP_MICRO, 77, 512, 8, True),
    ("pp_l14_vision_mb", L14_BATCH // PP_MICRO, 257, 1024, 16, False),
]
# the pipelined run against the plain one, relative to the largest plain
# value: the microbatches' GEMMs round apart from the whole batch's, and
# the weights' gradients are summed over 4 microbatches (TP_SUM_TOL's
# reasoning: bf16 2^-6, fp32 1e-5)
PP_TOL = TP_SUM_TOL


def pp_stage_tree(params, pp):
    """A copy of `params` whose leaves require grad, each stack whose depth
    divides pp replaced by the list of its stages' slices, cut by
    `PPLayout` (stage s's on a hand-made mesh of pp stages): the tree the
    in-process driver runs (`layers.transformer` takes a list of stages).
    Returns (tree, own): `own` a tensor a whole leaf, a list of pp tensors
    a stage leaf, in `tree_leaves` order of `params`."""
    from clip_event_tpu_torch.parallel.mesh import Mesh
    from clip_event_tpu_torch.parallel.pipeline import PPLayout

    leaves = [t.detach() for t in tree_leaves(params)]
    device = leaves[0].device
    layouts = [PPLayout(params, Mesh(s, pp, device, pp=pp)) for s in range(pp)]
    cuts = [lay.shard_leaves(leaves) for lay in layouts]
    own = [[c[i].clone().requires_grad_(True) for c in cuts] if spec.kind else t.clone().requires_grad_(True)
           for i, (spec, t) in enumerate(zip(layouts[0].specs, leaves))]
    stages = [tree_unflatten(params, [o[s] if isinstance(o, list) else o for o in own]) for s in range(pp)]
    tree = stages[0]
    for path in (("visual", "transformer"), ("text_transformer",)):
        try:
            node = _subtree(tree, path)
        except (KeyError, TypeError):
            continue
        if node["attn"]["qkv_w"].shape[0] != _subtree(params, path)["attn"]["qkv_w"].shape[0]:
            _subtree(tree, path[:-1])[path[-1]] = [_subtree(st, path) for st in stages]
    return tree, own


def _subtree(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def pp_grads_laid_back(outputs, own, pp, inputs=(), grad_outputs=None):
    """The gradients of `inputs`, then of `own` (`pp_stage_tree`), in one
    `autograd.grad`, each stage leaf's stages laid back in layer order by
    `PPSpec.from_shards`."""
    from clip_event_tpu_torch.parallel.pipeline import PPSpec

    flat = list(inputs) + [t for o in own for t in (o if isinstance(o, list) else [o])]
    grads = iter(torch.autograd.grad(outputs, flat, grad_outputs, allow_unused=True))
    out = [next(grads) for _ in inputs]
    for o in own:
        if isinstance(o, list):
            out.append(PPSpec("stage").from_shards(torch.stack([next(grads) for _ in range(pp)])))
        else:
            g = next(grads)
            out.append(torch.zeros_like(o) if g is None else g)
    return out


def pp_step_launches(mcfg, dtype, M):
    """K1 / K2 launches of one pipelined train step under full remat (the
    in-process driver's, any pp): each block of a stage slice runs its
    attention forward 3 times a microbatch (the driver's forward, without
    autograd; the backward's recompute of the stage with autograd on,
    under the block's checkpoint; that checkpoint's own recompute) and its
    backward once a microbatch; M microbatches a tower."""
    out = dict.fromkeys(COUNTERS, 0)
    for L, W, H in ((mcfg.vision_layers, mcfg.vision_width, mcfg.vision_heads),
                    (mcfg.transformer_layers, mcfg.transformer_width, mcfg.transformer_heads)):
        out[KERNEL] += 3 * M * L
        out[BWD_KERNEL] += M * L * k1_bwd_launches(W, H, dtype)
    return out


def pp_stack_launches(L, M):
    """K2 launches of one pipelined stack call, forward and backward, under
    "attn": per block and microbatch the driver's forward and the
    backward's recompute (whose saved region keeps the core's output, so
    no third), and one backward (HG_BWD_LAUNCHES_PER_CALL launches)."""
    out = dict.fromkeys(COUNTERS, 0)
    out[HG_KERNEL] = 2 * M * L
    out[HG_BWD_KERNEL] = M * L * HG_BWD_LAUNCHES_PER_CALL
    return out


def _pp_gaps(got, want) -> dict:
    return {"max_rel_gap": max(_rel(g, w) for g, w in zip(got, want)),
            "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want))}


def pp_train_step_check(mcfg, params, batch, dtype, timed=False) -> dict:
    """The train step's loss and every gradient at pp = PP_STAGES through
    the in-process driver, counted, against the plain step (the kernels,
    no pipeline; not counted) from the same params and batch; `timed`:
    the two forward-and-backward passes in turns."""
    name = str(dtype).split(".")[-1]
    kw = dict(compute_dtype=dtype, remat=True, impl="kernel")
    ref_params = tree_unflatten(params, [t.detach().clone().requires_grad_(True) for t in tree_leaves(params)])
    # the plain forward's features, and the step's loss and gradients
    with torch.no_grad():
        feats = (encode_image(ref_params, mcfg, batch["image"], compute_dtype=dtype),
                 encode_text(ref_params, mcfg, batch["text"], compute_dtype=dtype))
    total, _ = loss_fn(ref_params, batch, mcfg, **kw)
    want = torch.autograd.grad(total, tree_leaves(ref_params))
    want_loss = total.detach()
    del total
    tree, own = pp_stage_tree(params, PP_STAGES)
    M = PP_MICRO
    with layers.pipeline(_pp_mesh(), M):
        with torch.no_grad():
            got_feats = (encode_image(tree, mcfg, batch["image"], compute_dtype=dtype),
                         encode_text(tree, mcfg, batch["text"], compute_dtype=dtype))
        torch.cuda.synchronize()
        reset_launches()
        total, _ = loss_fn(tree, batch, mcfg, **kw)
        got = pp_grads_laid_back(total, own, PP_STAGES)
        torch.cuda.synchronize()
        launched = read_launches()
    want_launches = pp_step_launches(mcfg, dtype, M)
    check(launched == want_launches, f"pp_stages B/32 step {name}: launched {launched}, not {want_launches}")
    turns = {}
    if timed:
        # the forward and backward alone (no optimizer), plain and
        # pipelined in turns: what the driver's third forward a block, the
        # microbatches' smaller GEMMs and their launches cost on one card
        flat = [t for o in own for t in (o if isinstance(o, list) else [o])]

        def plain_step():
            torch.autograd.grad(loss_fn(ref_params, batch, mcfg, **kw)[0], tree_leaves(ref_params))

        def pp_step():
            with layers.pipeline(_pp_mesh(), M):
                torch.autograd.grad(loss_fn(tree, batch, mcfg, **kw)[0], flat)

        turns["plain_ms"], turns["pp_ms"] = in_turns(plain_step, pp_step, iters=2, warmup=1)
        # where the difference goes: each one's device busy time, idle
        # share and launches (torch.profiler, one warm run)
        turns["plain_profile"] = profile_one(plain_step, turns["plain_ms"])
        turns["pp_profile"] = profile_one(pp_step, turns["pp_ms"])
    loss_gap = abs(total.item() - want_loss.item()) / max(abs(want_loss.item()), 1e-30)
    grads = _pp_gaps(got, want)
    tol = PP_TOL[name]
    check(math.isfinite(total.item()) and loss_gap <= tol, f"pp_stages B/32 {name}: loss gap {loss_gap} > {tol}")
    check(grads["max_rel_gap"] <= tol, f"pp_stages B/32 {name}: a gradient gap {grads['max_rel_gap']} > {tol}")
    return {"dtype": name, "batch": batch["image"].shape[0], "microbatches": M, "loss": total.item(),
            "plain_loss": want_loss.item(), "loss_rel_gap": loss_gap, "grads": grads,
            "forward_bit_equal": {"image_features": bool(torch.equal(got_feats[0], feats[0])),
                                  "text_features": bool(torch.equal(got_feats[1], feats[1]))},
            "forward_max_abs_gap": max((a.float() - b.float()).abs().max().item()
                                       for a, b in zip(got_feats, feats)),
            "launched": {k: v for k, v in launched.items() if v}, "tol": tol,
            "forward_backward_ms_in_turns": turns or "not measured"}


def _pp_mesh():
    from clip_event_tpu_torch.parallel.mesh import Mesh

    return Mesh(0, PP_STAGES, torch.device("cuda"), pp=PP_STAGES)


def pp_stack_check(gen, dtype, mcfg=VIT_L14, B=L14_BATCH, device="cuda"):
    """One ViT-L/14 vision stack (24 blocks, W 1024, H 16, S 257: K2) at
    L14_BATCH rows under "attn", forward and backward through the
    in-process driver at pp = PP_STAGES, counted, against the plain stack
    (`layers.run_stack` on the whole batch, not counted): the output, dx
    and every leaf's gradient, stages laid back. Returns (dtype name, the
    pipelined output, the plain one, their gradients, the launches)."""
    from clip_event_tpu_torch.parallel.pipeline import run_in_process

    name = str(dtype).split(".")[-1]
    L, W, H, S = mcfg.vision_layers, mcfg.vision_width, mcfg.vision_heads, mcfg.grid_size ** 2 + 1
    stack = layers.init_transformer(torch.Generator().manual_seed(14), L, W)
    stack = {k: {n: v.to(device) for n, v in sub.items()} for k, sub in stack.items()}
    x = torch.randn((B, S, W), device=device, generator=gen).to(dtype)
    dy = torch.randn((B, S, W), device=device, generator=gen).to(dtype)
    whole = tree_unflatten(stack, [t.clone().requires_grad_(True) for t in tree_leaves(stack)])
    leaf = x.clone().requires_grad_(True)
    want_y = layers.run_stack(leaf, whole, H, None, "kernel", "attn", "xla")
    want = torch.autograd.grad(want_y, [leaf] + tree_leaves(whole), dy)
    tree, own = pp_stage_tree({"visual": {"transformer": stack}}, PP_STAGES)
    stages = tree["visual"]["transformer"]
    check(isinstance(stages, list) and len(stages) == PP_STAGES, "pp_stages: the L/14 stack splits")
    torch.cuda.synchronize()
    reset_launches()
    leaf = x.clone().requires_grad_(True)
    y = run_in_process(leaf, stages, H, None, PP_MICRO, "attn", "kernel", "xla")
    got = pp_grads_laid_back(y, own, PP_STAGES, inputs=[leaf], grad_outputs=dy)
    torch.cuda.synchronize()
    launched = read_launches()
    return name, y, want_y, got, want, launched


def phase_pp_stages(out_root=None, rows=None, errs=None):
    """Phase 5p (module docstring). Returns the launch counts of the
    pipelined runs; `rows` / `errs` (the kernel phase's) take the
    microbatch shapes' check rows."""
    t_phase = time.perf_counter()
    if rows is None:
        rows = {name: [] for name in COUNTERS}
        errs = {name: {} for name in COUNTERS}
    gen = torch.Generator(device="cuda").manual_seed(19)
    total = dict.fromkeys(COUNTERS, 0)
    # the microbatch shapes against the plain versions (the kernel phase's
    # gates; timed in bf16)
    for tag, B, S, W, H, causal in PP_MB_SHAPES:
        k = K1 if attention_ops.core_kernel(S, W, H) == "k1" else K2
        for dtype in (torch.bfloat16, torch.float32):
            check_attention(rows, errs, k, gen, tag, B, S, W, H, causal, dtype, dtype == torch.bfloat16)
    mcfg = VIT_B32
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    ds = _BenchPairs(TRAIN_BATCH, mcfg.image_resolution, mcfg.context_length, mcfg.vocab_size)
    steps = []
    for dtype, b in ((torch.bfloat16, TRAIN_BATCH), (torch.float32, FP32_CHECK_BATCH)):
        row = pp_train_step_check(mcfg, params, _device_batch(ds, b), dtype, timed=dtype == torch.bfloat16)
        total = {n: total[n] + row["launched"].get(n, 0) for n in COUNTERS}
        steps.append(row)
        emit({"phase": "pp_stages", "what": "b32_train_step", **row})
    del params
    stacks = []
    for dtype in (torch.bfloat16, torch.float32):
        name, y, want_y, got, want, launched = pp_stack_check(gen, dtype)
        want_launches = pp_stack_launches(VIT_L14.vision_layers, PP_MICRO)
        check(launched == want_launches, f"pp_stages L/14 stack {name}: launched {launched}, not {want_launches}")
        out_gap = _rel(y, want_y)
        grads = _pp_gaps(got, want)
        tol = PP_TOL[name]
        check(bool(torch.isfinite(y).all()) and out_gap <= tol, f"pp_stages L/14 {name}: output gap {out_gap}")
        check(grads["max_rel_gap"] <= tol, f"pp_stages L/14 {name}: a gradient gap {grads['max_rel_gap']} > {tol}")
        row = {"dtype": name, "B": L14_BATCH, "S": 257, "microbatches": PP_MICRO, "remat": "attn",
               "output_rel_gap": out_gap, "output_bit_equal": bool(torch.equal(y, want_y)),
               "dx_bit_equal": bool(torch.equal(got[0], want[0])), "grads": grads,
               "launched": {k: v for k, v in launched.items() if v}, "tol": tol}
        total = {n: total[n] + launched[n] for n in COUNTERS}
        stacks.append(row)
        emit({"phase": "pp_stages", "what": "l14_vision_stack", **row})
        del y, want_y, got, want
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "pp_stages_summary", "pp": PP_STAGES, "pp_microbatches": PP_MICRO, "launches": total,
          "launch_rules": {"b32_step_full_remat": "K1-fwd 3·M·L, K1-bwd M·L·k1_bwd_launches a tower",
                           "l14_stack_attn": "K2-fwd 2·M·L, K2-bwd M·L·HG_BWD_LAUNCHES_PER_CALL"},
          "seconds": seconds,
          "reckoned_pp_rank_state_gib": {f"{name} pp={pp}": reckoned_pp_rank_state_gib(m, pp, 8)
                                         for name, m in (("ViT-B/32", VIT_B32), ("ViT-L/14", VIT_L14))
                                         for pp in (2, 4)}})
    check(seconds <= 60.0, f"pp_stages took {seconds} s of its 60")
    return total


def reckoned_pp_rank_state_gib(mcfg, pp, world) -> dict:
    """The GiB one rank of a (dp × pp) mesh of `world` ranks would hold of
    an fp32 Adam state of `mcfg` (params, mu, nu): its stage (stage 0: the
    stages of a stack are alike, every whole leaf on every stage), alone
    and with ZeRO-1 / FSDP over its world/pp data ranks on top, by the
    layouts' own rules (`PPLayout`, `ShardLayout`, padding included);
    counted from the shapes on the meta device."""
    from clip_event_tpu_torch.parallel.mesh import Mesh
    from clip_event_tpu_torch.parallel.pipeline import PPLayout
    from clip_event_tpu_torch.parallel.sharding import ShardLayout

    with torch.device("meta"):
        params = init_params(torch.Generator(), mcfg, "meta")
    mesh = Mesh(0, world, torch.device("meta"), pp=pp)
    leaves = tree_leaves(params)
    stage = tree_unflatten(params, PPLayout(params, mesh).shard_leaves(leaves))
    specs = ShardLayout(stage, mesh, "fsdp").specs
    full = sum(t.numel() for t in leaves) * 4 / 2**30
    rank = sum(t.numel() for t in tree_leaves(stage)) * 4 / 2**30
    shard = sum(math.prod(s.shard_shape) for s in specs) * 4 / 2**30
    return {"pp": pp, "world": world, "dp": world // pp, "unsharded": 3 * full, "pp_rank": 3 * rank,
            "pp_zero": rank + 2 * shard, "pp_fsdp": 3 * shard}


# ------------------------------------------------------------- data feed

# the data_feed phase's synthetic VOA corpus: 768 news-photo-sized JPEGs
# (two B/32 batches of 384), and the files its decoder checks read
FEED_IMAGES, FEED_HW, FEED_QUALITY, FEED_CHECK_FILES = 768, (480, 640), 90, 32
# live steps, images the loader reads live alone, images resized on the card
FEED_LIVE_STEPS, FEED_LIVE_ALONE, FEED_DEVICE_RESIZE = 2, 48, 64
# the float path's difference from the Python path: one ulp of its /255,
# through (v - mean) / std (the JAX package's native tests' atol)
FEED_FLOAT_ATOL = 1e-6
_FEED_EVENTS = ("protest", "election", "flood", "attack", "wedding", "trial", "strike", "summit",
                "rally", "funeral", "arrest", "parade")
_FEED_CITIES = ("Kabul", "Lagos", "Quito", "Hanoi", "Tunis", "Minsk", "Dhaka", "Lima", "Accra",
                "Sofia", "Oslo", "Riga", "Doha", "Baku", "Yerevan", "Harare")
# VOA description templates: most short (the 32-token bucket), some
# medium (48) and some long (77)
_FEED_TEMPLATES = (
    "A {ev} event in {city}.",
    "Reporters said a {ev} event took place in {city} on Monday, where many people gathered "
    "near the main square while officials watched the crowd from nearby streets.",
    "Witnesses described a large {ev} event in {city} that lasted through the afternoon, "
    "with crowds filling the roads around the old market, police closing several bridges, "
    "and local leaders calling for calm as the events of the day continued late into the evening.",
)


def _feed_noise(seed: int, tiles: int = 4) -> np.ndarray:
    """A few tiles of sensor-like noise (sigma 6) the corpus's images share."""
    rng = np.random.default_rng([seed, 1 << 20])
    return np.round(rng.standard_normal((tiles, *FEED_HW, 3), dtype=np.float32) * 6.0).astype(np.float32)


def _feed_image(i: int, seed: int, noise: np.ndarray) -> np.ndarray:
    """A smooth RGB field (a separable sine pattern and a ramp) plus one of
    the noise tiles, rolled: JPEG sizes like a news photo's, not pure
    noise's. From (seed, i)."""
    rng = np.random.default_rng([seed, i])
    h, w = FEED_HW
    fy, fx = rng.uniform(0.5, 4.0, (2, 3)).astype(np.float32)
    py, px = rng.uniform(0.0, 2 * np.pi, (2, 3)).astype(np.float32)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    img = 120 + 70 * np.sin(2 * np.pi * fy * y + py) * np.cos(2 * np.pi * fx * x + px) + 40 * x * y
    img += np.roll(noise[i % len(noise)], int(rng.integers(w)), axis=1)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_feed_corpus(root: str, n: int = FEED_IMAGES, seed: int = 0) -> dict:
    """The synthetic VOA corpus of the data_feed phase, from `seed`: n JPEGs
    (FEED_HW, quality FEED_QUALITY) written by threads, the caption mapping
    and the template descriptions (1 positive, 1 event and 1 argument
    negative an image; repeated templates, so dedupe and the length buckets
    act)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    image_dir = os.path.join(root, "jpg")
    os.makedirs(image_dir, exist_ok=True)
    ids = [f"VOA_EN_NW_2017_{i:05d}_0" for i in range(n)]

    noise = _feed_noise(seed)

    def write(i):
        path = os.path.join(image_dir, ids[i] + ".jpg")
        Image.fromarray(_feed_image(i, seed, noise)).save(path, quality=FEED_QUALITY)
        return os.path.getsize(path)

    with ThreadPoolExecutor(max_workers=len(os.sched_getaffinity(0))) as pool:
        sizes = list(pool.map(write, range(n)))
    rng = np.random.default_rng(seed)
    mapping, descriptions = {}, {}
    for image_id in ids:
        doc = image_id[:-2]
        ev, ev2 = rng.choice(len(_FEED_EVENTS), 2, replace=False)
        city, city2 = rng.choice(len(_FEED_CITIES), 2, replace=False)
        t = _FEED_TEMPLATES[rng.choice(3, p=(0.65, 0.2, 0.15))]
        mapping[doc] = {"0": {"url": "", "cap": f"FILE - A {_FEED_EVENTS[ev]} in {_FEED_CITIES[city]}."}}
        descriptions[image_id] = {
            "pos": [t.format(ev=_FEED_EVENTS[ev], city=_FEED_CITIES[city])],
            "neg_event": [t.format(ev=_FEED_EVENTS[ev2], city=_FEED_CITIES[city])],
            "neg_argument": [t.format(ev=_FEED_EVENTS[ev], city=_FEED_CITIES[city2])],
        }
    paths = {"image_dir": image_dir, "mapping_json": os.path.join(root, "image_caption_mapping.json"),
             "descriptions_json": os.path.join(root, "descriptions_template_template.json"),
             "images": [os.path.join(image_dir, i + ".jpg") for i in ids], "mean_kb": float(np.mean(sizes)) / 1e3}
    with open(paths["mapping_json"], "w") as fh:
        json.dump(mapping, fh)
    with open(paths["descriptions_json"], "w") as fh:
        json.dump(descriptions, fh)
    return paths


class _CheckedRows:
    """A dataset read live whose every image is held against the image
    cache's row for its file, bit for bit, as the loader's threads read it
    (the train loop's own decodes: no extra pass over the corpus)."""

    def __init__(self, ds, cache):
        import threading

        self._ds, self._cache = ds, cache
        self._lock = threading.Lock()
        self.checked, self.differ = 0, []

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        tensors, meta = self._ds[i]
        rec = self._ds.data[i]
        row = self._cache.get_u8(os.path.join(rec["image_dir"], rec["image_id"] + ".jpg"), self._ds.image_size)
        same = row is not None and np.array_equal(row, tensors["image"])
        with self._lock:
            self.checked += 1
            if not same:
                self.differ.append(rec["image_id"])
        return tensors, meta


class _Rows:
    """The first n examples of a dataset (the loader-alone readings)."""

    def __init__(self, ds, n):
        self._ds, self._n = ds, n

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._ds[i]


def _loader_images_per_s(ds, batch, workers) -> float:
    """Images/s of the loader alone (no step) over `ds` in batches of `batch`."""
    from clip_event_tpu_torch.data.common import DataLoader

    loader = DataLoader(ds, batch_size=batch, shuffle=False, num_workers=workers, prefetch=2)
    t0 = time.perf_counter()
    seen = sum(b["image"].shape[0] for b, _ in loader)
    return seen / (time.perf_counter() - t0)


def _feed_eval(root, cache_dir):
    """The retrieval eval CLI of tests/fixtures.py at ViT-B/32 through
    `evals.cli.run`, with `image_cache` and without: (metrics, launches,
    cache hits) each."""
    import contextlib
    import io

    from clip_event_tpu_torch import eval_retrieval
    from clip_event_tpu_torch.data import cache as image_cache
    from clip_event_tpu_torch.evals.cli import run

    fx = _load_fixtures()
    p = fx.make_retrieval_fixture(os.path.join(root, "retrieval"))
    stats = image_cache.build_image_cache(image_cache.scan_image_files(p["coco_dir"]), cache_dir, size=224)
    check(stats["images"] == 4 and stats["failed"] == 0, f"retrieval cache {stats}")
    hits = []
    get = image_cache.ImageCache.get

    def counted(self, path, size=224):
        out = get(self, path, size)
        hits.append(out is not None)
        return out

    results = {}
    image_cache.ImageCache.get = counted
    try:
        for name, extra in (("cached", {"image_cache": cache_dir}), ("live", {})):
            image_cache.activate(None)
            cfg = {"model": "ViT-B/32", "dataset": "coco", "caption_file": p["coco_json"],
                   "image_dir": p["coco_dir"], "seed": 0, "batch_size": 4,
                   "output_json": os.path.join(root, f"retrieval_{name}.json"), **extra}
            path = os.path.join(root, f"retrieval_{name}_cfg.json")
            with open(path, "w") as fh:
                json.dump(cfg, fh)
            argv, sys.argv = sys.argv, ["eval_retrieval", "--cfg", path]
            n_hits = len(hits)
            reset_launches()
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    run("eval_retrieval", eval_retrieval.evaluate)
            finally:
                sys.argv = argv
            torch.cuda.synchronize()
            with open(cfg["output_json"]) as fh:
                results[name] = {"metrics": json.load(fh), "launches": read_launches(),
                                 "cache_hits": sum(hits[n_hits:])}
    finally:
        image_cache.ImageCache.get = get
        image_cache.activate(None)
    return results


def phase_data_feed(out_root):
    """`configs/finetune_template_fast.json` through the port's train entry
    (`train.build_dataset`, `train.train`) at ViT-B/32 384 x 3, bf16, fed
    from JPEG files: a synthetic corpus, the native decoder's status and
    checks, the cache build, the loop from the cache (1 warm-up + 4 timed
    steps) and live (FEED_LIVE_STEPS steps, bit for bit the cached run's
    first steps, every image against its cache row), a resident step of the
    loop's first batch with its idle share, the loader alone, the on-device
    resize against the host float path, and the retrieval eval with and
    without the cache."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from clip_event_tpu_torch.data import cache as image_cache
    from clip_event_tpu_torch.data import native
    from clip_event_tpu_torch.data.common import DataLoader
    from clip_event_tpu_torch.data.device_pipeline import preprocess_on_device
    from clip_event_tpu_torch.data.transform import preprocess_image, preprocess_image_u8
    from clip_event_tpu_torch.train import build_dataset

    t_phase = time.perf_counter()
    nproc = len(os.sched_getaffinity(0))
    root = os.path.join(out_root, "data_feed")
    os.environ.pop("CLIP_EVENT_IMAGE_CACHE", None)
    image_cache.activate(None)
    t0 = time.perf_counter()
    corpus = write_feed_corpus(root, FEED_IMAGES)
    corpus_s = time.perf_counter() - t0

    # the native decoder: built or not (and why), then its checks
    t0 = time.perf_counter()
    built = native.available()
    status = {"built": built, "jpeg_decoder": native.jpeg_decoder(), "build_error": native.build_error(),
              "build_s": time.perf_counter() - t0, "nproc": nproc}
    emit({"phase": "data_feed_native", **status})
    if built:
        def both(path):
            with Image.open(path) as img:
                u8 = preprocess_image_u8(img, 224)
            return (native.preprocess_jpeg_file_u8(path, 224), u8,
                    native.preprocess_jpeg_file(path, 224), preprocess_image(u8, 224))

        with ThreadPoolExecutor(max_workers=nproc) as pool:
            pairs = list(pool.map(both, corpus["images"][:FEED_CHECK_FILES]))
        check(all(a is not None and np.array_equal(a, b) for a, b, _, _ in pairs),
              "native u8 path equals preprocess_image_u8 bit for bit")
        float_err = max(float(np.abs(c - d).max()) for _, _, c, d in pairs)
        check(float_err <= FEED_FLOAT_ATOL, f"native float path within {FEED_FLOAT_ATOL}: {float_err}")
    else:
        float_err = None

    # the cache: built once; its rows are checked against the live run's decodes
    cache_dir = os.path.join(root, "image_cache")
    t0 = time.perf_counter()
    stats = image_cache.build_image_cache(corpus["images"], cache_dir, size=224, num_workers=nproc)
    build_s = time.perf_counter() - t0
    check(stats == {"images": FEED_IMAGES, "failed": 0, "size": 224}, f"cache build {stats}")

    with open(os.path.join(REPO, "configs", "finetune_template_fast.json")) as fh:
        raw = json.load(fh)
    # only the paths change, and a step cap; begin_ckpt null: the seed-0 init
    # below is passed to `train` (with "jit" the CLI would import a .pth)
    n_steps = 1 + 4
    raw.update(posneg_descriptions_json=corpus["descriptions_json"],
               image_caption_json=[corpus["mapping_json"]], image_dir=[corpus["image_dir"]],
               image_cache=cache_dir, begin_ckpt=None, max_steps=n_steps,
               ckpt_dir=os.path.join(root, "ckpt"), tb_log_dir=os.path.join(root, "logs"))
    cfg = validate_config(raw)
    check(cfg["model"] == "ViT-B/32" and cfg["batch_size"] == TRAIN_BATCH and cfg["compute_dtype"] == "bfloat16"
          and cfg["length_buckets"] == [32, 48] and cfg["dedupe_texts"] == 768,
          "finetune_template_fast.json: ViT-B/32, 384, bf16, buckets [32, 48], dedupe 768")
    mcfg = VIT_B32
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), mcfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    remat = layers.remat_policy(cfg["remat"])

    def loop(ds, steps, tag):
        """`train` over `ds` for `steps` steps, counted: the metrics, and the
        device time between consecutive steps' ends (CUDA events recorded
        as each step's metrics arrive)."""
        metrics, events = {}, {}

        def on_step(step, m):
            metrics[step] = m
            events[step] = torch.cuda.Event(enable_timing=True)
            events[step].record()

        reset_launches()
        t0 = time.perf_counter()
        train(dict(cfg, max_steps=steps), mcfg, ds, params, "cuda", on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(sorted(metrics) == list(range(steps)), f"{tag} steps {sorted(metrics)}")
        expected = train_launches(mcfg, steps, remat=remat)
        check(launches == expected, f"{tag} launches {launches} != {expected}")
        values = {k: [float(metrics[i][k]) for i in range(steps)] for k in metrics[0]}
        check(all(np.isfinite(values["loss"])), f"{tag} losses {values['loss']}")
        return {"values": values, "wall_s": wall, "launches": launches,
                "gap_ms": [events[i - 1].elapsed_time(events[i]) for i in range(1, steps)]}

    # the loop from the cache: build_dataset activates the config's cache
    t0 = time.perf_counter()
    ds = build_dataset(cfg, mcfg)
    dataset_s = time.perf_counter() - t0
    active = image_cache.active_cache()
    check(active is not None and active.cache_dir == cache_dir, "build_dataset activated the config's cache")
    check(len(ds) == FEED_IMAGES and ds.uint8_images, f"dataset of {len(ds)} uint8 images")
    plan_loader = DataLoader(ds, cfg["batch_size"], shuffle=True, seed=cfg["seed"], drop_last=True,
                             num_workers=cfg["num_workers"], bucket_widths=cfg["length_buckets"])
    widths, crosses = [], []
    for epoch in range(n_steps):
        plan_loader.set_epoch(epoch)
        for j, (_, width) in enumerate(plan_loader._plan()):
            widths.append(width)
            crosses.append(j == 0)
    widths, crosses = widths[:n_steps], crosses[:n_steps]
    check(len(set(widths)) > 1 or widths[0] < ds.context, f"the length buckets act: widths {widths}")
    cached = loop(ds, n_steps, "data_feed_cached")
    first = cached["values"]["loss"][0]
    D = NUM_POS + NUM_NEG
    check(abs(first - _chance(TRAIN_BATCH, D)) < 0.5, f"first loss {first} vs chance {_chance(TRAIN_BATCH, D)}")
    # the steady steps: a step whose batch the loader built while the
    # previous step ran (the first step of an epoch also waits for the
    # epoch's end: its checkpoint and a new loader)
    in_epoch = [g for g, c in zip(cached["gap_ms"], crosses[1:]) if not c]
    # (the first step at a width also meets new shapes: allocations, GEMM
    # heuristics)
    steady = [{"step": i + 1, "width": w, "ms": g, "pairs_per_sec": TRAIN_BATCH * (NUM_POS + NUM_NEG) / g * 1e3}
              for i, (g, c, w) in enumerate(zip(cached["gap_ms"], crosses[1:], widths[1:])) if not c]

    # the loader alone: the cache's rows, then live decodes (raw: PIL and
    # the Python u8 path, as in the JAX package)
    cached_ips = _loader_images_per_s(_Rows(ds, cfg["batch_size"]), cfg["batch_size"], cfg["num_workers"])
    # the same rows at other thread counts: what the tokenizer's threads cost
    by_threads = {w: _loader_images_per_s(_Rows(ds, cfg["batch_size"]), cfg["batch_size"], w)
                  for w in (1, 4, 8, 16)}
    image_cache.activate(None)
    n_alone = min(FEED_LIVE_ALONE, len(ds))
    live_ips = _loader_images_per_s(_Rows(ds, n_alone), n_alone, cfg["num_workers"])

    # the same loop live (the cache cleared; the same order and seed), every
    # decoded image held against its cache row
    checked = _CheckedRows(ds, image_cache.ImageCache(cache_dir))
    live = loop(checked, FEED_LIVE_STEPS, "data_feed_live")
    check(checked.checked == FEED_LIVE_STEPS * TRAIN_BATCH and not checked.differ,
          f"{checked.checked} live decodes, rows differing from the cache: {checked.differ[:8]}")
    for k, v in live["values"].items():
        check(v == cached["values"][k][:FEED_LIVE_STEPS], f"live {k} {v} != cached {cached['values'][k]}")

    # a resident step of the loop's first batch (no loader behind it), and
    # its device busy time against the loop's steps of the same width
    image_cache.activate(cache_dir)
    plan_loader.set_epoch(0)
    batches = iter(plan_loader)
    first_batch = next(batches)[0]
    batches.close()
    image_cache.activate(None)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in first_batch.items()}
    same_width = [g for g, c, w in zip(cached["gap_ms"], crosses[1:], widths[1:]) if not c and w == widths[0]]
    ref_ms = float(np.mean(same_width or in_epoch))
    opt = build_optimizer("adam", build_schedule("none", 1e-6, 1))
    resident = {"state": create_train_state(params, opt)}
    step = make_train_step(mcfg, opt, compute_dtype=torch.bfloat16, remat=True)

    def one_step():
        resident["state"], _ = step(resident["state"], batch)

    one_step()
    resident_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        resident_ms.append((time.perf_counter() - t0) * 1e3)
    prof = profile_one(one_step, ref_ms, kernels=(("attention_fwd", "attention_fwd_kernel"),
                                                   ("attention_bwd", "attention_bwd_")))
    del batch, resident, step

    # the resize on the card: raw 480 x 640 images against the host float path
    def decode(path):
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))

    with ThreadPoolExecutor(max_workers=nproc) as pool:
        raws = list(pool.map(decode, corpus["images"][:FEED_DEVICE_RESIZE]))
        host = list(pool.map(lambda im: native.preprocess_rgb(im, 224) if built else preprocess_image(im, 224),
                             raws))
    raw_gpu = torch.from_numpy(np.stack(raws)).cuda()
    got = preprocess_on_device(raw_gpu, 224)
    torch.cuda.synchronize()
    diffs = [np.abs(got[i].cpu().numpy() - host[i]) for i in range(len(raws))]
    p99, worst = max(float(np.percentile(d, 99)) for d in diffs), max(float(d.max()) for d in diffs)
    check(p99 <= 1.5 / 255 / 0.26 + 1e-3 and worst <= 20.0 / 255 / 0.26,
          f"preprocess_on_device against the host path: p99 {p99}, max {worst}")
    resize_ms = cuda_ms(lambda: preprocess_on_device(raw_gpu, 224), iters=10, warmup=2)
    del raw_gpu, got

    # the retrieval eval with the cache and without
    evals = _feed_eval(root, os.path.join(root, "retrieval_cache"))
    check(evals["cached"]["metrics"] == evals["live"]["metrics"], "retrieval metrics with and without the cache")
    check(evals["cached"]["launches"] == evals["live"]["launches"], "retrieval launches with and without the cache")
    check(evals["cached"]["cache_hits"] == 4 and evals["live"]["cache_hits"] == 0, f"cache hits {evals}")
    check(image_cache.active_cache() is None, "no cache left active")

    pairs = TRAIN_BATCH * D
    emit({"phase": "data_feed", "model": "ViT-B/32", "config": "configs/finetune_template_fast.json",
          "seed": 0, "nproc": nproc, "images": FEED_IMAGES, "image_hw": FEED_HW, "jpeg_quality": FEED_QUALITY,
          "jpeg_mean_kb": corpus["mean_kb"], "corpus_write_s": corpus_s, "native": status,
          "native_float_max_abs_err": float_err, "cache_build_s": build_s,
          "cache_build_images_per_sec": FEED_IMAGES / build_s, "init_s": init_s, "build_dataset_s": dataset_s,
          "batch_images": TRAIN_BATCH, "descriptions_per_image": D, "remat": remat,
          "step_widths": widths, "step_starts_epoch": crosses,
          "cached": {"losses": cached["values"]["loss"], "gap_ms": cached["gap_ms"], "wall_s": cached["wall_s"],
                     "in_epoch_steps": steady,
                     "pairs_per_sec_with_epoch_ends": pairs * (n_steps - 1) / sum(cached["gap_ms"]) * 1e3},
          "live": {"losses": live["values"]["loss"], "gap_ms": live["gap_ms"], "wall_s": live["wall_s"],
                   "steps": FEED_LIVE_STEPS, "images_checked_against_cache": checked.checked},
          "live_steps_bit_equal_cached": True,
          "k1_launches_per_step": {k: v // n_steps for k, v in cached["launches"].items() if v},
          "resident_batch_step_ms": resident_ms, "resident_width": widths[0],
          "loop_step_ms_same_width": ref_ms, "device_busy_ms": prof.get("device_busy_ms"),
          "device_idle_share": prof.get("device_idle_share"),
          "loader_alone_images_per_sec": {"cached": cached_ips, "live": live_ips},
          "cached_loader_images_per_sec_by_threads": by_threads,
          "device_resize": {"images": FEED_DEVICE_RESIZE, "ms": resize_ms,
                            "images_per_sec": FEED_DEVICE_RESIZE / resize_ms * 1e3, "p99_abs_err": p99,
                            "max_abs_err": worst},
          "retrieval_with_cache": evals, "phase_s": time.perf_counter() - t_phase})
    return {k: cached["launches"][k] + live["launches"][k] for k in COUNTERS}


# the preprocess phase: the description pipeline's corpus (docs, the
# JPEGs' size, the docs without a readable image) and the 33 ACE event
# types the CLIP type scorer ranks
PP_DOCS, PP_HW, PP_MISSING, PP_CORRUPT = 64, (320, 480), 2, 1
PP_ACE_TYPES = (
    "Life.BeBorn", "Life.Marry", "Life.Divorce", "Life.Injure", "Life.Die", "Movement.Transport",
    "Transaction.TransferOwnership", "Transaction.TransferMoney", "Business.StartOrg",
    "Business.MergeOrg", "Business.DeclareBankruptcy", "Business.EndOrg", "Conflict.Attack",
    "Conflict.Demonstrate", "Contact.Meet", "Contact.PhoneWrite", "Personnel.StartPosition",
    "Personnel.EndPosition", "Personnel.Nominate", "Personnel.Elect", "Justice.ArrestJail",
    "Justice.ReleaseParole", "Justice.TrialHearing", "Justice.ChargeIndict", "Justice.Sue",
    "Justice.Convict", "Justice.Sentence", "Justice.Fine", "Justice.Execute", "Justice.Extradite",
    "Justice.Acquit", "Justice.Appeal", "Justice.Pardon",
)
PP_ROLES = ("Agent", "Person", "Place")
# the scorer's probs against the plain path: softmax(100 · cosine), and a
# probability moves by at most half the largest change of a logit
# (|dp_i| = p_i |dz_i − E_p dz| ≤ 2 p_i (1 − p_i) max|dz| ≤ max|dz| / 2), so
# the fp32 serving gate on the features (1e-4, taken on the cosines) gives
# 0.5 · 100 · 1e-4
PP_LOGIT_SCALE, PP_COSINE_GATE = 100.0, 1e-4
PP_PROB_GATE = 0.5 * PP_LOGIT_SCALE * PP_COSINE_GATE


def write_pp_corpus(root: str, seed: int = 0) -> dict:
    """The description pipeline's inputs, from `seed`: ColdStart entity and
    event files (PP_DOCS docs, 1-4 events each of the ACE types, with
    arguments), the caption mapping, the template file, the type
    descriptions (one a type), and a JPEG a doc (PP_HW, the data feed's
    smooth fields) but for PP_MISSING docs without a file and PP_CORRUPT
    with a file that is no image. Returns the paths and the doc ids."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    docs = [f"VOA_EN_NW_2017_{d:04d}_0" for d in range(PP_DOCS)]
    names = ("protesters", "police", "the minister", "a court", "soldiers", "the company", "the city",
             "a journalist", "voters", "the bank", "a farmer", "the border")
    ent, evt, mapping = [], [], {}
    for d, doc in enumerate(docs):
        ents = []
        for e in range(3):
            eid, name = f":Entity_{d}_{e}", names[int(rng.integers(len(names)))]
            off = f"{doc}:{20 * e}-{20 * e + len(name) - 1}"
            ent += [f"{eid}\ttype\thttps://tac.nist.gov/ontology#Person\t1.0",
                    f'{eid}\tcanonical_mention.actual\t"{name}"\t{off}\t0.9',
                    f'{eid}\tmention.actual\t"{name}"\t{off}\t0.9']
            ents.append((eid, off))
        for v in range(int(rng.integers(1, 5))):
            vid, etype = f":Event_{d}_{v}", PP_ACE_TYPES[int(rng.integers(len(PP_ACE_TYPES)))]
            off = f"{doc}:{100 + 10 * v}-{105 + 10 * v}"
            evt += [f"{vid}\ttype\thttps://tac.nist.gov/ontology#{etype}",
                    f'{vid}\tcanonical_mention.actual\t"event{v}"\t{off}\t0.8',
                    f'{vid}\tmention.actual\t"event{v}"\t{off}\t0.8']
            for r in range(int(rng.integers(0, 3))):
                eid, eoff = ents[r]
                evt.append(f"{vid}\thttps://tac.nist.gov/ontology#{etype}_{PP_ROLES[r]}.actual\t{eid}\t{eoff}\t0.8")
        mapping[doc[:-2]] = {"0": {"url": "", "cap": f"FILE - event0 near {names[d % len(names)]} today."}}
    paths = {k: os.path.join(root, f) for k, f in (
        ("entity", "entity.cs"), ("event", "event.cs"), ("mapping", "image_caption_mapping.json"),
        ("templates", "templates.json"), ("types", "type_descriptions.json"), ("image_dir", "jpg"))}
    for key, lines in (("entity", ent), ("event", evt)):
        with open(paths[key], "w") as fh:
            fh.write("\n".join(lines) + "\n")
    templates, types = {}, {}
    for t in PP_ACE_TYPES:
        words = " ".join(re.findall("[A-Z][^A-Z]*", t.split(".")[-1])).lower()
        templates[t] = {"template": f"<arg1> {words} <arg2> at <arg3>", "roles": list(PP_ROLES)}
        types[t] = {"desc_auto_name": f"An image of a {words} event ({t.split('.')[0].lower()})."}
    for key, obj in (("mapping", mapping), ("templates", templates), ("types", types)):
        with open(paths[key], "w") as fh:
            json.dump(obj, fh)
    os.makedirs(paths["image_dir"], exist_ok=True)
    noise = _feed_noise(seed)
    bad = PP_MISSING + PP_CORRUPT

    def write(i):
        path = os.path.join(paths["image_dir"], docs[i] + ".jpg")
        if i >= PP_DOCS - PP_CORRUPT:
            with open(path, "wb") as fh:
                fh.write(b"this is no JPEG")
        elif i < PP_DOCS - bad:
            img = _feed_image(i, seed, noise)[: PP_HW[0], : PP_HW[1]]
            Image.fromarray(img).save(path, quality=FEED_QUALITY)

    with ThreadPoolExecutor(max_workers=len(os.sched_getaffinity(0))) as pool:
        list(pool.map(write, range(PP_DOCS)))
    return {**paths, "docs": docs, "good": docs[: PP_DOCS - bad], "bad": docs[PP_DOCS - bad:]}


def phase_preprocess(out_root):
    """The port's `preprocess_descriptions` CLI (`python -m
    clip_event_tpu_torch.preprocess_descriptions`) at ViT-B/32 full width,
    seeded weights, on the card, over `write_pp_corpus`'s files with
    `add_clip_sim` and a cold `clip_cache_dir`: the CLIP type scorer
    encodes the 33 type descriptions (one text batch) and the readable
    images (one image batch), 12 K1-fwd launches a batch and no other
    kernel; the docs without a readable image get pred_idx -1. The scores
    against the plain path (the same images decoded again by threads, both
    towers with the plain attention) within PP_PROB_GATE, pred_idx equal
    where the plain top-two margin is above it; then the CLI again on the
    warm cache: the text batch alone (12 launches), every output file byte
    for byte the cold run's."""
    from concurrent.futures import ThreadPoolExecutor

    from clip_event_tpu_torch import preprocess_descriptions
    from clip_event_tpu_torch.data.common import load_image_file
    from clip_event_tpu_torch.preprocess import selection
    from clip_event_tpu_torch.tokenizer import tokenize

    t_phase = time.perf_counter()
    root = os.path.join(out_root, "preprocess")
    os.makedirs(root, exist_ok=True)
    corpus = write_pp_corpus(root)
    t_corpus = time.perf_counter() - t_phase
    cache_dir = os.path.join(root, "clip_cache")
    scored, score_s = {}, []
    real_score_all = selection.ClipTypeScorer.score_all

    def spy(self, doc_ids, image_paths):
        t0 = time.perf_counter()
        out = real_score_all(self, doc_ids, image_paths)
        score_s.append(time.perf_counter() - t0)
        scored.clear()
        scored.update(out)
        return out

    def run_cli(tag):
        cfg = {
            "output_dir": os.path.join(root, f"out_{tag}"),
            "cs_inputs": [[corpus["entity"], ""], [corpus["event"], ""]],
            "image_caption_json": [corpus["mapping"]], "template_file": corpus["templates"],
            "positive_option": ["template", "short"], "negative_option": ["template", "caption"],
            "add_clip_sim": True, "model": "ViT-B/32", "type_descriptions_json": corpus["types"],
            "image_dirs": {"VOA_EN_NW_2017": corpus["image_dir"]}, "clip_cache_dir": cache_dir,
        }
        path = os.path.join(root, f"cfg_{tag}.json")
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        reset_launches()
        t0 = time.perf_counter()
        selection.ClipTypeScorer.score_all = spy
        try:
            preprocess_descriptions.main(["--cfg", path])
        finally:
            selection.ClipTypeScorer.score_all = real_score_all
        torch.cuda.synchronize()
        return cfg["output_dir"], time.perf_counter() - t0, read_launches(), dict(scored)

    expected = {name: 0 for name in COUNTERS}
    out_cold, cold_s, cold, preds = run_cli("cold")
    check(cold == {**expected, KERNEL: 24}, f"preprocess cold launches {cold}: K1-fwd 12 + 12 alone")
    check(sorted(preds) == sorted(corpus["docs"]), "preprocess: every doc scored")
    check(all(preds[d]["pred_idx"] == -1 for d in corpus["bad"]), "preprocess: bad docs get pred_idx -1")
    check(all(preds[d]["pred_idx"] >= 0 for d in corpus["good"]), "preprocess: readable docs scored")
    check(sorted(os.listdir(cache_dir)) == sorted(d + ".json" for d in corpus["good"]),
          "preprocess: one cache file a scored doc")

    # the plain path: the same files decoded again, both towers plain
    model, mcfg = load_model_from_cfg({"ckpt": None, "model": "ViT-B/32"}, "cuda")
    files = [os.path.join(corpus["image_dir"], d + ".jpg") for d in corpus["good"]]
    with ThreadPoolExecutor(max_workers=len(os.sched_getaffinity(0))) as pool:
        images = np.stack(list(pool.map(lambda f: load_image_file(f, mcfg.image_resolution), files)))
    with open(corpus["types"]) as fh:
        type_desc = [v["desc_auto_name"] for v in json.load(fh).values()]
    enc = Encoders(model, mcfg, batch_size=BATCH)
    reset_launches()
    with layers.attention_impl("plain"):
        text_feats = enc.texts(tokenize(type_desc))
        feats = enc.images(images)
    check(read_launches() == expected, "preprocess: the plain path launches no kernel")
    logits = PP_LOGIT_SCALE * feats @ text_feats.T
    logits -= logits.max(axis=1, keepdims=True)
    plain = np.exp(logits)
    plain /= plain.sum(axis=1, keepdims=True)
    gaps, qualifying, flipped = [], 0, []
    for i, doc in enumerate(corpus["good"]):
        with open(os.path.join(cache_dir, doc + ".json")) as fh:
            rec = json.load(fh)
        check(rec == preds[doc], f"preprocess: {doc}'s cache file is its score")
        gaps.append(float(np.max(np.abs(np.asarray(rec["probs"], np.float32) - plain[i]))))
        top2 = np.sort(plain[i])[-2:]
        if top2[1] - top2[0] > PP_PROB_GATE:
            qualifying += 1
            if rec["pred_idx"] != int(plain[i].argmax()):
                flipped.append(doc)
    check(max(gaps) <= PP_PROB_GATE, f"preprocess: max |dprobs| {max(gaps)} > {PP_PROB_GATE}")
    check(not flipped, f"preprocess: pred_idx differs from the plain path on {flipped}")

    # warm: every score from the cache, the type descriptions encoded again
    out_warm, warm_s, warm, warm_preds = run_cli("warm")
    check(warm == {**expected, KERNEL: 12}, f"preprocess warm launches {warm}: K1-fwd 12 (text) alone")
    check(warm_preds == preds, "preprocess: the warm run's scores are the cold run's")
    names = sorted(os.listdir(out_cold))
    check(len(names) == 7 and sorted(os.listdir(out_warm)) == names, f"preprocess outputs {names}")
    for name in names:
        with open(os.path.join(out_cold, name), "rb") as a, open(os.path.join(out_warm, name), "rb") as b:
            check(a.read() == b.read(), f"preprocess: {name} differs between the cold and warm runs")
    n_scored = len(corpus["good"])
    emit({"phase": "preprocess", "model": "ViT-B/32", "dtype": "float32", "docs": PP_DOCS,
          "image_hw": list(PP_HW), "scored": n_scored, "bad": len(corpus["bad"]), "types": len(type_desc),
          "launches_cold": {KERNEL: cold[KERNEL]}, "launches_warm": {KERNEL: warm[KERNEL]},
          "max_abs_dprobs": max(gaps), "mean_over_docs_max_abs_dprobs": float(np.mean(gaps)), "prob_gate": PP_PROB_GATE,
          "pred_idx_checked_docs": qualifying, "pred_idx_differ": len(flipped),
          "cold_cli_s": cold_s, "warm_cli_s": warm_s, "cold_score_all_s": score_s[0],
          "cold_images_scored_per_s": n_scored / score_s[0], "corpus_s": t_corpus,
          "phase_s": time.perf_counter() - t_phase})
    return {k: cold[k] + warm[k] for k in COUNTERS}


# the phases `--only` runs alone (after the device and build phases)
PHASES_ALONE = {"train_full": phase_train_full, "serving_rn50": phase_serving_rn50,
                "train_rn50": phase_train_rn50, "evals": phase_evals,
                "serving_bundle": phase_serving_bundle, "train_dp": phase_train_dp,
                "data_feed": phase_data_feed, "tp_heads": phase_tp_heads, "pp_stages": phase_pp_stages,
                "preprocess": phase_preprocess, "bench_tools": lambda _root: phase_bench_tools()}


def profile_one(run, batch_ms, kernels=(("attention", "attention_fwd_kernel"),)):
    """Device time of one warm `run()` by kernel (torch.profiler): the busy
    time summed over the kernels themselves (not the aten ops that launch
    them), its share of `batch_ms` (the unprofiled time of one run), the
    time and busy share of each named kernel family (name substring), and
    the kernels that took most. It traces the device alone: every number
    here comes from the kernel rows, which a host trace would not change,
    and the tens of thousands of host ops of a train step take the tracer
    tens of seconds."""
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        out[f"{label}_kernel_calls"] = sum(k[2] for k in rows if needle in k[0])
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


def ptxas_usage(log: str, needle: str) -> dict:
    """{kernel: (registers, spill bytes (stores + loads))} of every kernel
    whose name holds `needle`, from a `-Xptxas -v` log: ptxas names a
    function, gives its stack frame and spills on the next line and its
    registers on the one after."""
    import re

    usage, name, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name is not None:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None and spill is not None:
            if needle in name:
                usage[name] = (int(m.group(1)), spill)
            name = None
    return usage


def main(argv=None) -> int:
    """No arguments: every phase. `--only k1` / `k2` / `k3` / `k4` / `k5` / `k6`
    (one or more): the device and build phases and those kernels' checks
    alone (the quick look after an edit to them), with a last line that
    says so; `b1` the wrappers' host cost (`--package-root DIR`: another
    tree's package), `graph` the graphed B/32 train step
    (`phase_train_graph`); `train_full`, `serving_rn50`, `train_rn50`,
    `evals`, `serving_bundle`, `train_dp`, `data_feed`, `tp_heads`,
    `pp_stages` or `preprocess` that phase alone. `--old-csrc DIR` builds K3 and K6 from an earlier tree's
    csrc/ and times them beside these in turns; `--k6-split` times K6
    without its core and without its projection (`k6_split`)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", choices=("k1", "k2", "k3", "k4", "k5", "k6", "b1", "graph")
                        + tuple(PHASES_ALONE), default=None)
    parser.add_argument("--package-root", default=None,
                        help="with --only b1: time the wrappers of the package under this directory")
    parser.add_argument("--old-csrc", default=None)
    parser.add_argument("--k6-split", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = port_bench.nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    # the bundles' exports run beside the kernels' build
    exports = start_bundle_exports(work.name) if args.only is None or "serving_bundle" in args.only else {}
    try:
        return run_phases(args, smi, work.name, exports)
    finally:
        stop(exports.values())
        work.cleanup()


def run_phases(args, smi, work_dir, exports) -> int:
    """Every phase after `device` (see `main`); the bundles' exports
    (`start_bundle_exports` into `work_dir`) are read after the build."""
    t0 = time.perf_counter()
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    check(set(SOURCES.values()) <= set(sources), f"kernel sources {sources}")
    seconds = _build.build(sources)
    ptxas = {name: [ln.strip() for ln in _build.BUILD_LOGS.get(name, "").splitlines() if "Used" in ln]
             for name in sources}
    # the tensor-core kernels ("mma", "tf32x3") keep their tiles'
    # accumulators in registers: a spill would send them to local memory
    # (an earlier tree's package, `--package-root` for `b1`, has its bf16
    # forwards on mma.sync: "_mma" kernels, no HGMMA)
    fwd = "_mma" if args.package_root else "_wgmma"
    needles = {KERNEL: (fwd, "_tf32x3"), BWD_KERNEL: ("_mma", "_tf32x3"),
               HG_KERNEL: (fwd, "_tf32x3"), HG_BWD_KERNEL: ("_mma", "_tf32x3"),
               MEGA_KERNEL: ("_tc",), ot.KERNEL: ("_warp",)}
    usage = {name: {needle: ptxas_usage(_build.BUILD_LOGS.get(name, ""), needle) for needle in found}
             for name, found in needles.items()}
    # K4: registers and spills of every forward and backward kernel (a
    # spill in the register path would send the row to local memory)
    k4_usage = {name: ptxas_usage(_build.BUILD_LOGS.get(name, ""), "layer_norm")
                for name in (ln.KERNEL, ln.BWD_KERNEL)}
    # K5: registers, shared memory and spills of each kernel, and the
    # warpgroup int8 MMA in the GEMM's SASS
    k5_log = _build.BUILD_LOGS.get(quant.KERNEL, "")
    k5_usage = ptxas_usage(k5_log, "")
    k5_sass = k5_sass_has_igmma()
    blocks_fn = _build.entry(quant.KERNEL, "clip_quant_gemm_blocks_per_sm", [ctypes.c_int])[1]
    k5_blocks = {name: blocks_fn(code) for name, code in (("float32", 0), ("bfloat16", 1))}
    k5_smem = _build.entry(quant.KERNEL, "clip_quant_gemm_smem_bytes", [])[1]()
    # K6: HMMA (mma.sync, bf16 and TF32) in every tensor-core kernel's SASS
    k6_sass = sass_has(MEGA_KERNEL, "_tc", "HMMA")
    # K1's and K2's bf16 forwards: the warpgroup MMA (HGMMA) in every
    # kernel's SASS, and at the paths' head_dim (64) no product that ptxas
    # serialized (each then waits for the last: the tensor cores' latency
    # on every step); the other head dims' lines are reported
    fwd_sass = {name: sass_has(name, "_wgmma", "HGMMA") for name in (KERNEL, HG_KERNEL)}
    fwd_serialized = {name: [ln.strip() for ln in _build.BUILD_LOGS.get(name, "").splitlines()
                             if "wgmma.mma_async instructions are serialized" in ln] for name in (KERNEL, HG_KERNEL)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": seconds, "ptxas": ptxas,
          "tensor_core_kernel_registers_and_spill_bytes": usage, "k6_sass_has_hmma": k6_sass,
          "k1_k2_fwd_sass_has_hgmma": fwd_sass, "k1_k2_fwd_wgmma_serialized": fwd_serialized,
          "k3_k6_ptxas": {name: [ln.strip() for ln in _build.BUILD_LOGS.get(name, "").splitlines()
                                 if "ptxas" in ln or "bytes" in ln] for name in (ot.KERNEL, MEGA_KERNEL)},
          "k5_ptxas": [ln.strip() for ln in k5_log.splitlines() if "ptxas" in ln or "bytes" in ln],
          "k5_registers_and_spill_bytes": k5_usage, "k5_gemm_sass_has_igmma": k5_sass,
          "k4_registers_and_spill_bytes": k4_usage,
          "k5_gemm_blocks_per_sm": k5_blocks, "k5_gemm_dynamic_smem_bytes": k5_smem})
    for name, by_needle in usage.items():
        for needle, by_kernel in by_needle.items():
            check(seconds[name] == 0.0 or by_kernel, f"{name}: no {needle} kernel in the ptxas log")
            check(not any(spill for _, spill in by_kernel.values()), f"{name}: a {needle} kernel spills: {by_kernel}")
    for name, by_kernel in k4_usage.items():
        check(seconds[name] == 0.0 or by_kernel, f"{name}: no layer_norm kernel in the ptxas log")
        check(not any(spill for _, spill in by_kernel.values()), f"{name}: a kernel spills: {by_kernel}")
    check(seconds[quant.KERNEL] == 0.0 or any("int8_gemm" in k for k in k5_usage),
          f"{quant.KERNEL}: no GEMM kernel in the ptxas log")
    check(not any(spill for _, spill in k5_usage.values()), f"{quant.KERNEL}: a kernel spills: {k5_usage}")
    check(bool(k5_sass) and all(k5_sass.values()), f"{quant.KERNEL}: no IGMMA in the GEMM's SASS: {k5_sass}")
    check(bool(k6_sass) and all(k6_sass.values()), f"{MEGA_KERNEL}: no HMMA in a tensor-core kernel: {k6_sass}")
    for name, found in ({} if args.package_root else fwd_sass).items():
        check(bool(found) and all(found.values()), f"{name}: no HGMMA in a bf16 forward kernel: {found}")
        # a cached library brings its log (`_build.build`): without one
        # the serialized check below could not run
        check(name in _build.BUILD_LOGS, f"{name}: no ptxas log beside the library")
        at_path = [ln for ln in fwd_serialized[name] if "wgmmaILi64E" in ln]
        check(not at_path, f"{name}: ptxas serialized the wgmma products at head_dim 64: {at_path}")
    check(all(n >= 1 for n in k5_blocks.values()), f"{quant.KERNEL}: the GEMM fits no SM: {k5_blocks}")
    t0 = time.perf_counter()
    exported = {tag: collect(child, f"{tag}: the bundle's export") for tag, child in exports.items()}
    if exported:
        emit({"phase": "bundle_exports", "beside": "build", "wait_after_build_s": time.perf_counter() - t0,
              "exports": exported})

    if args.old_csrc:
        OLD_LIBS.update(build_old_kernels(os.path.abspath(args.old_csrc)))
    if args.only:
        rows = {name: [] for name in COUNTERS}
        errs = {name: {} for name in COUNTERS}
        gen = torch.Generator(device="cuda").manual_seed(0)
        for only in args.only:
            if only == "serving_bundle":
                phase_serving_bundle(work_dir, exported)
                continue
            if only in PHASES_ALONE:
                with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_root:
                    PHASES_ALONE[only](out_root)
                continue
            {"k1": check_k1, "k2": check_k2, "k3": check_k3, "k4": check_k4, "k5": check_k5, "k6": check_k6,
             "b1": lambda *_: phase_b1(), "graph": lambda *_: only_graph()}[only](rows, errs, gen)
        if args.k6_split:
            k6_split(gen)
        torch.cuda.synchronize()
        print(smi, flush=True)
        print(json.dumps({"ok": True, "only": args.only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
        return 0

    rows, errs = phase_kernels()
    phase_b1()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_root:
        paths["serving"], float_rates = phase_serving(out_root)
        paths["train"], train_ms, train_prof = phase_train(out_root)
        paths["train_graph"] = phase_train_graph(out_root)
        paths["train_dp"] = phase_train_dp(out_root)
        paths["tp_heads"] = phase_tp_heads(out_root, rows, errs)
        paths["pp_stages"] = phase_pp_stages(out_root, rows, errs)
        paths["data_feed"] = phase_data_feed(out_root)
        paths["train_ln"], paths["train_ln_l14"] = phase_train_ln(out_root, train_ms, train_prof)
        paths["serving_ln"] = phase_serving_ln()
        paths["serving_l14"], l14_rates = phase_serving(out_root, "ViT-L/14", L14_SERVING_ITEMS,
                                                        matching=False, tag="serving_l14")
        paths["train_l14"], paths["train_b16"], paths["train_l14_fp32"] = phase_train_l14(out_root)
        paths["train_ot"], paths["train_ot_graph"] = phase_train_ot(out_root)
        paths["train_full"] = phase_train_full(out_root)
        paths["serving_rn50"] = phase_serving_rn50(out_root)
        paths["train_rn50"] = phase_train_rn50(out_root)
        paths["serving_int8_l14"] = phase_serving_int8(out_root, "ViT-L/14", L14_SERVING_ITEMS,
                                                       "serving_int8_l14", l14_rates)
        paths["serving_int8_b32"] = phase_serving_int8(out_root, "ViT-B/32", L14_SERVING_ITEMS,
                                                       "serving_int8_b32", float_rates, cos_gate=0.99)
        paths["serving_bundle"] = phase_serving_bundle(work_dir, exported)
        paths["evals"] = phase_evals(out_root)
        paths["preprocess"] = phase_preprocess(out_root)
        paths["bench_tools"] = phase_bench_tools()

    def entry(name, source, replaces, tol, head):
        by_path = {path: counts[name] for path, counts in paths.items()}
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "variants": sorted({r["variant"] for r in rows[name] if "variant" in r}),
            "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "head_shape": " ".join(str(head[k]) for k in ("shape", "dtype", "mode") if k in head),
            "max_abs_err_by_dtype": errs[name], "tolerance_by_dtype": tol,
            "by_shape": [r for r in rows[name] if "ms" in r],
        }

    def head(name, shape, dtype, mode=None, variant=None):
        return next(r for r in rows[name] if r["shape"] == shape and r["dtype"] == dtype
                    and r.get("mode") in (mode, None) and r.get("variant") in (variant, None))

    # top-level numbers: the attention kernels at a train step's shape in
    # bf16 (the training dtype; the tensor-core variants); K3 at finetune_ot's shape; K5 at L/14's
    # MLP fc in fp32, dynamic (the CLI's "int8"); K4 at the ViT-B/32 train
    # step's text shape in bf16; K6 at the component bench's text shape in
    # bf16; by_shape holds every timed shape in both dtypes (and K5's two
    # modes, K4c's two variants)
    for name in COUNTERS:
        check(sum(counts[name] for counts in paths.values()) > 0, f"{name} launched on the main paths")
    print(json.dumps({"kernels": [
        entry(KERNEL, "clip_event_tpu_torch/csrc/attention_fwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:93", TOL,
              head(KERNEL, "train_text", "bfloat16", variant="mma")),
        entry(BWD_KERNEL, "clip_event_tpu_torch/csrc/attention_bwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:101", BWD_TOL,
              head(BWD_KERNEL, "train_text", "bfloat16", variant="mma")),
        entry(HG_KERNEL, "clip_event_tpu_torch/csrc/attention_hg_fwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:410", TOL,
              head(HG_KERNEL, "l14_vision", "bfloat16", variant="mma")),
        entry(HG_BWD_KERNEL, "clip_event_tpu_torch/csrc/attention_hg_bwd.cu",
              "clip_event_tpu/ops/attention_pallas.py:421", BWD_TOL,
              head(HG_BWD_KERNEL, "l14_vision", "bfloat16", variant="mma")),
        entry(ot.KERNEL, "clip_event_tpu_torch/csrc/ipot.cu",
              "clip_event_tpu/ops/ot_pallas.py:40", OT_TOL,
              head(ot.KERNEL, "ot_finetune", "float32", variant="warp")),
        entry(quant.KERNEL, "clip_event_tpu_torch/csrc/quant_matmul.cu",
              "clip_event_tpu/ops/quant_pallas.py:64", QUANT_TOL,
              head(quant.KERNEL, "l14_vision_fc", "float32", "dynamic")),
        entry(ln.KERNEL, "clip_event_tpu_torch/csrc/layer_norm.cu",
              "clip_event_tpu/ops/ln_pallas.py:69", LN_TOL, head(ln.KERNEL, "b32_train_text", "bfloat16")),
        entry(ADD_LN_KERNEL, "clip_event_tpu_torch/csrc/layer_norm.cu",
              "clip_event_tpu/ops/ln_pallas.py:75", LN_TOL,
              head(ADD_LN_KERNEL, "b32_train_text", "bfloat16")),
        entry(ln.BWD_KERNEL, "clip_event_tpu_torch/csrc/layer_norm_bwd.cu",
              "clip_event_tpu/ops/ln_pallas.py:83", LN_BWD_TOL,
              head(ln.BWD_KERNEL, "b32_train_text", "bfloat16", variant="ln")),
        entry(MEGA_KERNEL, "clip_event_tpu_torch/csrc/ln_qkv_attention.cu",
              "clip_event_tpu/ops/attention_pallas.py:580", MEGA_TOL,
              head(MEGA_KERNEL, "mega_text", "bfloat16", variant="mma")),
    ]}), flush=True)
    print(smi, flush=True)
    # the last line, exactly these keys
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
