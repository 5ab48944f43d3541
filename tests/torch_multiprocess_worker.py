"""The rank processes of tests/test_torch_multiprocess.py (not a test file:
the test spawns these with `torch.multiprocessing`).

Imports torch, numpy and the port only, so a rank starts in a few seconds.
The batches are built here from numpy seeds, for the ranks and, as one
global batch, for the test's JAX reference; the weights come from the
port's init (the test carries them to JAX through the state dict). Every
rank joins a gloo group over a FileStore, runs the cases it is given and
pickles what it measured to `<out>/rank<r>.pkl`.

A case "<mode>:<case>" (`run_sharded`) runs Adam with the clip at 1.0 on
a state that is plain ("plain"), ZeRO-1 ("zero") or FSDP ("fsdp")
sharded over the ranks (`parallel/sharding.py`), and reports the full
state gathered back, the shard sizes and, where it wrote one, the
checkpoint's path.

A case "tp/<case>" (`run_tp`) runs on a (dcn × dp × tp) or (dp × pp) mesh
of the ranks (`TP_MESHES`): SGD with the clip at 1.0 on a tensor-parallel
state (Megatron slices of `TP_VIT`'s stacks and token embedding) or a
pipeline state (the stacks' stages, the GPipe schedule over the pp
group), Adam where ZeRO-1 or FSDP shards the state over the data ranks
on top (`TP_SHARDED`), or the M2E2 eval, the checkpoint a tp or pp run
writes, and a world-of-one file resumed at tp = 2 or pp = 2; it reports
the metrics, the full params gathered back and this rank's whole
(unsplit) leaves.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

VIT = dict(embed_dim=32, image_resolution=32, vision_layers=1, vision_width=64,
           vision_patch_size=16, context_length=77, vocab_size=49408,
           transformer_width=64, transformer_heads=1, transformer_layers=1)
# the 4 × 4 grid (patch 8) the local-attention case pools over
VIT_GRID = dict(VIT, vision_patch_size=8)
RESNET = dict(embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=8,
              vision_patch_size=None, context_length=77, vocab_size=49408,
              transformer_width=64, transformer_heads=1, transformer_layers=1)
NPOS, NNEG = 1, 2
D = NPOS + NNEG
NOBJ, NENT, R = 3, 4, 3
LR = 0.1
SEED = 1
# Adam's update is lr·m/(√v + ε): where a gradient element is near ε, the
# last-ulp differences of another summation order (XLA's, or the sharded
# step's) move it by up to a tenth of one update over three steps
# (tests/test_zero.py documents the same); at this lr that stays under the
# tests' 1e-5
ADAM_LR = 1e-5
# the seeds of the global batches the sharded cases step through, in turn
ADAM_SEEDS = (10, 11, 12)


# the model-parallel cases' model: two heads in both towers (every stack
# splits over tp = 2); two vision and four text layers, so both stacks
# divide pp = 2 and at pp = 4 the text stack does and the vision stack
# does not; S = 77 (text) and 5 (vision) are odd, so sequence parallelism
# pads both
TP_VIT = dict(VIT, vision_width=128, vision_layers=2, transformer_heads=2, transformer_layers=4)
# tp/<case>: (tp, dcn, sp, pp) of its mesh over 4 ranks
TP_MESHES = {
    "contrastive": (2, 1, False, 1), "sp": (2, 1, True, 1), "attn": (2, 1, False, 1),
    "accum": (2, 1, False, 1), "multi_step": (2, 1, True, 1), "dcn_tp": (2, 2, False, 1),
    "dcn_dp": (1, 2, False, 1), "evals": (2, 1, False, 1), "ckpt": (2, 1, False, 1),
    "resume": (2, 1, False, 1),
    "pp": (1, 1, False, 2), "pp_attn": (1, 1, False, 2), "pp4": (1, 1, False, 4),
    "pp_zero": (1, 1, False, 2), "pp_ckpt": (1, 1, False, 2), "pp_resume": (1, 1, False, 2),
    "fsdp": (2, 1, False, 1), "dcn_zero": (1, 2, False, 1), "pp_fsdp": (1, 1, False, 2),
    "dcn_fsdp": (1, 2, False, 1), "pp_loop": (1, 1, False, 2), "pp_multi_step": (1, 1, False, 2),
}
TP_REMAT = {"sp": False, "attn": "attn", "multi_step": "attn", "pp_attn": "attn"}
# the cases whose state ZeRO-1 or FSDP shards over the data ranks on top
TP_SHARDED = {"pp_zero": "zero", "fsdp": "fsdp", "dcn_zero": "zero", "pp_fsdp": "fsdp",
              "dcn_fsdp": "fsdp"}
# the pipeline and composed-sharding cases: 4 global rows (the 2 data ranks'
# batches of the contrastive cases, JAX's same runs), Adam where the state
# is sharded, checkpointed or resumed
COMPOSED = ("pp", "pp_attn", "pp4", "pp_zero", "pp_ckpt", "pp_resume", "fsdp", "dcn_zero", "pp_fsdp",
            "dcn_fsdp", "pp_multi_step")
COMPOSED_ROWS = 4
ADAM_CASES = ("ckpt", "resume", "pp_zero", "pp_ckpt", "pp_resume", "fsdp", "dcn_zero", "pp_fsdp",
              "dcn_fsdp")
# the GPipe microbatches asked for: at (dp 2, pp 2) 2 vision rows take 2
# and 6 text rows take 3; at pp = 4 the 12 text rows take 4
PP_MICROBATCHES = 4
TP_SEEDS = (40, 41)


def model_dict(case: str) -> dict:
    if case.startswith("tp/"):
        return TP_VIT
    return {"multiattention": VIT_GRID, "sync_bn": RESNET}.get(case, VIT)


def step_kwargs(case: str) -> dict:
    """The train step's settings: finetune_ot.json's OT branch (alignment,
    the IPOT solver), clip_event_full.json's local-attention branch
    ("desc_type", attention pooling), fp32 everywhere."""
    kw = {"ot": dict(alignment=True, use_pallas_ot=True),
          "multiattention": dict(multiattention="desc_type", multiattention_pooling="attention")}
    return dict(kw.get(case, {}), loss_type="kl" if case == "kl" else "ce")


def _tokens(rng, shape):
    out = np.zeros(tuple(shape) + (77,), np.int32)
    for idx in np.ndindex(*shape):
        eot = int(rng.integers(2, 30))
        out[idx][0] = 49406
        out[idx][1:eot] = rng.integers(1, 49000, eot - 1)
        out[idx][eot] = 49407
    return out


def make_batches(case: str, world: int, b_local: int, seed: int):
    """(global batch, [rank batches]) as numpy: the global batch is the
    rank batches' rows in rank order with the world-of-one label layout,
    which is what the JAX package assembles from the ranks' blocks; a
    deduped channel's unique rows are the ranks' blocks, each rank's
    inverse index offset by rank · cap / world (`data/dedupe.py`)."""
    from clip_event_tpu_torch.data.dedupe import dedupe_rows
    from clip_event_tpu_torch.data.labels import build_label_layout

    rng = np.random.default_rng(seed)
    bg = b_local * world
    res = model_dict(case)["image_resolution"]
    loss = "kl" if case == "kl" else "ce"
    rows = {"text": _tokens(rng, (bg * D,))}
    if case in ("ot",):
        crops = rng.normal(size=(bg, NOBJ, res, res, 3)).astype(np.float32)
        obj_n = rng.integers(1, NOBJ + 1, bg)
        crops[np.arange(NOBJ)[None] >= obj_n[:, None]] = 0.0
        rows.update(image=crops[:, 0].copy(), object_image=crops,
                    object_mask=(np.arange(NOBJ)[None] < obj_n[:, None]).astype(np.int32),
                    entity_text=_tokens(rng, (bg, NENT)),
                    entity_mask=(np.arange(NENT)[None] < rng.integers(0, NENT + 1, bg)[:, None])
                    .astype(np.int32))
    else:
        rows["image"] = rng.integers(0, 256, size=(bg, res, res, 3), dtype=np.uint8)
    dedupe = {}
    if case == "multiattention":
        lo = rng.uniform(0, 0.6, size=(bg, R, 2))
        hi = np.minimum(lo + rng.uniform(0.15, 0.6, size=(bg, R, 2)), 1.0)
        rows["bbox"] = np.concatenate([lo, hi], -1).astype(np.float32)
        rows["bbox_mask"] = (np.arange(R)[None] < rng.integers(0, R + 1, bg)[:, None]).astype(np.int32)
        vocab = _tokens(rng, (3,))
        for prefix in ("bbox_desc", "bbox_label"):
            dedupe[prefix] = (vocab[rng.integers(0, 3, size=(bg, R))], 3 * world)
    if case == "accum_dedupe":
        # image 2k repeats image 2k+1's descriptions: duplicate rows
        text = rows["text"].reshape(bg, D, 77)
        text[1::2] = text[0::2]
        dedupe["text"] = (rows.pop("text").reshape(bg, D, 77), D * b_local * world)

    def block(r):
        out = {k: v[r * b_local:(r + 1) * b_local] if k != "text" else
               v[r * b_local * D:(r + 1) * b_local * D] for k, v in rows.items()}
        lay = build_label_layout(b_local, NPOS, NNEG, loss, True, rank=r, world_size=world)
        out.update(labels_per_image=lay.labels_per_image, labels_per_text=lay.labels_per_text,
                   index_pos=lay.index_pos)
        for prefix, (tok, cap) in dedupe.items():
            local = tok[r * b_local:(r + 1) * b_local]
            out[f"{prefix}_unique"], out[f"{prefix}_inverse"] = dedupe_rows(
                local.reshape(-1, 77), cap, rank=r, world=world, strict=True)
        return out

    ranks = [block(r) for r in range(world)]
    lay = build_label_layout(bg, NPOS, NNEG, loss, True)
    glob = {k: np.concatenate([b[k] for b in ranks]) for k in ranks[0] if k != "index_pos"}
    glob.update(labels_per_image=lay.labels_per_image, labels_per_text=lay.labels_per_text,
                index_pos=lay.index_pos)
    return glob, ranks


def init_params(case: str):
    """The port's init from SEED; for the ResNet, random BatchNorm (and
    LayerNorm) statistics and scales, as tests/test_torch_resnet.py draws
    them: the init's zero bn3 scales would silence the residual branches
    and leave the batch statistics ill-conditioned."""
    from clip_event_tpu_torch.models import clip as T

    cfg = T.CLIPConfig(**model_dict(case))
    params = T.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    if case != "sync_bn":
        return params, cfg
    rng = np.random.default_rng(SEED)

    def perturb(tree):
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = perturb(v)
            elif k in ("mean", "bias"):
                out[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
            elif k == "var":
                out[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            elif k == "scale":
                lo, hi = (0.05, 0.2) if not v.any() else (0.5, 1.0)
                out[k] = torch.from_numpy(rng.uniform(lo, hi, v.shape).astype(np.float32))
            else:
                out[k] = v
        return out

    return perturb(params), cfg


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def run_step(case: str, world: int, rank: int, b_local: int, mesh):
    """One SGD step of the case (two microbatches with "accum_dedupe")
    from the port's init; returns (metrics, the params' state dict)."""
    from clip_event_tpu_torch.engine import optim as TO
    from clip_event_tpu_torch.engine import train_step as TT
    from clip_event_tpu_torch.models import resnet
    from clip_event_tpu_torch.models.convert import state_dict_from_params
    from clip_event_tpu_torch.parallel.mesh import replicate

    params, cfg = init_params(case)
    opt = TO.build_optimizer("sgd", TO.build_schedule("none", LR, 1), grad_clip_norm=None)
    state = TT.create_train_state(params, opt)
    replicate(state.params, mesh)
    kw = dict(compute_dtype=torch.float32, remat=True, mesh=mesh, **step_kwargs(case))
    if case == "accum_dedupe":
        micro = [make_batches(case, world, b_local, 20 + k)[1][rank] for k in range(2)]
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        step = TT.make_accum_step(cfg, opt, 2, **kw)
    else:
        batch = make_batches(case, world, b_local, 10)[1][rank]
        step = TT.make_train_step(cfg, opt, **kw)
    with resnet.bn_mode("batch" if case == "sync_bn" else "frozen", mesh):
        state, metrics = step(state, _t(batch))
    return {k: float(v) for k, v in metrics.items()}, state_dict_from_params(state.params, cfg)


def adam(moment_dtype=None):
    from clip_event_tpu_torch.engine import optim as TO

    return TO.build_optimizer("adam", TO.build_schedule("none", ADAM_LR, 1), grad_clip_norm=1.0,
                              moment_dtype=moment_dtype)


def state_record(state, cfg) -> dict:
    """The full state of a (sharded) train state, gathered on every rank:
    the params' state dict and each moment's, as float32 numpy."""
    from clip_event_tpu_torch.models.clip import tree_to
    from clip_event_tpu_torch.models.convert import state_dict_from_params
    from clip_event_tpu_torch.parallel.sharding import gather_state

    full = gather_state(state)
    out = {"count": int(full.opt_state["count"])}
    for k, tree in (("params", full.params), ("mu", full.opt_state["mu"]), ("nu", full.opt_state["nu"])):
        # copies: the step updates the state's tensors in place
        sd = state_dict_from_params(tree_to(tree, dtype=torch.float32), cfg)
        out[k] = {name: np.array(v) for name, v in sd.items()}
    return out


def shard_sizes(state) -> dict:
    """Per param leaf: the full numel, the rows of a stacked leaf, and the
    numel this rank holds of the param and of each moment."""
    from clip_event_tpu_torch.engine.optim import tree_leaves

    layout = state.sharding
    out = {"specs": [(s.shape, s.rows, s.replicated) for s in layout.specs],
           "params": [t.numel() for t in tree_leaves(state.params)]}
    for k in ("mu", "nu"):
        out[k] = [t.numel() for t in tree_leaves(state.opt_state[k])]
    return out


def saved_shapes(step, state, batch) -> set:
    """The shapes of the tensors autograd keeps outside the recomputed
    regions during one step (a tensor a checkpoint saves is not seen)."""
    shapes = set()

    def pack(t):
        shapes.add(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step(state, batch)
    return shapes


def run_sharded(name: str, world: int, rank: int, b_local: int, mesh, out: str) -> dict:
    """One sharded case (module docstring): "plain" / "zero" / "fsdp" on
    "contrastive", "ot" or "multiattention" (the first seed's step;
    contrastive: its checkpoint, and under "zero" a second step first,
    with the state after each), "zero:accum_dedupe" (two microbatches),
    "zero:bf16" (bf16 first moments), "fsdp:multi_step" (two steps in one
    `make_multi_step` dispatch) and "fsdp:from_one" (a world-of-one step on
    the global batch, checkpointed, restored, sharded over the ranks and
    stepped once more)."""
    from clip_event_tpu_torch.engine import train_step as TT
    from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
    from clip_event_tpu_torch.parallel.mesh import replicate
    from clip_event_tpu_torch.parallel.sharding import shard_state

    mode, case = name.split(":")
    base = case if case in ("ot", "multiattention", "accum_dedupe") else "contrastive"
    params, cfg = init_params(base)
    opt = adam("bfloat16" if case == "bf16" else None)
    kw = dict(compute_dtype=torch.float32, remat=True, mesh=mesh, **step_kwargs(base))

    def sharded(state):
        replicate(state.params, mesh)
        return state if mode == "plain" else shard_state(state, mesh, mode)

    def rank_batch(seed):
        return _t(make_batches(base, world, b_local, seed)[1][rank])

    result = {}
    if case == "from_one":
        glob = _t(make_batches(base, world, b_local, ADAM_SEEDS[0])[0])
        one = TT.make_train_step(cfg, opt, **dict(kw, mesh=None))(TT.create_train_state(params, opt), glob)[0]
        save_checkpoint(out, "from_one", 0, one.params, one.opt_state, cfg, step=one.step)
        params, opt_state, meta, _ = restore_checkpoint(os.path.join(out, "from_one", "from_one_0"))
        state = TT.create_train_state(params, opt)._replace(opt_state=opt_state, step=meta["step"])
        state, m = TT.make_train_step(cfg, opt, **kw)(sharded(state), rank_batch(ADAM_SEEDS[1]))
        result["metrics"] = {k: float(v) for k, v in m.items()}
    elif case == "accum_dedupe":
        micro = [make_batches(case, world, b_local, 20 + k)[1][rank] for k in range(2)]
        state = sharded(TT.create_train_state(params, opt))
        step = TT.make_accum_step(cfg, opt, 2, **kw)
        state, m = step(state, _t({k: np.stack([b[k] for b in micro]) for k in micro[0]}))
        result["metrics"] = {k: float(v) for k, v in m.items()}
    elif case == "multi_step":
        state = sharded(TT.create_train_state(params, opt))
        many, _ = TT.make_multi_step(cfg, opt, 2, **kw)
        batches = [rank_batch(seed) for seed in ADAM_SEEDS[:2]]
        state, m = many(state, {k: torch.stack([b[k] for b in batches]) for k in batches[0]})
        result["metrics"] = {k: v.tolist() for k, v in m.items()}
    else:
        state = sharded(TT.create_train_state(params, opt))
        step = TT.make_train_step(cfg, opt, **kw)
        if mode != "plain":
            result["sizes"] = shard_sizes(state)
        if mode == "fsdp" and case == "contrastive":
            probe = sharded(TT.create_train_state(params, opt))
            result["saved_shapes"] = saved_shapes(step, probe, rank_batch(ADAM_SEEDS[0]))
        state, m = step(state, rank_batch(ADAM_SEEDS[0]))
        result["metrics"] = {k: float(v) for k, v in m.items()}
        if case == "contrastive":
            if mode == "zero":
                result["step1"] = state_record(state, cfg)
                state, m = step(state, rank_batch(ADAM_SEEDS[1]))
                result["metrics2"] = {k: float(v) for k, v in m.items()}
            task = name.replace(":", "_")
            save_checkpoint(out, task, 0, state.params, state.opt_state, cfg, step=state.step,
                            sharding=state.sharding)
            result["ckpt"] = os.path.join(out, task, task + "_0")
        if mode != "plain":
            result["sizes_after"] = shard_sizes(state)
    result.update(state_record(state, cfg))
    return result


def tp_batch_case(case: str) -> str:
    """The `make_batches` case of a tp case (its accumulation dedupes)."""
    return "accum_dedupe" if case == "tp/accum" else "contrastive"


def tp_sgd():
    from clip_event_tpu_torch.engine import optim as TO

    return TO.build_optimizer("sgd", TO.build_schedule("none", LR, 1), grad_clip_norm=1.0)


def tp_record(state, cfg, mesh) -> dict:
    """The full params gathered (`full_params`), and this rank's whole
    leaves (those no rank of its model group splits) as they are, as
    numpy."""
    from clip_event_tpu_torch.engine.optim import tree_leaves
    from clip_event_tpu_torch.models.convert import state_dict_from_params
    from clip_event_tpu_torch.parallel.sharding import full_params, model_layout

    full = full_params(state)
    out = {"params": {k: np.array(v) for k, v in state_dict_from_params(
        {k: v for k, v in full.items()}, cfg).items()}}
    layout = model_layout(state.sharding)
    leaves = tree_leaves(state.params)
    out["whole"] = [leaves[i].detach().numpy().copy() for i, s in enumerate(layout.specs)
                    if s.kind is None] if layout is not None else []
    out["split"] = sum(s.kind is not None for s in layout.specs) if layout is not None else 0
    out["mesh"] = (mesh.dcn_idx, mesh.dp_idx, mesh.tp_idx, mesh.data.rank, mesh.data.world_size)
    out["stage"] = (mesh.pp_idx, mesh.pp)
    return out


SAVED_SEQ = 33


def saved_activation_bytes(params, cfg, mesh) -> int:
    """The bytes autograd keeps for the backward of a forward of the vision
    stack (this rank's slices) under remat "attn", on a [2, SAVED_SEQ, W]
    stream: each storage the pack hook sees once, the params left out."""
    from clip_event_tpu_torch.engine.optim import tree_leaves
    from clip_event_tpu_torch.models import layers
    from clip_event_tpu_torch.parallel.sharding import shard_params_tp

    stack = shard_params_tp(params, cfg, mesh)["visual"]["transformer"]
    weights = {t.untyped_storage().data_ptr() for t in tree_leaves(stack)}
    x = torch.randn(2, SAVED_SEQ, cfg.vision_width, generator=torch.Generator().manual_seed(SEED),
                    requires_grad=True)
    kept = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in weights:
            kept[storage.data_ptr()] = storage.nbytes()
        return t

    with layers.tensor_parallel(mesh), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        layers.transformer(x, stack, cfg.vision_heads, remat="attn")
    return sum(kept.values())


def run_tp(name: str, world: int, rank: int, b_local: int, out: str, fixtures=None) -> dict:
    """One model-parallel case (module docstring) on the mesh `TP_MESHES`
    gives it: its data rank's rows of the global batches of `TP_SEEDS`."""
    from clip_event_tpu_torch.models import layers

    case = name.split("/", 1)[1]
    tp, dcn, sp, pp = TP_MESHES[case]
    from clip_event_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh("cpu", tp=tp, dcn=dcn, sp=sp, pp=pp)
    if case in COMPOSED:
        b_local = COMPOSED_ROWS // mesh.data.world_size
    with layers.pipeline(mesh, PP_MICROBATCHES):
        return _run_tp_case(name, case, mesh, b_local, out, fixtures)


def _run_tp_case(name, case, mesh, b_local, out, fixtures) -> dict:
    from clip_event_tpu_torch.engine import train_step as TT
    from clip_event_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
    from clip_event_tpu_torch.models import layers
    from clip_event_tpu_torch.parallel.mesh import replicate
    from clip_event_tpu_torch.parallel.pipeline import shard_state_pp
    from clip_event_tpu_torch.parallel.sharding import shard_params_tp, shard_state, shard_state_tp

    data = mesh.data
    params, cfg = init_params(name)
    base = tp_batch_case(name)
    opt = adam() if case in ADAM_CASES else tp_sgd()
    kw = dict(compute_dtype=torch.float32, remat=TP_REMAT.get(case, True), mesh=mesh, loss_type="ce")

    def rank_batch(seed):
        return _t(make_batches(base, data.world_size, b_local, seed)[1][data.rank])

    def sharded(state):
        replicate(state.params, mesh)
        if mesh.tp > 1:
            state = shard_state_tp(state, cfg, mesh)
        if mesh.pp > 1:
            state = shard_state_pp(state, mesh)
        mode = TP_SHARDED.get(case)
        return state if mode is None else shard_state(state, mesh, mode)

    result = {}
    if case == "pp_loop":
        return run_pp_loop(mesh, out, fixtures["voa"])
    if case == "evals":
        from clip_event_tpu_torch.data.m2e2 import M2E2Dataset
        from clip_event_tpu_torch.evals.m2e2 import evaluate_m2e2

        m = fixtures["m2e2"]
        ds = M2E2Dataset(m["anno_json"], m["image_dir"], m["ontology_json"], image_size=32)
        with layers.tensor_parallel(mesh):
            result["sharded"] = evaluate_m2e2(shard_params_tp(params, cfg, mesh), cfg, ds,
                                              batch_size=3, device="cpu", rank=mesh.data.rank,
                                              world_size=mesh.data.world_size)
        result["single"] = evaluate_m2e2(params, cfg, ds, batch_size=3, device="cpu", rank=0,
                                         world_size=1)
        return result
    if case in ("resume", "pp_resume"):
        glob = _t(make_batches(base, data.world_size, b_local, TP_SEEDS[0])[0])
        one = TT.make_train_step(cfg, opt, **dict(kw, mesh=None))(TT.create_train_state(params, opt), glob)[0]
        # every rank calls the save (rank 0 writes, all wait)
        task = f"{case}_from_one"
        save_checkpoint(out, task, 0, one.params, one.opt_state, cfg, step=one.step)
        params, opt_state, meta, _ = restore_checkpoint(os.path.join(out, task, f"{task}_0"))
        state = TT.create_train_state(params, opt)._replace(opt_state=opt_state, step=meta["step"])
        state, m = TT.make_train_step(cfg, opt, **kw)(sharded(state), rank_batch(TP_SEEDS[1]))
        result["metrics"] = {k: float(v) for k, v in m.items()}
        result["count"] = int(state.opt_state["count"])
    elif case == "accum":
        micro = [make_batches(base, data.world_size, b_local, 20 + k)[1][data.rank] for k in range(2)]
        state = sharded(TT.create_train_state(params, opt))
        step = TT.make_accum_step(cfg, opt, 2, **kw)
        state, m = step(state, _t({k: np.stack([b[k] for b in micro]) for k in micro[0]}))
        result["metrics"] = {k: float(v) for k, v in m.items()}
    elif case in ("multi_step", "pp_multi_step"):
        if case == "multi_step":
            result["saved"] = saved_activation_bytes(params, cfg, mesh)
        state = sharded(TT.create_train_state(params, opt))
        many, _ = TT.make_multi_step(cfg, opt, 2, **kw)
        batches = [rank_batch(seed) for seed in TP_SEEDS]
        state, m = many(state, {k: torch.stack([b[k] for b in batches]) for k in batches[0]})
        result["metrics"] = {k: v.tolist() for k, v in m.items()}
    else:
        if case == "attn":
            result["saved"] = saved_activation_bytes(params, cfg, mesh)
        state = sharded(TT.create_train_state(params, opt))
        if case in TP_SHARDED:
            result["sizes"] = shard_sizes(state)
        with layers.ln_impl("pallas" if case == "sp" else "xla"):
            state, m = TT.make_train_step(cfg, opt, **kw)(state, rank_batch(TP_SEEDS[0]))
        result["metrics"] = {k: float(v) for k, v in m.items()}
        if case == "dcn_zero":
            from clip_event_tpu_torch.engine.optim import tree_leaves

            result["moments"] = [t.numpy().copy() for k in ("mu", "nu")
                                 for t in tree_leaves(state.opt_state[k])]
        if case in ("ckpt", "pp_ckpt"):
            task = f"{case}_run"
            save_checkpoint(out, task, 0, state.params, state.opt_state, cfg, step=state.step,
                            sharding=state.sharding)
            result["ckpt"] = os.path.join(out, task, task + "_0")
            rec = state_record(state, cfg)
            result.update({k: rec[k] for k in ("mu", "nu", "count")})
    result.update(tp_record(state, cfg, mesh))
    return result


def run_pp_loop(mesh, out: str, voa: dict) -> dict:
    """The train loop (`train.train`: loader, pipeline stages, the epoch's
    validation through the pipeline, the checkpoint) at (dp 2, pp 2),
    batch 2 a data rank, and then at a world of one (no mesh) at batch 4,
    every rank running both: one epoch of the synthetic VOA corpus, Adam,
    from the same init. Returns each run's full params and rank 0's
    scalars."""
    from clip_event_tpu_torch import train as TR
    from clip_event_tpu_torch.config import validate_config
    from clip_event_tpu_torch.engine.metrics import ScalarWriter
    from clip_event_tpu_torch.models.convert import state_dict_from_params
    from clip_event_tpu_torch.parallel.sharding import full_params

    params, mcfg = init_params("tp/pp_loop")
    base = {"task": "pp_loop", "constrastive_loss": "ce", "posneg_descriptions_json": voa["descriptions_json"],
            "image_caption_json": [voa["mapping_json"]], "image_dir": [voa["image_dir"]], "max_epoch": 1,
            "lr": ADAM_LR, "optimizer": "adam", "lr_scheduler": "none", "compute_dtype": "float32",
            "remat": True, "num_workers": 2, "seed": 5, "validate_every": 1,
            "val_image_caption_json": [voa["mapping_json"]], "val_image_dir": [voa["image_dir"]],
            "pp_microbatches": PP_MICROBATCHES}
    result = {}
    for name, m, batch in (("pp", mesh, 2), ("one", None, 4)):
        root = os.path.join(out, f"pp_loop_{name}")
        cfg = validate_config(dict(base, batch_size=batch, pp=1 if m is None else m.pp,
                                   ckpt_dir=os.path.join(root, "ckpt"), tb_log_dir=os.path.join(root, "logs")))
        rank, world = (m.data.rank, m.data.world_size) if m is not None else (0, 1)
        logs = os.path.join(root, "logs", "rank0")
        writer = ScalarWriter(logs) if mesh.rank == 0 else None
        state = TR.train(cfg, mcfg, TR.build_dataset(cfg, mcfg, rank, world), params, "cpu", writer=writer,
                         mesh=m)
        result[name] = {"params": {k: np.array(v) for k, v in state_dict_from_params(full_params(state),
                                                                                    mcfg).items()}}
        if writer is not None:
            writer.close()
            with open(os.path.join(logs, "scalars.jsonl")) as fh:
                result[name]["scalars"] = [json.loads(line) for line in fh]
        result[name]["ckpt"] = os.path.join(cfg["ckpt_dir"], "pp_loop", "pp_loop_0")
    return result


def comm_checks(rank: int, world: int) -> None:
    """The JAX package's multi-process assertions (tests/test_multiprocess.py
    `_WORKER`) on the port's collectives, and `any_rank`."""
    from clip_event_tpu_torch.engine.metrics import SmoothedValue
    from clip_event_tpu_torch.parallel.collectives import all_gather_objects, any_rank, comm, reduce_dict

    assert comm.world_size == world and comm.rank == rank
    assert comm.is_main_process == (rank == 0)
    out = reduce_dict({"loss": float(rank + 1), "acc": 10.0 * (rank + 1)}, average=True)
    assert abs(out["loss"] - (world + 1) / 2) < 1e-6, out
    assert abs(out["acc"] - 10.0 * (world + 1) / 2) < 1e-6, out
    out = reduce_dict({"n": float(rank + 1)}, average=False)
    assert abs(out["n"] - world * (world + 1) / 2) < 1e-6, out
    objs = all_gather_objects({"rank": rank, "payload": "x" * (10 + 100 * rank)})
    assert [o["rank"] for o in objs] == list(range(world)), objs
    assert len(objs[1]["payload"]) == 110, objs
    meter = SmoothedValue()
    for v in range(3):  # rank r sees 10r, 10r + 1, 10r + 2
        meter.update(10.0 * rank + v)
    meter.synchronize_between_processes()
    assert meter.count == 3 * world
    want = sum(10.0 * r + v for r in range(world) for v in range(3)) / (3 * world)
    assert abs(meter.global_avg - want) < 1e-6
    assert any_rank(rank == world - 1) and not any_rank(False)
    comm.synchronize()


def run_evals(fixtures: dict):
    """The M2E2 eval (plain and with the threshold sweep) and the matching
    eval, sharded by the process group, and the same calls on one shard."""
    from clip_event_tpu_torch.data.m2e2 import M2E2Dataset
    from clip_event_tpu_torch.data.voa import VOACaptionDataset
    from clip_event_tpu_torch.evals.m2e2 import evaluate_m2e2
    from clip_event_tpu_torch.evals.matching import evaluate_matching

    params, cfg = init_params("evals")
    m, v = fixtures["m2e2"], fixtures["voa"]
    m2e2 = M2E2Dataset(m["anno_json"], m["image_dir"], m["ontology_json"], image_size=32)
    voa = VOACaptionDataset([v["mapping_json"]], [v["image_dir"]], image_size=32)
    out = {}
    for name, fn, ds, kw in (
        ("m2e2", evaluate_m2e2, m2e2, {}),
        ("m2e2_sweep", evaluate_m2e2, m2e2, {"select_null_threshold": True}),
        ("matching", evaluate_matching, voa, {}),
    ):
        out[name] = (fn(params, cfg, ds, batch_size=3, device="cpu", **kw),
                     fn(params, cfg, ds, batch_size=3, device="cpu", rank=0, world_size=1, **kw))
    return out


def run_embed_case(fixtures: dict, out_dir: str, texts):
    from clip_event_tpu_torch.embed import run_embed

    params, cfg = init_params("embed")
    return run_embed({"output_dir": out_dir, "image_dir": fixtures["m2e2"]["image_dir"],
                      "texts": list(texts), "batch_size": 2, "shard_size": 2, "num_workers": 2},
                     params, cfg, device="cpu")


def main(rank: int, world: int, out: str, cases, b_local: int, fixtures=None, texts=()):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), world),
                            rank=rank, world_size=world)
    from clip_event_tpu_torch.parallel.mesh import make_mesh

    try:
        mesh = make_mesh("cpu")
        results = {"mesh": (mesh.rank, mesh.world_size, str(mesh.device))}
        for case in cases:
            if case == "comm":
                comm_checks(rank, world)
                results["comm"] = "ok"
            elif case == "evals":
                results["evals"] = run_evals(fixtures)
            elif case == "embed":
                results["embed"] = run_embed_case(fixtures, os.path.join(out, "embed"), texts)
            elif case.startswith("tp/"):
                results[case] = run_tp(case, world, rank, b_local, out, fixtures)
            elif ":" in case:
                results[case] = run_sharded(case, world, rank, b_local, mesh, out)
            else:
                results[case] = run_step(case, world, rank, b_local, mesh)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()
