"""The rank processes of tests/test_torch_multiprocess.py (not a test file:
the test spawns these with `torch.multiprocessing`).

Imports torch, numpy and the port only, so a rank starts in a few seconds.
The batches are built here from numpy seeds, for the ranks and, as one
global batch, for the test's JAX reference; the weights come from the
port's init (the test carries them to JAX through the state dict). Every
rank joins a gloo group over a FileStore, runs the cases it is given and
pickles what it measured to `<out>/rank<r>.pkl`.
"""

from __future__ import annotations

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


def model_dict(case: str) -> dict:
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
            else:
                results[case] = run_step(case, world, rank, b_local, mesh)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()
