"""Batch embedding export — the serving/indexing surface (counterpart of
`clip_event_tpu/embed.py`).

Streams a corpus (image files and/or text lines) through the normalized
encoders and writes sharded `.npz` files of unit-norm float32 features plus
their ids, and a `manifest.json`. Host threads decode the next batches
while the card encodes the current one; batches have a fixed size. Under a
multi-process launch each rank encodes its rank-strided slice and writes
rank-tagged shards (`<kind>-rNN-NNNNN.npz`); the loader's wrap-around rows
are dropped, the ranks' manifests are merged, and rank 0 writes the one
`manifest.json`.

CLI: `python -m clip_event_tpu_torch.embed --cfg <json> [--device cpu]`,
with the config keys of `run_embed` plus the model keys (`ckpt` or
`model`, `seed`).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Sequence

import numpy as np

from clip_event_tpu_torch.data.common import DataLoader, ExampleDataset, load_image_file

log = logging.getLogger(__name__)

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFilesDataset(ExampleDataset):
    """Every image file under the given dirs (or an explicit list).

    Ids are the filename stems when those are unique across the corpus;
    otherwise the full path is used, so two `photo_001.jpg` in different
    dirs never collide in the exported index."""

    def __init__(self, image_dirs: Sequence[str] = (), image_files: Sequence[str] = (),
                 image_size: int = 224):
        files: List[str] = list(image_files)
        for d in image_dirs:
            for name in sorted(os.listdir(d)):
                if name.lower().endswith(_IMAGE_EXTS):
                    files.append(os.path.join(d, name))
        if not files:
            raise ValueError("no image files found")
        self.files = files
        stems = [os.path.splitext(os.path.basename(p))[0] for p in files]
        self.ids = stems if len(set(stems)) == len(stems) else files
        self.image_size = image_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        path = self.files[idx]
        image = load_image_file(path, self.image_size)
        return {"image": image}, {"id": self.ids[idx], "path": path}


def _write_shard(out_dir: str, kind: str, tag: str, shard_idx: int,
                 ids: List[str], feats: List[np.ndarray]) -> str:
    path = os.path.join(out_dir, f"{kind}-{tag}{shard_idx:05d}.npz")
    np.savez_compressed(
        path,
        ids=np.asarray(ids),
        features=np.concatenate(feats).astype(np.float32),
    )
    return path


def embed_stream(dataset, enc, field: str, kind: str, out_dir: str,
                 shard_size: int, batch_size: int, num_workers: int = 8,
                 id_key: str = "id", rank: int = 0, world_size: int = 1) -> Dict:
    """Encode `dataset` and write `<kind>-NNNNN.npz` shards of (ids, features).

    Constant host memory: at most one shard of features is resident. With
    `world_size` > 1 this rank encodes its rank-strided slice and writes
    `<kind>-rNN-NNNNN.npz` shards, without the loader's wrap-around rows
    (no gather: the export is embarrassingly parallel). Returns this
    rank's manifest entry for the stream."""
    from clip_event_tpu_torch.evals.common import genuine_rows

    os.makedirs(out_dir, exist_ok=True)
    loader = DataLoader(
        dataset, batch_size=min(batch_size, len(dataset)), shuffle=False, drop_last=False,
        num_workers=num_workers, rank=rank, world_size=world_size,
    )
    tag = f"r{rank:02d}-" if world_size > 1 else ""
    encode = enc.images if kind == "image" else enc.texts
    ids: List[str] = []
    feats: List[np.ndarray] = []
    shards: List[str] = []
    count = 0
    dim = None
    offset = 0
    for batch, metas in loader:
        f = encode(np.asarray(batch[field]))
        dim = f.shape[-1]
        genuine = genuine_rows(rank, world_size, offset, f.shape[0], len(dataset))
        offset += f.shape[0]
        f = f[genuine]
        metas = [m for m, g in zip(metas, genuine) if g]
        feats.append(f)
        ids.extend(str(m[id_key]) for m in metas)
        count += f.shape[0]
        while len(ids) >= shard_size:
            buf = np.concatenate(feats)
            shards.append(
                _write_shard(out_dir, kind, tag, len(shards), ids[:shard_size], [buf[:shard_size]])
            )
            rest = buf[shard_size:]
            ids, feats = ids[shard_size:], ([rest] if rest.size else [])
    if ids:
        shards.append(_write_shard(out_dir, kind, tag, len(shards), ids, feats))
    return {
        "kind": kind, "count": count, "dim": int(dim or 0),
        "shards": [os.path.basename(s) for s in shards],
        "normalized": True, "dtype": "float32",
    }


def run_embed(cfg: dict, params, mcfg, device="cuda") -> dict:
    """Config contract (the JAX embed CLI's):

      output_dir            where shards + manifest.json land (required)
      image_dir / image_files   images to embed (either/both, optional)
      text_file             one text per line (optional)
      texts                 inline list of strings (optional)
      batch_size (64), shard_size (50000), num_workers (8)
      length_buckets        e.g. [32, 48]: encode each text at the
                            narrowest listed static width that fits its
                            EOT (lossless; shards are width-tagged
                            text-wNN-*.npz)
      rank / world_size     the shard of this process (default: its place
                            in the process group; (0, 1) without one)
    """
    from clip_event_tpu_torch.data.text import TextDataset
    from clip_event_tpu_torch.evals.common import Encoders, resolve_shard
    from clip_event_tpu_torch.parallel.collectives import all_gather_objects

    rank, world_size = resolve_shard(cfg.get("rank"), cfg.get("world_size"))
    out_dir = cfg["output_dir"]
    batch = cfg.get("batch_size", 64)
    shard = cfg.get("shard_size", 50000)
    workers = cfg.get("num_workers", 8)
    enc = Encoders(params, mcfg, batch_size=batch, device=device)

    manifests = {}
    image_dirs = cfg.get("image_dir", [])
    if isinstance(image_dirs, str):
        image_dirs = [image_dirs]
    image_files = cfg.get("image_files", [])
    if isinstance(image_files, str):
        image_files = [image_files]
    if image_dirs or image_files:
        ds = ImageFilesDataset(image_dirs, image_files, mcfg.image_resolution)
        log.info("embedding %d images", len(ds))
        manifests["images"] = embed_stream(ds, enc, "image", "image", out_dir, shard, batch, workers,
                                           rank=rank, world_size=world_size)

    texts = list(cfg.get("texts", []))
    if cfg.get("text_file"):
        with open(cfg["text_file"]) as fh:
            texts += [line.rstrip("\n") for line in fh if line.strip()]
    if texts:
        buckets = sorted({int(w) for w in cfg.get("length_buckets", [])})
        groups = [(texts, 0)]
        if buckets:
            # encode each text at the narrowest listed static width that
            # fits its EOT (never truncated; over-long → the implicit
            # full-width group); ids travel with features, so a plain
            # partition suffices
            from clip_event_tpu_torch.tokenizer import CONTEXT_LENGTH, tokenize

            widths = np.argmax(tokenize(texts), axis=-1) + 1
            caps = [w for w in buckets if w < CONTEXT_LENGTH] + [CONTEXT_LENGTH]
            assign = np.searchsorted(caps, widths)
            groups = [
                ([t for t, a in zip(texts, assign) if a == bi], cap)
                for bi, cap in enumerate(caps)
            ]
            groups = [(g, cap) for g, cap in groups if g]
            log.info("length_buckets %s: group sizes %s", caps, [len(g) for g, _ in groups])
        merged = None
        for group_texts, cap in groups:
            ds = TextDataset(group_texts, context=cap)
            log.info("embedding %d texts (width %s)", len(ds), cap or "full")
            m = embed_stream(
                ds, enc, "text", f"text-w{cap}" if cap else "text",
                out_dir, shard, batch, workers, id_key="text", rank=rank, world_size=world_size,
            )
            if merged is None:
                merged = m
            else:
                merged["count"] += m["count"]
                merged["shards"] += m["shards"]
        merged["kind"] = "text"
        manifests["texts"] = merged

    if not manifests:
        raise ValueError("nothing to embed: give image_dir/image_files, text_file, or texts")
    if world_size > 1:
        # the ranks' manifests merged: every rank returns the global one
        merged_all: Dict[str, Dict] = {}
        for rank_manifests in all_gather_objects(manifests):
            for k, m in rank_manifests.items():
                if k not in merged_all:
                    merged_all[k] = dict(m, count=0, shards=[])
                merged_all[k]["count"] += m["count"]
                merged_all[k]["shards"] += m["shards"]
        manifests = merged_all
    if rank == 0:
        with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
            json.dump(manifests, fh, indent=2)
    return {k: {"count": m["count"], "shards": len(m["shards"]), "dim": m["dim"]}
            for k, m in manifests.items()}


if __name__ == "__main__":
    from clip_event_tpu_torch.evals.cli import run

    run("Batch embedding export", run_embed)
