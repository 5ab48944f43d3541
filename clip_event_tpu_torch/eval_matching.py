"""Zero-shot image↔caption matching CLI (counterpart of the repo's
`eval_matching.py`).

`python -m clip_event_tpu_torch.eval_matching --cfg <json> [--device cpu]`.
Config keys: dataset ∈ {voa, meed}, ckpt, [model, seed, batch_size,
output_json]; voa: image_caption_json[] + image_dir[]; meed: anno_json +
image_dir + prompt.
"""

from __future__ import annotations


def evaluate(cfg, model, mcfg, device):
    from clip_event_tpu_torch.evals.matching import evaluate_matching

    kind = cfg.get("dataset", "voa")
    if kind == "voa":
        from clip_event_tpu_torch.data.voa import VOACaptionDataset

        dataset = VOACaptionDataset(
            image_caption_jsons=cfg["image_caption_json"],
            image_dirs=cfg["image_dir"],
            image_size=mcfg.image_resolution,
        )
    elif kind == "meed":
        from clip_event_tpu_torch.data.meed import MEEDDataset

        dataset = MEEDDataset(
            anno_json=cfg["anno_json"],
            image_dir=cfg["image_dir"],
            prompt=cfg.get("prompt", "verbprefix"),
            image_size=mcfg.image_resolution,
        )
    else:
        raise ValueError("dataset must be 'voa' or 'meed'")
    return evaluate_matching(
        model, mcfg, dataset, batch_size=cfg.get("batch_size", 32), device=device,
        rank=cfg.get("rank"), world_size=cfg.get("world_size"),
    )


if __name__ == "__main__":
    from clip_event_tpu_torch.evals.cli import run

    run("Zero-shot image-caption matching", evaluate)
