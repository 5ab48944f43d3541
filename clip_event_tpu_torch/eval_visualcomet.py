"""Zero-shot VisualCOMET CLI (counterpart of the repo's
`eval_visualcomet.py`).

`python -m clip_event_tpu_torch.eval_visualcomet --cfg <json> [--device cpu]`.
Config keys: anno_json, image_dir, ckpt, [field ∈ {event, intent, before,
after}, prompt, model, seed, batch_size, quantize, quantize_towers,
calibration_*, output_json].
"""

from __future__ import annotations


def evaluate(cfg, model, mcfg, device):
    from clip_event_tpu_torch.data.visualcomet import VisualCOMETDataset
    from clip_event_tpu_torch.evals.visualcomet import evaluate_visualcomet

    dataset = VisualCOMETDataset(
        anno_json=cfg["anno_json"],
        image_dir=cfg["image_dir"],
        field=cfg.get("field", "event"),
        prompt=cfg.get("prompt", ""),
        image_size=mcfg.image_resolution,
    )
    return evaluate_visualcomet(model, mcfg, dataset, batch_size=cfg.get("batch_size", 32),
                                device=device, rank=cfg.get("rank"), world_size=cfg.get("world_size"))


if __name__ == "__main__":
    from clip_event_tpu_torch.evals.cli import run

    run("Zero-shot VisualCOMET evaluation", evaluate)
