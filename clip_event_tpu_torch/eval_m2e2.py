"""Zero-shot M2E2 multimedia event extraction CLI (counterpart of the
repo's `eval_m2e2.py`) under the M2E2 per-mention P/R/F1 protocol
(`evals/m2e2.py`).

`python -m clip_event_tpu_torch.eval_m2e2 --cfg <json> [--device cpu]`.
Config keys: image_anno, image_dir, ie_ontology_json, ckpt, [model, seed,
batch_size, image_suffix, image_list, null_threshold,
select_null_threshold, ground_arguments, arg_topk, iou_threshold,
quantize, quantize_towers, calibration_*, output_json].
"""

from __future__ import annotations


def evaluate(cfg, model, mcfg, device):
    from clip_event_tpu_torch.data.m2e2 import M2E2Dataset
    from clip_event_tpu_torch.evals.m2e2 import evaluate_m2e2

    dataset = M2E2Dataset(
        image_anno=cfg["image_anno"],
        image_dir=cfg["image_dir"],
        ie_ontology_json=cfg["ie_ontology_json"],
        image_list=cfg.get("image_list"),
        image_suffix=cfg.get("image_suffix", ".jpg"),
        image_size=mcfg.image_resolution,
    )
    return evaluate_m2e2(
        model, mcfg, dataset,
        batch_size=cfg.get("batch_size", 32),
        null_threshold=cfg.get("null_threshold"),
        select_null_threshold=cfg.get("select_null_threshold", False),
        ground_arguments=cfg.get("ground_arguments", False),
        arg_topk=cfg.get("arg_topk", 4),
        iou_threshold=cfg.get("iou_threshold", 0.5),
        device=device, rank=cfg.get("rank"), world_size=cfg.get("world_size"),
    )


if __name__ == "__main__":
    from clip_event_tpu_torch.evals.cli import run

    run("Zero-shot M2E2 evaluation", evaluate)
