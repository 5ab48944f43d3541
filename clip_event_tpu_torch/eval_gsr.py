"""Zero-shot GSR/SWiG eval CLI (counterpart of the repo's `eval_gsr.py`):
verb classification, argument grounding and the imSitu/SWiG noun metrics
(value, value-all, grounded-value[-all]; `evals/gsr.py`).

`python -m clip_event_tpu_torch.eval_gsr --cfg <json> [--device cpu]`.
Config keys: anno_json, image_dir, ontology_json, ckpt, [prompt, model,
seed, batch_size, max_roles, load_object, object_detection,
object_class_map, object_threshold, object_topk, ground_topk, ground_via,
value_metrics, iou_threshold, use_pallas_attention, quantize,
quantize_towers, calibration_*, output_json].
"""

from __future__ import annotations


def evaluate(cfg, model, mcfg, device):
    from clip_event_tpu_torch.data.sr import GSRDataset
    from clip_event_tpu_torch.evals.gsr import evaluate_gsr

    dataset = GSRDataset(
        anno_json=cfg["anno_json"],
        image_dir=cfg["image_dir"],
        ontology_json=cfg["ontology_json"],
        prompt=cfg.get("prompt", "name"),
        max_roles=cfg.get("max_roles", 6),
        load_object=cfg.get("load_object", False),
        object_detection=cfg.get("object_detection"),
        object_class_map=cfg.get("object_class_map"),
        object_threshold=cfg.get("object_threshold", 0.2),
        object_topk=cfg.get("object_topk", 40),
        image_size=mcfg.image_resolution,
    )
    return evaluate_gsr(
        model, mcfg, dataset,
        batch_size=cfg.get("batch_size", 32),
        ground_topk=cfg.get("ground_topk", 4),
        ground_via=cfg.get("ground_via", "grid"),
        value_metrics=cfg.get("value_metrics", True),
        iou_threshold=cfg.get("iou_threshold", 0.5),
        device=device,
    )


if __name__ == "__main__":
    from clip_event_tpu_torch.evals.cli import run

    run("Zero-shot GSR/SWiG evaluation", evaluate)
