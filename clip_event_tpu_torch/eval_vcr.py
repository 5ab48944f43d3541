"""Zero-shot VCR CLI (counterpart of the repo's `eval_vcr.py`).

`python -m clip_event_tpu_torch.eval_vcr --cfg <json> [--device cpu]`.
Config keys: qa_jsonl, image_dir, ckpt, [rationale, model, seed,
batch_size, quantize, quantize_towers, calibration_*, output_json]. Q→A
accuracy, or QA→R with rationale=true.
"""

from __future__ import annotations


def evaluate(cfg, model, mcfg, device):
    from clip_event_tpu_torch.data.vcr import VCRDataset
    from clip_event_tpu_torch.evals.vcr import evaluate_vcr

    dataset = VCRDataset(
        qa_jsonl=cfg["qa_jsonl"],
        image_dir=cfg["image_dir"],
        rationale=cfg.get("rationale", False),
        image_size=mcfg.image_resolution,
    )
    return evaluate_vcr(model, mcfg, dataset, batch_size=cfg.get("batch_size", 32), device=device,
                        rank=cfg.get("rank"), world_size=cfg.get("world_size"))


if __name__ == "__main__":
    from clip_event_tpu_torch.evals.cli import run

    run("Zero-shot VCR evaluation", evaluate)
