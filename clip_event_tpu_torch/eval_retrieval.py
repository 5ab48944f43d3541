"""Image–text retrieval CLI on COCO (Karpathy) or Flickr30k (counterpart of
the repo's `eval_retrieval.py`).

`python -m clip_event_tpu_torch.eval_retrieval --cfg <json> [--device cpu]`.
Config keys: dataset ∈ {coco, flickr}, ckpt, [model, seed, batch_size,
quantize, quantize_towers, calibration_*, output_json]; coco: caption_file
+ image_dir [+ prompt]; flickr: split_list + caption_file + image_dir.
"""

from __future__ import annotations


def evaluate(cfg, model, mcfg, device):
    from clip_event_tpu_torch.data.retrieval import COCODataset, FlickrDataset
    from clip_event_tpu_torch.evals.retrieval import evaluate_retrieval

    kind = cfg.get("dataset", "coco")
    if kind == "coco":
        dataset = COCODataset(
            caption_file=cfg["caption_file"],
            image_dir=cfg["image_dir"],
            prompt=cfg.get("prompt", "An photo of"),
            image_size=mcfg.image_resolution,
        )
    elif kind == "flickr":
        dataset = FlickrDataset(
            split_list=cfg["split_list"],
            caption_file=cfg["caption_file"],
            image_dir=cfg["image_dir"],
            image_size=mcfg.image_resolution,
        )
    else:
        raise ValueError("dataset must be 'coco' or 'flickr'")
    return evaluate_retrieval(model, mcfg, dataset, batch_size=cfg.get("batch_size", 32), device=device,
                              rank=cfg.get("rank"), world_size=cfg.get("world_size"))


if __name__ == "__main__":
    from clip_event_tpu_torch.evals.cli import run

    run("Image-text retrieval evaluation", evaluate)
