"""Offline description-generation pipeline of the port (counterpart of the
root `preprocess_descriptions.py`; reference
`src/preprocess/preprocess_description_contrastive.py` __main__, :536-571):

    python -m clip_event_tpu_torch.preprocess_descriptions --cfg cfg.json [--device cpu]

Steps, all config-driven (no hard-coded cluster paths):
  1. caption cleanup → image_caption_clean.json
  2. ColdStart load + salient-event selection (optionally CLIP-ranked)
     → doc_ke/entity_info/evt_info/evt_args/doc_salient_event jsons
  3. pos/neg template generation → descriptions_<pos>_<neg>.json

Config keys (the JAX CLI's):
  output_dir, cs_inputs: [[path, suffix], ...], image_caption_json: [...],
  template_file, positive_option: [...], negative_option: [...],
  [add_clip_sim, clip_ckpt, model, type_descriptions_json, image_dirs:
   {doc_prefix: dir}, clip_cache_dir, merge_args, neg_num, use_rolename,
   sample_neg_arg, seed]

The output files have the JAX CLI's names and bytes. With `add_clip_sim`
the CLIP type scorer (`preprocess/selection.py`) runs the fp32 encoders on
the card, where every block of both towers runs K1's forward; the default
device is the card, and with no card and no `--device cpu` the CLI raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import os


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Generate contrastive descriptions")
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    with open(args.cfg) as fh:
        cfg = json.load(fh)

    from clip_event_tpu_torch.platform import resolve_device

    device = resolve_device(args.device)

    from clip_event_tpu_torch.preprocess.ke import load_cs_files
    from clip_event_tpu_torch.preprocess.selection import (
        ClipTypeScorer,
        preprocess_caption,
        select_salient_events,
    )
    from clip_event_tpu_torch.preprocess.templates import (
        generate_descriptions,
        write_descriptions,
    )

    output_dir = cfg["output_dir"]
    os.makedirs(output_dir, exist_ok=True)

    # 1. captions
    doc_caption = preprocess_caption(cfg["image_caption_json"])
    with open(os.path.join(output_dir, "image_caption_clean.json"), "w") as fh:
        json.dump(doc_caption, fh, indent=4)

    # 2. knowledge elements + salient events
    store = load_cs_files([tuple(x) for x in cfg["cs_inputs"]])

    scorer = None
    image_paths = {}
    add_clip_sim = cfg.get("add_clip_sim", False)
    if add_clip_sim:
        from clip_event_tpu_torch.evals.cli import load_model_from_cfg

        model, mcfg = load_model_from_cfg(
            {"ckpt": cfg.get("clip_ckpt"), "model": cfg.get("model", "ViT-B/32")}, device
        )
        with open(cfg["type_descriptions_json"]) as fh:
            type_desc = json.load(fh)
        type_desc = {
            t: (v["desc_auto_name"] if isinstance(v, dict) else v)
            for t, v in type_desc.items()
        }
        scorer = ClipTypeScorer(
            model, mcfg, type_desc, cache_dir=cfg.get("clip_cache_dir"), device=device
        )
        image_dirs = cfg.get("image_dirs", {})
        for doc_id in store["doc_ke"]:
            prefix = doc_id[:14]
            if prefix in image_dirs:
                image_paths[doc_id] = os.path.join(image_dirs[prefix], doc_id + ".jpg")

    merge_args = cfg.get("merge_args", True)
    salient = select_salient_events(
        store, scorer=scorer, image_paths=image_paths, merge_args=merge_args
    )

    def dump(name, obj):
        with open(os.path.join(output_dir, name), "w") as fh:
            json.dump(obj, fh, indent=4, default=list)

    dump("doc_ke.json", {k: dict(v) for k, v in store["doc_ke"].items()})
    dump("entity_info.json", dict(store["entity_info"]))
    dump("evt_info.json", dict(store["evt_info"]))
    dump("evt_args.json", {k: {r: dict(a) for r, a in v.items()} for k, v in store["evt_args"].items()})
    dump(f"doc_salient_event_{add_clip_sim}_merge{merge_args}.json", salient)

    # 3. descriptions
    pos_opt = cfg["positive_option"]
    neg_opt = cfg["negative_option"]
    with open(cfg["template_file"]) as fh:
        templates = json.load(fh)
    descriptions = generate_descriptions(
        pos_opt,
        neg_opt,
        templates,
        salient,
        doc_caption,
        neg_num=cfg.get("neg_num", 1),
        use_rolename=cfg.get("use_rolename", True),
        sample_neg_arg=cfg.get("sample_neg_arg", False),
        seed=cfg.get("seed", 999),
    )
    out_path = os.path.join(
        output_dir, "descriptions_%s_%s.json" % ("".join(pos_opt), "".join(neg_opt))
    )
    write_descriptions(descriptions, out_path)
    logging.info("wrote %d image descriptions to %s", len(descriptions), out_path)


if __name__ == "__main__":
    main()
