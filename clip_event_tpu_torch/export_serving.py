"""Export a CLIP-Event model as a serving bundle (counterpart of the repo's
`export_serving.py`).

    python -m clip_event_tpu_torch.export_serving --cfg eval_config.json --out bundle_dir/
    python -m clip_event_tpu_torch.export_serving --cfg eval_config.json --out bundle_dir/ --device cpu

The config takes the eval CLIs' keys (`ckpt`, a torch state-dict file in
OpenAI naming, or a `model` preset with `seed`), `compute_dtype`
("float32" or "bfloat16"), and `"quantize": "int8" | "int8_static"` with
`"quantize_towers"` and, for `int8_static`, the `calibration_*` keys. The
bundle holds batch-polymorphic `torch.export` programs, the weights and
their metadata (`engine/export.py`). The export traces on `--device` (the
card unless `--device cpu`); the bundle serves on either:

    from clip_event_tpu_torch.engine.export import load_serving_bundle
    m = load_serving_bundle("bundle_dir/")            # device="cpu" on the CPU
    feats = m.encode_image(images)                    # any batch size
"""

from __future__ import annotations


def main(argv=None):
    import argparse
    import json
    import logging

    import torch

    from clip_event_tpu_torch.engine.export import save_serving_bundle
    from clip_event_tpu_torch.evals.cli import calibration_batches_from_cfg, load_model_from_cfg
    from clip_event_tpu_torch.ops.quant import calibrate_act_scales

    parser = argparse.ArgumentParser(description="Export a serving bundle")
    parser.add_argument("--cfg", type=str, required=True, help="model config JSON")
    parser.add_argument("--out", type=str, required=True, help="bundle output dir")
    parser.add_argument(
        "--context", type=int, default=0,
        help="export the text encoder at this static token width instead of the model's "
        "(exact for texts whose EOT fits)",
    )
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    with open(args.cfg) as fh:
        cfg = json.load(fh)
    # the exporter quantizes (the programs are traced on the quantized
    # tree), so the loader must not: take the keys out first
    quantize = cfg.pop("quantize", None)
    quantize_towers = cfg.pop("quantize_towers", None)
    model, mcfg = load_model_from_cfg(cfg, args.device)
    params = model.params()
    act_stats = None
    if quantize == "int8_static":
        imgs, toks = calibration_batches_from_cfg(cfg, mcfg)
        act_stats = calibrate_act_scales(params, mcfg, imgs, toks)
    dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else torch.float32
    out = save_serving_bundle(args.out, params, mcfg, compute_dtype=dtype, context=args.context or None,
                              quantize=quantize, quantize_towers=quantize_towers, act_stats=act_stats)
    print(f"serving bundle written to {out}")


if __name__ == "__main__":
    main()
