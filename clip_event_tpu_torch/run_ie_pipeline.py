"""Raw VOA corpus → IE artifacts → contrastive descriptions, end to end (the
port's counterpart of the root `run_ie_pipeline.py`, on its own copy of the
runner, `preprocess/ie_pipeline.py`).

The missing on-ramp the reference only documents across three bash scripts
(`pipeline_full_en.sh`, `multimedia.sh`, `set_up_m36.sh`): this runner takes
a corpus directory (ltf/rsd text + vision/ images), drives the dockerized IE
stages (or prints their exact commands on hosts without docker), and tells
you how to finish with `clip_event_tpu_torch.preprocess_descriptions`.
It runs no model: nothing of it touches the card.

Usage:
    python -m clip_event_tpu_torch.run_ie_pipeline --data-root /corpora/voa2017 --plan
    python -m clip_event_tpu_torch.run_ie_pipeline --data-root /corpora/voa2017 --execute \
        --stages setup text-ie vision-ie
"""

import argparse
import logging


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data-root", required=True,
                        help="corpus dir with ltf/, rsd/, vision/ subdirs")
    parser.add_argument("--cu-toolbox", default="",
                        help="CU grounding toolbox checkout (vision-ie stage)")
    parser.add_argument("--edl-data", default="",
                        help="EDL KB directory (setup stage)")
    parser.add_argument("--stages", nargs="*", default=None,
                        help="subset of: setup preprocess oneie entity fillers "
                        "event merge aif vision-ie (or 'text-ie' for the full "
                        "text chain; default all)")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--plan", action="store_true",
                      help="print the docker commands without running (default)")
    mode.add_argument("--execute", action="store_true",
                      help="actually run the docker stages")
    args = parser.parse_args(argv)

    from clip_event_tpu_torch.preprocess.ie_pipeline import run

    ok = run(
        args.data_root,
        cu_toolbox=args.cu_toolbox,
        edl_data=args.edl_data,
        stages=args.stages,
        dry_run=not args.execute,
    )
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
