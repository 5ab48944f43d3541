"""IE-result visualization: paginated HTML pages per image (the port's own
copy of `clip_event_tpu/tools/visualization.py`, byte for byte the same
pages; reference `data/voa/visualization.py:22-124`).

Per image (sorted by event count, `page_limit` images per page): the
extracted events with types and arguments, optional OpenIE triples, and the
source images. Paths are all arguments — the reference hard-coded cluster
paths and an out-of-repo `LTF_util`; context snippets here come from the
caption mapping instead of LTF files (pass `captions`). It runs no model:
nothing of it touches the card.

    python -m clip_event_tpu_torch.tools.visualization --cfg cfg.json
"""

from __future__ import annotations

import html as html_lib
import json
import logging
import os
from collections import defaultdict
from typing import Dict, Optional, Sequence

from clip_event_tpu_torch.data.coldstart import load_ie_index

log = logging.getLogger(__name__)

_PAGE_HEAD = "<!DOCTYPE html>\n<html>\n<head>\n<title>CLIP-Event IE</title>\n</head>\n<body>\n"
_PAGE_TAIL = "</body>\n</html>\n"


def load_openie_tab(path: str) -> Dict[str, list]:
    """openie.tab rows: file, sent, subj, rel, obj → {image_id: [triples]}"""
    out = defaultdict(list)
    with open(path) as fh:
        for line in fh:
            tabs = line.rstrip("\n").split("\t")
            if len(tabs) < 5:
                continue
            image_id = tabs[0].split("/")[-1].replace(".rsd.txt", "")
            out[image_id].append(f"({tabs[2]}, {tabs[3]}, {tabs[4]})")
    return out


def render_ie_pages(
    entity_cs: Sequence[str],
    event_cs: Sequence[str],
    output_dir: str,
    captions: Optional[Dict[str, str]] = None,
    image_urls: Optional[Dict[str, list]] = None,
    openie_tab: Optional[str] = None,
    page_limit: int = 50,
) -> int:
    """Write voa_events_<n>.html pages; returns the number of images shown."""
    os.makedirs(output_dir, exist_ok=True)
    index = load_ie_index(entity_cs, event_cs)
    openie = load_openie_tab(openie_tab) if openie_tab else {}
    captions = captions or {}
    image_urls = image_urls or {}

    docs = sorted(
        index.doc_events.items(), key=lambda kv: len(kv[1]), reverse=True
    )
    pages: Dict[int, list] = defaultdict(list)
    for count, (image_id, events) in enumerate(docs):
        chunks = [f"<b>{html_lib.escape(image_id)}</b>: \n<br>"]
        if image_id in captions:
            chunks.append(f"<i>{html_lib.escape(captions[image_id])}</i>\n<br>")
        chunks.append("<b>============== IE ================</b>: \n<br>")
        for event_id in events:
            etype = index.event_type.get(event_id, "?")
            mentions = ", ".join(sorted(index.event_mentions.get(event_id, [])))
            chunks.append(
                f'<span style="color:red">{html_lib.escape(event_id)}: '
                f"{html_lib.escape(etype)}</span>, {html_lib.escape(mentions)}\n<br>"
            )
            for role, args in index.event_arguments.get(event_id, {}).items():
                names = ", ".join(
                    f"{a}:{index.entity_name.get(a, '?')}" for a in sorted(args)
                )
                chunks.append(
                    f"[Argument] {html_lib.escape(role)}={html_lib.escape(names)}\n<br>"
                )
        if openie:
            chunks.append("<b>============== OpenIE ================</b>: \n<br>")
            for triple in openie.get(image_id.replace(".", "_"), []):
                chunks.append(f"{html_lib.escape(triple)}\n<br>")
        urls = image_urls.get(image_id, [])
        if urls:
            chunks.append("<b>============== Images ================</b>: \n<br>")
            for url in urls:
                chunks.append(f'<img src="{html_lib.escape(url)}" width="300">\n<br>')
        chunks.append("\n<br><br><br>")
        pages[count // page_limit].append("".join(chunks))

    for page, blocks in pages.items():
        path = os.path.join(output_dir, f"voa_events_{page}.html")
        with open(path, "w") as fh:
            fh.write(_PAGE_HEAD)
            fh.write("\n".join(blocks))
            fh.write(_PAGE_TAIL)
    log.info("wrote %d pages for %d images to %s", len(pages), len(docs), output_dir)
    return len(docs)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Render IE visualization HTML")
    parser.add_argument("--cfg", required=True, help="JSON: entity_cs[], event_cs[], output_dir, [caption_clean_json, image_caption_json, openie_tab, page_limit]")
    args = parser.parse_args(argv)
    cfg = json.load(open(args.cfg))

    captions = None
    if cfg.get("caption_clean_json"):
        captions = json.load(open(cfg["caption_clean_json"]))
    image_urls = None
    if cfg.get("image_caption_json"):
        image_urls = defaultdict(list)
        data = json.load(open(cfg["image_caption_json"]))
        for doc_id in data:
            for idx in data[doc_id]:
                image_urls[f"{doc_id}_{idx}".replace(".", "_")].append(
                    data[doc_id][idx].get("url", "")
                )
    render_ie_pages(
        cfg["entity_cs"],
        cfg["event_cs"],
        cfg["output_dir"],
        captions=captions,
        image_urls=image_urls,
        openie_tab=cfg.get("openie_tab"),
        page_limit=cfg.get("page_limit", 50),
    )


if __name__ == "__main__":
    main()
