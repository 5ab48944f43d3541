"""Rich ColdStart knowledge-element loader for preprocessing (the port's own
copy of `clip_event_tpu/preprocess/ke.py`;
reference `preprocess_description_contrastive.py:20-113` — richer than the
training-time parser in `data.coldstart`: keeps per-type confidences,
mention tables, KB links, and argument tuples).

Store layout (plain dicts, JSON-serializable):
  doc_ke[docid] = {"entity": [ids], "event": [ids], "relation": [ids]}
  entity_info[id] = {type: {t: conf}, confidence, canonical_mention,
                     mention: {offset: (mention_type, text)}, link: {...}}
  evt_info[id]   = {type, confidence, canonical_mention, mention: {...}}
  evt_args[event_id][role][arg_id] =
      (offset, mention_type, mention_text, canonical_mention)
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Tuple

from clip_event_tpu_torch.data.coldstart import parse_offset


def new_store():
    return {
        "doc_ke": defaultdict(lambda: defaultdict(list)),
        "entity_info": defaultdict(dict),
        "evt_info": defaultdict(dict),
        "evt_args": defaultdict(lambda: defaultdict(dict)),
    }


def _norm_id(raw: str, suffix: str) -> str:
    return f"{raw}_{suffix}" if suffix else raw


def load_cs(path: str, suffix: str, store: dict) -> None:
    doc_ke = store["doc_ke"]
    entity_info = store["entity_info"]
    evt_info = store["evt_info"]
    evt_args = store["evt_args"]

    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.rstrip("\n")
            tabs = line.split("\t")
            if len(tabs) < 3:
                continue

            if line.startswith(":Entity") or line.startswith(":Filler"):
                entity_id = _norm_id(tabs[0], suffix)
                pred = tabs[1]
                if pred == "type":
                    conf = float(tabs[3]) if len(tabs) >= 4 else 1.0
                    entity_info[entity_id].setdefault("type", {})[
                        tabs[2].split("#")[-1]
                    ] = conf
                elif "canonical_mention" in pred and len(tabs) >= 5:
                    docid, _, _ = parse_offset(tabs[3])
                    entity_info[entity_id]["confidence"] = float(tabs[4])
                    entity_info[entity_id]["canonical_mention"] = tabs[2][1:-1]
                    if entity_id not in doc_ke[docid]["entity"]:
                        doc_ke[docid]["entity"].append(entity_id)
                elif "mention" in pred and len(tabs) >= 5:
                    entity_info[entity_id].setdefault("mention", {})[tabs[3]] = (
                        pred.replace(".actual", ""),
                        tabs[2][1:-1],
                    )
                elif "link" in pred:
                    conf = tabs[3] if len(tabs) > 3 else 1.0
                    entity_info[entity_id].setdefault("link", {})[tabs[2]] = conf

            elif line.startswith(":Event") or line.startswith(":Relation"):
                ke_type = line[1 : line.find("_")].lower()
                evt_id = _norm_id(tabs[0], suffix)
                pred = tabs[1]
                if pred == "type":
                    evt_info[evt_id]["type"] = tabs[2].split("#")[-1].strip()
                elif "canonical_mention" in pred and len(tabs) >= 5:
                    docid, _, _ = parse_offset(tabs[3])
                    evt_info[evt_id]["confidence"] = float(tabs[4])
                    evt_info[evt_id]["canonical_mention"] = tabs[2][1:-1]
                    if evt_id not in doc_ke[docid][ke_type]:
                        doc_ke[docid][ke_type].append(evt_id)
                elif "mention" in pred and len(tabs) >= 5:
                    evt_info[evt_id].setdefault("mention", {})[tabs[3]] = (
                        pred.replace(".actual", ""),
                        tabs[2][1:-1],
                    )
                elif ("Entity" in tabs[2] or "Filler" in tabs[2]) and len(tabs) >= 5:
                    role = tabs[1].split("#")[-1].replace(".actual", "")
                    arg_id = _norm_id(tabs[2], suffix)
                    if arg_id not in evt_args[evt_id][role]:
                        arg_entity = entity_info.get(arg_id, {})
                        mention = arg_entity.get("mention", {}).get(tabs[3], ("", ""))
                        evt_args[evt_id][role][arg_id] = (
                            tabs[3],
                            mention[0],
                            mention[1],
                            arg_entity.get("canonical_mention", mention[1]),
                        )


def load_cs_files(inputs: Iterable[Tuple[str, str]]) -> dict:
    """inputs: iterable of (path, suffix). Returns the populated store."""
    store = new_store()
    for path, suffix in inputs:
        load_cs(path, suffix, store)
    return store
