"""ColdStart (.cs) knowledge-element parsers (the port's own copy of
`clip_event_tpu/data/coldstart.py`).

Same artifact contract as the reference (`dataset_voa.py:282-368`): tab-
separated `.cs` files from the GAIA IE pipeline with `:Entity_*` / `:Event_*`
subject lines carrying `type`, `canonical_mention`, `mention`, and
`<Type>_<Role>.<realis>` argument assertions. Returns plain-dict indices
keyed by doc id. The reference's latent bugs (undefined `event_4tuple`,
`dataset_voa.py:321-323`) are not reproduced; 4-tuple lines are ignored.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set


@dataclasses.dataclass
class IEIndex:
    """Entity/event knowledge extracted from ColdStart files."""

    # docid → entityid → confidence (str, as in the artifact)
    doc_entities: Dict[str, Dict[str, str]]
    entity_type: Dict[str, str]  # entityid → type
    entity_name: Dict[str, str]  # entityid → canonical mention text
    entity_mentions: Dict[str, Set[str]]  # entityid → mention offsets
    doc_events: Dict[str, Dict[str, str]]  # docid → eventid → type
    event_type: Dict[str, str]
    event_mentions: Dict[str, Set[str]]  # eventid → mention texts
    event_arguments: Dict[str, Dict[str, Set[str]]]  # eventid → role → arg ids


def parse_offset(offset: str):
    """'DOCID:start-end' → (docid, start, end)."""
    docid, _, span = offset.rpartition(":")
    start, _, end = span.partition("-")
    return docid, int(start), int(end)


def _strip_quotes(s: str) -> str:
    return s[1:-1] if len(s) >= 2 and s[0] == '"' and s[-1] == '"' else s


def parse_entity_cs(path: str, index: IEIndex, load_mention: bool = False) -> None:
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            if not line.startswith(":Entity"):
                continue
            tabs = line.rstrip("\n").split("\t")
            if len(tabs) < 3:
                continue
            subj, pred = tabs[0], tabs[1]
            if pred == "type":
                index.entity_type[subj] = tabs[2].split("#")[-1]
            elif "canonical_mention" in pred and len(tabs) >= 5:
                docid = tabs[3].split(":")[0]
                index.entity_name[subj] = _strip_quotes(tabs[2])
                index.doc_entities[docid][subj] = tabs[4]
            elif "mention" in pred and load_mention and len(tabs) >= 4:
                index.entity_mentions[subj].add(tabs[3])


def parse_event_cs(path: str, index: IEIndex) -> None:
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            if not line.startswith(":Event"):
                continue
            tabs = line.rstrip("\n").split("\t")
            if len(tabs) < 3:
                continue
            subj, pred = tabs[0], tabs[1]
            if pred == "type":
                index.event_type[subj] = tabs[2].split("#")[-1]
            elif "mention" in pred and len(tabs) >= 4:
                docid = tabs[3].split(":")[0]
                index.event_mentions[subj].add(_strip_quotes(tabs[2]))
                index.doc_events[docid][subj] = index.event_type.get(subj, "")
            elif "mention" not in pred and "_" in pred and len(tabs) >= 4:
                # argument assertion: '<Type>_<Role>.<realis>'
                role = pred[pred.rfind("_") + 1 :].split(".")[0]
                index.event_arguments[subj][role].add(tabs[2])


def load_ie_index(
    entity_files: Optional[Iterable[str]] = None,
    event_files: Optional[Iterable[str]] = None,
    load_mention: bool = False,
) -> IEIndex:
    """Parse all given .cs files into one index (reference `load_ie_cs`)."""
    index = IEIndex(
        doc_entities=defaultdict(dict),
        entity_type={},
        entity_name=defaultdict(str),
        entity_mentions=defaultdict(set),
        doc_events=defaultdict(dict),
        event_type={},
        event_mentions=defaultdict(set),
        event_arguments=defaultdict(lambda: defaultdict(set)),
    )
    for path in entity_files or []:
        parse_entity_cs(path, index, load_mention=load_mention)
    for path in event_files or []:
        parse_event_cs(path, index)
    return index


def doc_entity_names(index: IEIndex, docid: str) -> List[str]:
    return [index.entity_name[eid] for eid in index.doc_entities.get(docid, {})]


def doc_event_names(index: IEIndex, docid: str) -> List[str]:
    return [
        ", ".join(sorted(index.event_mentions[eid]))
        for eid in index.doc_events.get(docid, {})
    ]
