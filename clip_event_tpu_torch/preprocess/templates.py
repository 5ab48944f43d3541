"""Positive / hard-negative description generation (the port's own copy of
`clip_event_tpu/preprocess/templates.py`; reference
`preprocess_description_contrastive.py:299-489`). The same seed gives the
same descriptions, and `write_descriptions` the same bytes.

Four styles per side (template / short / shortverb / caption-edit):
  * positives fill the ontology template's `<argN>` slots with the salient
    event's canonical argument mentions;
  * event-level negatives re-fill the same arguments into templates of event
    types from *different parent types* observed in the corpus;
  * argument-level negatives move each filled argument into a wrong role
    slot (role swap / resample);
  * leftover `<argN>` slots become lowercase role names (`rename_args`).

Reproducibility fix over the reference: all sampling goes through an
explicit seeded `random.Random`, and argument sets are sorted before
joining (the reference iterates unordered sets — same corpus, different
descriptions per run).
"""

from __future__ import annotations

import json
import logging
import random
import re
from collections import defaultdict
from typing import Dict, Iterable, List

log = logging.getLogger(__name__)

STYLES = ("template", "short", "shortverb", "caption")


def short_template_type(event_type: str) -> str:
    words = re.findall("[A-Z][^A-Z]*", event_type.split(".")[-1])
    type_str = " ".join(words).lower() if words else event_type.split(".")[-1]
    return f"An image of {type_str} event. "


def short_template_role(role: str, args_str: str) -> str:
    return f"The {role.lower()} are {args_str.lower()}. "


def edit_type(caption: str, trigger_word: str, event_type_neg: str) -> str:
    trigger_neg = " ".join(re.findall("[A-Z][^A-Z]*", event_type_neg.split(".")[-1])).lower()
    return caption.replace(trigger_word, trigger_neg) if trigger_word else caption


def rename_args(template: str, roles: List[str]) -> str:
    for idx, role in enumerate(roles):
        template = template.replace(f"<arg{idx + 1}>", role.lower())
    return template


def normalize_role(role: str) -> str:
    return role.split("_")[-1].replace("Prosecutor", "Adjudicator")


def build_negative_type_pool(doc_salient_event: dict) -> Dict[str, List[str]]:
    """parent type → candidate negative event types (types whose parent
    differs), reference :321-331."""
    pos_by_parent = defaultdict(set)
    for rec in doc_salient_event.values():
        etype = rec["event_type"]
        pos_by_parent[etype.split(".")[0]].add(etype)
    neg_pool = defaultdict(list)
    for parent, types in sorted(pos_by_parent.items()):
        for other in sorted(pos_by_parent):
            if other != parent:
                neg_pool[other].extend(sorted(types))
    return neg_pool


def generate_descriptions(
    positive_option: Iterable[str],
    negative_option: Iterable[str],
    template_dict: dict,
    doc_salient_event: dict,
    doc_caption: Dict[str, str],
    neg_num: int = 1,
    use_rolename: bool = True,
    sample_neg_arg: bool = False,
    seed: int = 999,
) -> dict:
    """Returns {image_id: {pos: [...], neg_event: [...], neg_argument: [...]}}
    (the `descriptions_<pos>_<neg>.json` contract, reference :316-484)."""
    rng = random.Random(seed)
    neg_pool = build_negative_type_pool(doc_salient_event)
    out = defaultdict(lambda: defaultdict(list))

    for doc_id in sorted(doc_salient_event):
        rec = doc_salient_event[doc_id]
        event_type = rec["event_type"]
        event_trigger = rec.get("event_trigger", "")
        event_args = rec["event_args"]
        caption = doc_caption.get(doc_id, "")
        if event_type not in template_dict:
            log.warning("no template for %s (%s)", event_type, doc_id)
            continue

        roles_ontology = template_dict[event_type]["roles"]
        template = template_dict[event_type]["template"]
        template_short = short_template_type(event_type)

        # ---- sample event-level negative types from other parents
        candidates = neg_pool[event_type.split(".")[0]]
        if not candidates:
            continue
        neg_types = rng.sample(candidates, min(neg_num, len(candidates)))
        neg_templates = [template_dict[t]["template"] for t in neg_types]
        neg_shorts = [short_template_type(t) for t in neg_types]
        neg_captions = [edit_type(caption, event_trigger, t) for t in neg_types]

        # ---- fill correct arguments
        filled_template = template
        filled_short = template_short
        filled_arg_roles: Dict[str, str] = {}
        for role in sorted(event_args):
            args = event_args[role]
            role_n = normalize_role(role)
            if role_n not in roles_ontology:
                continue
            slot = f"<arg{roles_ontology.index(role_n) + 1}>"
            filled = " and ".join(sorted({tup[3] for tup in args.values()}))
            filled_arg_roles[role_n] = filled
            filled_template = filled_template.replace(slot, filled)
            filled_short += short_template_role(role_n, filled)
            neg_templates = [t.replace(slot, filled) for t in neg_templates]
            neg_shorts = [s + short_template_role(role_n, filled) for s in neg_shorts]

        positive_option = list(positive_option)
        negative_option = list(negative_option)
        if "caption" in positive_option:
            out[doc_id]["pos"].append(caption)
        if "template" in positive_option:
            out[doc_id]["pos"].append(filled_template)
        if "short" in positive_option:
            out[doc_id]["pos"].append(filled_short)
        if "shortverb" in positive_option:
            out[doc_id]["pos"].append(template_short)
        if "template" in negative_option:
            out[doc_id]["neg_event"].extend(neg_templates)
        if "short" in negative_option:
            out[doc_id]["neg_event"].extend(neg_shorts)
        if "caption" in negative_option:
            out[doc_id]["neg_event"].extend(neg_captions)
        if "shortverb" in negative_option:
            out[doc_id]["neg_event"].extend(short_template_type(t) for t in neg_types)

        # ---- argument-level negative: move filled args into wrong slots
        neg_arg_template = template
        neg_arg_short = template_short
        neg_arg_caption = caption
        used_neg_slots = set()
        if sample_neg_arg:
            unfilled = [r for r in roles_ontology if r not in filled_arg_roles]
            pool = unfilled if unfilled else list(filled_arg_roles)
            picks = rng.sample(pool, min(neg_num, len(pool)))
            last_filled = (
                list(filled_arg_roles.values())[-1] if filled_arg_roles else ""
            )
            for neg_role in picks:
                slot = f"<arg{roles_ontology.index(neg_role) + 1}>"
                neg_arg_template = neg_arg_template.replace(slot, last_filled)
                used_neg_slots.add(neg_role)
        else:
            candidates_roles = list(roles_ontology)
            for role_filled, filled in filled_arg_roles.items():
                pool = [r for r in candidates_roles if r != role_filled]
                if not pool:
                    continue
                neg_role = rng.sample(pool, 1)[0]
                candidates_roles.remove(neg_role)
                slot = f"<arg{roles_ontology.index(neg_role) + 1}>"
                neg_arg_template = neg_arg_template.replace(slot, filled)
                neg_arg_short += short_template_role(neg_role, filled)
                used_neg_slots.add(neg_role)
                if neg_role in filled_arg_roles:
                    neg_arg_caption = neg_arg_caption.replace(
                        filled, filled_arg_roles[neg_role]
                    )
                else:
                    neg_arg_caption = neg_arg_caption.replace(filled, neg_role.lower())

        # fill remaining correct args into slots not used as negatives
        for role_n, filled in filled_arg_roles.items():
            if role_n in used_neg_slots:
                continue
            slot = f"<arg{roles_ontology.index(role_n) + 1}>"
            neg_arg_template = neg_arg_template.replace(slot, filled)

        if "template" in negative_option:
            out[doc_id]["neg_argument"].append(neg_arg_template)
        if "short" in negative_option:
            out[doc_id]["neg_argument"].append(neg_arg_short)
        if "caption" in negative_option:
            out[doc_id]["neg_argument"].append(neg_arg_caption)

        if use_rolename:
            for key in out[doc_id]:
                out[doc_id][key] = [
                    rename_args(t, roles_ontology) for t in out[doc_id][key]
                ]

    return {k: dict(v) for k, v in out.items()}


def write_descriptions(descriptions: dict, output_path: str) -> None:
    with open(output_path, "w") as fh:
        json.dump(descriptions, fh, indent=4)
