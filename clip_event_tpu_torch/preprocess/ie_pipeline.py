"""IE pipeline orchestration: raw VOA corpus → `.cs` / descriptions artifacts
(the port's own copy of `clip_event_tpu/preprocess/ie_pipeline.py`: the
same stages, and for the same arguments the same commands, command for
command).

The reference runs text/vision information extraction as a fleet of docker
images driven by bash (`src/preprocess/ie/pipeline_full_en.sh`,
`multimedia.sh:1-7`, infra in `set_up_m36.sh`). SURVEY §2.6 scopes out
re-implementing the IE *models*; what this module provides is the *runner*
that takes a user from a raw corpus directory to the artifact contracts the
training data layer consumes:

  <data_root>/merge/cs/entity.cs, event.cs, ...   (ColdStart KEs — parsed by
                                                   `preprocess.ke.load_cs_files`)
  <data_root>/vision/*.pkl                        (object detections — parsed
                                                   by `data.coldstart` / voa)
  descriptions_<pos>_<neg>.json                   (via preprocess_descriptions)

Each stage is declared as data (name, docker image, command template,
produced artifacts), covering every uncommented `docker` step of the
reference scripts line-for-line (`tests/test_ie_pipeline.py` asserts the
plan covers each reference `docker run` image+entrypoint, and
`tests/test_torch_tools_cli.py` that this copy's plan is the same). `plan()` renders
the exact commands; `run()` executes them with subprocess when docker is
available, verifying the expected artifacts appear. Stages whose docker
images are unreachable are reported, not silently skipped — the corpus
contracts are also satisfiable by any other IE system that emits the same
files.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Stage:
    name: str
    description: str
    reference: str  # file:line of the reference commands being reproduced
    commands: Callable[[Dict[str, str]], List[List[str]]]
    produces: Callable[[Dict[str, str]], List[str]]  # artifact paths


def _vars(data_root: str, cu_toolbox: str, edl_data: str, lang: str = "en") -> Dict[str, str]:
    """The reference pipeline's path-variable block (pipeline_full_en.sh:17-98)."""
    d = os.path.abspath(data_root)
    edl = f"{d}/edl"
    rel = f"{d}/relation"
    evt = f"{d}/event"
    return {
        "data_root": d,
        "lang": lang,
        "cu_toolbox": cu_toolbox or os.path.join(d, "cu_toolbox"),
        "edl_data": edl_data or os.path.join(d, "edl_data"),
        "ltf_source": f"{d}/ltf",
        "rsd_source": f"{d}/rsd",
        "ltf_file_list": f"{d}/ltf_lst",
        "rsd_file_list": f"{d}/rsd_lst",
        "edl_output_dir": edl,
        "edl_bio": f"{edl}/{lang}.bio",
        "edl_cs_oneie": f"{d}/merge/cs/entity.cs",
        "edl_tab_nam_bio": f"{d}/merge/mention/{lang}.nam.bio",
        "edl_tab_nam": f"{d}/merge/mention/{lang}.nam.tab",
        "edl_tab_nom": f"{d}/merge/mention/{lang}.nom.tab",
        "edl_tab_pro": f"{d}/merge/mention/{lang}.pro.tab",
        "edl_tab_link": f"{edl}/{lang}.linking.tab",
        "edl_tab_link_fb": f"{edl}/{lang}.linking.freebase.tab",
        "edl_tab_final": f"{edl}/merged_final.tab",
        "edl_cs_coarse": f"{edl}/merged.cs",
        "entity_fine_model": f"{edl}/merged_fine.tsv",
        "edl_cs_fine": f"{edl}/merged_fine.cs",
        "edl_json_fine": f"{edl}/{lang}.linking.freebase.fine.json",
        "geonames_features": f"{edl}/{lang}.linking.geo.json",
        "entity_lorelei_multiple": f"{edl}/{lang}.linking.tab.candidates.json",
        "edl_cs_fine_all": f"{edl}/merged_all_fine.cs",
        "edl_cs_fine_protester": f"{edl}/merged_all_fine_protester.cs",
        "edl_cs_info": f"{edl}/merged_all_fine_info.cs",
        "edl_cs_info_conf": f"{edl}/merged_all_fine_info_conf.cs",
        "edl_tab_color": f"{edl}/{lang}.linking.col.tab",
        "edl_cs_color": f"{edl}/{lang}.color.cs",
        "conf_all": f"{edl}/all_conf.txt",
        "ground_truth_tab_dir": f"{edl}/ldc_anno_matched",
        "core_nlp_output_path": f"{d}/corenlp",
        "filler_coarse": f"{edl}/filler_{lang}.cs",
        "filler_coarse_color": f"{edl}/filler_{lang}_all.cs",
        "filler_fine": f"{edl}/filler_fine.cs",
        "udp_dir": f"{d}/udp",
        "relation_cs_oneie": f"{d}/merge/cs/relation.cs",
        "relation_result_dir": rel,
        "relation_cs_coarse": f"{rel}/{lang}.rel.cs",
        "relation_cs_fine": f"{rel}/{lang}/{lang}.fine_rel.cs",
        "new_relation_coarse": f"{rel}/new_relation_{lang}.cs",
        "event_result_dir": evt,
        "event_coarse_oneie": f"{d}/merge/cs/event.cs",
        "event_coarse_without_time": f"{evt}/event_rewrite.cs",
        "event_fine": f"{evt}/events_fine.cs",
        "event_frame": f"{evt}/events_fine_framenet.cs",
        "event_depen": f"{evt}/events_fine_depen.cs",
        "event_fine_all": f"{evt}/events_fine_all.cs",
        "event_fine_all_clean": f"{evt}/events_fine_all_clean.cs",
        "event_corefer": f"{evt}/events_corefer.cs",
        "event_corefer_confidence": f"{evt}/events_corefer_confidence.tab",
        "event_final": f"{evt}/events_info.cs",
        "edl_vec_file": f"{lang}.mention.hidden.txt",
        "evt_vec_file": f"{lang}.trigger.hidden.txt",
        "merged_cs": f"{d}/{lang}_full.cs",
        "merged_cs_link": f"{d}/{lang}_full_link.cs",
        "ttl_initial": f"{d}/initial",
    }


def _dock(image: str, data_root: str, *args: str, gpus: bool = False,
          workdir: str = "", network_host: bool = False,
          extra_mounts: Sequence[str] = ()) -> List[str]:
    cmd = ["docker", "run", "--rm", "-i", "-v", f"{data_root}:{data_root}"]
    for m in extra_mounts:
        cmd += ["-v", m]
    if workdir:
        cmd += ["-w", workdir]
    if network_host:
        cmd += ["--network=host"]
    if gpus:
        cmd += ["--gpus", "all"]
    return cmd + [image] + list(args)


_PY36 = "/opt/conda/envs/py36/bin/python"


def _setup_commands(v):
    """set_up_m36.sh:5-49 — image pulls, EDL KB fetch, MongoDB, KB import,
    entity-API + event-coref services."""
    pulls = [["docker", "pull", img] for img in (
        "mongo", "panx27/edl", "limanling/uiuc_ie_m36",
        "dylandilu/event_coreference_xdoc", "panx27/data-processor",
        "limanling/aida-tools", "dylandilu/chuck_coreference",
        "limteng/oneie_aida_m36", "wenhycs/uiuc_event_time",
        "panx27/aida20_mention", "laituan245/spanbert_entity_coref",
        "laituan245/spanbert_coref", "laituan245/es_event_coref",
        "laituan245/es_spanbert_entity_coref",
        "yrf1/object-detection", "limanling/grounding-merging",
    )]
    ed = v["edl_data"]
    kb = [
        # EDL KB download + unpack (set_up_m36.sh:29-31)
        ["docker", "run", "--rm", "-v", f"{ed}:/data", "panx27/data-processor",
         "wget", "http://159.89.180.81/demo/resources/edl_data.tar.gz", "-P", "/data"],
        ["docker", "run", "--rm", "-v", f"{ed}:/data", "panx27/data-processor",
         "tar", "zxvf", "/data/edl_data.tar.gz", "-C", "/data"],
        # MongoDB backing the linker (set_up_m36.sh:34)
        ["docker", "run", "-d", "--rm", "-v", f"{ed}/edl_data/db:/data/db",
         "--name", "db", "mongo"],
        # KB import (set_up_m36.sh:38-39; kb_dir = $1)
        ["docker", "run", "--rm", "--link", "db:mongo", "-v", f"{ed}/kb:/data",
         "panx27/edl", "python", "./projs/docker_aida19/kb/import_kb.py",
         "/data/entities.tab"],
        ["docker", "run", "--rm", "--link", "db:mongo", "-v", f"{ed}/kb:/data",
         "panx27/edl", "python", "./projs/docker_aida19/kb/import_mentions.py",
         "/data/entities.tab"],
        # entity-API service (set_up_m36.sh:42-44)
        ["docker", "run", "-d", "-i", "--rm", "--name", "aida_entity",
         "-w", "/entity_api", "-p", "5500:5500", "--gpus", "all",
         "limanling/uiuc_ie_m36", "/opt/conda/envs/aida_entity/bin/python",
         "/entity_api/entity_api/app.py", "--eval", "m36"],
        # per-language event-coref services (set_up_m36.sh:47-49)
        ["docker", "run", "-d", "-i", "--rm", "-w", "/event_coreference_xdoc",
         "-p", "6301:6301", "--name", "event_coreference_ru",
         "dylandilu/event_coreference_xdoc", "python",
         "aida_event_coreference_backen_rus.py"],
        ["docker", "run", "-d", "-i", "--rm", "-w", "/event_coreference_xdoc",
         "-p", "6101:6101", "--name", "event_coreference_es",
         "dylandilu/event_coreference_xdoc", "python",
         "aida_event_coreference_backen_spa.py"],
    ]
    return pulls + kb


def _preprocess_commands(v):
    """pipeline_full_en.sh:109-138 — bio conversion, file lists, CoreNLP, UDP."""
    d = v["data_root"]
    return [
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/aida_utilities/ltf2bio.py", v["ltf_source"], v["edl_bio"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/aida_utilities/dir_readlink.py", v["rsd_source"], v["rsd_file_list"],
              "--stanford_corenlp", v["core_nlp_output_path"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/aida_utilities/dir_ls.py", v["ltf_source"], v["ltf_file_list"]),
        # Stanford CoreNLP (pipeline_full_en.sh:122-128)
        _dock("limanling/aida-tools", d,
              "java", "-mx50g", "-cp", "/stanford-corenlp-aida_0/*",
              "edu.stanford.nlp.pipeline.StanfordCoreNLP",
              "-annotators", "tokenize,ssplit,pos,lemma,ner",
              "-outputFormat", "json",
              "-filelist", v["rsd_file_list"],
              "-properties", f"StanfordCoreNLP_{v['lang']}.properties",
              "-outputDirectory", v["core_nlp_output_path"],
              workdir="/stanford-corenlp-aida_0"),
        # universal dependency parser (pipeline_full_en.sh:130-136)
        _dock("limanling/uiuc_ie_m36", d, "mkdir", "-p", v["udp_dir"]),
        _dock("dylandilu/chuck_coreference", d,
              "python", "./bio2udp.py", "--lang", v["lang"],
              "--path_bio", v["edl_bio"], "--udp_dir", v["udp_dir"],
              workdir="/scr"),
    ]


def _oneie_commands(v):
    """pipeline_full_en.sh:148-150 — coarse entity/relation/event extraction."""
    return [
        _dock("limteng/oneie_aida_m36", v["data_root"],
              "/opt/conda/bin/python", "/oneie/predict.py",
              "-i", v["ltf_source"], "-o", v["data_root"],
              "-l", v["lang"], "--output_hidden",
              workdir="/oneie", gpus=True),
    ]


def _entity_commands(v):
    """pipeline_full_en.sh:151-183 — fine typing, KB linking, nominal coref,
    tab→cs, entity-id rewrite."""
    d = v["data_root"]
    return [
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/entity/aida_edl/typing.py", v["lang"],
              v["edl_tab_nam_bio"], v["entity_fine_model"], network_host=True),
        # EDL linking against the MongoDB KB (pipeline_full_en.sh:161-170)
        ["docker", "run", "--rm", "-i",
         "-v", f"{v['edl_data']}:/data",
         "-v", f"{d}:/testdata_{v['lang']}",
         "--link", "db:mongo", "panx27/edl",
         "python", "./projs/docker_aida19/aida19.py", v["lang"],
         f"/testdata_{v['lang']}/merge/mention/{v['lang']}.nam.tab",
         f"/testdata_{v['lang']}/merge/mention/{v['lang']}.nom.tab",
         f"/testdata_{v['lang']}/merge/mention/{v['lang']}.pro.tab",
         f"/testdata_{v['lang']}/edl", "m36"],
        _dock("laituan245/spanbert_entity_coref", d,
              "-edl_official", v["edl_tab_link"],
              "-edl_freebase", v["edl_tab_link_fb"],
              "-l", v["ltf_source"], "-o", v["edl_tab_final"], gpus=True),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/entity/aida_edl/tab2cs.py",
              v["edl_tab_final"], v["edl_cs_coarse"], "EDL"),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/aida_utilities/rewrite_entity_id.py",
              v["edl_cs_oneie"], v["relation_cs_oneie"], v["event_coarse_oneie"],
              v["edl_cs_coarse"], v["relation_cs_coarse"],
              v["event_coarse_without_time"]),
    ]


def _filler_commands(v):
    """pipeline_full_en.sh:186-258 — fillers, fine-grained entities, colors,
    fine relations, entity postprocessing + informative justification."""
    d = v["data_root"]
    return [
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/entity/aida_filler/extract_filler_relation.py",
              "--corenlp_dir", v["core_nlp_output_path"],
              "--ltf_dir", v["ltf_source"],
              "--edl_path", v["edl_cs_coarse"],
              "--text_dir", v["rsd_source"],
              "--path_relation", v["new_relation_coarse"],
              "--path_filler", v["filler_coarse"],
              "--lang", v["lang"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/entity/aida_edl/fine_grained_entity.py",
              v["lang"], v["edl_json_fine"], v["edl_tab_link_fb"],
              v["entity_fine_model"], v["geonames_features"],
              v["edl_cs_coarse"], v["edl_cs_fine"], v["filler_fine"],
              "--filler_coarse", v["filler_coarse"],
              "--ground_truth_tab_dir", v["ground_truth_tab_dir"],
              "--ltf_dir", v["ltf_source"], "--rsd_dir", v["rsd_source"],
              "--eval", "m36"),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/relation/FineRelationExtraction/utils/color_fillers.py",
              "--en_color_fill_tab_fname", v["edl_tab_color"],
              "--en_fill_cs_fname", v["filler_coarse"],
              "--en_combo_outfname", v["filler_coarse_color"],
              "--en_color_outfname", v["edl_cs_color"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36, "-u",
              "/relation/FineRelationExtraction/EVALfine_grained_relations.py",
              "--lang_id", v["lang"],
              "--ltf_dir", v["ltf_source"], "--rsd_dir", v["rsd_source"],
              "--cs_fnames", v["edl_cs_coarse"], v["filler_coarse_color"],
              v["relation_cs_coarse"], v["new_relation_coarse"],
              v["event_coarse_without_time"],
              "--fine_ent_type_tab", v["edl_tab_link_fb"],
              "--fine_ent_type_json", v["edl_json_fine"],
              "--outdir", v["relation_result_dir"], "--fine_grained"),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/aida_utilities/pipeline_merge_m18.py",
              "--cs_fnames", v["edl_cs_fine"], v["filler_fine"],
              "--output_file", v["edl_cs_fine_all"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/entity/aida_edl/add_protester.py",
              v["event_coarse_without_time"], v["edl_cs_fine_all"],
              v["edl_cs_fine_protester"]),
        _dock("panx27/aida20_mention", d,
              "python", "./extend.py", v["lang"], v["ltf_source"],
              v["edl_cs_fine_protester"], v["edl_cs_info"] + "_tmp"),
        _dock("panx27/aida20_mention", d,
              "python", "./revise.py", v["edl_cs_info"] + "_tmp",
              v["edl_cs_info"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/aida_utilities/rewrite_mention_confidence.py",
              v["lang"], v["edl_tab_nam"], v["edl_tab_nom"], v["edl_tab_pro"],
              v["edl_tab_link"], v["entity_lorelei_multiple"], v["ltf_source"],
              v["edl_cs_info"], v["edl_cs_info_conf"], v["conf_all"]),
    ]


def _event_commands(v):
    """pipeline_full_en.sh:261-309 — fine-grained events, rule-based events,
    merge, arg rewrite, event coref, informative mentions."""
    d = v["data_root"]
    return [
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/event/aida_event/fine_grained/fine_grained_events.py",
              v["lang"], v["ltf_source"], v["edl_json_fine"],
              v["edl_tab_link_fb"], v["edl_cs_coarse"],
              v["event_coarse_without_time"], v["event_fine"],
              "--filler_coarse", v["filler_coarse"],
              "--entity_finegrain_aida", v["edl_cs_fine_all"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/event/aida_event/framenet/new_event_dependency.py",
              v["rsd_source"], v["udp_dir"], v["edl_cs_coarse"],
              v["filler_coarse"], v["event_fine"], v["event_frame"],
              v["event_depen"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/aida_utilities/pipeline_merge_m18.py",
              "--cs_fnames", v["event_fine"], v["event_depen"],
              "--output_file", v["event_fine_all"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/event/aida_event/fine_grained/rewrite_args.py",
              v["event_fine_all"], v["ltf_source"],
              v["event_fine_all_clean"] + "_tmp", v["lang"]),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/event/aida_event/fine_grained/rewrite_args.py",
              v["event_fine_all_clean"] + "_tmp", v["ltf_source"],
              v["event_fine_all_clean"], v["lang"]),
        _dock("laituan245/spanbert_coref", d,
              "-i", v["event_fine_all_clean"], "-c", v["event_corefer"],
              "-t", v["event_corefer_confidence"], "-l", v["ltf_source"],
              gpus=True),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/event/aida_event/postprocessing_event_informative_mentions.py",
              v["ltf_source"], v["event_corefer"], v["event_final"],
              "--eval", "m36"),
    ]


def _merge_commands(v):
    """pipeline_full_en.sh:313-322 — final ColdStart merge + link confidence."""
    d = v["data_root"]
    return [
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/postprocessing/pipeline_merge.py",
              "--cs_fnames", v["edl_cs_info_conf"], v["edl_cs_color"],
              v["relation_cs_fine"], v["event_final"],
              "--output_file", v["merged_cs"], "--eval", "m36"),
        _dock("limanling/uiuc_ie_m36", d, _PY36,
              "/aida_utilities/postprocessing_link_confidence.py",
              v["entity_lorelei_multiple"], v["merged_cs"],
              v["merged_cs_link"],
              f"{v['edl_output_dir']}/lorelei_private_data.json",
              "--eval", "m36"),
    ]


def _aif_commands(v):
    """pipeline_full_en.sh:329-344 — AIF/ttl conversion."""
    d = v["data_root"]
    return [
        _dock("limanling/uiuc_ie_m36", d,
              "/opt/conda/envs/aida_entity/bin/python",
              "/postprocessing/aif_converter_combine.py",
              "--input_cs", v["merged_cs_link"], "--ltf_dir", v["ltf_source"],
              "--output_ttl_dir", v["ttl_initial"],
              "--lang", v["lang"], "--eval", "m36",
              "--evt_coref_score_tab", v["event_corefer_confidence"],
              "--ent_vec_dir", f"{d}/merge/mention",
              "--ent_vec_files", v["edl_vec_file"],
              "--evt_vec_dir", f"{d}/merge/mention",
              "--evt_vec_files", v["evt_vec_file"],
              "--event_embedding_from_file",
              "--freebase_tab", v["edl_tab_link_fb"],
              "--fine_grained_entity_type_path", v["edl_json_fine"],
              "--lorelei_link_mapping",
              f"{v['edl_output_dir']}/lorelei_private_data.json"),
        _dock("limanling/uiuc_ie_m36", d,
              "chmod", "-R", "777", v["ttl_initial"]),
    ]


def _vision_commands(v):
    """multimedia.sh:1-7 — object detection, visual feature extraction,
    grounding, and graph merging."""
    d = v["data_root"]
    # the vision images' home directory inside their containers
    home = "/root"

    def _ground(script):
        return ["docker", "run", "--rm", "-i",
                "-v", f"{d}/vision:{home}/LDC",
                "-v", f"{d}/ltf:{home}/ltf",
                "-v", f"{d}:{home}/shared",
                "-v", f"{v['cu_toolbox']}:{home}/models", "--gpus", "all",
                "limanling/grounding-merging",
                f"{home}/conda/envs/aida-env/bin/python", script]

    return [
        ["docker", "run", "--rm", "-i",
         "-v", f"{d}/vision:{home}/input",
         "-v", f"{d}:{home}/output", "--gpus", "all",
         "yrf1/object-detection", "/bin/bash", "./full_script.sh"],
        _ground("Feature_Extraction.py"),
        _ground("Visual_Grounding_mp.py"),
        _ground("Graph_Merging.py"),
    ]


STAGES: List[Stage] = [
    Stage("setup",
          "pull IE docker images + EDL KB + MongoDB + entity-API/coref services",
          "set_up_m36.sh:5-49", _setup_commands, lambda v: []),
    Stage("preprocess",
          "ltf→bio + file lists + Stanford CoreNLP + universal dependency parse",
          "pipeline_full_en.sh:109-138", _preprocess_commands,
          lambda v: [v["edl_bio"], v["core_nlp_output_path"], v["udp_dir"]]),
    Stage("oneie",
          "OneIE coarse entity/relation/event extraction",
          "pipeline_full_en.sh:148-150", _oneie_commands,
          lambda v: [v["edl_cs_oneie"], v["event_coarse_oneie"]]),
    Stage("entity",
          "fine typing → EDL KB linking → nominal coref → tab2cs → id rewrite",
          "pipeline_full_en.sh:151-183", _entity_commands,
          lambda v: [v["edl_cs_coarse"], v["event_coarse_without_time"]]),
    Stage("fillers",
          "filler/relation extraction, fine entities, colors, informative "
          "justification, mention confidence",
          "pipeline_full_en.sh:186-258", _filler_commands,
          lambda v: [v["filler_coarse"], v["edl_cs_info_conf"]]),
    Stage("event",
          "fine-grained + rule-based events, arg rewrite, event coref, "
          "informative mentions",
          "pipeline_full_en.sh:261-309", _event_commands,
          lambda v: [v["event_final"]]),
    Stage("merge",
          "final ColdStart merge + lorelei link confidence",
          "pipeline_full_en.sh:313-322", _merge_commands,
          lambda v: [v["merged_cs_link"]]),
    Stage("aif",
          "AIF/ttl RDF conversion",
          "pipeline_full_en.sh:329-344", _aif_commands,
          lambda v: [v["ttl_initial"]]),
    Stage("vision-ie",
          "object detection + visual grounding + graph merging",
          "multimedia.sh:1-7", _vision_commands,
          lambda v: [f"{v['data_root']}/vision"]),
]

#: the text-IE stages in reference execution order — `--stages text-ie`
#: expands to these (the round-2 runner's single coarse stage, now complete)
TEXT_IE_STAGES = ["preprocess", "oneie", "entity", "fillers", "event",
                  "merge", "aif"]


def docker_available() -> bool:
    return shutil.which("docker") is not None


def _expand(stages: Optional[Sequence[str]]) -> Optional[List[str]]:
    if stages is None:
        return None
    out: List[str] = []
    for s in stages:
        out.extend(TEXT_IE_STAGES if s == "text-ie" else [s])
    return out


def plan(data_root: str, cu_toolbox: str = "", edl_data: str = "",
         stages: Optional[Sequence[str]] = None) -> Dict[str, List[List[str]]]:
    """Render the exact commands per stage without running anything."""
    v = _vars(data_root, cu_toolbox, edl_data)
    stages = _expand(stages)
    wanted = set(stages) if stages else {s.name for s in STAGES}
    unknown = wanted - {s.name for s in STAGES}
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; options: "
                         f"{[s.name for s in STAGES] + ['text-ie']}")
    return {s.name: s.commands(v) for s in STAGES if s.name in wanted}


def run(data_root: str, cu_toolbox: str = "", edl_data: str = "",
        stages: Optional[Sequence[str]] = None, dry_run: bool = True) -> bool:
    """Execute (or print, when dry_run) the pipeline stages in order.

    Returns True when every requested stage's artifacts exist afterwards.
    """
    v = _vars(data_root, cu_toolbox, edl_data)
    plans = plan(data_root, cu_toolbox, edl_data, stages)
    ok = True
    if not dry_run and not docker_available():
        log.error(
            "docker is not available on this host. Run the commands below on "
            "a docker-capable machine, or produce the same artifacts with "
            "another IE system; then point preprocess_descriptions at them."
        )
        # an explicitly requested --execute that cannot run is a failure:
        # print the plan, but exit nonzero so scripts/CI don't conclude the
        # IE stages ran
        dry_run = True
        ok = False
    for stage in STAGES:
        if stage.name not in plans:
            continue
        log.info("== stage %s: %s (reference %s)", stage.name,
                 stage.description, stage.reference)
        for cmd in plans[stage.name]:
            printable = " ".join(cmd)
            if dry_run:
                log.info("DRY-RUN: %s", printable)
                continue
            log.info("RUN: %s", printable)
            proc = subprocess.run(cmd)
            if proc.returncode != 0:
                log.error("stage %s failed (rc=%d): %s", stage.name,
                          proc.returncode, printable)
                ok = False
                break
        for artifact in stage.produces(v):
            if not dry_run and not os.path.exists(artifact):
                log.error("stage %s did not produce %s", stage.name, artifact)
                ok = False
    if dry_run:
        log.info(
            "next: python -m clip_event_tpu_torch.preprocess_descriptions --cfg <cfg.json> with "
            "cs_inputs pointing at %s/merge/cs and %s/edl/merged.cs",
            v["data_root"], v["data_root"],
        )
    return ok
