"""The port's description pipeline on the CPU against the JAX package's
(`clip_event_tpu_torch/preprocess/`, `preprocess_descriptions`, `zoo`):

- `load_cs_files`, `select_salient_events` (with and without CLIP
  predictions, merging or not), `generate_descriptions` in every style and
  option, `preprocess_caption`: equal dicts, in equal order, and equal
  bytes where written, on a seeded synthetic ColdStart corpus;
- `ClipTypeScorer` on a tiny CLIP (2 layers, width 64) with the JAX params
  carried across by `params_from_jax`, on six seeded images plus one
  missing and one corrupt file: probs within 1e-4 (JAX at "highest"
  precision, tests/conftest.py), `pred_idx` equal; each package reads the
  other's cache, and a cached doc encodes nothing;
- the port's `preprocess_descriptions` main in this process with
  `--device cpu`, without and with `add_clip_sim`, against the JAX CLI's
  `main` in this process on the same files and `.pth`: every output file
  byte for byte;
- `zoo.load` of a local file, `available_models`, `tokenize`.

Both sides decode images with PIL (the JAX package's native JPEG decoder
differs from PIL by one unit in the last place)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models.convert import params_from_jax  # noqa: E402

CFG_KW = dict(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=16, context_length=77, vocab_size=49408,
    transformer_width=64, transformer_heads=1, transformer_layers=2,
)
JCFG, TCFG = J.CLIPConfig(**CFG_KW), T.CLIPConfig(**CFG_KW)
PROB_TOL = 1e-4

TEMPLATES = {
    "Conflict.Attack": {
        "template": "<arg1> attacked <arg2> using <arg3> at <arg4>",
        "roles": ["Attacker", "Target", "Instrument", "Place"],
    },
    "Conflict.Demonstrate": {
        "template": "<arg1> demonstrated at <arg2>",
        "roles": ["Entity", "Place"],
    },
    "Justice.Arrest": {
        "template": "<arg1> arrested <arg2> at <arg3>",
        "roles": ["Agent", "Person", "Place"],
    },
    "Movement.Transport": {
        "template": "<arg1> transported <arg2> to <arg3>",
        "roles": ["Agent", "Artifact", "Destination"],
    },
    "Contact.Meet": {
        "template": "<arg1> met <arg2> at <arg3>",
        "roles": ["Entity", "Participant", "Place"],
    },
    "Life.Die": {
        "template": "<arg1> killed <arg2> at <arg3>",
        "roles": ["Agent", "Victim", "Place"],
    },
}
PREFIX = "VOA_EN_NW_2017"
N_DOCS = 8


def write_corpus(root, seed=0):
    """A seeded ColdStart corpus of N_DOCS docs (ids `PREFIX_<d>_0`): two
    .cs files each of entities and events (the second pair with suffix
    "b"), relations, fillers, links and typed mentions; each doc 0-4
    events of random types and roles, one doc none. Returns the paths."""
    rng = np.random.default_rng(seed)
    types = list(TEMPLATES)
    names = ["rebels", "police", "the city", "a thief", "troops", "protesters", "officials",
             "the base", "a truck", "the border", "a journalist", "the minister"]
    out = {}
    for part, suffix in (("a", ""), ("b", "b")):
        ent, evt = [], []
        for d in range(N_DOCS):
            doc = f"{PREFIX}_{d}{part}_0"
            ents = []
            for e in range(int(rng.integers(2, 5))):
                eid = f":Entity_{d}_{e}"
                name = names[int(rng.integers(len(names)))]
                start = 10 * e
                off = f"{doc}:{start}-{start + len(name) - 1}"
                ent += [
                    f"{eid}\ttype\thttps://tac.nist.gov/ontology#{rng.choice(['Person', 'GPE', 'Weapon'])}"
                    f"\t{rng.uniform(0.5, 1):.3f}",
                    f'{eid}\tcanonical_mention.actual\t"{name}"\t{off}\t{rng.uniform(0.5, 1):.3f}',
                    f'{eid}\tmention.actual\t"{name}"\t{off}\t1.0',
                    f'{eid}\tnominal_mention.actual\t"{name.split()[-1]}"\t{doc}:{start + 100}-{start + 104}\t0.5',
                ]
                if e == 0:
                    ent.append(f"{eid}\tlink\tLDC2015E42:{d}{e}\t0.9")
                ents.append((eid, off))
            ent += [
                f":Filler_{d}\ttype\thttps://tac.nist.gov/ontology#Time\t1.0",
                f':Filler_{d}\tcanonical_mention.actual\t"monday"\t{doc}:200-205\t1.0',
            ]
            n_events = 0 if d == 3 else int(rng.integers(1, 5))
            for v in range(n_events):
                vid = f":Event_{d}_{v}"
                etype = types[int(rng.integers(len(types)))]
                trig = f"trigger{v}"
                evt += [
                    f"{vid}\ttype\thttps://tac.nist.gov/ontology#{etype}",
                    f'{vid}\tcanonical_mention.actual\t"{trig}"\t{doc}:{300 + v}-{305 + v}\t{rng.uniform(0.3, 1):.3f}',
                    f'{vid}\tmention.actual\t"{trig}"\t{doc}:{300 + v}-{305 + v}\t1.0',
                ]
                roles = TEMPLATES[etype]["roles"] + ["Time"]
                for r in range(int(rng.integers(0, 4))):
                    role = roles[int(rng.integers(len(roles)))]
                    eid, off = ents[int(rng.integers(len(ents)))]
                    evt.append(f"{vid}\thttps://tac.nist.gov/ontology#{etype}_{role}.actual\t{eid}\t{off}\t0.8")
            evt += [
                f":Relation_{d}\ttype\thttps://tac.nist.gov/ontology#Physical.LocatedNear",
                f':Relation_{d}\tcanonical_mention.actual\t"near"\t{doc}:400-404\t0.7',
                f":Relation_{d}\thttps://tac.nist.gov/ontology#Physical.LocatedNear_Entity.actual"
                f"\t{ents[0][0]}\t{ents[0][1]}\t0.7",
                "short line",
            ]
        for kind, lines in (("entity", ent), ("event", evt)):
            path = os.path.join(root, f"{kind}_{part}.cs")
            with open(path, "w") as fh:
                fh.write("\n".join(lines) + "\n")
            out[kind, part] = (path, suffix)
    # caption mapping keyed by doc (the captions' image ids are the docs')
    mapping = {}
    for part in ("a", "b"):
        for d in range(N_DOCS):
            mapping.setdefault(f"{PREFIX}_{d}{part}", {})["0"] = {
                "url": "", "cap": f"FILE - trigger0 in city {d}: rebels and police at the base.",
            }
    out["mapping"] = os.path.join(root, "mapping.json")
    with open(out["mapping"], "w") as fh:
        json.dump(mapping, fh)
    out["templates"] = os.path.join(root, "templates.json")
    with open(out["templates"], "w") as fh:
        json.dump(TEMPLATES, fh)
    out["cs_inputs"] = [list(out[k, p]) for p in ("a", "b") for k in ("entity", "event")]
    return out


def jsonable(obj) -> str:
    """Dict contents and order as the JSON dumps see them."""
    return json.dumps(obj, default=list)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_corpus")
    return str(root), write_corpus(str(root))


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("CLIP_EVENT_NATIVE", "0")
    monkeypatch.delenv("CLIP_EVENT_IMAGE_CACHE", raising=False)


def _stores(corpus):
    from clip_event_tpu.preprocess.ke import load_cs_files as jax_load
    from clip_event_tpu_torch.preprocess.ke import load_cs_files

    inputs = [tuple(x) for x in corpus[1]["cs_inputs"]]
    return load_cs_files(inputs), jax_load(inputs)


def test_load_cs_files_matches_jax(corpus):
    ours, ref = _stores(corpus)
    assert list(ours) == list(ref)
    for key in ref:
        assert jsonable(ours[key]) == jsonable(ref[key]), key
    # every branch of the loader saw data
    assert any(v.get("link") for v in ref["entity_info"].values())
    assert any(v.get("relation") for v in ref["doc_ke"].values())
    assert any("_b" in k for k in ref["evt_args"])
    assert sum(len(v["event"]) for v in ours["doc_ke"].values()) > N_DOCS


class StubScorer:
    """The same fixed CLIP predictions for both packages' selection."""

    def __init__(self, doc_ids):
        self.id2str = list(TEMPLATES)
        rng = np.random.default_rng(1)
        self.preds = {}
        for i, doc in enumerate(doc_ids):
            if i % 5 == 4:
                self.preds[doc] = {"scores": 0.0, "pred_idx": -1, "probs": []}
            else:
                self.preds[doc] = {"scores": float(rng.uniform(0.2, 1.0)),
                                   "pred_idx": int(rng.integers(len(self.id2str))), "probs": []}

    def score_all(self, doc_ids, image_paths):
        return {d: self.preds[d] for d in doc_ids}


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("merge_args", [True, False])
def test_select_salient_events_matches_jax(corpus, clip, merge_args):
    from clip_event_tpu.preprocess.selection import select_salient_events as jax_select
    from clip_event_tpu_torch.preprocess.selection import select_salient_events

    ours, ref = _stores(corpus)
    scorer = StubScorer(list(ref["doc_ke"])) if clip else None
    a = select_salient_events(ours, scorer=scorer, merge_args=merge_args)
    b = jax_select(ref, scorer=scorer, merge_args=merge_args)
    assert jsonable(a) == jsonable(b)
    assert len(a) == 2 * N_DOCS - 2  # the two docs without an event


STYLE_CASES = {
    "template": (["template"], ["template"], {}),
    "short_shortverb": (["short", "shortverb"], ["short", "shortverb"], {}),
    "caption": (["caption"], ["caption"], {}),
    "all_styles": (["caption", "template", "short", "shortverb"],
                   ["template", "short", "caption", "shortverb"], {}),
    "sample_neg_arg_neg2": (["template", "short"], ["template", "short", "caption"],
                            {"sample_neg_arg": True, "neg_num": 2}),
    "no_rolename_seed7": (["template"], ["template", "caption"], {"use_rolename": False, "seed": 7}),
}


@pytest.mark.parametrize("case", list(STYLE_CASES))
def test_generate_descriptions_matches_jax(corpus, tmp_path, case):
    from clip_event_tpu.preprocess import templates as JT
    from clip_event_tpu.preprocess.selection import preprocess_caption as jax_caption
    from clip_event_tpu.preprocess.selection import select_salient_events as jax_select
    from clip_event_tpu_torch.preprocess import templates as TT
    from clip_event_tpu_torch.preprocess.selection import preprocess_caption

    pos, neg, kw = STYLE_CASES[case]
    files = corpus[1]
    captions = preprocess_caption([files["mapping"]])
    assert jsonable(captions) == jsonable(jax_caption([files["mapping"]]))
    ref_store = _stores(corpus)[1]
    salient = jax_select(ref_store)
    a = TT.generate_descriptions(pos, neg, TEMPLATES, salient, captions, **kw)
    b = JT.generate_descriptions(pos, neg, TEMPLATES, salient, captions, **kw)
    assert jsonable(a) == jsonable(b)
    assert a and all(v.get("pos") for v in a.values())
    TT.write_descriptions(a, str(tmp_path / "ours.json"))
    JT.write_descriptions(b, str(tmp_path / "ref.json"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert JT.build_negative_type_pool(salient) == TT.build_negative_type_pool(salient)


# ---------------------------------------------------------------- scorer
TYPE_DESC = {
    "Conflict.Attack": "An image of an attack with weapons.",
    "Conflict.Demonstrate": {"desc_auto_name": "An image of protesters marching."},
    "Justice.Arrest": "An image of police arresting a person.",
    "Movement.Transport": "An image of a vehicle transporting goods.",
    "Contact.Meet": "An image of officials meeting.",
    "Life.Die": "An image of a funeral.",
}


def write_images(root, doc_ids, seed=0):
    """Six seeded JPEGs of 48 x 64 (+ noise blocks), the seventh doc's file
    missing, the eighth's corrupt. Returns {doc: path}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = {doc: os.path.join(root, doc + ".jpg") for doc in doc_ids}
    for doc in doc_ids[:6]:
        base = rng.integers(0, 256, size=(1, 1, 3)) * np.ones((48, 64, 3))
        arr = np.clip(base + rng.normal(0, 40, size=(48, 64, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(paths[doc], quality=90)
    with open(paths[doc_ids[7]], "wb") as fh:
        fh.write(b"not a jpeg at all")
    return paths


@pytest.fixture(scope="module")
def weights():
    np_params = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), JCFG))
    return np_params, params_from_jax(np_params, TCFG, "cpu")


def _flat_desc():
    return {t: (v["desc_auto_name"] if isinstance(v, dict) else v) for t, v in TYPE_DESC.items()}


def _count_image_encodes(scorer):
    calls = []
    inner = scorer._enc.images

    def counted(x):
        calls.append(len(x))
        return inner(x)

    scorer._enc.images = counted
    return calls


def test_scorer_matches_jax_and_caches_cross(tmp_path, weights):
    from clip_event_tpu.preprocess.selection import ClipTypeScorer as JaxScorer
    from clip_event_tpu_torch.preprocess.selection import ClipTypeScorer

    np_params, params = weights
    docs = [f"{PREFIX}_{d}a_0" for d in range(8)]
    paths = write_images(str(tmp_path / "img"), docs)
    jc, tc = str(tmp_path / "cache_jax"), str(tmp_path / "cache_port")
    ref = JaxScorer(np_params, JCFG, _flat_desc(), cache_dir=jc).score_all(docs, paths)
    scorer = ClipTypeScorer(params, TCFG, _flat_desc(), cache_dir=tc, device="cpu")
    assert scorer.id2str == list(TYPE_DESC)
    ours = scorer.score_all(docs, paths)
    assert list(ours) == list(ref)
    for doc in docs:
        o, r = ours[doc], ref[doc]
        assert o["pred_idx"] == r["pred_idx"], doc
        if r["pred_idx"] == -1:
            assert o == r
            continue
        assert len(o["probs"]) == len(TYPE_DESC)
        assert np.max(np.abs(np.subtract(o["probs"], r["probs"]))) <= PROB_TOL, doc
        assert abs(o["scores"] - r["scores"]) <= PROB_TOL
    assert [ours[d]["pred_idx"] for d in docs[6:]] == [-1, -1]
    assert sorted(os.listdir(tc)) == sorted(os.listdir(jc)) == sorted(d + ".json" for d in docs[:6])

    # the port reads JAX's cache and JAX the port's; a cached doc encodes nothing
    port_on_jax = ClipTypeScorer(params, TCFG, _flat_desc(), cache_dir=jc, device="cpu")
    calls = _count_image_encodes(port_on_jax)
    assert port_on_jax.score_all(docs, paths) == ref and calls == []
    jax_on_port = JaxScorer(np_params, JCFG, _flat_desc(), cache_dir=tc)
    assert jax_on_port.score_all(docs, paths) == ours
    # one uncached doc: one image encoded, the rest read from the cache
    os.remove(os.path.join(tc, docs[0] + ".json"))
    calls = _count_image_encodes(scorer)
    again = scorer.score_all(docs, paths)
    assert calls == [1] and sorted(again) == sorted(docs)
    assert all(again[d] == ours[d] for d in docs[1:])
    # (alone in its padded batch: the CPU's GEMM blocking may move a bit)
    assert again[docs[0]]["pred_idx"] == ours[docs[0]]["pred_idx"]
    assert np.max(np.abs(np.subtract(again[docs[0]]["probs"], ours[docs[0]]["probs"]))) <= PROB_TOL


# ------------------------------------------------------------- the CLI
def _cli_cfg(files, out_dir, **extra):
    return {
        "output_dir": out_dir, "cs_inputs": files["cs_inputs"],
        "image_caption_json": [files["mapping"]], "template_file": files["templates"],
        "positive_option": ["template", "short"], "negative_option": ["template", "caption"],
        "seed": 3, **extra,
    }


@pytest.mark.parametrize("add_clip_sim", [False, True])
def test_preprocess_descriptions_cli_matches_jax(corpus, tmp_path, monkeypatch, add_clip_sim):
    import preprocess_descriptions as jax_cli
    from clip_event_tpu.engine.checkpoint import export_torch_checkpoint
    from clip_event_tpu_torch import preprocess_descriptions as cli

    root, files = corpus
    extra = {}
    if add_clip_sim:
        pth = str(tmp_path / "clip.pth")
        export_torch_checkpoint(pth, J.init_params(jax.random.PRNGKey(1), JCFG), JCFG, epoch=0, task="clip")
        docs = [f"{PREFIX}_{d}{p}_0" for p in ("a", "b") for d in range(N_DOCS)]
        write_images(str(tmp_path / "img"), docs[:8])
        write_images(str(tmp_path / "img"), docs[8:], seed=1)
        with open(tmp_path / "types.json", "w") as fh:
            json.dump(TYPE_DESC, fh)
        extra = {"add_clip_sim": True, "clip_ckpt": pth, "type_descriptions_json": str(tmp_path / "types.json"),
                 "image_dirs": {PREFIX: str(tmp_path / "img")}, "merge_args": False}
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        cfg = _cli_cfg(files, str(tmp_path / f"out_{name}"),
                       **dict(extra, clip_cache_dir=str(tmp_path / f"cache_{name}")) if extra else {})
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["preprocess_descriptions.py", "--cfg", str(path)])
            main()
        else:
            main(["--cfg", str(path), "--device", "cpu"])
        outs[name] = cfg["output_dir"]
    names = sorted(os.listdir(outs["jax"]))
    salient = f"doc_salient_event_{add_clip_sim}_merge{not add_clip_sim}.json"
    assert names == sorted(["image_caption_clean.json", "doc_ke.json", "entity_info.json", "evt_info.json",
                            "evt_args.json", salient, "descriptions_templateshort_templatecaption.json"])
    assert sorted(os.listdir(outs["port"])) == names
    for n in names:
        with open(os.path.join(outs["port"], n), "rb") as a, open(os.path.join(outs["jax"], n), "rb") as b:
            assert a.read() == b.read(), n
    if add_clip_sim:
        # the CLIP votes changed the choice of some docs' events
        from clip_event_tpu_torch.preprocess.selection import select_salient_events

        with open(os.path.join(outs["port"], salient)) as fh:
            ranked = json.load(fh)
        plain = select_salient_events(_stores(corpus)[0], merge_args=False)
        assert any(ranked[d]["event_id"] != plain[d]["event_id"] for d in plain)
        cached = sorted(os.listdir(tmp_path / "cache_port"))
        assert cached == sorted(os.listdir(tmp_path / "cache_jax")) and len(cached) == 12
        for n in cached:
            with open(tmp_path / "cache_port" / n) as a, open(tmp_path / "cache_jax" / n) as b:
                o, r = json.load(a), json.load(b)
            assert o["pred_idx"] == r["pred_idx"]
            assert np.max(np.abs(np.subtract(o["probs"], r["probs"]))) <= PROB_TOL


def test_preprocess_descriptions_cli_raises_without_a_card(corpus, tmp_path):
    from clip_event_tpu_torch import preprocess_descriptions as cli

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_cli_cfg(corpus[1], str(tmp_path / "out"))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--cfg", str(path)])
    assert not (tmp_path / "out").exists()


# ----------------------------------------------------------------- zoo
def test_zoo_load_local_file_matches_jax(tmp_path, weights):
    from PIL import Image

    from clip_event_tpu import zoo as JZ
    from clip_event_tpu.engine.checkpoint import export_torch_checkpoint
    from clip_event_tpu_torch import zoo as TZ

    np_params, _ = weights
    pth = str(tmp_path / "tiny.pth")
    export_torch_checkpoint(pth, np_params, JCFG, epoch=0, task="tiny")
    params, cfg, pre = TZ.load(pth, device="cpu")
    jparams, jcfg, jpre = JZ.load(pth)
    assert cfg == TCFG and jcfg == JCFG
    ref = params_from_jax(jax.tree.map(np.asarray, jparams), TCFG, "cpu")
    flat_a, flat_b = _flat(params), _flat(ref)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype, k
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (45, 61, 3), dtype=np.uint8))
    x, y = pre(img), jpre(img)
    assert x.shape == (32, 32, 3) and x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert TZ.available_models() == JZ.available_models()
    texts = ["an image of a protest", "Police arrest a thief at the border."]
    np.testing.assert_array_equal(TZ.tokenize(texts), JZ.tokenize(texts))
    np.testing.assert_array_equal(TZ.tokenize(texts, 16), JZ.tokenize(texts, 16))
    with pytest.raises(RuntimeError, match="not found"):
        TZ.load(str(tmp_path / "missing.pth"), device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, item in enumerate(v):
                out.update(_flat(item, f"{prefix}{k}.{i}."))
        else:
            out[prefix + k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out
