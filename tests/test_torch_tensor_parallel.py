"""Tensor, sequence and multi-slice data parallelism of the port in one
process, on the CPU, against the JAX package: the leaf rule of the tp
layout against JAX's `param_shardings` on the 8-device virtual mesh; the
head-group reorder in the weight against the reorder JAX's
`sharded_attention_tp` makes in the activation; each head group's
attention run rank by rank through the port's plain versions (and the
"attn" policy's `_AttentionSaved`) against JAX's head-group-parallel
Pallas kernel in interpret mode; the sequence-parallel pad and chunks at
odd S; the model-parallel config rules and messages against JAX's
`validate_config`; the mesh's arithmetic. The multi-rank steps are in
tests/test_torch_tp_ranks.py.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from clip_event_tpu import config as JC  # noqa: E402
from clip_event_tpu.models import clip as J  # noqa: E402
from clip_event_tpu.models import layers as JL  # noqa: E402
from clip_event_tpu.parallel.sharding import TENSOR_AXIS, make_mesh_2d, param_shardings  # noqa: E402
from clip_event_tpu_torch import config as TC  # noqa: E402
from clip_event_tpu_torch.engine.optim import tree_leaves, tree_unflatten  # noqa: E402
from clip_event_tpu_torch.models import clip as T  # noqa: E402
from clip_event_tpu_torch.models import layers as TL  # noqa: E402
from clip_event_tpu_torch.ops import attention as A  # noqa: E402
from clip_event_tpu_torch.parallel import collectives as TCO  # noqa: E402
from clip_event_tpu_torch.parallel import mesh as TM  # noqa: E402
from clip_event_tpu_torch.parallel import sharding as TS  # noqa: E402
from tests.test_model_parity import TINY_VIT  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tiny model whose stacks split over tp = 2 and 4 (vision: 256 / 64 = 4
# heads; text: 4 heads)
TINY_TP = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=256,
               vision_patch_size=16, context_length=16, vocab_size=128, transformer_width=64,
               transformer_heads=4, transformer_layers=2)
PRESETS = {"ViT-B/32": "VIT_B32", "ViT-B/16": "VIT_B16", "ViT-L/14": "VIT_L14"}


def _jax_dims(shapes, mesh):
    """JAX's layout as the port states it: the dim 'tp' splits, or None."""
    def dim(s):
        spec = tuple(s.spec)
        return spec.index(TENSOR_AXIS) if TENSOR_AXIS in spec else None

    return jax.tree.map(dim, param_shardings(shapes, mesh))


def _meta_tree(shapes):
    """The port's tree of meta tensors at JAX's shapes (the ViT layouts are
    the same in both packages)."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)


def _port_dims(params, cfg, tp):
    """The port's layout in the same terms: the dim of the full leaf its
    `TPSpec` splits (counted from the front), or None."""
    leaves = tree_leaves(params)
    dims = [None if s.kind is None else TS._TP_DIM[s.kind] % x.dim()
            for s, x in zip(TS.tp_specs(params, cfg, tp), leaves)]
    return tree_unflatten(params, dims)


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


@pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2)])
@pytest.mark.parametrize("model", ["TINY_VIT", "TINY_TP", "ViT-B/32", "ViT-B/16", "ViT-L/14"])
def test_leaf_rule_matches_jax_param_shardings(model, dp, tp):
    """The same leaves split on the same dims as JAX's `param_shardings`
    on a (dp × tp) mesh, shapes only. The one difference is the tower
    rule: a stack whose heads do not divide tp (TINY_VIT's single head)
    stays whole, where JAX splits each leaf whose dim divides."""
    if model in PRESETS:
        jcfg, tcfg = getattr(J, PRESETS[model]), getattr(T, PRESETS[model])
    else:
        spec = TINY_TP if model == "TINY_TP" else dict(TINY_VIT.__dict__)
        jcfg, tcfg = J.CLIPConfig(**spec), T.CLIPConfig(**spec)
    shapes = jax.eval_shape(lambda: J.init_params(jax.random.PRNGKey(0), jcfg))
    want = _flat(_jax_dims(shapes, make_mesh_2d(dp=dp, tp=tp)))
    got = _flat(_port_dims(_meta_tree(shapes), tcfg, tp))
    assert got.keys() == want.keys()
    heads = {"text_transformer": tcfg.transformer_heads, "visual.transformer": tcfg.vision_heads}
    differ = {k for k in want if got[k] != want[k]}
    for k in differ:
        stack = next(s for s in heads if k.startswith(s + "."))
        assert heads[stack] % tp and got[k] is None, k
    if model != "TINY_VIT":
        assert not differ
    assert got["token_embedding"] == 0
    assert sum(v is not None for v in got.values()) == (13 if model != "TINY_VIT" else 1)


def test_head_group_reorder_is_in_the_weight():
    """Rank g's projection through its `qkv_w` / `qkv_b` slices is the g-th
    tp chunk of JAX's head-group-reordered activation
    (`attention_pallas.py:357-362`); the slices gather back to the full
    leaves bit for bit."""
    rng = np.random.default_rng(0)
    B, S, W, L = 2, 5, 64, 4
    for tp in (2, 4):
        wl = W // tp
        x = rng.normal(size=(B, S, W)).astype(np.float32)
        w = rng.normal(size=(L, W, 3 * W)).astype(np.float32)
        b = rng.normal(size=(L, 3 * W)).astype(np.float32)
        qkv = jnp.einsum("bsw,wk->bsk", x, w[1], precision="highest") + b[1]
        reordered = np.asarray(qkv.reshape(B, S, 3, tp, wl).transpose(0, 1, 3, 2, 4).reshape(B, S, 3 * W))
        spec = TS.TPSpec("qkv")
        for g in range(tp):
            wg, bg = spec.shard_of(torch.from_numpy(w), tp, g), spec.shard_of(torch.from_numpy(b), tp, g)
            assert wg.shape == (L, W, 3 * wl) and bg.shape == (L, 3 * wl)
            local = (torch.from_numpy(x) @ wg[1] + bg[1]).numpy()
            np.testing.assert_allclose(local, reordered[..., g * 3 * wl:(g + 1) * 3 * wl], atol=2e-5, rtol=0)
        for full in (w, b):
            shards = torch.stack([spec.shard_of(torch.from_numpy(full), tp, g) for g in range(tp)])
            assert torch.equal(spec.from_shards(shards), torch.from_numpy(full))
        for kind, dim in (("column", -1), ("row", -2), ("vocab", 0)):
            spec2 = TS.TPSpec(kind)
            shards = torch.stack([spec2.shard_of(torch.from_numpy(w), tp, g) for g in range(tp)])
            assert shards.shape[1 + dim % 3] == w.shape[dim] // tp
            assert torch.equal(spec2.from_shards(shards), torch.from_numpy(w))


def _port_tp_attention(x, p, H, bias, tp, remat):
    """One block's attention sublayer as a tp group computes it, rank by
    rank in one process: each rank's slices, its H/tp heads through the
    plain versions (`attention_core` on a CPU tensor; under remat the
    "attn" policy's `_AttentionSaved` with the rank's `TPBlock`), the row-parallel
    partial products summed (g), `out_b` once."""
    scale = (x.shape[-1] // H) ** -0.5
    col, row = TS.TPSpec("qkv"), TS.TPSpec("row")
    out = 0
    for g in range(tp):
        qkv_w, qkv_b = col.shard_of(p["qkv_w"], tp, g), col.shard_of(p["qkv_b"], tp, g)
        if remat:
            o = TL._AttentionSaved.apply(x, p["ln_1"]["scale"], p["ln_1"]["bias"], qkv_w, qkv_b, bias, H,
                                         "kernel", "xla", TL.TPBlock(_Rank(g, tp), False, x.shape[1]))
        else:
            h = TL.layer_norm(x, p["ln_1"])
            o = TL.attention_core(TL.linear(h, qkv_w, qkv_b), bias, H // tp, scale, "kernel")
        out = out + o @ row.shard_of(p["out_w"], tp, g)
    return out + p["out_b"]


@pytest.mark.parametrize("remat", [False, True])
def test_head_groups_match_jax_sharded_attention_tp(remat):
    """At test_tp_pallas_attention_matches_einsum's shape (W=64, H=4, S=16,
    B=4; mesh dp=2 × tp=2): the port's head groups, concatenated by the
    row-parallel sum, against JAX's `sharded_attention_tp` (the Pallas
    kernel in interpret mode, reached through `multi_head_attention` with
    a tp mesh): forward and the gradients of the params and the input, at
    that test's tolerances."""
    W, H, S, B, tp = 64, 4, 16, 4, 2
    tt = JL.init_transformer(jax.random.PRNGKey(1), 1, W)
    layer = jax.tree.map(lambda a: a[0], tt)
    rng = np.random.default_rng(3)
    layer = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), layer)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    bias = JL.causal_mask(S)
    mesh = make_mesh_2d(dp=2, tp=tp)

    def jax_fn(p, xx):
        h = JL.layer_norm(xx, p["ln_1"])
        return JL.multi_head_attention(h, p["attn"], H, bias, impl=("pallas", mesh))

    ref = np.asarray(jax_fn(layer, x))
    gref = jax.grad(lambda p, xx: jnp.sum(jax_fn(p, xx) ** 2), argnums=(0, 1))(layer, jnp.asarray(x))

    tp_params = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in layer["attn"].items()}
    tp_params["ln_1"] = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in layer["ln_1"].items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = _port_tp_attention(xt, tp_params, H, torch.from_numpy(np.array(bias)), tp, remat)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=3e-5, rtol=1e-4)
    (out ** 2).sum().backward()
    pairs = [(xt.grad, gref[1])] + [(tp_params[k].grad, gref[0]["attn"][k]) for k in layer["attn"]]
    pairs += [(tp_params["ln_1"][k].grad, gref[0]["ln_1"][k]) for k in ("scale", "bias")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)


class _Rank:
    """A tp group's view, for the sequence helpers that need no process
    group."""

    def __init__(self, rank, world_size):
        self.rank, self.world_size = rank, world_size


@pytest.mark.parametrize("seq,tp", [(77, 2), (257, 2), (197, 4), (50, 4), (5, 2)])
def test_sequence_parallel_pad_and_chunks(seq, tp):
    """Odd S: the stream pads to a multiple of tp, each rank holds one
    ⌈S/tp⌉-row chunk, the chunks laid side by side are the padded stream,
    and the exit drops the pad; the pad rows are zeros going in."""
    block = TL.TPBlock(_Rank(0, tp), True, seq)
    assert block.padded == -(-seq // tp) * tp and block.padded - seq < tp
    x = torch.randn(2, seq, 8)
    padded = torch.nn.functional.pad(x, (0, 0, 0, block.padded - seq))
    chunks = [TCO._seq_chunk(padded, _Rank(r, tp)) for r in range(tp)]
    assert all(c.shape == (2, block.padded // tp, 8) for c in chunks)
    whole = torch.cat(chunks, dim=1)
    assert torch.equal(whole[:, :seq], x) and not whole[:, seq:].any()


def test_mesh_axes_and_groups_in_the_flat_order():
    """rank = (dcn_idx·DP + dp_idx)·TP + tp_idx; each subgroup's ranks: the
    tp and data groups, and under dcn the slice groups (a slice's data
    ranks) and the cross groups (a dp_idx's ranks across the slices), which
    ZeRO-1 / FSDP shard within and sum across."""
    groups = TM._axis_groups(8, tp=2, dcn=2)
    assert groups["tp_group"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert groups["data_group"] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert groups["slice_group"] == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert groups["cross_group"] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert sorted(groups) == ["cross_group", "data_group", "slice_group", "tp_group"]
    assert TM._axis_groups(4, 1, 1) == {}
    assert TM._axis_groups(4, 1, 2) == {"slice_group": [[0, 1], [2, 3]], "cross_group": [[0, 2], [1, 3]]}
    m = TM.Mesh(5, 8, torch.device("cpu"), tp=2, dcn=2)
    assert (m.dp, m.dcn_idx, m.dp_idx, m.tp_idx) == (2, 1, 0, 1)
    assert (m.data.rank, m.data.world_size, m.data.dcn) == (2, 4, 2)
    assert (m.tensor.rank, m.tensor.world_size) == (1, 2) and TM.data_size(m) == 4
    plain = TM.Mesh(1, 2, torch.device("cpu"))
    assert plain.data is plain and plain.dp == 2


def test_make_mesh_refuses_what_does_not_divide():
    """JAX's message (`train.py:269-273`) at a world of one (no group), and
    sp without tp as JAX's `set_sequence_parallel` refuses it."""
    with pytest.raises(ValueError, match="dcn_dp=1 x tp=2 does not divide device count 1"):
        TM.make_mesh("cpu", tp=2)
    with pytest.raises(ValueError, match="dcn_dp=2 x tp=1 does not divide device count 1"):
        TM.make_mesh("cpu", dcn=2)
    with pytest.raises(ValueError, match="requires a 'tp' mesh axis"):
        TM.make_mesh("cpu", sp=True)
    assert TM.make_mesh("cpu").tp == 1
    assert TM.data_process_group(1) == (0, 1)
    with pytest.raises(ValueError, match="does not divide process_count=1"):
        TM.data_process_group(2)
    # a pp group's ranks load one data rank's rows: rank // (tp·pp)
    with pytest.raises(ValueError, match="does not divide process_count=1"):
        TM.data_process_group(1, pp=2)


def test_tp_kernels_refuse_a_head_group_no_kernel_takes():
    """B/16's vision tower at tp = 4 (W/tp = 192, S = 197) takes neither K1
    nor K2: the setup check names the tower and the shape; every tp = 2
    head group of the presets has its kernel."""
    with pytest.raises(ValueError, match=r"transformer stack's head group \(S=197, W=192, H=3\)"):
        TS.check_tp_kernels(T.VIT_B16, 4)
    for cfg in (T.VIT_B32, T.VIT_B16, T.VIT_L14):
        TS.check_tp_kernels(cfg, 2)
    assert A.core_kernel(257, 512, 8) == "k2" and A.core_kernel(197, 384, 6) == "k2"
    assert A.core_kernel(77, 384, 6) == "k1" and A.core_kernel(50, 384, 6) == "k1"


def test_a_sliced_stack_needs_the_tp_group():
    """A stack of a tp rank's slices run without `set_tensor_parallel`
    refuses, as does a vocab-parallel embedding; a whole stack runs as
    before under a tp group."""
    params = T.init_params(torch.Generator().manual_seed(0), T.CLIPConfig(**TINY_TP), "cpu")
    stack = params["text_transformer"]
    sliced = dict(stack, attn=dict(stack["attn"], qkv_w=stack["attn"]["qkv_w"][..., :96]))
    x = torch.randn(2, 16, 64)
    with pytest.raises(ValueError, match="set_tensor_parallel"):
        TL.transformer(x, sliced, 4, impl="plain")
    with pytest.raises(ValueError, match="set_tensor_parallel"):
        T.embed_tokens(params["token_embedding"][:64], torch.zeros(2, 3, dtype=torch.long), 128)
    assert TL.resolve_tensor_parallel() is None
    assert TL._stack_tp(stack, x) is None


BASE = {"task": "t", "constrastive_loss": "ce", "batch_size": 2, "lr": 1e-4,
        "optimizer": "adam", "max_epoch": 1, "posneg_descriptions_json": "x",
        "image_caption_json": ["x"], "image_dir": ["x"], "ckpt_dir": "c", "tb_log_dir": "l"}


@pytest.mark.parametrize("extra", [
    {"tp": 2}, {"tp": 4, "sp": True}, {"dcn_dp": 2}, {"tp": 2, "dcn_dp": 2, "sp": True},
    {"tp": 0}, {"tp": 1.5}, {"sp": True}, {"dcn_dp": 0}, {"pp_microbatches": 0},
])
def test_model_parallel_rules_match_jax(extra):
    """The JAX package's tp / sp / dcn_dp rules with its messages."""
    try:
        ref = JC.validate_config(dict(BASE, **extra))
    except JC.ConfigError as err:
        with pytest.raises(TC.ConfigError) as got:
            TC.validate_config(dict(BASE, **extra))
        assert str(got.value) == str(err)
    else:
        assert TC.validate_config(dict(BASE, **extra)) == ref


@pytest.mark.parametrize("extra", [
    {"pp": 2}, {"pp": 2, "tp": 2}, {"tp": 2, "zero": True}, {"tp": 2, "fsdp": True},
    {"dcn_dp": 2, "zero": True}, {"dcn_dp": 2, "fsdp": True},
])
def test_what_stays_refused_names_a6c(extra):
    """pp, and ZeRO-1 / FSDP composed with tp or dcn_dp, once refused for
    A6(c): now validated as the JAX package validates them, accepted with
    the same config, or refused with its message (pp × tp); no refusal
    names A6(c) any more."""
    try:
        ref = JC.validate_config(dict(BASE, **extra))
    except JC.ConfigError as err:
        with pytest.raises(TC.ConfigError) as got:
            TC.validate_config(dict(BASE, **extra))
        assert str(got.value) == str(err) and "A6(c)" not in str(got.value)
    else:
        assert TC.validate_config(dict(BASE, **extra)) == ref
    assert TC._UNPORTED == {}


def test_pretrain_vitl14_tp2_validates_as_in_jax():
    with open(os.path.join(REPO, "configs", "pretrain_vitl14_tp2.json")) as fh:
        raw = json.load(fh)
    ours = TC.validate_config(raw)
    assert ours == JC.validate_config(raw)
    assert (ours["tp"], ours["remat"], ours["steps_per_dispatch"]) == (2, "attn", 4)
    TS.check_tp_kernels(TC.model_config(ours), ours["tp"])


def test_tp_layout_partial_leaves():
    """The whole leaves whose gradient a tp rank holds in part: ln_1 of
    every split stack, and under sp ln_2, out_b and proj_b too; none of a
    whole stack (TINY_VIT at tp = 2)."""
    for spec, n_partial in ((TINY_TP, (4, 12)), (dict(TINY_VIT.__dict__), (0, 0))):
        cfg = T.CLIPConfig(**spec)
        params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        for sp, want in zip((False, True), n_partial):
            specs = TS.tp_specs(params, cfg, 2, sp)
            assert len(specs) == len(tree_leaves(params))
            assert sum(s.partial for s in specs) == want
