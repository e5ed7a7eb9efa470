"""The port's backbones (``repro_torch.models.transformer`` / ``stacked``)
and parameter accounting against the reference's on the CPU, on the
reference's weights, for all ten archs.  Exact: the layer grouping,
``from_layerwise``, the parameter counts and bytes at full size, the
in-situ prune masks.  Logits of both forwards at rtol = atol = 1e-4, with
the frontend stub given to the VLM and audio archs and their cross-attention
gates opened to 0.5 (at init they are 0 and the layer adds nothing).  The
periodic archs run at 4 layers, the first depth at which the reduced
configs form a periodic segment.  The serving path (caches, decode) is in
``test_torch_models_decode.py``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as RP
from repro.models import accounting as RA
from repro.models import stacked as RS
from repro.models import transformer as RT
from repro.models.config import ALL_SHAPES
from repro.pruning import insitu as ref_insitu
from repro_torch import configs, tree
from repro_torch.data import pipeline as P
from repro_torch.models import accounting as A
from repro_torch.models import stacked as S
from repro_torch.models import transformer as T
from repro_torch.pruning import insitu

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = list(ref_configs.ARCH_IDS)
# reduced depths: a periodic segment needs n_layers // period > 1 (the
# reduced period is 2); deepseek-v2 at 4 stacks 3 MoE layers after 1 dense
LAYERS = {"zamba2_2_7b": 4, "llama_3_2_vision_90b": 4,
          "musicgen_medium": 4, "deepseek_v2_236b": 4}
# a period holding a run of more than one layer: leaves (reps, count, ...)
LONG_PERIODS = {"zamba2_2_7b": dict(hybrid_every=3),
                "llama_3_2_vision_90b": dict(xattn_every=3)}


def _cfgs(arch, **kw):
    kw.setdefault("n_layers", LAYERS.get(arch, 2))
    return (ref_configs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


def _long_period_cfgs(arch):
    """6 layers of period 3: two repetitions of [run of 2, run of 1]."""
    rcfg, cfg = _cfgs(arch, n_layers=6)
    kw = LONG_PERIODS[arch]
    return (dataclasses.replace(rcfg, **kw), dataclasses.replace(cfg, **kw))


def _open_gates(params):
    """The reference's params with every cross-attention gate at 0.5."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.full_like(a, 0.5)
        if getattr(p[-1], "key", None) == "gate" else a, params)


def _frontends(rcfg, cfg, batch):
    """(the reference's frontend stub, the port's) or (None, None)."""
    if not cfg.frontend_tokens:
        return None, None
    return RP.frontend_stub(rcfg, batch), P.frontend_stub(cfg, batch, CPU)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _same_tree(got, want):
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = tree.flatten_with_path(got)
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.fixture(scope="module")
def stacked_params():
    """arch -> (reference config, port config, reference stacked params,
    the same weights as tensors)."""
    out = {}
    for arch in ARCHS:
        rcfg, cfg = _cfgs(arch)
        rp = _open_gates(RS.init_params(rcfg, jax.random.PRNGKey(0)))
        out[arch] = (rcfg, cfg, rp, tree.params_from_numpy(rp, CPU))
    return out


# ---------------------------------------------------------------------------
# Layer grouping, layout.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_segments_match_reference(arch, reduced):
    rcfg, cfg = (ref_configs.get_config(arch), configs.get_config(arch))
    if reduced:
        rcfg, cfg = rcfg.reduced(n_layers=12), cfg.reduced(n_layers=12)
    assert repr(S.segments(cfg)) == repr(RS.segments(rcfg))
    assert [repr(S.layer_sig(cfg, i)) for i in range(cfg.n_layers)] == \
        [repr(RS.layer_sig(rcfg, i)) for i in range(rcfg.n_layers)]
    assert T._layer_kinds(cfg) == RT._layer_kinds(rcfg)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_from_layerwise_matches_reference(arch):
    # the restructuring alone: the reference's layerwise weights carried
    # across, stacked by both packages (every arch, ported kinds or not)
    rcfg, cfg = _cfgs(arch, n_layers=6)
    lw = RT.init_params(rcfg, jax.random.PRNGKey(1))
    _same_tree(S.from_layerwise(cfg, tree.params_from_numpy(lw, CPU)),
               RS.from_layerwise(rcfg, lw))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch, stacked_params):
    rcfg, cfg, rp, _ = stacked_params[arch]
    gen = torch.Generator().manual_seed(0)
    for got, want in ((S.init_params(cfg, gen, CPU), rp),
                      (T.init_params(cfg, gen, CPU),
                       RT.init_params(rcfg, jax.random.PRNGKey(0)))):
        want = jax.tree_util.tree_flatten_with_path(want)[0]
        got = tree.flatten_with_path(got)
        assert [tree.keystr(p) for p, _ in got] == \
            [jax.tree_util.keystr(p) for p, _ in want]
        for (_, a), (_, b) in zip(want, got):
            assert tuple(b.shape) == a.shape
            assert str(b.dtype).split(".")[-1] == str(a.dtype)


def test_stacked_init_fills_layers_from_the_generator():
    _, cfg = _cfgs("qwen2_moe_a2_7b", n_layers=3)
    p1 = S.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    p2 = S.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    wi = p1["segments"][0]["moe"]["wi"]
    assert torch.equal(wi, p2["segments"][0]["moe"]["wi"])
    # each layer its own draw
    assert not torch.equal(wi[0], wi[1]) and not torch.equal(wi[1], wi[2])
    # the layers of a stack are the blocks drawn one after the other: the
    # stacked init equals the layerwise init, stacked
    lw = T.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    want = dict(tree.flatten_with_path(S.from_layerwise(cfg, lw)))
    got = tree.flatten_with_path(p1)
    assert [p for p, _ in got] == list(want)
    for path, t in got:
        assert torch.equal(t, want[path]), tree.keystr(path)


@pytest.mark.parametrize("arch", sorted(LONG_PERIODS))
def test_long_period_layout_matches_reference(arch):
    rcfg, cfg = _long_period_cfgs(arch)
    seg = S.segments(cfg)[0]
    assert isinstance(seg, S.Periodic) and seg.reps == 2
    assert [r.count for r in seg.inner] == [2, 1]
    want = jax.tree_util.tree_flatten_with_path(
        RS.init_params(rcfg, jax.random.PRNGKey(0)))[0]
    got = tree.flatten_with_path(
        S.init_params(cfg, torch.Generator().manual_seed(0), CPU))
    assert [(tree.keystr(p), tuple(t.shape)) for p, t in got] == \
        [(jax.tree_util.keystr(p), a.shape) for p, a in want]


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_forward_matches_reference(arch, stacked_params):
    rcfg, cfg, rp, tp = stacked_params[arch]
    toks = _tokens(rcfg, (2, 12), 2)
    fe_r, fe = _frontends(rcfg, cfg, 2)
    want, _, aux_r = RS.forward(rp, rcfg, jnp.asarray(toks, jnp.int32),
                                frontend=fe_r)
    got, caches, aux = S.forward(tp, cfg, torch.tensor(toks), frontend=fe)
    assert caches is None and got.dtype is torch.float32
    assert tuple(got.shape) == (2, 12, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_r), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_layerwise_forward_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    lw = _open_gates(RT.init_params(rcfg, jax.random.PRNGKey(4)))
    tlw = tree.params_from_numpy(lw, CPU)
    toks = _tokens(rcfg, (2, 10), 3)
    fe_r, fe = _frontends(rcfg, cfg, 2)
    want, _, _ = RT.forward(lw, rcfg, jnp.asarray(toks, jnp.int32),
                            frontend=fe_r)
    got, _, _ = T.forward(tlw, cfg, torch.tensor(toks), frontend=fe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same weights stacked give the same logits
    st, _, _ = S.forward(S.from_layerwise(cfg, tlw), cfg, torch.tensor(toks),
                         frontend=fe)
    np.testing.assert_allclose(st.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)
    assert T.param_count(tlw) == RT.param_count(lw)


@pytest.mark.parametrize("arch", sorted(LONG_PERIODS))
def test_long_period_forward_matches_reference(arch):
    rcfg, cfg = _long_period_cfgs(arch)
    rp = _open_gates(RS.init_params(rcfg, jax.random.PRNGKey(6)))
    toks = _tokens(rcfg, (2, 8), 4)
    fe_r, fe = _frontends(rcfg, cfg, 2)
    want, _, _ = RS.forward(rp, rcfg, jnp.asarray(toks, jnp.int32),
                            frontend=fe_r)
    got, _, _ = S.forward(tree.params_from_numpy(rp, CPU), cfg,
                          torch.tensor(toks), frontend=fe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_frontend_is_read_only_by_the_fusion_layers():
    """With the gates closed (as at init) the frontend changes nothing;
    opened, it changes the logits."""
    _, cfg = _cfgs("llama_3_2_vision_90b")
    p = S.init_params(cfg, torch.Generator().manual_seed(5), CPU)
    toks = torch.tensor(_tokens(cfg, (2, 6), 5))
    fe = P.frontend_stub(cfg, 2, CPU)
    bare, _, _ = S.forward(p, cfg, toks)
    assert torch.equal(S.forward(p, cfg, toks, frontend=fe)[0], bare)
    opened = tree.map_with_path(
        lambda path, t: torch.full_like(t, 0.5) if path[-1] == "gate" else t,
        p)
    assert not torch.allclose(S.forward(opened, cfg, toks, frontend=fe)[0],
                              bare)


def test_prune_masks_match_reference():
    rcfg, cfg = _cfgs("olmo_1b")
    lw = RT.init_params(rcfg, jax.random.PRNGKey(5))
    keep = np.random.default_rng(6).random(rcfg.d_model) > 0.3
    toks = _tokens(rcfg, (2, 8), 7)
    want, _, _ = RT.forward(lw, rcfg, jnp.asarray(toks, jnp.int32),
                            prune_masks={"mlp_1": jnp.asarray(keep)})
    got, _, _ = T.forward(tree.params_from_numpy(lw, CPU), cfg,
                          torch.tensor(toks),
                          prune_masks={"mlp_1": torch.tensor(keep)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Accounting at full size (meta device, no memory).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_accounting_matches_reference(arch, monkeypatch):
    # each count re-traces the whole tree; one trace a package serves all
    for mod in (A, RA):
        monkeypatch.setattr(mod, "param_shapes",
                            functools.lru_cache(mod.param_shapes))
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert A.param_count(cfg) == RA.param_count(rcfg)
    assert A.param_bytes(cfg) == RA.param_bytes(rcfg)
    assert A.active_param_count(cfg) == RA.active_param_count(rcfg)
    for shape in ALL_SHAPES:
        assert A.model_flops(cfg, shape) == RA.model_flops(rcfg, shape)
    shapes = A.param_shapes(cfg)
    assert all(t.is_meta for _, t in tree.flatten_with_path(shapes))


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "zamba2_2_7b",
                                  "mamba2_1_3b", "llama_3_2_vision_90b"])
def test_prune_params_visits_the_reference_leaves(arch, stacked_params):
    """The MLP inputs in-situ pruning zeroes: zamba2's shared block
    (``shared_attn/mlp/wi``), deepseek-v2's dense MLP and MoE shared
    experts (not the routed banks), the ``inner`` lists of a periodic
    tree; mamba2 has no MLP (sparsity 0).  Masks and sparsity equal the
    reference's exactly."""
    rcfg, cfg, rp, tp = stacked_params[arch]
    _, want = ref_insitu.prune_params(rp, rcfg, 0.3)
    _, got = insitu.prune_params(tp, cfg, 0.3)
    assert list(got["masks"]) == list(want["masks"])
    for key, mask in want["masks"].items():
        np.testing.assert_array_equal(got["masks"][key].numpy(),
                                      np.asarray(mask))
    assert got["weight_sparsity"] == want["weight_sparsity"]
    assert (got["weight_sparsity"] == 0) == (arch == "mamba2_1_3b")
    keys = " ".join(got["masks"])
    if arch == "zamba2_2_7b":
        assert "['shared_attn']['mlp']['wi']" in keys
    if arch == "deepseek_v2_236b":
        assert "['moe']['shared']['wi']" in keys and "['mlp']" in keys
    if arch == "llama_3_2_vision_90b":
        assert "['inner'][1]['mlp']['wi']" in keys


def test_deepseek_v2_full_size_numbers():
    cfg = configs.get_config("deepseek_v2_236b")
    # 6 layers (1 dense + 5 MoE): 39.58 GiB by the reference's accounting
    six = dataclasses.replace(cfg, n_layers=6, layer_pattern=("mla",) * 6)
    assert A.param_bytes(six) == RA.param_bytes(
        dataclasses.replace(ref_configs.get_config("deepseek_v2_236b"),
                            n_layers=6, layer_pattern=("mla",) * 6))
    assert round(A.param_bytes(six) / 2**30, 2) == 39.58
    assert repr(S.segments(six)) == repr(RS.segments(
        dataclasses.replace(ref_configs.get_config("deepseek_v2_236b"),
                            n_layers=6, layer_pattern=("mla",) * 6)))


def test_qwen2_moe_full_size_numbers():
    cfg = configs.get_config("qwen2_moe_a2_7b")
    assert A.param_count(cfg) == 14_315_587_584
    assert A.param_bytes(cfg) == 2 * 14_315_587_584 - 2 * 24 * 2048 * 60 \
        + 4 * 24 * 2048 * 60      # bfloat16 except the float32 routers
    assert S.segments(cfg)[0].count == 24
    assert dataclasses.replace(cfg).moe_capacity_factor == 1.25
