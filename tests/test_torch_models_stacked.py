"""The port's backbones (``repro_torch.models.transformer`` / ``stacked``)
and parameter accounting against the reference's on the CPU, on the
reference's weights.  Exact: the layer grouping and ``from_layerwise`` for
all ten archs, the parameter counts and bytes at full size for the dense
and MoE archs.  Logits of both forwards at rtol = atol = 1e-4.  The
serving path (caches, decode) is in ``test_torch_models_decode.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import accounting as RA
from repro.models import stacked as RS
from repro.models import transformer as RT
from repro.models.config import ALL_SHAPES
from repro_torch import configs, tree
from repro_torch.models import accounting as A
from repro_torch.models import stacked as S
from repro_torch.models import transformer as T

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["olmo_1b", "qwen3_14b", "gemma_7b", "deepseek_7b",
         "qwen2_moe_a2_7b"]
UNPORTED = ["deepseek_v2_236b", "zamba2_2_7b", "mamba2_1_3b",
            "llama_3_2_vision_90b", "musicgen_medium"]


def _cfgs(arch, **kw):
    return (ref_configs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


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
        rp = RS.init_params(rcfg, jax.random.PRNGKey(0))
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


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_kinds_raise(arch):
    cfg = configs.get_config(arch).reduced()
    for fn in (lambda: S.init_params(cfg, torch.Generator(), CPU),
               lambda: T.init_params(cfg, torch.Generator(), CPU),
               lambda: A.param_count(configs.get_config(arch)),
               lambda: S.init_cache(configs.get_config(arch), 1, 4, "meta")):
        with pytest.raises(NotImplementedError, match="A12b"):
            fn()


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_forward_matches_reference(arch, stacked_params):
    rcfg, cfg, rp, tp = stacked_params[arch]
    toks = _tokens(rcfg, (2, 12), 2)
    want, _, aux_r = RS.forward(rp, rcfg, jnp.asarray(toks, jnp.int32))
    got, caches, aux = S.forward(tp, cfg, torch.tensor(toks))
    assert caches is None and got.dtype is torch.float32
    assert tuple(got.shape) == (2, 12, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_r), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_layerwise_forward_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    lw = RT.init_params(rcfg, jax.random.PRNGKey(4))
    tlw = tree.params_from_numpy(lw, CPU)
    toks = _tokens(rcfg, (2, 10), 3)
    want, _, _ = RT.forward(lw, rcfg, jnp.asarray(toks, jnp.int32))
    got, _, _ = T.forward(tlw, cfg, torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same weights stacked give the same logits
    st, _, _ = S.forward(S.from_layerwise(cfg, tlw), cfg, torch.tensor(toks))
    np.testing.assert_allclose(st.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)
    assert T.param_count(tlw) == RT.param_count(lw)


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
def test_full_size_accounting_matches_reference(arch):
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert A.param_count(cfg) == RA.param_count(rcfg)
    assert A.param_bytes(cfg) == RA.param_bytes(rcfg)
    assert A.active_param_count(cfg) == RA.active_param_count(rcfg)
    for shape in ALL_SHAPES:
        assert A.model_flops(cfg, shape) == RA.model_flops(rcfg, shape)
    shapes = A.param_shapes(cfg)
    assert all(t.is_meta for _, t in tree.flatten_with_path(shapes))


def test_qwen2_moe_full_size_numbers():
    cfg = configs.get_config("qwen2_moe_a2_7b")
    assert A.param_count(cfg) == 14_315_587_584
    assert A.param_bytes(cfg) == 2 * 14_315_587_584 - 2 * 24 * 2048 * 60 \
        + 4 * 24 * 2048 * 60      # bfloat16 except the float32 routers
    assert S.segments(cfg)[0].count == 24
    assert dataclasses.replace(cfg).moe_capacity_factor == 1.25
