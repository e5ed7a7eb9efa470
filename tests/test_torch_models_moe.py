"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's on the CPU, on the reference's weights.  Integer outputs are
exact: the capacity, the einsum dispatch's slots and keep mask, and the
router's expert indices under each of the reference's three engine names.
The router's top-k values are bit-equal; the gates (their softmax) are
bit-equal to torch's softmax of the reference's values and within 2 ulp of
the reference's gates (XLA's CPU ``exp`` and torch's round differently in
the last bit).  Layer outputs at rtol = atol = 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import sort as ref_sort
from repro.models import moe as RM
from repro_torch import configs, tree
from repro_torch.models import moe as M

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
REF_ROUTERS = ["radix", "pallas", "lax"]


def _cfgs(router="radix", **kw):
    rcfg = dataclasses.replace(
        ref_configs.get_config("qwen2_moe_a2_7b").reduced(),
        router_impl=router, **kw)
    cfg = dataclasses.replace(
        configs.get_config("qwen2_moe_a2_7b").reduced(),
        router_impl=router, **kw)
    return rcfg, cfg


@pytest.fixture(scope="module")
def moe():
    rcfg, cfg = _cfgs()
    rp = RM.init_moe(rcfg, jax.random.PRNGKey(0))
    return rp, tree.params_from_numpy(rp, CPU)


def _x(seed, shape=(2, 16, 64)):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("n,k,e", [(1, 4, 60), (16, 4, 60), (64, 4, 60),
                                   (12, 2, 8), (7, 6, 160), (1000, 4, 60),
                                   (4096, 6, 160), (75, 4, 60)])
@pytest.mark.parametrize("factor", [None, 1.0, 1.25, 2.0, 0.3])
def test_capacity_matches_reference(n, k, e, factor):
    assert M._capacity(n, k, e, factor) == RM._capacity(n, k, e, factor)


def test_init_moe_layout_matches_reference():
    rcfg, cfg = _cfgs()
    want = jax.tree_util.tree_flatten_with_path(
        RM.init_moe(rcfg, jax.random.PRNGKey(0)))[0]
    got = tree.flatten_with_path(
        M.init_moe(cfg, torch.Generator().manual_seed(0), torch.device(CPU)))
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)


@pytest.mark.parametrize("ref_name", REF_ROUTERS)
def test_route_topk_matches_reference(ref_name):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((48, 8)).astype(np.float32)
    # tie rows: equal logits go to the lowest index under every engine
    logits[0] = 1.0
    logits[1, :5] = logits[1, 5]
    gates_r, idx_r = RM.route_topk(jnp.asarray(logits), 2, ref_name)
    vals_r, _ = ref_sort.topk(jnp.asarray(logits), 2, engine=ref_name)
    gates, idx = M.route_topk(torch.tensor(logits), 2, ref_name)
    assert idx.dtype is torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(idx[0].numpy(), [0, 1])
    vals = torch.gather(torch.tensor(logits), -1, idx.long())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_r))
    assert torch.equal(gates, torch.softmax(torch.tensor(
        np.asarray(vals_r)), dim=-1))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), rtol=0,
                               atol=2.4e-7)


def test_router_names_map_to_port_engines():
    assert M.ROUTER_ENGINES == {"radix": "radix", "pallas": "fused-topk",
                                "lax": "torch", "fused-topk": "fused-topk",
                                "torch": "torch"}
    lg = torch.tensor(np.random.default_rng(2).standard_normal((10, 60)),
                      dtype=torch.float32)
    outs = [M.route_topk(lg, 4, name) for name in M.ROUTER_ENGINES]
    for g, i in outs[1:]:
        assert torch.equal(g, outs[0][0]) and torch.equal(i, outs[0][1])
    with pytest.raises(ValueError, match="router_impl"):
        M.route_topk(lg, 4, "pallas-tns")


def _ref_slots(eidx, E, C):
    """The reference's slot computation (``_einsum_dispatch``) in jnp."""
    B, T, k = eidx.shape
    oh_e = jax.nn.one_hot(jnp.asarray(eidx), E, dtype=jnp.float32)
    flat = oh_e.reshape(B, T * k, E)
    pos = (jnp.cumsum(flat, axis=1) * flat).reshape(B, T, k, E)
    pos_tk = jnp.sum(pos, axis=-1) - 1.0
    return np.asarray(pos_tk), np.asarray((pos_tk < C) & (pos_tk >= 0))


@pytest.mark.parametrize("factor", [None, 1.0, 0.5])
def test_dispatch_slots_match_reference(factor):
    # a skewed router (expert 0 takes most tokens) so that capacity drops
    rng = np.random.default_rng(3)
    B, T, k, E = 2, 40, 2, 8
    eidx = np.where(rng.random((B, T, k)) < 0.6, 0,
                    rng.integers(0, E, (B, T, k)))
    eidx[..., 1] = np.where(eidx[..., 1] == eidx[..., 0],
                            (eidx[..., 0] + 1) % E, eidx[..., 1])
    C = M._capacity(T, k, E, factor)
    want_pos, want_keep = _ref_slots(eidx, E, C)
    _, pos, keep = M.dispatch_slots(torch.tensor(eidx, dtype=torch.int32), E,
                                    C)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if factor is not None:
        assert not want_keep.all()


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("factor", ["cfg", 8.0, 1.0, 0.5])
def test_apply_moe_matches_reference(moe, dispatch, factor):
    rp, tp = moe
    rcfg, cfg = _cfgs()
    x = _x(4) * 2
    kw = {} if factor == "cfg" else {"capacity_factor": factor}
    y_r, aux_r = RM.apply_moe(rp, jnp.asarray(x, jnp.float32), rcfg,
                              dispatch=dispatch, **kw)
    y, aux = M.apply_moe(tp, torch.tensor(x, dtype=torch.float32), cfg,
                         dispatch=dispatch, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_r), **TOL)


def test_apply_moe_dense_ref_matches_reference(moe):
    rp, tp = moe
    rcfg, cfg = _cfgs()
    x = _x(5)
    want = RM.apply_moe_dense_ref(rp, jnp.asarray(x, jnp.float32), rcfg)
    got = M.apply_moe_dense_ref(tp, torch.tensor(x, dtype=torch.float32), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # with no drops both dispatches equal the dense oracle
    for dispatch in ("einsum", "sort"):
        y, _ = M.apply_moe(tp, torch.tensor(x, dtype=torch.float32), cfg,
                           capacity_factor=8.0, dispatch=dispatch)
        np.testing.assert_allclose(y.numpy(), got.numpy(), **TOL)


def test_apply_moe_gelu_matches_reference():
    # GeGLU experts (as gemma's MLP): the tanh form of GELU
    rcfg, cfg = _cfgs(mlp_act="gelu")
    rp = RM.init_moe(rcfg, jax.random.PRNGKey(6))
    x = _x(7)
    y_r, _ = RM.apply_moe(rp, jnp.asarray(x, jnp.float32), rcfg)
    y, _ = M.apply_moe(tree.params_from_numpy(rp, CPU),
                       torch.tensor(x, dtype=torch.float32), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)


@pytest.mark.parametrize("router", ["radix", "pallas", "lax", "fused-topk",
                                    "torch"])
def test_every_router_name_gives_the_same_layer(moe, router):
    _, tp = moe
    x = torch.tensor(_x(8), dtype=torch.float32)
    want, _ = M.apply_moe(tp, x, _cfgs("radix")[1])
    got, _ = M.apply_moe(tp, x, _cfgs(router)[1])
    assert torch.equal(got, want)
