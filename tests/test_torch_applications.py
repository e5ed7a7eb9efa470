"""The port's applications against the reference package's on the CPU:
Dijkstra on the TNS engines (``repro_torch.graph.dijkstra``, paper §3.1)
and in-situ pruning (``repro_torch.pruning.insitu``, §3.2), with the
parameter-tree helper (``repro_torch.tree``) that carries the reference's
weights across.  Every comparison is exact: paths, DR and cycle counts,
located indices, masks bit for bit, key strings, sparsity and the pruned
weights.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs
from repro.graph import dijkstra as ref_dj
from repro.models import stacked
from repro.pruning import insitu as ref_insitu
from repro_torch import tree
from repro_torch.graph import dijkstra as dj
from repro_torch.models import stacked as tstacked
from repro_torch.pruning import insitu

CPU = "cpu"
PAIRS = [(0, 13), (3, 15), (5, 12), (15, 0)]


# ---------------------------------------------------------------------------
# Dijkstra.
# ---------------------------------------------------------------------------


def test_graph_matches_reference():
    assert dj.STATIONS == ref_dj.STATIONS and dj.EDGES == ref_dj.EDGES
    assert dj.adjacency() == ref_dj.adjacency()
    degs = [len(v) for v in dj.adjacency().values()]
    assert all(3 <= d <= 4 for d in degs) and sum(degs) == 54


@pytest.mark.parametrize("full_sort_stats", [False, True])
@pytest.mark.parametrize("engine,ref_engine", [("tns", "jax"),
                                               ("oracle", "oracle")])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_shortest_path_matches_reference(src, dst, engine, ref_engine,
                                         full_sort_stats):
    got = dj.shortest_path(src, dst, k=2, engine=engine,
                           full_sort_stats=full_sort_stats, device=CPU)
    want = ref_dj.shortest_path(src, dst, k=2, engine=ref_engine,
                                full_sort_stats=full_sort_stats)
    assert got.path == want.path == ref_dj.reference_shortest_path(
        src, dst)[1]
    for f in ("total_drs", "total_cycles", "numbers_sorted", "fig5e_drs",
              "fig5e_numbers"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.prev, want.prev)


@pytest.mark.parametrize("src,dst", PAIRS)
def test_reference_shortest_path_matches(src, dst):
    assert dj.reference_shortest_path(src, dst) == \
        ref_dj.reference_shortest_path(src, dst)


def test_fig5e_drs_per_number_about_3():
    res = dj.shortest_path(0, 13, k=2, engine="tns", device=CPU)
    assert 2.0 <= res.fig5e_drs_per_number <= 4.0
    assert res.fig5e_numbers == 54


# ---------------------------------------------------------------------------
# Cycle-faithful pruning.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ber", [0.0, 0.05])
@pytest.mark.parametrize("n,rate", [(32, 0.3), (64, 0.3), (100, 0.55)])
def test_tns_prune_matches_reference(n, rate, ber):
    w = np.random.default_rng(n).standard_normal(n)
    got = insitu.tns_prune(w, rate, k=2, ber=ber, seed=3, device=CPU)
    want = ref_insitu.tns_prune(w, rate, k=2, ber=ber, seed=3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert len(got[0]) == round(rate * n)


def test_tns_prune_finds_smallest():
    w = np.random.default_rng(0).standard_normal(32)
    idx, cycles, drs = insitu.tns_prune(w, rate=0.3, k=2, device=CPU)
    mags = np.abs(insitu.quantize_8bit_signmag(w))
    np.testing.assert_array_equal(np.sort(mags[idx]), np.sort(mags)[:10])
    assert cycles > 0 and drs > 0
    np.testing.assert_array_equal(insitu.quantize_8bit_signmag(w),
                                  ref_insitu.quantize_8bit_signmag(w))


# ---------------------------------------------------------------------------
# Throughput pruning over a parameter tree.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def olmo():
    """The reduced olmo-1b tree from the reference's ``init_params``, and
    the same weights carried across with ``params_from_numpy``."""
    cfg = configs.get_config("olmo_1b").reduced()
    params = stacked.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, tree.params_from_numpy(params, CPU)


def test_tree_paths_match_jax(olmo):
    _, params, tparams = olmo
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = tree.flatten_with_path(tparams)
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert "['segments'][0]['mlp']['wi']" in [tree.keystr(p)
                                              for p, _ in got]
    for (_, a), (_, b) in zip(want, got):
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_keystr_of_every_key_kind():
    t = {"b": [{"x": 1}, (2, 3)], "a": {"k": 4}}
    assert [tree.keystr(p) for p, _ in tree.flatten_with_path(t)] == \
        [jax.tree_util.keystr(p)
         for p, _ in jax.tree_util.tree_flatten_with_path(t)[0]]
    assert tree.map_with_path(lambda p, v: v * 10, t) == \
        {"b": [{"x": 10}, (20, 30)], "a": {"k": 40}}


def test_tree_walks_free_the_leaves_without_the_cycle_collector():
    # a walk that closed over its output list would keep every flattened
    # leaf alive until gc ran (a 26 GiB model's init held 18 GiB more)
    import gc
    import weakref
    gc.disable()
    try:
        t = torch.zeros(4)
        ref = weakref.ref(t)
        params = {"a": [{"w": t}], "b": (1,)}
        flat = tree.flatten_with_path(params)
        mapped = tree.map_with_path(lambda _, v: v, params)
        del flat, mapped, params, t
        assert ref() is None
    finally:
        gc.enable()


def test_params_from_numpy_keeps_bfloat16_bits():
    import jax.numpy as jnp
    a = jnp.asarray(np.random.default_rng(1).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = tree.params_from_numpy({"w": a}, CPU)["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.5, 0.7, 1.0])
def test_prune_params_matches_reference(olmo, rate):
    cfg, params, tparams = olmo
    want_p, want = ref_insitu.prune_params(params, cfg, rate)
    got_p, got = insitu.prune_params(tparams, cfg, rate)
    assert list(got["masks"]) == list(want["masks"]) == \
        ["['segments'][0]['mlp']['wi']"]
    for key, mask in want["masks"].items():
        assert got["masks"][key].dtype == torch.bool
        np.testing.assert_array_equal(got["masks"][key].numpy(),
                                      np.asarray(mask))
    assert got["weight_sparsity"] == want["weight_sparsity"]
    assert got["weight_sparsity"] == pytest.approx(rate, abs=0.05)
    want_leaves = jax.tree_util.tree_flatten_with_path(want_p)[0]
    got_leaves = tree.flatten_with_path(got_p)
    assert [tree.keystr(p) for p, _ in got_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (_, a), (_, b) in zip(want_leaves, got_leaves):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_prune_params_zeroes_the_dropped_lanes(olmo):
    cfg, _, tparams = olmo
    new, stats = insitu.prune_params(tparams, cfg, 0.3)
    keep = stats["masks"]["['segments'][0]['mlp']['wi']"]
    wi = new["segments"][0]["mlp"]["wi"]
    assert bool((wi[~keep] == 0).all())
    old = tparams["segments"][0]["mlp"]["wi"]
    assert torch.equal(wi[keep], old[keep])


@pytest.mark.parametrize("rate,d", [(0.1, 5), (0.625, 4), (0.3, 64),
                                    (0.5, 3), (0.7, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_keep_mask_matches_reference(rate, d, dtype):
    # (0.1, 5): float32(0.1) * 5 rounds to 0.5 in float32 and half to even
    # gives 0 lanes, where float64 would give 1; (0.625, 4) and (0.5, 3)
    # are exact halves
    import jax.numpy as jnp
    w = np.random.default_rng(d).standard_normal((2, d, 7))
    jw = jnp.asarray(w, getattr(jnp, dtype))
    want = np.asarray(ref_insitu.lane_keep_mask(jw, rate))
    tw = tree.to_tensor(np.asarray(jw), CPU)
    for r in (rate, torch.tensor(rate)):
        got = insitu.lane_keep_mask(tw, r)
        np.testing.assert_array_equal(got.numpy(), want)
    expect = int(np.round(np.float32(rate) * np.float32(d)))
    assert int((~want).sum(-1)[0]) == expect


# ---------------------------------------------------------------------------
# In-situ pruning on a served model (the reference's
# ``TestInsituPruning.test_prune_params_runtime_tunable`` and
# ``test_pruned_model_still_runs_and_degrades_gracefully``), on the
# reference's stacked olmo-1b weights.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.7])
def test_prune_params_runtime_tunable(olmo, rate):
    cfg, params, tparams = olmo
    _, want = ref_insitu.prune_params(params, cfg, rate)
    _, got = insitu.prune_params(tparams, cfg, rate)
    # lanes pruned ~= rate (weight sparsity tracks lane sparsity), and the
    # masks are the reference's bit for bit
    assert got["weight_sparsity"] == want["weight_sparsity"]
    assert got["weight_sparsity"] == pytest.approx(rate, abs=0.05)
    for key, mask in want["masks"].items():
        np.testing.assert_array_equal(got["masks"][key].numpy(),
                                      np.asarray(mask))


def test_pruned_model_still_runs_and_degrades_gracefully(olmo):
    import jax.numpy as jnp
    from repro_torch import configs as tconfigs
    cfg, params, tparams = olmo
    tcfg = tconfigs.get_config("olmo_1b").reduced()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    base, _, _ = tstacked.forward(tparams, tcfg, torch.tensor(toks))
    p30, _ = insitu.prune_params(tparams, tcfg, 0.3)
    out30, _, _ = tstacked.forward(p30, tcfg, torch.tensor(toks))
    assert bool(torch.isfinite(out30).all())
    # 30% pruning perturbs but does not destroy the logits
    cos = (base * out30).sum() / (base.norm() * out30.norm())
    assert float(cos) > 0.5
    # the same pruned forward as the reference's
    rp30, _ = ref_insitu.prune_params(params, cfg, 0.3)
    want, _, _ = stacked.forward(rp30, cfg, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(out30.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
