"""The port's fault injection (``repro_torch.runtime.faults``) and its
verify-and-repair engines (``repro_torch.sort.resilient``) against the
reference package's, case for case with ``tests/test_resilience.py``: the
same ``FaultSpec`` and seed give the same flipped bits, the same repairs,
retries, quality, ``degraded`` flag and extra cycles, through
``device="cpu"``.  Every compared output is an integer, a boolean or a
ratio of integer counts: compared exactly."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import sort as jsort
from repro.core import bitplane as jbp
from repro.runtime import faults as jf
from repro.sort import resilient as jres
from repro_torch import sort as tsort
from repro_torch.core import bitplane as tbp
from repro_torch.core import catns as tca
from repro_torch.runtime import faults as tf
from repro_torch.sort import resilient as tres

# reference engine -> the port's engine of the same function
ENGINES = {"tns": "tns", "tns-oracle": "tns-oracle", "ml": "ml", "mb": "mb",
           "bts": "bts", "bitslice": "bitslice", "pallas-tns": "fused-tns",
           "radix": "radix", "mb-ft": "mb-ft"}
RESULT_FIELDS = ("quality", "faults_injected", "repairs", "retries",
                 "degraded", "extra_cycles", "banks", "engine")


def _data(n=64, seed=0, width=16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << width, n).astype(
        np.uint16 if width <= 16 else np.uint32)


def _port_name(ref_name: str) -> str:
    if ref_name.startswith("resilient:"):
        return "resilient:" + ENGINES[ref_name[len("resilient:"):]]
    return ENGINES[ref_name]


def _both(x, ref_engine, spec=None, **kw):
    """The same call in both packages, under the same spec if one is
    given; returns (port result, reference result)."""
    if spec is None:
        return (tsort.sort(x, engine=_port_name(ref_engine), device="cpu",
                           **kw), jsort.sort(x, engine=ref_engine, **kw))
    with tf.inject(tf.FaultSpec(**spec)):
        got = tsort.sort(x, engine=_port_name(ref_engine), device="cpu",
                         **kw)
    with jf.inject(jf.FaultSpec(**spec)):
        want = jsort.sort(x, engine=ref_engine, **kw)
    return got, want


def _assert_same(got, want):
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)
    for f in ("cycles", "drs", "reload_cycles"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in RESULT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "engine":
            w = _port_name(w) if w.split(":")[-1] in ENGINES else w
        assert g == w, (f, g, w)


# ---------------------------------------------------------------------------
# The fault spec and the injector.
# ---------------------------------------------------------------------------


def test_parse_spec_matches_reference():
    text = ("ber=0.01,banks=4,dead_banks=1:2,seed=7,parity_ecc=on,"
            "redundant_reads=3,stuck_zero=0.02,delay_s=0.5,delay_prob=0.1")
    got, want = tf.parse_spec(text), jf.parse_spec(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.faulty and not tf.FaultSpec().faulty
    fixed = got.without_dead_banks()
    assert fixed.dead_banks == () and fixed.ber == 0.01


def test_unknown_engine_message_lists_resilient():
    with pytest.raises(KeyError, match="resilient:tns"):
        tsort.sort(_data(8), engine="no-such-engine", device="cpu")


def test_no_hook_outside_context():
    planes = tbp.to_bitplanes(_data(32), 16, tbp.UNSIGNED)
    assert tbp.read_planes(planes) is planes
    assert tf.current() is None


SPECS = [
    dict(ber=0.05, seed=1),
    dict(stuck_one=0.3, seed=1),
    dict(stuck_zero=0.1, stuck_one=0.05, ber=0.02, seed=4),
    dict(dead_banks=(1,), banks=4),
    dict(ber=0.05, seed=1, redundant_reads=5),
    dict(ber=0.01 / 16, seed=1, parity_ecc=True),
    dict(ber=0.05, seed=3, dead_banks=(0, 2), redundant_reads=3,
         parity_ecc=True),
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("kind, level_bits", [("bit", 1), ("digit", 2)])
def test_reads_flip_the_reference_bits(spec, kind, level_bits):
    x = _data(64, seed=4)
    planes = (tbp.to_bitplanes(x, 16, tbp.UNSIGNED) if kind == "bit" else
              tbp.to_digitplanes(x, 16, tbp.UNSIGNED, level_bits))
    tc, jc = tf.FaultCounters(), jf.FaultCounters()
    with tf.inject(tf.FaultSpec(**spec), counters=tc):
        got = [tbp.read_planes(planes, kind=kind, level_bits=level_bits,
                               banks=4) for _ in range(2)]
    with jf.inject(jf.FaultSpec(**spec), counters=jc):
        want = [jbp.read_planes(planes, kind=kind, level_bits=level_bits,
                                banks=4) for _ in range(2)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_probe_dead_banks():
    spec = tf.FaultSpec(dead_banks=(0, 2), banks=4)
    assert tf.probe_dead_banks(spec) == [0, 2]
    assert tf.probe_dead_banks(tf.FaultSpec(banks=4)) == []


@pytest.mark.parametrize("d", [1, 4, 8, 16, 26])
def test_hamming_planes_match_reference(d):
    bits = np.random.default_rng(d).integers(0, 2, (2, d, 40)).astype(
        np.uint8)
    code = tf._hamming_encode(bits)
    np.testing.assert_array_equal(code, jf._hamming_encode(bits))
    code[:, 0, ::3] ^= 1                          # one flip a column
    got, want = tf._hamming_decode(code, d), jf._hamming_decode(code, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], bits)
    assert got[1] == want[1] > 0


# ---------------------------------------------------------------------------
# Comparison-free verification.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt, width, dtype", [("unsigned", 16, np.uint16),
                                               ("twos", 16, np.int16),
                                               ("float", 32, np.float32)])
@pytest.mark.parametrize("ascending", [True, False])
def test_check_sorted_and_quality_match_reference(fmt, width, dtype,
                                                  ascending):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(32) if fmt == "float" else
         rng.integers(-500 if fmt == "twos" else 0, 500, 32)).astype(dtype)
    x[4] = x[9]
    perm = np.argsort(x, kind="stable")
    if not ascending:
        perm = perm[::-1]
    cases = [perm, perm[:7], perm[[1, 0] + list(range(2, 32))],
             perm[::-1], np.array([0, 0, 1]), np.array([-1, 0]),
             np.array([], dtype=np.int64), perm[3:9]]
    for p in cases:
        kw = dict(width=width, fmt=fmt, ascending=ascending)
        assert tres.check_sorted(x, p, **kw) == \
            jres.check_sorted(x, p, **kw)
        if p.size and p.min() >= 0:
            assert tres.emission_quality(x, p, **kw) == \
                jres.emission_quality(x, p, **kw)


# ---------------------------------------------------------------------------
# The resilient wrapper.
# ---------------------------------------------------------------------------


def test_zero_fault_parity_all_engines():
    x = _data(48, seed=7)
    for name in sorted(tsort.engines()):
        if name.startswith(tres.PREFIX):
            continue
        try:
            inner = tsort.sort(x, engine=name, k=2, device="cpu")
            res = tsort.sort(x, engine=tres.PREFIX + name, k=2,
                             device="cpu")
        except NotImplementedError:
            continue
        assert np.array_equal(res.indices, inner.indices), name
        assert res.quality == 1.0 and not res.degraded, name
        assert res.repairs == 0 and res.retries == 0, name
        assert res.engine == tres.PREFIX + name


CASES = [
    # (spec, n, seed, call) as tests/test_resilience.py runs them
    (dict(ber=0.01, dead_banks=(1,), banks=4, seed=3), 64, 3, {}),
    (dict(ber=0.20, seed=5), 64, 5, {}),
    (dict(ber=0.01, seed=2), 64, 8, {}),
    (dict(ber=0.01, seed=4), 64, 9, dict(stop_after=8)),
    (dict(stuck_one=0.002, ber=0.004, seed=9), 40, 1, {}),
]


@pytest.mark.parametrize("spec, n, seed, call", CASES)
@pytest.mark.parametrize("engine", ["tns", "pallas-tns", "tns-oracle", "ml",
                                    "bts"])
def test_resilient_engines_match_reference(engine, spec, n, seed, call):
    got, want = _both(_data(n, seed=seed), "resilient:" + engine, spec,
                      **call)
    _assert_same(got, want)


def test_dead_bank_plus_ber_repaired_exactly():
    x = _data(64, seed=3)
    spec = dict(ber=0.01, dead_banks=(1,), banks=4, seed=3)
    res, _ = _both(x, "resilient:tns", spec)
    assert res.quality == 1.0 and not res.degraded
    assert res.repairs > 0 and res.retries > 0 and res.faults_injected > 0
    assert res.extra_cycles > 0
    assert np.array_equal(res.values, np.sort(x))


def test_high_ber_degrades_gracefully():
    res, want = _both(_data(64, seed=5), "resilient:tns",
                      dict(ber=0.20, seed=5))
    assert res.degraded and 0.0 <= res.quality < 1.0 and res.retries > 0
    assert sorted(res.indices.tolist()) == list(range(64))
    assert res.quality == want.quality


@pytest.mark.parametrize("engine", ["tns", "pallas-tns", "mb-ft"])
def test_batched_facade_aggregates_counters(engine):
    xb = np.stack([_data(32, seed=s) for s in range(3)])
    got, want = _both(xb, "resilient:" + engine, dict(ber=0.01, seed=1))
    _assert_same(got, want)
    assert got.indices.shape == (3, 32)
    assert got.quality == 1.0 and not got.degraded
    # each instance repaired on its own (mb-ft's inner ladder repairs
    # before the wrapper sees a failure)
    assert got.retries >= (3 if engine != "mb-ft" else 0)
    for b in range(3):
        assert np.array_equal(got.values[b], np.sort(xb[b]))


def test_lazy_wrapping_of_late_engines():
    from repro_torch.sort.registry import _REGISTRY, register
    from repro_torch.sort.result import SortResult

    @register("toy-late", mode="throughput")
    def _toy(x, *, width, fmt, k, ascending, level_bits, stop_after,
             device):
        perm = np.argsort(x, kind="stable")
        if not ascending:
            perm = perm[::-1]
        return SortResult(values=np.asarray(x)[perm], indices=perm,
                          engine="toy-late", fmt=fmt, width=width, n=len(x))

    try:
        assert "resilient:toy-late" not in _REGISTRY
        res = tsort.sort(_data(16), engine="resilient:toy-late",
                         device="cpu")
        assert res.quality == 1.0 and res.engine == "resilient:toy-late"
        assert "resilient:toy-late" in _REGISTRY
    finally:
        _REGISTRY.pop("toy-late", None)
        _REGISTRY.pop("resilient:toy-late", None)


def test_topk_engine_sees_no_faults():
    """fused-topk never reads the array: the wrapper passes it clean, as
    it passes the reference's pallas-topk."""
    x = _data(30, seed=2)
    spec = dict(ber=0.2, seed=1)
    with tf.inject(tf.FaultSpec(**spec)):
        got = tsort.sort(x, engine="resilient:fused-topk", stop_after=8,
                         device="cpu")
    with jf.inject(jf.FaultSpec(**spec)):
        want = jsort.sort(x, engine="resilient:pallas-topk", stop_after=8)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert (got.quality, got.faults_injected, got.retries) == \
        (want.quality, want.faults_injected, want.retries) == (1.0, 0, 0)


# ---------------------------------------------------------------------------
# The fault-tolerant multi-bank engine.
# ---------------------------------------------------------------------------


def test_mb_ft_clean_matches_tns():
    x = _data(64, seed=10)
    got, want = _both(x, "mb-ft", banks=4)
    _assert_same(got, want)
    assert np.array_equal(got.indices,
                          tsort.sort(x, engine="tns", device="cpu").indices)
    assert got.quality == 1.0 and got.repairs == 0 and got.banks == 4


@pytest.mark.parametrize("n, dead, seed", [(64, (2,), 7), (63, (1,), 3),
                                           (48, (0, 3), 5)])
def test_mb_ft_remaps_onto_survivors(monkeypatch, n, dead, seed):
    """Dead banks are re-programmed onto the survivors.  Where the
    survivors split the dataset evenly the multi-bank machine runs; by
    eq. 2 it gives the reference's single-array permutation and counts,
    and so every repair count of the reference."""
    calls = []
    real = tca.multibank_sort

    def counted(*a, **kw):
        calls.append(kw["banks"])
        return real(*a, **kw)

    monkeypatch.setattr(tca, "multibank_sort", counted)
    x = _data(n, seed=seed)
    spec = dict(ber=0.005, dead_banks=dead, banks=4, seed=seed)
    got, want = _both(x, "mb-ft", spec, banks=4)
    _assert_same(got, want)
    survivors = 4 - len(dead)
    assert got.banks == survivors
    assert calls == ([survivors] * (1 + got.retries)
                     if n % survivors == 0 else [])
    assert got.quality == 1.0 and not got.degraded and got.repairs > 0
    assert got.extra_cycles >= 16 * (-(-n // 4)) * len(dead)
    assert np.array_equal(got.values, np.sort(x))


def test_mb_ft_all_banks_dead_raises():
    with tf.inject(tf.FaultSpec(dead_banks=(0, 1), banks=2)):
        with pytest.raises(RuntimeError, match="dead"):
            tsort.sort(_data(16), engine="mb-ft", banks=2, device="cpu")


# ---------------------------------------------------------------------------
# The fault-tolerance runtime.
# ---------------------------------------------------------------------------


def test_retries_forward_kwargs_and_exhaust():
    calls = []

    def step(a, *, b):
        calls.append((a, b))
        if len(calls) < 3:
            raise RuntimeError("transient")
        return a + b

    assert tf.run_step_with_retries(step, 1, b=2, retries=3,
                                    backoff_s=0.001) == 3
    assert calls == [(1, 2)] * 3
    with pytest.raises(RuntimeError):
        tf.run_step_with_retries(
            lambda: (_ for _ in ()).throw(RuntimeError("x")), retries=1,
            backoff_s=0.001)


def test_heartbeat_and_straggler_monitor():
    hb = tf.Heartbeat(interval_s=0.01, timeout_s=0.05)
    hb.start_self_beat("h")
    hb.stop(join_timeout_s=1.0)
    assert hb._thread is None and hb.suspects() == []
    times = [1.0, 1.1, 3.5, 0.9, 2.5, 1.0, 9.0]
    got, want = tf.StragglerMonitor(), jf.StragglerMonitor()
    assert [got.observe(t) for t in times] == \
        [want.observe(t) for t in times]
    assert (got.ema, got.flagged_steps) == (want.ema, want.flagged_steps)


@pytest.mark.parametrize("n, mp", [(8, 4), (6, 4), (3, 2), (1, 8)])
def test_elastic_remesh_builds_a_device_grid(n, mp):
    assert tf.best_mesh_shape(n, mp) == jf.best_mesh_shape(n, mp)
    mesh = tf.elastic_remesh(["cpu"] * n, mp, axis_names=("bank", "mp"))
    dp, m = tf.best_mesh_shape(n, mp)
    assert mesh.devices.shape == (dp, m)
    assert mesh.shape == {"bank": dp, "mp": m}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
