"""The port's copies of the Table-S5 cost model and of the event-driven
TNS oracle against the reference package's: the calibrated constants are
the system's parameters and must be equal; the oracle must give the same
permutations and cycle / DR / reload counts on the same inputs."""
import dataclasses

import numpy as np
import pytest

from repro.core import cost as jcost
from repro.core import ref_tns as jrt
from repro_torch.core import cost
from repro_torch.core import ref_tns as rt

FMT_DATA = {
    "unsigned": (lambda r, n: r.integers(0, 16, n).astype(np.uint8), 4),
    "twos": (lambda r, n: r.integers(-128, 128, n).astype(np.int8), 8),
    "signmag": (lambda r, n: r.integers(-2**6, 2**6, n), 8),
    "float": (lambda r, n: r.standard_normal(n).astype(np.float16), 16),
}


def test_calibrated_constants_equal():
    assert {k: dataclasses.asdict(v) for k, v in cost.TABLE_S5.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcost.TABLE_S5.items()}
    assert cost.REFERENCE_SYSTEMS == jcost.REFERENCE_SYSTEMS
    assert cost.table_s5_published() == jcost.table_s5_published()
    for name in ("_FREQ_N_EXP", "_FREQ_K_SLOPE", "_AREA_N_EXP",
                 "_AREA_K_SLOPE", "_POWER_N_EXP", "_POWER_K_SLOPE",
                 "_XBAR_AREA", "_XBAR_POWER"):
        assert getattr(cost, name) == getattr(jcost, name), name


@pytest.mark.parametrize("strategy", sorted(jcost.TABLE_S5))
@pytest.mark.parametrize("n, k, banks", [(1024, None, 1), (256, 2, 4),
                                         (4096, 6, 8)])
def test_operating_points_and_metrics_equal(strategy, n, k, banks):
    kw = dict(n=n, w=16, k=k, level_bits=2, banks=banks)
    got = cost.operating_point(strategy, **kw)
    want = jcost.operating_point(strategy, **kw)
    assert dataclasses.asdict(got) == pytest.approx(dataclasses.asdict(want),
                                                    rel=1e-12)
    gm = cost.sort_metrics(3 * n, n, got)
    wm = jcost.sort_metrics(3 * n, n, want)
    assert dataclasses.asdict(gm) == pytest.approx(dataclasses.asdict(wm),
                                                   rel=1e-12)


def test_operating_point_validation_equal():
    for bad in (dict(strategy="nope"), dict(strategy="tns", n=0),
                dict(strategy="tns", banks=0)):
        strategy = bad.pop("strategy")
        with pytest.raises(ValueError) as got:
            cost.operating_point(strategy, **bad)
        with pytest.raises(ValueError) as want:
            jcost.operating_point(strategy, **bad)
        assert str(got.value) == str(want.value)


def _same(got, want):
    np.testing.assert_array_equal(got.perm, want.perm)
    assert (got.cycles, got.drs, got.reload_cycles) == \
        (want.cycles, want.drs, want.reload_cycles)


@pytest.mark.parametrize("fmt", list(FMT_DATA))
@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("stop_after", [None, 4])
def test_tns_oracle_equal(fmt, k, ascending, stop_after):
    gen, width = FMT_DATA[fmt]
    x = gen(np.random.default_rng(k * 10 + len(fmt)), 20)
    kw = dict(width=width, k=k, fmt=fmt, ascending=ascending,
              stop_after=stop_after)
    _same(rt.tns_sort(x, **kw), jrt.tns_sort(x, **kw))


@pytest.mark.parametrize("level_bits, ideal", [(2, False), (1, True)])
def test_tns_oracle_multilevel_and_ideal_lifo_equal(level_bits, ideal):
    x = np.random.default_rng(3).integers(0, 256, 24).astype(np.uint8)
    kw = dict(width=8, k=2, level_bits=level_bits, ideal_lifo=ideal)
    _same(rt.tns_sort(x, **kw), jrt.tns_sort(x, **kw))


def test_published_cycle_counts():
    # S3/S4: 6 numbers, 4 bits: BTS 24 cycles, TNS k=3 10 cycles
    x = np.array([9, 2, 14, 3, 11, 7])
    assert rt.bts_sort(x, width=4).cycles == 24
    assert rt.tns_sort(x, width=4, k=3).cycles == 10


def test_other_oracles_equal():
    x = np.random.default_rng(4).integers(0, 16, 12)
    _same(rt.bts_sort(x, width=4), jrt.bts_sort(x, width=4))
    _same(rt.multibank_sort(x, width=4, k=2, banks=3),
          jrt.multibank_sort(x, width=4, k=2, banks=3))
    _same(rt.bitslice_sort(x, width=4, k=2, slice_widths=[2, 2]),
          jrt.bitslice_sort(x, width=4, k=2, slice_widths=[2, 2]))
    res = rt.tns_sort(x, width=4, k=2)
    assert rt.verify_sorted(x, res)
