"""The port's cycle-faithful TNS machines (``repro_torch.core.tns``), the
single instance and the batched machine with both of its steps, against
the reference package's JAX machines (``repro.core.tns``) and against the
port's event-driven oracle, on the same seeded numpy inputs through
``device="cpu"``.  Every output is an integer: perm, cycles, DRs and
reload cycles are compared exactly."""
import numpy as np
import pytest
import torch

from repro import sort as jsort
from repro.core import tns as jt
from repro.runtime import faults as jfaults
from repro_torch import sort as tsort
from repro_torch.core import ref_tns as rt
from repro_torch.core import tns as tt
from repro_torch.kernels import fused_tns
from repro_torch.runtime import faults as tfaults

FMT_DATA = {
    "unsigned": (lambda r, s: r.integers(0, 256, s).astype(np.uint8), 8),
    "twos": (lambda r, s: r.integers(-128, 128, s).astype(np.int8), 8),
    "signmag": (lambda r, s: r.integers(-2**14, 2**14, s), 16),
    "float": (lambda r, s: r.standard_normal(s).astype(np.float16), 16),
}


def _data(fmt, shape, seed):
    gen, width = FMT_DATA[fmt]
    x = gen(np.random.default_rng(seed), shape)
    if x.ndim == 2 and x.shape[0] > 2:
        x[1] = x[1, 0]                        # an all-ties bank
        x[2] = x[2] // 4 * 4 if fmt != "float" else np.round(x[2])
    return x, width


def _host(out):
    return [np.asarray(t.cpu()) for t in out]


def _same(got, want, m=None):
    """Equal perm (first m slots), cycles, DRs and reload cycles."""
    gp, *gc = _host(got)
    wp, *wc = (np.asarray(a) for a in want)
    if m is not None:
        gp, wp = gp[..., :m], wp[..., :m]
    np.testing.assert_array_equal(gp, wp)
    for g, w, what in zip(gc, wc, ("cycles", "drs", "reload_cycles")):
        np.testing.assert_array_equal(g, w, err_msg=what)


# A few cells against the JAX machines (each compiles once per shape and
# static argument); the whole grid against the oracle below.
JAX_CELLS = [
    ("unsigned", dict(k=2)),
    ("twos", dict(k=1, ascending=False)),
    ("signmag", dict(k=3, stop_after=7)),
    ("float", dict(k=2)),
    ("float", dict(k=0, ascending=False, stop_after=5)),
    ("unsigned", dict(k=2, level_bits=2)),
    ("unsigned", dict(k=1, level_bits=4, ascending=False)),
    ("float", dict(k=2, ideal_lifo=True)),
]


@pytest.mark.parametrize("fmt, kw", JAX_CELLS)
def test_batched_machine_matches_jax(fmt, kw):
    x, width = _data(fmt, (4, 40), seed=len(fmt))
    want = jt.tns_sort_batch(x, width=width, fmt=fmt, **kw)
    got = tt.tns_sort_batch(x, width=width, fmt=fmt, device="cpu", **kw)
    _same(got, want)


@pytest.mark.parametrize("fmt, kw", JAX_CELLS[::2])
def test_single_instance_matches_jax(fmt, kw):
    x, width = _data(fmt, (24,), seed=3)
    want = jt.tns_sort(x, width=width, fmt=fmt, **kw)
    got = tt.tns_sort(x, width=width, fmt=fmt, device="cpu", **kw)
    _same(got, want)


# multi-level digits straddle the sign bit, so the ml engine feeds the
# machine unsigned sort keys: multi-level cells are unsigned
GRID = ([(fmt, 1, False) for fmt in FMT_DATA]
        + [(fmt, 1, True) for fmt in FMT_DATA]
        + [("unsigned", 2, False), ("unsigned", 4, False),
           ("unsigned", 4, True)])


@pytest.mark.parametrize("fmt, level_bits, ideal_lifo", GRID)
def test_machines_match_the_oracle_on_the_grid(fmt, level_bits, ideal_lifo):
    """k 0-3, both directions, stop_after None / 5, on banks with an
    all-ties row and heavy duplicates: the batched machine and the single
    instance equal the event-driven oracle in every count."""
    x, width = _data(fmt, (3, 21), seed=level_bits)
    for k in range(4):
        for ascending in (True, False):
            for stop_after in (None, 5):
                call = dict(width=width, k=k, fmt=fmt,
                            ascending=ascending, level_bits=level_bits,
                            ideal_lifo=ideal_lifo, stop_after=stop_after)
                batch = tt.tns_sort_batch(x, device="cpu", unroll=3, **call)
                for b in range(x.shape[0]):
                    o = rt.tns_sort(x[b], **call)
                    want = (o.perm, o.cycles, o.drs, o.reload_cycles)
                    m = len(o.perm)
                    _same(tt.TnsOut(*(t[b] for t in batch)), want, m)
                    _same(tt.tns_sort(x[b], device="cpu", **call), want, m)


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 70])
def test_packed_step_at_word_edges(n):
    """The bit-parallel step carries 32 cells an int32 word: a bank's last
    cell may be a word's sign bit, or sit alone in a ragged word."""
    x, width = _data("float", (4, n), seed=n)
    x[0, -1] = -x[0, :].min() - 1 if n > 1 else x[0, -1]
    for k in (0, 2, 5):
        for ascending in (True, False):
            call = dict(width=width, k=k, fmt="float", ascending=ascending)
            got = tt.tns_sort_batch(x, device="cpu", **call)
            for b in range(x.shape[0]):
                o = rt.tns_sort(x[b], **call)
                _same(tt.TnsOut(*(t[b] for t in got)),
                      (o.perm, o.cycles, o.drs, o.reload_cycles))


def test_unroll_changes_nothing():
    x, width = _data("signmag", (5, 30), seed=9)
    outs = [tt.tns_sort_batch(x, width=width, k=2, fmt="signmag",
                              stop_after=11, device="cpu", unroll=u)
            for u in (1, 3, 32)]
    for o in outs[1:]:
        _same(o, _host(outs[0]))


def test_int32_word_helpers_are_exact_on_the_sign_bit():
    bits = torch.zeros((3, 64), dtype=torch.bool)
    bits[0, 31] = True                        # word 0's sign bit alone
    bits[1, 32:] = True                       # word 1 all ones
    bits[2, ::7] = True
    words = tt._pack_bits(bits)
    assert words.dtype == torch.int32
    assert words[0, 0].item() == -(1 << 31) and words[1, 1].item() == -1
    np.testing.assert_array_equal(
        fused_tns.popcount(words).sum(-1).numpy(), bits.sum(-1).numpy())
    wide = fused_tns.pack_words(bits)         # the int64-held form
    np.testing.assert_array_equal(fused_tns.popcount(words).numpy(),
                                  fused_tns.popcount(wide).numpy())


def test_batched_machine_guards():
    planes = torch.zeros((1, 2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="level_bits <= 8"):
        tt.tns_sort_planes_batched(planes, k=1, level_bits=9)
    with pytest.raises(ValueError, match="N < 32768"):
        tt.tns_sort_planes_batched(torch.zeros((1, 1, 1 << 15),
                                               dtype=torch.uint8), k=1)
    with pytest.raises(ValueError, match=r"\(B, N\) batch"):
        tt.tns_sort_batch(np.zeros(4, np.uint8), width=8, k=1, device="cpu")


def test_wide_banks_run_one_instance_after_another():
    """N >= 2^15: the tns engine loops the single instance over banks, as
    the reference does."""
    x = np.random.default_rng(5).integers(0, 256, (2, 1 << 15)).astype(
        np.uint8)
    want = jsort.sort(x, engine="tns", stop_after=3)
    got = tsort.sort(x, engine="tns", stop_after=3, device="cpu")
    np.testing.assert_array_equal(got.indices, want.indices)
    for f in ("cycles", "drs", "reload_cycles"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("batched", [False, True])
def test_faults_reach_the_machines_through_read_planes(batched):
    x, width = _data("unsigned", (3, 48), seed=4)
    if not batched:
        x = x[0]
    spec = dict(ber=0.03, stuck_one=0.01, seed=6)
    run_j = jt.tns_sort_batch if batched else jt.tns_sort
    run_t = tt.tns_sort_batch if batched else tt.tns_sort
    jc, tc = jfaults.FaultCounters(), tfaults.FaultCounters()
    with jfaults.inject(jfaults.FaultSpec(**spec), counters=jc):
        want = run_j(x, width=width, k=2, fmt="unsigned")
    with tfaults.inject(tfaults.FaultSpec(**spec), counters=tc):
        got = run_t(x, width=width, k=2, fmt="unsigned", device="cpu")
    _same(got, want)
    assert tc.faults_injected == jc.faults_injected > 0
    clean = run_t(x, width=width, k=2, fmt="unsigned", device="cpu")
    assert not np.array_equal(_host(clean)[0], _host(got)[0])


def test_machines_refuse_the_card_when_there_is_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.tns_sort(np.arange(4, dtype=np.uint8), width=8, k=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.tns_sort_batch(np.zeros((2, 4), np.uint8), width=8, k=1)
