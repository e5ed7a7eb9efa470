"""The port's CA-TNS strategies (``repro_torch.core.catns``) and its copy of
the device model against the reference package's, on the same seeded
numpy inputs through ``device="cpu"``: BTS, the multi-bank machine (banks
on a tensor axis) with its eq. 2 cycle identity to basic TNS and against
the reference's shard_map machine on four XLA host devices, and the
eq. (4) bit-slice estimate.  Integer outputs are compared exactly."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import catns as jca
from repro.core import device_model as jdm
from repro_torch.core import catns as tca
from repro_torch.core import device_model as tdm
from repro_torch.core import ref_tns as rt
from repro_torch.core import tns as tt

REPO = Path(__file__).resolve().parent.parent
CELLS = {
    "unsigned": (lambda r, n: r.integers(0, 256, n).astype(np.uint8), 8),
    "twos": (lambda r, n: r.integers(-128, 128, n).astype(np.int8), 8),
    "signmag": (lambda r, n: r.integers(-2**14, 2**14, n), 16),
    "float": (lambda r, n: r.standard_normal(n).astype(np.float16), 16),
}


def _counts(out):
    return [np.asarray(t.cpu()).tolist() for t in out]


@pytest.mark.parametrize("fmt", list(CELLS))
@pytest.mark.parametrize("ascending", [True, False])
def test_bts_matches_reference_and_oracle(fmt, ascending):
    gen, width = CELLS[fmt]
    x = gen(np.random.default_rng(len(fmt)), 12)
    x[3] = x[7]                                   # a tie
    got = tca.bts_sort(x, width=width, fmt=fmt, ascending=ascending,
                       device="cpu")
    want = jca.bts_sort(x, width=width, fmt=fmt, ascending=ascending)
    assert _counts(got) == [np.asarray(a).tolist() for a in want]
    o = rt.bts_sort(x, width=width, fmt=fmt, ascending=ascending)
    assert _counts(got)[0] == o.perm.tolist()
    assert _counts(got)[1] == o.cycles == 12 * width


@pytest.mark.parametrize("fmt", list(CELLS))
@pytest.mark.parametrize("banks", [1, 2, 4, 8])
def test_multibank_is_cycle_identical_to_tns(fmt, banks):
    """Eq. 2: the synchronised banks behave cycle for cycle like one
    length-N sorter, in every count and in the emission order."""
    gen, width = CELLS[fmt]
    x = gen(np.random.default_rng(banks), 24)
    x[5] = x[17]
    level_bits = (1, 2) if fmt == "unsigned" else (1,)
    for k in (0, 1, 2):
        for ascending in (True, False):
            for lb in level_bits:
                call = dict(width=width, k=k, fmt=fmt, ascending=ascending,
                            level_bits=lb, device="cpu")
                got = tca.multibank_sort(x, banks=banks, **call)
                assert _counts(got) == _counts(tt.tns_sort(x, **call))


def test_multibank_rank_is_the_inverse_permutation():
    x = np.random.default_rng(2).integers(0, 256, 16)
    planes = torch.from_numpy(
        tt._encode(x, 8, "unsigned", 1)[0]).to(torch.uint8)
    rank, *_ = tca.multibank_sort_planes(planes, banks=4, k=2)
    perm = tca.multibank_sort(x, width=8, k=2, banks=4, device="cpu").perm
    assert rank[perm.long()].tolist() == list(range(16))


def test_multibank_needs_an_even_split():
    with pytest.raises(ValueError, match="multiple of the bank count"):
        tca.multibank_sort(np.arange(10), width=8, k=1, banks=4,
                           device="cpu")


def test_multibank_matches_the_shard_map_machine():
    """The reference's multi-bank machine over a 4-bank mesh of XLA host
    devices (a subprocess, so the device-count flag does not leak), against
    the port's banks on a tensor axis."""
    code = r"""
import json, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import catns as ca
mesh = Mesh(np.array(jax.devices()).reshape(4), ("bank",))
cells = json.loads(sys.argv[1])
out = []
for c in cells:
    x = np.array(c["x"], dtype=c["dtype"])
    r = ca.multibank_sort(x, width=c["width"], k=c["k"], mesh=mesh,
                          fmt=c["fmt"], level_bits=c["lb"])
    out.append([np.asarray(a).tolist() for a in r])
print(json.dumps(out))
"""
    rng = np.random.default_rng(7)
    cells = []
    for fmt, k, lb in (("unsigned", 2, 1), ("twos", 2, 1), ("float", 2, 1),
                       ("signmag", 0, 1), ("unsigned", 1, 2)):
        gen, width = CELLS[fmt]
        x = gen(rng, 16)
        cells.append(dict(x=x.tolist(), dtype=str(x.dtype), width=width,
                          k=k, fmt=fmt, lb=lb))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", code, json.dumps(cells)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for c, w in zip(cells, want):
        got = tca.multibank_sort(np.array(c["x"], dtype=c["dtype"]),
                                 width=c["width"], k=c["k"], banks=4,
                                 fmt=c["fmt"], level_bits=c["lb"],
                                 device="cpu")
        assert _counts(got) == w, c["fmt"]


@pytest.mark.parametrize("slices", [[8, 8], [4, 12], [5, 5, 6]])
def test_bitslice_estimate_matches_reference(slices):
    data = np.random.default_rng(3).integers(0, 2**16, 64)
    got = tca.bitslice_estimate_cycles(data, 16, 2, slices, device="cpu")
    assert got == jca.bitslice_estimate_cycles(data, 16, 2, slices)
    sim = rt.bitslice_sort(data, width=16, k=2, slice_widths=slices)
    assert sim.cycles <= got["estimate"] + len(data) + 16


def test_device_model_copy_draws_what_the_reference_draws():
    states = np.random.default_rng(0).integers(0, 8, 5000)
    a, b = tdm.write_verify(states, seed=1), jdm.write_verify(states, seed=1)
    np.testing.assert_array_equal(a.pulses, b.pulses)
    np.testing.assert_array_equal(a.failed, b.failed)
    assert (a.mean_pulses, a.pfr) == (b.mean_pulses, b.pfr)
    np.testing.assert_array_equal(tdm.read_conductance(states, seed=2),
                                  jdm.read_conductance(states, seed=2))
    for lb in (1, 2, 3):
        assert tdm.level_error_rate(lb, n_mc=20_000) == \
            jdm.level_error_rate(lb, n_mc=20_000)
    assert tdm.operating_ber(2) == jdm.operating_ber(2)
    planes = np.random.default_rng(4).integers(0, 2, (8, 64)).astype(
        np.uint8)
    np.testing.assert_array_equal(tdm.apply_ber(planes, 0.1, seed=3),
                                  jdm.apply_ber(planes, 0.1, seed=3))
    digits = np.random.default_rng(5).integers(0, 16, (4, 64)).astype(
        np.uint8)
    np.testing.assert_array_equal(tdm.apply_digit_ber(digits, 4, 0.1, 3),
                                  jdm.apply_digit_ber(digits, 4, 0.1, 3))
    x = np.array([3.0, np.nan, 1.0, 2.0])
    for perm in (np.argsort(x), np.array([1, 0, 2, 3])):
        assert tdm.sorting_accuracy(x, perm) == \
            jdm.sorting_accuracy(x, perm)
