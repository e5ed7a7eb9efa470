"""Stochastic memristor device model (paper §5.2, S1-S2, Fig. 2).

The physical observables the paper reports — and which this model is
calibrated to reproduce in expectation — are:

* binary programming: ON/OFF ratio >= 16.14x, zero programming error under
  DC write (S1);
* multi-level write-verify (8 states, dG_i proportional to G_i^target):
  average 13.95 pulses to converge, average programming failure rate (PFR)
  1.224% across the 8 states (§5.2, Fig. S3-S5);
* programming effort grows then saturates with target conductance, and
  drops sharply near the LRS regime (Fig. S4);
* bit errors from overlapping conductance states degrade sorting / NN
  accuracy gracefully (PointNet++ tolerates ~20% BER, Fig. S28).

Everything here is host-side numpy: device programming is an offline step
(Agilent pulse generators + LabVIEW in the paper), not part of the compute
path on the card.  That path consumes the *resulting* bit planes, with
``apply_ber`` injecting the read-error process.  This is the port's own
copy of the reference package's device model, draw for draw.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

# 8 non-linear target conductance states (uS), dG_i proportional to G_i
# (Fig. S3b).  The absolute values are representative; the calibrated
# observables are the pulse counts and PFR below.
G_TARGETS_US = np.array([15.0, 25.0, 40.0, 60.0, 85.0, 115.0, 150.0, 190.0])
DG_FRAC = 0.055                      # dG_i = 5.5% of G_i^target
ON_OFF_RATIO = 16.14                 # Fig. 2c (lowest measured)
N_MAX_PULSES = 50                    # write-verify pulse budget

# Mean pulse effort per state: grows with G then saturates; the LRS-adjacent
# state converges fast (stable filaments, Fig. S4).  Scaled + dispersed so
# that mean pulses ~= 13.95 and PFR ~= 1.224% (§5.2) — asserted in tests.
_BASE_PULSES = 0.85 * np.array([7.0, 10.5, 13.0, 15.0, 16.2, 17.0, 17.5, 15.5])
_PULSE_SIGMA = 0.60                  # lognormal dispersion (numerical fit)


@dataclasses.dataclass
class WriteVerifyStats:
    pulses: np.ndarray        # pulses used per programmed cell
    failed: np.ndarray        # bool per cell (did not converge in N_MAX)
    state: np.ndarray         # requested state index per cell

    @property
    def mean_pulses(self) -> float:
        return float(self.pulses[~self.failed].mean())

    @property
    def pfr(self) -> float:
        return float(self.failed.mean())


def write_verify(states: np.ndarray, seed: int = 0) -> WriteVerifyStats:
    """Simulate closed-loop write-verify programming (§5.2) of multi-level
    cells.  ``states``: int array of requested state indices (0..7)."""
    rng = np.random.default_rng(seed)
    states = np.asarray(states)
    base = _BASE_PULSES[states]
    pulses = np.ceil(base * rng.lognormal(0.0, _PULSE_SIGMA, states.shape))
    failed = pulses > N_MAX_PULSES
    pulses = np.minimum(pulses, N_MAX_PULSES)
    return WriteVerifyStats(pulses=pulses, failed=failed, state=states)


def read_conductance(states: np.ndarray, seed: int = 0,
                     spread_frac: float = DG_FRAC) -> np.ndarray:
    """Sample programmed conductances around their targets (Fig. 2e CDF)."""
    rng = np.random.default_rng(seed)
    g = G_TARGETS_US[np.asarray(states)]
    return rng.normal(g, spread_frac * g / 2.0)


def level_error_rate(level_bits: int, spread_frac: float = DG_FRAC,
                     n_mc: int = 200_000, seed: int = 0) -> float:
    """Monte-Carlo probability that a multi-level DR mis-reads a cell
    (adjacent-state conductance overlap), for ML-n-bit cells using the
    first 2**n of the 8 calibrated states."""
    nlev = 1 << level_bits
    idx = np.linspace(0, len(G_TARGETS_US) - 1, nlev).round().astype(int)
    g = G_TARGETS_US[idx]
    bounds = (g[1:] + g[:-1]) / 2.0
    rng = np.random.default_rng(seed)
    states = rng.integers(0, nlev, n_mc)
    reads = rng.normal(g[states], spread_frac * g[states] / 2.0)
    decoded = np.searchsorted(bounds, reads)
    return float((decoded != states).mean())


@functools.lru_cache(maxsize=None)
def operating_ber(level_bits: int = 1, seed: int = 0) -> float:
    """Effective per-bit error rate at the calibrated operating point:
    convergence failures (PFR) leave the cell one state off (half its bits
    wrong on average for Gray-adjacent levels) plus the conductance-overlap
    mis-read term.  Cached per (level_bits, seed) — the underlying
    100k-cell Monte-Carlo is pure in its arguments and hot callers (the
    resilience harness, CI smoke lanes) ask for the same point repeatedly."""
    if level_bits <= 1:
        return 0.0  # binary DC writes show no programming error (S1)
    rng = np.random.default_rng(seed)
    st = write_verify(rng.integers(0, 1 << level_bits, 100_000), seed=seed)
    return float(st.pfr * 0.5 + level_error_rate(level_bits, seed=seed))


def apply_ber(planes: np.ndarray, ber: float, seed: int = 0) -> np.ndarray:
    """Flip each stored bit with probability ``ber`` (device bit errors from
    overlapped conductance states, Fig. S28)."""
    if ber <= 0:
        return planes
    rng = np.random.default_rng(seed)
    flips = rng.random(planes.shape) < ber
    return np.where(flips, 1 - planes, planes).astype(planes.dtype)


def apply_digit_ber(digits: np.ndarray, level_bits: int, ber: float,
                    seed: int = 0) -> np.ndarray:
    """Bit errors for multi-level digits: each of the n bits inside a digit
    flips independently with probability ``ber``."""
    if ber <= 0:
        return digits
    rng = np.random.default_rng(seed)
    out = digits.copy()
    for b in range(level_bits):
        flips = rng.random(digits.shape) < ber
        out = np.where(flips, out ^ (1 << b), out)
    return out.astype(digits.dtype)


def sorting_accuracy(values: np.ndarray, perm: np.ndarray) -> float:
    """Fraction of emission positions whose value matches the true sorted
    order — the sorting-quality metric under device noise.  NaN-safe for
    float inputs: NaN emissions count as correct where the true sorted
    order also holds NaN (np.sort places NaNs last)."""
    x = np.asarray(values, dtype=np.float64)
    expect = np.sort(x)
    got = x[perm]
    match = (expect == got) | (np.isnan(expect) & np.isnan(got))
    return float(np.mean(match))
