"""Time sources for the serving loop.

The orchestrator never reads wall time directly: every latency, deadline
and throughput figure comes from a :class:`Clock`, so the whole loop runs
deterministically under :class:`SimulatedClock` in unit tests and CI — no
sleeps, no flaky timing — while :class:`WallClock` serves interactive
runs.  Simulated time is denominated in microseconds of *device* time:
latency-mode engines advance it by ``cycles / f_clk`` at their
Table-S5-calibrated operating point, so the serving metrics live in the
same time domain as the paper's throughput numbers.
"""
from __future__ import annotations

import time


class SimulatedClock:
    """Deterministic microsecond clock advanced explicitly by the loop."""

    def __init__(self, start_us: float = 0.0):
        self._now_us = float(start_us)

    def now_us(self) -> float:
        return self._now_us

    def advance_us(self, dt_us: float) -> float:
        if dt_us < 0:
            raise ValueError(f"cannot advance by {dt_us} us (negative)")
        self._now_us += float(dt_us)
        return self._now_us

    def advance_cycles(self, cycles: float, freq_hz: float) -> float:
        """Advance by the device time of ``cycles`` at ``freq_hz``."""
        if freq_hz <= 0:
            raise ValueError(f"freq_hz must be positive, got {freq_hz}")
        return self.advance_us(float(cycles) / freq_hz * 1e6)


class WallClock:
    """Monotonic host clock (interactive runs; never used in tests)."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now_us(self) -> float:
        return (time.monotonic() - self._t0) * 1e6

    def advance_us(self, dt_us: float) -> float:
        # wall time advances itself; the call is a no-op so orchestrator
        # code is clock-agnostic
        return self.now_us()

    def advance_cycles(self, cycles: float, freq_hz: float) -> float:
        return self.now_us()
