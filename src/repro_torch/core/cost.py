"""Hardware cost model for the memristor SIM system, calibrated to the
paper's measured operating points (Table S5, 1024 x 32-bit sort).

Physical quantities (clock frequency, area, power) cannot be measured on
CPU/TPU, so this model anchors every strategy at its published Table S5
operating point and extrapolates with scaling laws that reproduce the
*trends* reported in S11:

  * frequency decreases with bank length N and LIFO depth k (S11.1),
  * area grows with N and k; the cross-array processor adds area/power
    per extra bank (S11.2),
  * bit-slice FIFOs dominate BS power (S11.2.2),
  * ML periphery (n-bit ADCs + wider NE logic) lowers frequency but also
    the DR count (S8.3).

The exponents are engineering estimates; tests only assert the published
anchor points and the monotone trends, never the extrapolated magnitudes.

Latency is exact: it comes from the cycle-faithful engines, and
``throughput = N / (cycles / frequency)`` reproduces Table S5 (e.g. BTS:
1024 / (32768 cycles / 625 MHz) = 19.53 numbers/us — the published value).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

# ---------------------------------------------------------------------------
# Published operating points (Table S5): sort 1024 x 32-bit unsigned.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    name: str
    freq_hz: float
    area_mm2: float
    power_w: float
    n_ref: int = 1024
    w_ref: int = 32
    k_ref: int = 4

    def with_(self, **kw) -> "OperatingPoint":
        return dataclasses.replace(self, **kw)


# Derived from Table S5 columns: area = throughput/area_eff,
# power = throughput/energy_eff.
TABLE_S5 = {
    "bts":  OperatingPoint("bts",  625e6, 19.531e-3 / 0.6966 * 1e3 / 1e3, 19.531e6 / 4.9080e9, k_ref=0),
    "tns":  OperatingPoint("tns",  400e6, 136.79e-3 / 2.0540, 136.79e6 / 20.840e9, k_ref=4),
    "mb":   OperatingPoint("mb",   435e6, 168.55e-3 / 2.0562, 168.55e6 / 16.725e9, k_ref=6),
    "bs":   OperatingPoint("bs",   370e6, 208.14e-3 / 1.3462, 208.14e6 / 2.2028e9, k_ref=4),
    "ml":   OperatingPoint("ml",   312e6, 186.67e-3 / 2.5779, 186.67e6 / 38.128e9, k_ref=1),
}

# Reference sorting systems from Table S5 (for the comparison benchmark).
REFERENCE_SYSTEMS = {
    # name: (technology, freq_hz, throughput num/us, area_eff, energy_eff)
    "asic_merge": dict(tech="40nm", freq=1e9, thpt=27.018,
                       area_eff=0.0784, energy_eff=0.2077),
    "cpu_xeon6342": dict(tech="7nm", freq=2.8e9, thpt=12.271,
                         area_eff=None, energy_eff=9.36e-5),
    "gpu_a100": dict(tech="7nm", freq=765e6, thpt=1.2719,
                     area_eff=None, energy_eff=7.29e-5),
}

# Scaling-law coefficients (documented engineering estimates).
_FREQ_N_EXP = 0.06     # f ~ N^-0.06 (bigger banks -> slower periphery)
_FREQ_K_SLOPE = 0.02   # ~2% frequency loss per extra LIFO entry
_AREA_N_EXP = 0.85     # periphery area sub-linear in N (shared decode)
_AREA_K_SLOPE = 0.06   # LIFO + logic area per k
_POWER_N_EXP = 0.9
_POWER_K_SLOPE = 0.05
_XBAR_AREA = 0.004     # mm^2 per extra bank's cross-array processor share
_XBAR_POWER = 1.6e-3   # W per extra bank (sync signal tree)


def operating_point(strategy: str, *, n: int = 1024, w: int = 32,
                    k: Optional[int] = None, level_bits: int = 1,
                    banks: int = 1) -> OperatingPoint:
    """Operating point for a configuration.  Exact at the Table S5 anchors;
    scaled by the documented laws elsewhere."""
    if strategy not in TABLE_S5:
        raise ValueError(
            f"unknown strategy {strategy!r}; expected one of "
            f"{sorted(TABLE_S5)}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if w < 1:
        raise ValueError(f"w must be >= 1, got {w}")
    if banks < 1:
        raise ValueError(f"banks must be >= 1, got {banks}")
    base = TABLE_S5[strategy]
    kk = base.k_ref if k is None else k
    n_bank = max(1, n // banks) if strategy == "mb" else n
    n_base = 512 if strategy == "mb" else base.n_ref
    f = base.freq_hz * (n_base / max(1, n_bank)) ** _FREQ_N_EXP \
        * (1.0 - _FREQ_K_SLOPE * (kk - base.k_ref))
    area = base.area_mm2 * (n / base.n_ref) ** _AREA_N_EXP \
        * (1.0 + _AREA_K_SLOPE * (kk - base.k_ref)) \
        + _XBAR_AREA * max(0, banks - (2 if strategy == "mb" else 1))
    power = base.power_w * (n / base.n_ref) ** _POWER_N_EXP \
        * (1.0 + _POWER_K_SLOPE * (kk - base.k_ref)) \
        + _XBAR_POWER * max(0, banks - (2 if strategy == "mb" else 1))
    if strategy == "ml" and level_bits != 4:
        # anchor is ML-4-bit; fewer levels -> simpler ADC/NE -> faster
        f *= 1.0 + 0.05 * (4 - level_bits)
        power *= 1.0 - 0.04 * (4 - level_bits)
    return OperatingPoint(f"{strategy}(n={n},k={kk})", f, area, power,
                          n_ref=n, w_ref=w, k_ref=kk)


@dataclasses.dataclass(frozen=True)
class SortMetrics:
    cycles: int
    throughput_num_per_us: float
    area_mm2: float
    area_eff: float          # numbers / ns / mm^2
    energy_eff: float        # numbers / nJ
    power_w: float
    fom: float               # throughput x area_eff x energy_eff (Table S5)
    latency_us: float
    energy_nj: float


def sort_metrics(cycles: int, n: int, point: OperatingPoint) -> SortMetrics:
    latency_s = cycles / point.freq_hz
    thpt_us = n / (latency_s * 1e6)
    thpt_ns = thpt_us / 1e3
    area_eff = thpt_ns / point.area_mm2
    energy_j = point.power_w * latency_s
    energy_eff = n / (energy_j * 1e9)          # numbers per nJ
    return SortMetrics(
        cycles=int(cycles),
        throughput_num_per_us=thpt_us,
        area_mm2=point.area_mm2,
        area_eff=area_eff,
        energy_eff=energy_eff,
        power_w=point.power_w,
        fom=thpt_us * area_eff * energy_eff,
        latency_us=latency_s * 1e6,
        energy_nj=energy_j * 1e9,
    )


def table_s5_published() -> dict:
    """The paper's published Table S5 rows (for assertions/reports)."""
    return {
        "bts": dict(freq=625e6, thpt=19.531, area_eff=0.6966, energy_eff=4.9080, fom=66.772),
        "tns": dict(freq=400e6, thpt=136.79, area_eff=2.0540, energy_eff=20.840, fom=5855.4),
        "mb":  dict(freq=435e6, thpt=168.55, area_eff=2.0562, energy_eff=16.725, fom=5796.4),
        "bs":  dict(freq=370e6, thpt=208.14, area_eff=1.3462, energy_eff=2.2028, fom=617.22),
        "ml":  dict(freq=312e6, thpt=186.67, area_eff=2.5779, energy_eff=38.128, fom=18347.0),
        "asic_merge": dict(freq=1e9, thpt=27.018, area_eff=0.0784, energy_eff=0.2077, fom=0.4398),
    }
