"""The fused TNS kernel's tuning table: measured time per (fmt, N, m, B,
device) cell, persisted beside the repository and read back by the
serving dispatcher's wall-time prior.

The CUDA kernel takes no run-time knobs: its layout is fixed by N (a warp
a bank, four banks a block up to N = 1024).  So the sweep has one
candidate, the kernel as it is, and a cell's row records its time; the
table API (keys, sweep, save / load, nearest-cell lookup) is the one a
kernel with knobs would use.

Keys end in the device, ``"<card name>/sm_XY"`` on a CUDA device and
``"cpu"`` on the host, so a table tuned on one card never steers another
device.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import backend

#: the knobs a cell's winner records; the kernel has none
DEFAULT_PARAMS: Dict[str, int] = {}

BENCH_ARTIFACT = "BENCH_torch_fused_tns.json"

# what a table row holds beside the winner's knobs
_MEASURED = ("us", "sweep")


def device_tag(device=None) -> str:
    """The device field of a key: the card's name and compute capability,
    or ``"cpu"``.  ``None`` means the card."""
    dev = backend.resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"{torch.cuda.get_device_name(dev)}/sm_{major}{minor}"


def cell_key(fmt: str, n: int, m: int, b: int, device=None) -> str:
    """Stable table key for one workload cell (``m`` = emitted numbers:
    N for a full sort, ``stop_after`` for top-m)."""
    return f"{fmt}|N{n}|m{m}|B{b}|{device_tag(device)}"


def candidate_params(b: int) -> List[Dict[str, int]]:
    """The sweep lattice: one empty candidate, the kernel has no knobs."""
    return [dict(DEFAULT_PARAMS)]


def _gen_batch(fmt: str, width: int, n: int, b: int, seed: int):
    rng = np.random.default_rng(seed)
    if fmt == "unsigned":
        return rng.integers(0, 1 << width, (b, n))
    if fmt == "twos":
        half = 1 << (width - 1)
        return rng.integers(-half, half, (b, n))
    if fmt == "signmag":
        half = 1 << (width - 2)
        return rng.integers(-half, half, (b, n))
    return rng.standard_normal((b, n)).astype(np.float16)


def measure_cell(*, fmt: str, width: int, n: int, m: int, b: int,
                 k: int = 2, reps: int = 3, seed: int = 0,
                 device=None) -> Dict[str, object]:
    """Time ``sort(engine="fused-tns")`` on one cell for every candidate:
    the winner's knobs plus the full sweep (medians in us per call, host
    clock around the whole call, the first call excluded)."""
    from repro_torch.sort import sort
    dev = backend.resolve_device(device)
    x = _gen_batch(fmt, width, n, b, seed)
    stop = None if m >= n else m
    rows = []
    for cand in candidate_params(b):
        kw = dict(engine="fused-tns", width=width, k=k, fmt=fmt,
                  stop_after=stop, device=dev, **cand)
        sort(x, **kw)                          # build and load the kernel
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sort(x, **kw)
            ts.append(time.perf_counter() - t0)
        rows.append({**cand, "us": round(float(np.median(ts)) * 1e6, 1)})
    best = min(rows, key=lambda r: r["us"])
    return {**best, "sweep": rows}


def sweep(cells: Sequence[Dict[str, int]], *, reps: int = 3, seed: int = 0,
          device=None) -> Dict[str, Dict[str, object]]:
    """Tune every cell: ``cells`` entries carry fmt/width/n/m/b (+k)."""
    table: Dict[str, Dict[str, object]] = {}
    for cell in cells:
        key = cell_key(cell["fmt"], cell["n"], cell["m"], cell["b"], device)
        table[key] = measure_cell(
            fmt=cell["fmt"], width=cell["width"], n=cell["n"],
            m=cell["m"], b=cell["b"], k=cell.get("k", 2), reps=reps,
            seed=seed, device=device)
    return table


def save_table(table: Dict[str, Dict[str, object]], path) -> None:
    """Write ``{"env": backend.env_stamp(), "autotune": table}``: the
    table beside the card, power limit and versions it was measured
    with."""
    doc = {"env": backend.env_stamp(), "autotune": table}
    Path(path).write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")


def load_table(path) -> Dict[str, Dict[str, object]]:
    """Load an autotune table from a sweep file or a full BENCH artifact
    (both nest it under the "autotune" key)."""
    doc = json.loads(Path(path).read_text())
    return doc.get("autotune", doc)


_DEFAULT_CACHE: Dict[str, object] = {}


def default_table() -> Dict[str, Dict[str, object]]:
    """The committed table (repo-root BENCH artifact), cached on mtime so
    interactive regeneration is picked up without a process restart."""
    path = Path(__file__).resolve().parents[3] / BENCH_ARTIFACT
    if not path.exists():
        return {}
    mtime = path.stat().st_mtime_ns
    if _DEFAULT_CACHE.get("mtime") != mtime:
        try:
            _DEFAULT_CACHE["table"] = load_table(path)
        except (ValueError, OSError):
            _DEFAULT_CACHE["table"] = {}
        _DEFAULT_CACHE["mtime"] = mtime
    return _DEFAULT_CACHE["table"]          # type: ignore[return-value]


def nearest_cell(fmt: str, n: int, m: int, b: int, *, device=None,
                 table: Optional[Dict[str, Dict[str, object]]] = None
                 ) -> Optional[str]:
    """The key of the cell that steers (fmt, N, m, B) on ``device``: the
    exact key if tuned, else the nearest tuned cell of the same fmt and
    device (log-space distance over (N, m, B), ties to the first key in
    sorted order), else None."""
    table = default_table() if table is None else table
    tag = device_tag(device)
    key = f"{fmt}|N{n}|m{m}|B{b}|{tag}"
    if key in table:
        return key
    suffix = f"|{tag}"
    best, best_d = None, None
    for k in sorted(table):
        if not (k.startswith(f"{fmt}|") and k.endswith(suffix)):
            continue
        try:
            kn, km, kb = (int(part[1:]) for part in k.split("|")[1:4])
        except ValueError:
            continue
        d = sum(abs(np.log2(max(a, 1)) - np.log2(max(x, 1)))
                for a, x in ((kn, n), (km, m), (kb, b)))
        if best_d is None or d < best_d:
            best, best_d = k, d
    return best


def best_params(fmt: str, n: int, m: int, b: int, *, device=None,
                table: Optional[Dict[str, Dict[str, object]]] = None
                ) -> Dict[str, int]:
    """The winning knobs for a cell: an exact table hit, else the nearest
    tuned cell of the same fmt and device, else the defaults."""
    table = default_table() if table is None else table
    key = nearest_cell(fmt, n, m, b, device=device, table=table)
    if key is None:
        return dict(DEFAULT_PARAMS)
    return {k: int(v) for k, v in table[key].items() if k not in _MEASURED}
