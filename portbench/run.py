"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

From the root of a checkout, on a machine with the card(s) a cell asks
for::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``portbench/configs/<name>.json``, whose ``driver`` names
``portbench/drivers/<driver>.py``) and a traffic mix
(``portbench/traffic/<mix>.json``).  The run makes its inputs and weights
from the seed, warms every shape it will use (``setup_s``), measures for
``--seconds``, checks what the timed path produced against the plain
reference (``portbench/reference/``), and prints one JSON line.  With
``--trace 1`` a profiled slice of the same loop comes first and the line
carries the per-layer metrics (``portbench/metrics/<name>.py``) in place
of the end-to-end ones.

The run fails, and prints no result, without the card(s), or when a
module named ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package,
told from ``repro_torch`` by its whole top-level name) is loaded at the
start, after set-up, or once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot give a result: it prints none and exits non-zero."""


def forbidden_loaded(modules=None) -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in list(modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def guard(when: str) -> None:
    found = forbidden_loaded()
    if found:
        raise Refused(f"{when}: the process has loaded {', '.join(found)}")


def _setup_paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every build and kernel cache at a fixed path inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # one host thread for the math libraries: the host work of a cell is
    # one Python thread's, and idle pools only take cores from it
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_inputs(bench: dict, name: str):
    """(cell, configuration, traffic mix) of a workload, by name."""
    from portbench import gen
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r}; there are {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    return cell, cfg, gen.load_mix(cell["traffic"])


def _applies(metric: dict, cell: str, reported=()) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def run(name: str, seed: int, seconds: float, trace: bool, device,
        bench=None, cfg=None, mix=None, patch=None, control=False) -> dict:
    """One run of a cell; returns the result line as a dict.  ``cfg`` /
    ``mix`` replace the cell's files and ``patch(cell)`` may replace parts
    of the driver before set-up (the CPU tests); ``control`` judges the
    control's answers in the program's place (``control.py``)."""
    import torch
    from portbench import trace as tr

    bench = bench or load_bench()
    cell, cfg0, mix0 = cell_inputs(bench, name)
    cfg, mix = cfg or cfg0, mix or mix0
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = tr.Spans(trace)
    drv = driver.Cell(cfg, mix, seed, dev, spans)
    if patch:
        patch(drv)
    before = time.perf_counter() - T_START     # interpreter, imports
    drv.setup()
    sync()
    guard("after set-up")
    setup_s = time.perf_counter() - T_START

    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        n = mix["trace_units"]
        with profile(activities=acts) as prof:
            with spans("window"):
                for _ in range(n):
                    drv.unit()
                sync()
        traced = tr.from_profiler(prof, drv.trace_counters(n))

    drv.begin_window()
    sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        drv.unit()
    sync()
    window_s = time.perf_counter() - t0
    e2e = drv.metrics(window_s)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.free()
    guard("once the window closed")
    checks = drv.check(control=True) if control else drv.check()

    metrics = {}
    units = {}
    if not trace:
        for m in bench["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = setup_s
            elif _applies(m, name):
                if m["name"] not in e2e:
                    raise Refused(f"the driver gave no {m['name']}")
                metrics[m["name"]] = e2e[m["name"]]
            units[m["name"]] = m["unit"]
    else:
        reported = [m["name"] for m in bench["end_to_end"]
                    if m["name"] == "setup_s" or _applies(m, name)]
        for m in bench["per_layer"]:
            if _applies(m, name, reported):
                v = tr.load_reader(m["name"])(traced)
                if v is not None:
                    metrics[m["name"]] = v
                    units[m["name"]] = m["unit"]
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": int(drv.attempted), "failed": int(drv.failed),
           "metrics": {k: {"value": float(v), "unit": units[k]}
                       for k, v in metrics.items()},
           "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        out["breakdown"] = traced.breakdown()
    # where set-up went, for PERF.md (stderr only; not a metric)
    out["_setup_phases"] = dict({"before the driver": before},
                                **getattr(drv, "phases", {}))
    out["checks"] = {k: {"value": float(v), "limit": float(lim)}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        guard("at the start")
        _setup_paths()
        bench = load_bench()
        chips = {w["name"]: w["chips"]
                 for w in bench["workloads"]}.get(args.workload)
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < (chips or 1):
            raise Refused(f"the cell needs {chips or 1} CUDA device(s); "
                          f"this machine has "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.set_num_threads(1)
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda", bench=bench)
        guard("before the result")
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for k, v in out.pop("_setup_phases").items():
        print(f"setup {k}: {v:.3f} s", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
