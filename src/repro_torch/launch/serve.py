"""Serving CLI — thin front-end over the port's serving subsystem.

It runs the continuous-batching orchestrator (:mod:`repro_torch.serving`)
on a deterministic synthetic request trace: async admission with
backpressure, budget-aware engine dispatch over the port's sort registry,
and sustained-throughput metrics (p50/p99 latency, batch occupancy,
evictions) on a simulated device clock.  The engines run on the card
unless ``--device cpu`` asks for the host.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 40 --n 48 \\
        --mean-gap-us 0.1 --out serve.json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 6 --n 32 --chunk 16 --fault-spec ber=0.01,seed=0

``--fault-spec`` serves from an imperfect array.  The one-shot
model-decode driver (``--oneshot``) needs the model zoo and is not ported
yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional

from repro_torch import serving, sort as sort_engine
from repro_torch.runtime import faults


def serve_requests(n_requests: int, *, n: int = 48, seed: int = 0,
                   mean_gap_us: float = 0.1, max_batch: int = 8,
                   chunk: int = 8, quality_floor: Optional[float] = None,
                   fault_spec: Optional[faults.FaultSpec] = None,
                   device=None) -> Dict:
    """Run one synthetic trace through the orchestrator on ``device``
    (``None``: the card); returns the sustained-throughput summary (plus
    fault counters when injecting)."""
    trace = serving.make_trace(n_requests, seed=seed, n=n,
                               mean_gap_us=mean_gap_us,
                               quality_floor=quality_floor)
    orch = serving.Orchestrator(
        clock=serving.SimulatedClock(),
        cfg=serving.OrchestratorConfig(max_batch=max_batch, chunk=chunk),
        device=device)
    if fault_spec is not None:
        counters = faults.FaultCounters()
        with faults.inject(fault_spec, counters=counters):
            report = orch.run(trace)
        report["fault_counters"] = dataclasses.asdict(counters)
    else:
        report = orch.run(trace)
    report["trace_mix"] = serving.trace_mix(trace)
    return report


def _print_report(report: Dict) -> None:
    print(f"[serve] {report['completed']} completed / "
          f"{report['accepted']} accepted ({report['rejected']} rejected, "
          f"{report['expired']} expired, {report['failed']} failed) "
          f"in {report['ticks']} ticks / {report['sim_us']:.2f}us device")
    print(f"[serve] throughput {report['throughput_elems_per_us']:.1f} "
          f"elems/us  latency p50 {report['p50_latency_us']:.2f}us "
          f"p99 {report['p99_latency_us']:.2f}us")
    print(f"[serve] batch occupancy mean {report['mean_batch_occupancy']:.2f} "
          f"peak {report['peak_batch_occupancy']}  queue depth mean "
          f"{report['mean_queue_depth']:.2f}  evictions/tick "
          f"{report['evictions_per_tick']:.2f}")
    print(f"[serve] engine dispatches: {report['engines']}")
    if "fault_counters" in report:
        c = report["fault_counters"]
        print(f"[serve] fault counters: reads={c['reads']} "
              f"faults={c['faults_injected']} corrected={c['corrected']} "
              f"votes={c['votes']} delays={c['delays']}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="continuous-batching serving loop over the port's "
                    "sort engines")
    ap.add_argument("--oneshot", action="store_true",
                    help="the one-shot model-decode driver (not ported "
                         "yet)")
    ap.add_argument("--fault-spec", default=None,
                    help="inject device faults for the whole run, e.g. "
                         "'ber=0.01,banks=4,dead_banks=1:2,seed=0' "
                         "(see repro_torch.runtime.faults.FaultSpec)")
    ap.add_argument("--list-engines", action="store_true",
                    help="print the sort-engine registry and exit")
    ap.add_argument("--device", default=None,
                    help="torch device the engines run on (default: the "
                         "CUDA device; 'cpu' runs the plain versions)")
    grp = ap.add_argument_group("serving loop")
    grp.add_argument("--requests", type=int, default=40)
    grp.add_argument("--n", type=int, default=48,
                     help="per-request problem size")
    grp.add_argument("--mean-gap-us", type=float, default=0.1,
                     help="mean inter-arrival gap (device us)")
    grp.add_argument("--seed", type=int, default=0)
    grp.add_argument("--max-batch", type=int, default=8)
    grp.add_argument("--chunk", type=int, default=8,
                     help="emission chunk per orchestrator step")
    grp.add_argument("--quality-floor", type=float, default=None,
                     help="override every request's quality floor "
                          "(defaults to 0.99 under --fault-spec)")
    grp.add_argument("--out", default=None,
                     help="write the summary JSON here")
    args = ap.parse_args(argv)

    if args.list_engines:
        for name, spec in sorted(sort_engine.engines().items()):
            print(f"{name:12s} [{spec.mode:10s}] {spec.description}")
        return
    if args.oneshot:
        raise SystemExit(
            "--oneshot (the model-decode driver) is not ported yet: it "
            "needs the model zoo and launch layer, item A12 of ROADMAP.md")

    fault_spec = faults.parse_spec(args.fault_spec) if args.fault_spec \
        else None
    floor = args.quality_floor
    if floor is None and fault_spec is not None:
        floor = 0.99   # force verified engines on a faulted array
    report = serve_requests(
        args.requests, n=args.n, seed=args.seed,
        mean_gap_us=args.mean_gap_us, max_batch=args.max_batch,
        chunk=args.chunk, quality_floor=floor, fault_spec=fault_spec,
        device=args.device)
    _print_report(report)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"[serve] wrote {args.out}")


if __name__ == "__main__":
    main()
