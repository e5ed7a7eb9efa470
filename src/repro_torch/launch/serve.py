"""Serving CLI — thin front-end over the port's serving subsystem.

Default mode runs the continuous-batching orchestrator
(:mod:`repro_torch.serving`) on a deterministic synthetic request trace:
async admission with backpressure, budget-aware engine dispatch over the
port's sort registry, and sustained-throughput metrics (p50/p99 latency,
batch occupancy, evictions) on a simulated device clock.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 40 --n 48 \\
        --mean-gap-us 0.1 --out serve.json
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 6 --n 32 --chunk 16 --fault-spec ber=0.01,seed=0

``--oneshot`` runs the model-decode loop: batched prefill + decode over
the stacked model with the paper's technique in the loop (comparison-free
top-k sampling through the sort-engine facade, engine-selectable MoE
routing, optional in-situ pruning of the served weights).  Weights are
random, drawn from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --oneshot \\
        --arch qwen2_moe_a2_7b --device cpu --layers 2 --d-model 64 \\
        --vocab 128 --batch 2 --prompt-len 4 --max-new 5 --top-k 8 \\
        --prune 0.3 --router-impl pallas

Both modes accept ``--fault-spec`` to serve from an imperfect array, and
run on the card unless ``--device cpu`` asks for the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import serving, sort as sort_engine
from repro_torch.kernels import backend
from repro_torch.models.moe import ROUTER_ENGINES
from repro_torch.runtime import faults
from repro_torch.runtime.faults import run_step_with_retries


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


# ---------------------------------------------------------------------------
# --oneshot: the prefill+decode model loop.
# ---------------------------------------------------------------------------


def serve(cfg, batch: int, prompt_len: int, max_new: int, top_k: int = 0,
          prune_rate: float = 0.0, seed: int = 0, device=None,
          mesh=None) -> Dict:
    """Batched prefill of a random prompt, then ``max_new - 1`` decode
    steps with top-k sampling, over random weights drawn from ``seed`` on
    ``device`` (``None``: the card).  Returns the tokens and the times.

    On ``mesh`` (a DeviceMesh; every rank of it calls this) each rank
    prefills and decodes its rows of the batch
    (``steps.make_sharded_*_step``), the caches laid out over the mesh by
    ``launch.sharding.cache_specs``, the weights by the reference's
    serving specs (tensor-parallel only: replicated over the data axes,
    so no step gathers them).  Every rank samples the whole batch's next
    tokens from the gathered logits with the same generator, so the
    tokens are the unsharded run's wherever the logits are."""
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import sampling, stacked
    from repro_torch.pruning import insitu

    dev = (sharding.mesh_device(mesh) if mesh is not None
           else backend.resolve_device(device))
    wf = bool(cfg.frontend_tokens)
    max_len = prompt_len + max_new
    params = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)

    if prune_rate > 0:
        # the paper's in-situ pruning (§3.2): TNS locates the p% smallest
        # magnitudes in each MLP input row-block at serve time (masking an
        # input lane == zeroing its weight row, Algorithm S2)
        params, pstats = insitu.prune_params(params, cfg, prune_rate)
        print(f"[serve] in-situ pruned: weight sparsity "
              f"{pstats['weight_sparsity']:.1%}")

    # the reference's prompt: the same numpy draw from the same seed
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                             dtype=torch.int32, device=dev)
    # the VLM / audio frontend stub, given to prefill and every decode step
    fe = (dp.frontend_stub(cfg, batch, dev),) if wf else ()
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    caches = stacked.init_cache(cfg, batch, max_len, dev)
    if mesh is None:
        prefill = steps_lib.make_prefill_step(cfg, with_frontend=wf)
        decode = steps_lib.make_decode_step(cfg, with_frontend=wf)
        rows, last = slice(0, batch), (lambda lg: lg[:, -1, :])
    else:
        data_axes = mesh_lib.data_axes(mesh)
        prefill = steps_lib.make_sharded_prefill_step(cfg, mesh,
                                                      with_frontend=wf)
        decode = steps_lib.make_sharded_decode_step(cfg, mesh,
                                                    with_frontend=wf)
        caches = sharding.place(caches, mesh, sharding.cache_specs(
            mesh, caches, data_axes))
        params = sharding.place(params, mesh, sharding.param_specs(
            mesh, params, dp=None))
        rows = sharding.local_rows(mesh, batch, data_axes)
        fe = tuple(f[rows] for f in fe)
        where = sharding.placements(mesh, sharding.batch_spec(
            mesh, (batch, cfg.vocab), data_axes))

        def last(lg):
            return DTensor.from_local(lg[:, -1, :].contiguous(), mesh, where,
                                      run_check=False).full_tensor()

    t0 = time.monotonic()
    logits, caches = prefill(params, prompt[rows], caches, *fe)
    sync()
    prefill_s = time.monotonic() - t0

    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = sampling.sample_logits(last(logits), gen, top_k)[:, None]
    out = [prompt, tok]
    pos = torch.full((batch,), prompt_len - 1, dtype=torch.int32, device=dev)
    t0 = time.monotonic()
    for _ in range(max_new - 1):
        pos = pos + 1
        logits, caches = decode(params, tok[rows], pos[rows], caches, *fe)
        tok = sampling.sample_logits(last(logits), gen, top_k)[:, None]
        out.append(tok)
    seq = torch.cat(out, dim=1).cpu().numpy()
    decode_s = time.monotonic() - t0
    return {
        "tokens": seq,
        "prefill_s": prefill_s,
        "decode_tok_per_s": batch * (max_new - 1) / max(decode_s, 1e-9),
        "pruned": prune_rate,
    }


def _oneshot_main(args) -> Dict:
    from repro_torch import configs

    if not args.arch:
        raise SystemExit("--oneshot requires --arch")
    cfg = configs.get_config(args.arch)
    if args.router_impl:
        cfg = dataclasses.replace(cfg, router_impl=args.router_impl)
    if not args.full_size:
        cfg = cfg.reduced(n_layers=args.layers, d_model=args.d_model,
                          vocab=args.vocab)
        if cfg.ssm_state:
            cfg = dataclasses.replace(
                cfg, ssm_chunk=min(cfg.ssm_chunk, args.prompt_len))
    run = lambda: serve(cfg, args.batch, args.prompt_len, args.max_new,
                        top_k=args.top_k, prune_rate=args.prune,
                        seed=args.seed, device=args.device)
    if args.fault_spec:
        spec = faults.parse_spec(args.fault_spec)
        counters = faults.FaultCounters()
        probe_state: Dict = {}
        probe_dev = backend.resolve_device(args.device)

        def attempt():
            with faults.inject(spec, counters=counters):
                # pre-flight: a resilient sort on the faulted array; a
                # degraded result means even the repair ladder cannot
                # trust this array — retry (fresh read noise), then fail
                probe = sort_engine.sort(
                    np.arange(64, dtype=np.uint16)[::-1].copy(),
                    engine="resilient:tns", device=probe_dev)
                probe_state.update(
                    quality=float(probe.quality), repairs=probe.repairs,
                    retries=probe.retries, degraded=probe.degraded)
                print(f"[serve] fault pre-flight: quality="
                      f"{probe.quality:.3f} repairs={probe.repairs} "
                      f"retries={probe.retries} degraded={probe.degraded}")
                if probe.degraded:
                    raise RuntimeError("fault pre-flight degraded")
                return run()

        res = run_step_with_retries(
            attempt, retries=args.serve_retries, backoff_s=0.05,
            on_retry=lambda i, e: print(f"[serve] retry {i + 1}: {e}"),
            rng=np.random.default_rng(spec.seed))
        # surface the winning attempt's degradation fields in the summary
        res["probe"] = dict(probe_state)
        print(f"[serve] fault counters: reads={counters.reads} "
              f"faults={counters.faults_injected} "
              f"corrected={counters.corrected} votes={counters.votes} "
              f"delays={counters.delays}")
    else:
        res = run()
    summary = (f"[serve] prefill {res['prefill_s']*1e3:.0f}ms, "
               f"decode {res['decode_tok_per_s']:.1f} tok/s, "
               f"prune={res['pruned']:.0%}")
    probe = res.get("probe")
    if probe:
        summary += (f", degraded={probe['degraded']} "
                    f"repairs={probe['repairs']} retries={probe['retries']} "
                    f"quality={probe['quality']:.3f}")
    print(summary)
    print(f"[serve] first sequence: {res['tokens'][0][:24]}...")
    return res


def main(argv=None):
    """The CLI; returns the one-shot run's result under ``--oneshot``
    (tokens and times), else None."""
    ap = argparse.ArgumentParser(
        description="continuous-batching serving loop (default) or the "
                    "one-shot model-decode loop (--oneshot)")
    ap.add_argument("--oneshot", action="store_true",
                    help="run the prefill+decode model loop instead of "
                         "the request-serving loop")
    ap.add_argument("--fault-spec", default=None,
                    help="inject device faults for the whole run, e.g. "
                         "'ber=0.01,banks=4,dead_banks=1:2,seed=0' "
                         "(see repro_torch.runtime.faults.FaultSpec)")
    ap.add_argument("--list-engines", action="store_true",
                    help="print the sort-engine registry and exit")
    ap.add_argument("--device", default=None,
                    help="torch device the engines and the model run on "
                         "(default: the CUDA device; 'cpu' runs the plain "
                         "versions)")
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
    grp = ap.add_argument_group("one-shot model decode")
    grp.add_argument("--arch", default=None)
    grp.add_argument("--batch", type=int, default=4)
    grp.add_argument("--prompt-len", type=int, default=16)
    grp.add_argument("--max-new", type=int, default=32)
    grp.add_argument("--top-k", type=int, default=0)
    grp.add_argument("--prune", type=float, default=0.0)
    grp.add_argument("--layers", type=int, default=4)
    grp.add_argument("--d-model", type=int, default=256)
    grp.add_argument("--vocab", type=int, default=1024)
    grp.add_argument("--full-size", action="store_true")
    grp.add_argument("--router-impl", default=None,
                     choices=sorted(ROUTER_ENGINES),
                     help="MoE routing top-k engine, by the reference's "
                          "name (radix | pallas | lax) or the port's "
                          "(radix | fused-topk | torch); default: the arch "
                          "config's choice")
    grp.add_argument("--serve-retries", type=int, default=2,
                     help="full-run retries when the fault pre-flight "
                          "degrades (with --fault-spec)")
    args = ap.parse_args(argv)

    if args.list_engines:
        for name, spec in sorted(sort_engine.engines().items()):
            print(f"{name:12s} [{spec.mode:10s}] {spec.description}")
        return
    if args.oneshot:
        return _oneshot_main(args)

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
