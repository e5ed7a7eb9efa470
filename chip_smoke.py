#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one.  Phases, in
order; any failure raises and exits non-zero:

1. environment: the card's name and power limit, ``env_stamp()``;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc/`` (one
   ``nvcc`` each, in parallel, into ``build/kernels/``);
3. each kernel against its plain PyTorch version on the card, on a grid of
   formats, LIFO depths, stop points and directions (integer outputs,
   tolerance 0: equal exactly), plus the useful-DR cross-check between
   the two kernels;
4. the port's paths at full size, each driven with the launch counts set
   to 0 just before and read just after:
   a. ``sort(x, engine="fused-tns", k=2)`` on float16 (4096, 1024) —
      N = 1024 is the paper's array, 4096 banks put 64 MiB of planes on
      the card — held against a stable argsort of the sort keys, the
      event-driven oracle on rows 0-3 and the plain version on all rows;
   b. a large-bank top-m call, (512, 16384) with ``stop_after=64``, whose
      keys need 64 KiB of shared memory per block;
   c. the useful-DR check path: ``min_search`` over the (4096, 16, 1024)
      planes against the fused kernel's one-episode mixed-read count;
5. times (CUDA events after warm-up) beside the least time the card could
   take (bytes over 3.35 TB/s, integer operations over 67 T/s, the larger
   of the two), the plain version's time and ``torch.sort``'s;
6. one JSON line describing each kernel, then the device line last.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
ALU_OPS_PER_S = 67e12          # H100 SXM peak outside the tensor cores
# integer operations the episode algorithm needs per alive lane and
# episode: path depth (xor, and, bit length), resume test, masked key
# (xor, and), min, winner test, winner count, divergence (xor, bit
# length), deepest divergence (max), divergence bit (shift, or), emission
# test
FUSED_OPS_PER_LANE_EPISODE = 15
# per lane and column: compare, then OR into the hit and keep flags
DR_OPS_PER_LANE_COLUMN = 3
FORMATS = {"unsigned": 8, "twos": 8, "signmag": 16, "float": 16}


def expect(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def gen(fmt: str, rng, shape):
    if fmt == "unsigned":
        return rng.integers(0, 256, shape).astype("uint8")
    if fmt == "twos":
        return rng.integers(-128, 128, shape).astype("int8")
    if fmt == "signmag":
        return rng.integers(-2**14, 2**14, shape)
    return rng.standard_normal(shape).astype("float16")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np
    from repro_torch.core import bitplane as bp
    from repro_torch.core import ref_tns
    from repro_torch.kernels import _build, backend, digit_read, fused_tns
    from repro_torch.kernels.ref import min_search_ref
    from repro_torch.sort import sort

    dev = torch.device("cuda")
    err = {"fused_tns": 0, "digit_read": 0}

    def same(name, got, want, what):
        got, want = got.to(torch.int64), want.to(torch.int64)
        expect(got.shape == want.shape, f"{name} {what}: shape "
               f"{tuple(got.shape)} vs {tuple(want.shape)}")
        diff = int((got - want).abs().max()) if got.numel() else 0
        err[name] = max(err[name], diff)
        expect(diff == 0, f"{name} {what}: kernel differs from the plain "
               f"version by up to {diff}")

    def planes_of(x, width, fmt):
        sign = (bp.sign_plane(x, width, fmt)
                if fmt in ("signmag", "float") else None)
        return bp.planes_from_numpy(bp.to_bitplanes(x, width, fmt), sign,
                                    device=dev)

    def fused_pair(planes, sign, what, *, stop_after, **kw):
        """Kernel and plain version on the same device inputs; returns the
        kernel's (rank, counters) and the plain version's seconds."""
        got = fused_tns.fused_tns_rank(planes, sign, stop_after=stop_after,
                                       **kw)
        torch.cuda.synchronize()
        n = planes.shape[2]
        stop_n = max(n if stop_after is None else min(stop_after, n), 1)
        t0 = time.perf_counter()
        want = fused_tns.fused_tns_rank_ref(planes, sign, stop_n=stop_n, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        same("fused_tns", got[0], want[0], f"{what} rank")
        same("fused_tns", got[1], want[1], f"{what} counters")
        same("fused_tns", fused_tns.rank_to_perm(got[0]),
             fused_tns.rank_to_perm(want[0]), f"{what} perm")
        return got, plain_s

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    # ---- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print("env", json.dumps(backend.env_stamp()), flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    _build.build(["fused_tns", "digit_read"])
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in sorted(_build.build_logs.items()):
        print(f"ptxas {name}:", " | ".join(
            ln.strip() for ln in log.splitlines() if "Used" in ln
            or "spill" in ln), flush=True)

    # ---- 3. kernels vs plain versions on the card
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    cells = 0
    for fmt, width in FORMATS.items():
        for n in (130, 1024):
            x = gen(fmt, rng, (64, n))
            planes, sign = planes_of(x, width, fmt)
            for k in (0, 2):
                for stop in (6, None):
                    for asc in (True, False):
                        fused_pair(planes, sign, f"{fmt} N={n} k={k} "
                                   f"stop={stop} asc={asc}", k=k, fmt=fmt,
                                   ascending=asc, stop_after=stop)
                        cells += 1
    ties = torch.zeros((2, 8, 16), dtype=torch.uint8, device=dev)
    fused_pair(ties, None, "all ties", k=2, fmt="unsigned", ascending=True,
               stop_after=None)
    one, one_sign = planes_of(gen("float", rng, (64, 1)), 16, "float")
    fused_pair(one, one_sign, "N=1", k=2, fmt="float", ascending=True,
               stop_after=None)
    print(f"fused_tns == plain on {cells + 2} cells "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    dr_planes = torch.from_numpy(bp.to_bitplanes(
        rng.integers(0, 2**16, (64, 1024)), 16, "unsigned")).to(dev)
    for asc in (True, False):
        mask, drs = digit_read.min_search(dr_planes, asc)
        rmask, rdrs = min_search_ref(dr_planes, asc)
        same("digit_read", mask, rmask, f"mask asc={asc}")
        same("digit_read", drs, rdrs, f"useful DRs asc={asc}")
    one_ep = fused_tns.fused_tns_planes(dr_planes, None, k=2,
                                        fmt="unsigned", stop_after=1)
    expect(torch.equal(one_ep.useful_drs, digit_read.min_search(dr_planes)[1]),
           "fused useful DRs at stop_after=1 != min_search's")
    print("digit_read == plain; fused useful DRs == min_search's", flush=True)

    # ---- 4a. main path: sort() at full size
    x = np.random.default_rng(0).standard_normal((4096, 1024)).astype(
        np.float16)
    fused_tns.LAUNCHES = digit_read.LAUNCHES = 0
    t0 = time.perf_counter()
    res = sort(x, engine="fused-tns", k=2)
    sort_s = time.perf_counter() - t0
    launches = {"fused_tns": fused_tns.LAUNCHES,
                "digit_read": digit_read.LAUNCHES}
    print(f"sort(fused-tns) (4096, 1024) float16: launches {launches}, "
          f"{sort_s:.3f} s", flush=True)
    expect(launches["fused_tns"] > 0, "sort() did not launch fused_tns")
    keys = bp.sort_key(x, 16, "float")
    expect(res.indices.shape == x.shape and res.values.shape == x.shape,
           "result shape")
    expect(np.isfinite(res.values.astype(np.float32)).all(), "values finite")
    expect(np.array_equal(res.indices, np.argsort(keys, axis=1,
                                                  kind="stable")),
           "indices != stable argsort of the sort keys")
    for b in range(4):
        o = ref_tns.tns_sort(x[b], width=16, k=2, fmt="float")
        expect(np.array_equal(res.indices[b], o.perm)
               and (int(res.cycles[b]), int(res.drs[b]),
                    int(res.reload_cycles[b]))
               == (o.cycles, o.drs, o.reload_cycles),
               f"row {b} differs from the oracle")
    print("indices == stable argsort of sort_key; rows 0-3 == ref_tns "
          "(perm, cycles, DRs, reload cycles)", flush=True)
    row0 = dataclasses.replace(res, cycles=res.cycles[:1])
    print("metrics row 0:", row0.metrics(), flush=True)
    planes, sign = planes_of(x, 16, "float")
    (_, cnt), plain_s = fused_pair(planes, sign, "full size", k=2,
                                   fmt="float", ascending=True,
                                   stop_after=None)
    lane_eps = int(cnt[:, 6].sum())
    print(f"full size: kernel == plain (plain {plain_s:.3f} s); "
          f"lane-episodes {lane_eps}", flush=True)

    # ---- 4b. large-bank top-m
    xb = np.random.default_rng(1).standard_normal((512, 16384)).astype(
        np.float16)
    fused_tns.LAUNCHES = digit_read.LAUNCHES = 0
    resb = sort(xb, engine="fused-tns", k=2, stop_after=64)
    expect(fused_tns.LAUNCHES > 0, "top-m sort() did not launch fused_tns")
    keysb = bp.sort_key(xb, 16, "float")
    expect(np.array_equal(resb.indices, np.argsort(
        keysb, axis=1, kind="stable")[:, :64]), "top-m != stable argsort")
    o = ref_tns.tns_sort(xb[0], width=16, k=2, fmt="float", stop_after=64)
    expect(np.array_equal(resb.indices[0], o.perm)
           and int(resb.cycles[0]) == o.cycles
           and int(resb.drs[0]) == o.drs, "top-m row 0 != oracle")
    planes_b, sign_b = planes_of(xb, 16, "float")
    (_, cnt_b), _ = fused_pair(planes_b, sign_b, "large bank", k=2,
                               fmt="float", ascending=True, stop_after=64)
    print("top-m (512, 16384, stop_after=64): == argsort, row 0 == ref_tns, "
          "kernel == plain", flush=True)

    # ---- 4c. useful-DR check path at full size
    fused_tns.LAUNCHES = digit_read.LAUNCHES = 0
    mask, dr_full = digit_read.min_search(planes)
    one_ep = fused_tns.fused_tns_planes(planes, None, k=2, fmt="unsigned",
                                        stop_after=1)
    dr_launches = {"fused_tns": fused_tns.LAUNCHES,
                   "digit_read": digit_read.LAUNCHES}
    expect(dr_launches["digit_read"] > 0, "check path did not launch "
           "digit_read")
    expect(torch.equal(one_ep.useful_drs, dr_full),
           "full size: fused useful DRs != min_search's")
    rmask, rdrs = min_search_ref(planes)
    same("digit_read", mask, rmask, "full size mask")
    same("digit_read", dr_full, rdrs, "full size useful DRs")
    print(f"check path (4096, 16, 1024): launches {dr_launches}; "
          "min_search == plain == fused one-episode count", flush=True)

    # ---- 5. times
    B, W, N = planes.shape
    fused_ms = cuda_ms(lambda: fused_tns.fused_tns_rank(
        planes, sign, k=2, fmt="float"), 5)
    topm_ms = cuda_ms(lambda: fused_tns.fused_tns_rank(
        planes_b, sign_b, k=2, fmt="float", stop_after=64), 5)
    dr_ms = cuda_ms(lambda: digit_read.min_search(planes), 20)
    t0 = time.perf_counter()
    for _ in range(3):
        sort(x, engine="fused-tns", k=2)
    sort_ms = (time.perf_counter() - t0) / 3 * 1e3
    # the same call's steps one by one: where its time goes
    marks = [time.perf_counter()]
    digits = bp.to_bitplanes(x, 16, "float")
    sign_np = bp.sign_plane(x, 16, "float")
    marks.append(time.perf_counter())
    p_in, s_in = bp.planes_from_numpy(digits, sign_np, device=dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    rank_out, _ = fused_tns.fused_tns_rank(p_in, s_in, k=2, fmt="float")
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    fused_tns.rank_to_perm(rank_out).cpu().numpy()
    marks.append(time.perf_counter())
    steps = dict(zip(("encode on the host", "copy in", "kernel",
                      "perm + copy out"),
                     ((b - a) * 1e3 for a, b in zip(marks, marks[1:]))))
    keys_t = torch.from_numpy(keys.astype(np.int32)).to(dev)
    lib_ms = cuda_ms(lambda: torch.sort(keys_t, dim=1, stable=True), 20)
    dr_plain_ms = cuda_ms(lambda: min_search_ref(planes), 3)

    fused_bytes = planes.numel() + sign.numel() + 4 * B * N + 4 * B * 8
    fused_ops = lane_eps * FUSED_OPS_PER_LANE_EPISODE
    dr_bytes = planes.numel() + B * N + 4 * B
    dr_ops = B * W * N * DR_OPS_PER_LANE_COLUMN

    def bound(nbytes, ops):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / ALU_OPS_PER_S * 1e3
        return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                       else "operations"), by_bytes, by_ops

    fb = bound(fused_bytes, fused_ops)
    db = bound(dr_bytes, dr_ops)
    topm_ops = int(cnt_b[:, 6].sum()) * FUSED_OPS_PER_LANE_EPISODE
    tb = bound(planes_b.numel() + sign_b.numel() + 4 * 512 * 16384
               + 4 * 512 * 8, topm_ops)
    print(f"[{card}] fused_tns (4096, 1024) full sort k=2: {fused_ms:.4f} ms;"
          f" bytes bound {fb[2]:.4f} ms ({fused_bytes} B), ops bound "
          f"{fb[3]:.4f} ms ({fused_ops} int ops) -> bound by {fb[1]}; "
          f"plain {plain_s * 1e3:.1f} ms; torch.sort {lib_ms:.4f} ms",
          flush=True)
    print(f"[{card}] sort(engine='fused-tns') whole call: {sort_ms:.1f} ms; "
          "steps: " + ", ".join(f"{k} {v:.1f} ms" for k, v in steps.items()),
          flush=True)
    print(f"[{card}] fused_tns (512, 16384) stop_after=64: {topm_ms:.4f} ms;"
          f" bound {tb[0]:.4f} ms by {tb[1]}", flush=True)
    print(f"[{card}] min_search (4096, 16, 1024): {dr_ms:.4f} ms; bound "
          f"{db[0]:.4f} ms by {db[1]}; plain {dr_plain_ms:.3f} ms",
          flush=True)

    # ---- 6. kernel line, then the device line
    kernels = [
        {"name": "fused_tns", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_tns.cu",
         "replaces": "src/repro/kernels/fused_tns.py:155",
         "launches": launches["fused_tns"],
         "max_abs_err": float(err["fused_tns"]), "ms": fused_ms,
         "plain_ms": plain_s * 1e3, "bound_ms": fb[0], "bound_by": fb[1],
         "library_ms": lib_ms},
        {"name": "digit_read", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/digit_read.cu",
         "replaces": "src/repro/kernels/digit_read.py:43",
         "launches": dr_launches["digit_read"],
         "max_abs_err": float(err["digit_read"]), "ms": dr_ms,
         "plain_ms": dr_plain_ms, "bound_ms": db[0], "bound_by": db[1],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
