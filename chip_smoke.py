#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one.  Phases, in
order; any failure raises and exits non-zero:

1. environment: the card's name and power limit, ``env_stamp()``;
2. build: every CUDA kernel in ``src/repro_torch/kernels/csrc/`` (one
   ``nvcc`` each, in parallel, into ``build/kernels/``);
3. each kernel against its plain PyTorch version on the card: the fused
   TNS and digit-read kernels on a grid of formats, LIFO depths, stop
   points and directions, plus the useful-DR cross-check between the two;
   the fused kernel also at N around its word edges (31, 32, 33, 1023,
   1025, 4096) with k in {1, 17}, W = 30 unsigned, and past 16384 lanes
   with W = 30 (its shared-memory fallback);
   key pack / unpack on float32, bfloat16 and int32 with +-0, +-inf and
   NaN; radix top-k over N in {1, 60, 160, 1024}, k in {1, 6, 32}, r in
   {1, 3, 4, 8} with an all-ties row, over wide rows, N in {16385, 50304,
   70000}, k in {1, 6, 50}, and at the kernel's form edges: N 1024 / 1025
   (warp form / radix select), the widest row staged in shared memory and
   one past it, k = 1024 / 1025 (the select's sort capacity / the digit
   rounds), rows whose tie set at the threshold straddles the k-th slot,
   and r in {5, 6, 7}, whose low bits are never read (integer outputs:
   equal exactly);
   the digit read over N in {1, 31, 32, 33, 1024, 2048, 2049, 65536} (the
   warp form up to 2048 lanes, the block form past it), W in {1, 16, 32},
   both directions, planes holding bytes 2 and 255 (equal exactly);
   the pruned matmul in float32 and bfloat16 at a ragged shape and with an
   all-false mask, and at the edges of its wgmma form: M in {1, 64, 65,
   130} x N in {8, 120, 256, 264} x K in {8, 64, 72, 2056}, all-pruned and
   all-kept masks, NaN and infinity in pruned lanes of x and pruned rows
   of w (NaN where the plain version has it), a wmma-form cell (K = 257)
   and K = 0, each form's launch count checked (tolerance: see
   ``mm_tolerance``);
4. the port's paths at full size, each driven with the launch counts set
   to 0 just before and read just after:
   a. ``sort(x, engine="fused-tns", k=2)`` on float16 (4096, 1024) —
      N = 1024 is the paper's array, 4096 banks put 64 MiB of planes on
      the card — held against a stable argsort of the sort keys, the
      event-driven oracle on rows 0-3 and the plain version on all rows;
   b. a large-bank top-m call, (512, 16384) with ``stop_after=64``, whose
      keys need 64 KiB of shared memory per block;
   c. the useful-DR check path: ``min_search`` over the (4096, 16, 1024)
      planes against the fused kernel's one-episode mixed-read count,
      through the digit read's warp form;
   d. the MoE router: ``topk(logits, 6, engine="fused-topk")`` on float32
      (16384, 160) (deepseek-v2: 160 routed experts, top-6, 16384
      tokens) and top-4 of bfloat16 (16384, 60) (qwen2-moe), indices held
      to the plain version, values to ``torch.topk``'s, and the packed
      keys of both inputs to the plain version (unpacked: bit for bit);
   e. ``sort(x, engine="fused-topk", stop_after=32)`` on float32
      (4096, 1024), held to a stable argsort of the sort keys;
   f. ``sort(x, engine="radix")`` on the same x (plain torch, no kernel);
   g. ``pruned_matmul`` at olmo-1b's MLP (bfloat16 x (4096, 2048), w
      (2048, 8192)), the 30 % of input lanes with the smallest max |w|
      dropped by ``prune_mask``, through the matmul's wgmma form;
   h. ``topk_mask(logits, 50)`` over olmo-1b's vocabulary, (64, 50304)
      (plain torch);
   i. ``sort(x, k=2)`` on a's x with no engine named: the default ``tns``
      engine, the batched machine in plain torch on the card, held bit for
      bit to a's ``fused-tns`` result (perm, values, cycles, DRs, reload
      cycles), timed step by step; the single instance on row 0;
   j. the other latency engines at N = 1024, each held to the port's host
      run of the same call and to a stable argsort: ``ml`` (level_bits 4)
      and ``tns`` with ``ideal_lifo`` (the generic step), ``mb`` with 4
      banks on (16, 1024) float16, ``bts`` on two rows, ``bitslice`` on
      (16, 1024) uint16;
   k. faults: ``FaultSpec(ber=1e-3, dead_banks=(1,), banks=4, seed=0)``;
      ``resilient:tns`` and ``resilient:fused-tns`` on (16, 1024) float16
      equal the clean sort, undegraded, with the host run's fault, repair,
      retry and extra-cycle counts (the fused engine's host run on two
      rows, its whole batch held to ``resilient:tns``'s counts); ``mb-ft``
      over 4 banks with bank 1 dead on (1023,) float16, through the
      multi-bank machine over the 3 survivors;
   l. serving at the reference's own bench configuration
      (``benchmarks/bench_serve.py``: 40 requests, n 48, chunk 8, gap
      0.05 us, max_batch 8): the continuous-batching orchestrator and the
      one-shot loop, then the faulted point (6 requests,
      ``FaultSpec(ber=0.01, seed=0)``, quality floor 0.99, verified
      engines only), each on the card and on the host: every request
      done, none failed, its indices numpy's stable argsort prefix; the
      fused engines' kernels launched wherever the dispatcher picked them,
      the top-k and key-pack kernels in any case;
   m. serving at the paper's array width, n = 1024: 16 requests of all
      five classes, chunk 1024, and the one-shot loop on the first 8, with
      the same checks;
   n. Dijkstra on the ``tns`` machine with the Fig. 5e statistics for the
      four (src, dst) pairs: paths equal the comparison-based reference,
      DRs, cycles and Fig. 5e counts equal the host run, 2-4 DRs a number;
   o. in-situ pruning: ``tns_prune`` on 1024 weights at rate 0.3 with BER
      0 and 0.01 equal to the host run; ``prune_params`` at rate 0.3 on
      olmo-1b's MLP input stack, bfloat16 (16, 2048, 16384): masks equal
      the host run bit for bit, weight sparsity within 0.05 of the rate,
      dropped lanes zero;
   p. the autotune table: ``sort(engine="fused-tns")`` timed on the six
      cells of ``BENCH_pallas_tns.json``'s table, written to
      ``build/BENCH_torch_fused_tns.json``, printed, and read back by
      ``best_params`` and the serving dispatcher's wall prior;
5. times (CUDA events after warm-up) beside the least time the card could
   take (bytes over 3.35 TB/s, integer operations over 67 T/s, bfloat16
   tensor-core operations over 989 T/s, the larger; the fused TNS kernel's
   operations also counted word by word, and over the int32 issue rate),
   the plain version's time and one PyTorch call computing the same
   function where there is one; the top-k kernel at the router's shape,
   path e's (4096, 1024) k=32 and olmo-1b's vocabulary (64, 50304) k=50,
   each beside ``torch.topk`` on int64-widened and on sign-flipped int32
   keys and its bound, and at (4096, 1024) for k in {1, 32, 64}; a
   breakdown of the ``topk()`` call; path i's call step by step beside the
   fused kernel, and the single instance's time a cycle; the pruned matmul
   and the digit read beside their times before their redesign
   (``PERF.md``), the matmul with
   inputs cold in L2, also with every lane kept (the mask's cost), and the
   host time of a call of each matmul form (the wgmma form encodes two
   TMA descriptors a call);
6. one JSON line describing each kernel, then the device line last.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
ALU_OPS_PER_S = 67e12          # H100 SXM peak outside the tensor cores
# Hopper's int32 issue rate: 64 results per clock per SM (NVIDIA's Hopper
# architecture white paper), taken at the SM clock nvidia-smi reports
INT32_OPS_PER_CLOCK_PER_SM = 64
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bfloat16 tensor cores
# SM cycles the card sleeps per timed call while the host queues the calls
# (about 0.2 ms at the H100's clock)
SLEEP_CYCLES_PER_CALL = 400_000
# integer operations the episode algorithm needs per alive lane and
# episode: path depth (xor, and, bit length), resume test, masked key
# (xor, and), min, winner test, winner count, divergence (xor, bit
# length), deepest divergence (max), divergence bit (shift, or), emission
# test
FUSED_OPS_PER_LANE_EPISODE = 15
# the same episodes counted on 32-lane words, as the bit-sliced kernel
# does them: per column read and word, the kept-digit narrowing (xor,
# and), the excluded word (xor) and two non-empty flags; per episode and
# word, the resumed set (and with alive), its count (popcount), the sign
# test (and) and the emission's clear (and-not)
FUSED_OPS_PER_WORD_COLUMN = 5
FUSED_OPS_PER_WORD_EPISODE = 4
# per lane and column: compare, then OR into the hit and keep flags
DR_OPS_PER_LANE_COLUMN = 3
# integer operations of the top-k kernel.  Warp form (N <= 1024): per key,
# its load (mask, the lane's not-emitted bit: shift, or) and its part in
# the lane's first candidate (bit test, compare, two selects); per round,
# two warp reductions, the key test and select, the slot and the held
# pair, the winner's bit cleared; per key the winner's lane rescans (bit
# test, compare, two selects)
TOPK_WARP_OPS_PER_KEY = 7
TOPK_WARP_OPS_PER_ROUND = 10
TOPK_WARP_OPS_PER_RESCAN_KEY = 4
# radix select (N > 1024): per key and histogram pass (prefix: shift,
# compare; digit: shift, and; the counter's address, the count), per key
# compacted (shift, two compares, or) and per compare-exchange of the
# bitonic sort (64-bit compare, two selects)
TOPK_SELECT_OPS_PER_KEY_PASS = 6
TOPK_SELECT_OPS_PER_KEY_COMPACT = 4
TOPK_OPS_PER_COMPARE_EXCHANGE = 4
# olmo-1b (src/repro/configs/olmo_1b.py): MLP widths and vocabulary
OLMO_D_MODEL, OLMO_D_FF, OLMO_VOCAB = 2048, 8192, 50304
OLMO_LAYERS = 16
# card times before this slice's redesigns (PERF.md, kernel table: NVIDIA
# H100 80GB HBM3, 700.00 W): the pruned matmul at olmo-1b's MLP (its WMMA
# kernel, now the wmma form) and the digit read at (4096, 16, 1024) (its
# one-block-a-row kernel, now the block form)
MATMUL_MS_BEFORE, DIGIT_READ_MS_BEFORE = 2.0123, 0.0709
PRUNE_RATE = 0.3               # share of MLP input lanes pruned in situ
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


def mm_tolerance(x, w, keep, exact):
    """Elementwise bound on |result - exact| for ``(x * keep) @ w`` summed
    in float32 and rounded to x's dtype, ``exact`` being the float64
    product.  The products of float32 or bfloat16 inputs are exact or
    rounded once; each of the K float32 additions may lose one float32 ulp
    (2^-23: the tensor cores' adder need not round to nearest), hence
    acc = K * 2^-23 * (|x * keep| @ |w|); the final rounding to the
    output type adds at most u * (|exact| + acc), u = 2^-24 for float32
    and 2^-8 for bfloat16."""
    xm = (x.double() * keep.double()).abs()
    acc = x.shape[1] * 2.0 ** -23 * (xm @ w.double().abs())
    unit = 2.0 ** -8 if x.dtype.itemsize == 2 else 2.0 ** -24
    return acc * (1 + unit) + unit * exact.abs()


def topk_work_ops(keys, k: int, r: int) -> int:
    """Integer operations the top-k kernel does on these (B, N) int32 key
    bits: the warp form's per key and per round, the winner's lane
    rescanning its ceil(N/32) keys; the radix select's per key and
    histogram pass (the passes this data needs, counted by the select's
    plain model), per key compacted and per compare-exchange of its sort.
    The select's index-ordered sweep of ties at the threshold, which rows
    of distinct random keys never need, is not counted."""
    from repro_torch.kernels import radix_topk
    from repro_torch.kernels.ref import topk_keys_select_ref
    b, n = keys.shape
    if n <= radix_topk.WARP_MAX_N:
        return b * (n * TOPK_WARP_OPS_PER_KEY + k * (
            TOPK_WARP_OPS_PER_ROUND
            + TOPK_WARP_OPS_PER_RESCAN_KEY * -(-n // 32)))
    stats = {}
    topk_keys_select_ref(keys, k, r, stats)
    m = 1 << (k - 1).bit_length()
    lg = m.bit_length() - 1
    exchanges = m // 2 * lg * (lg + 1) // 2
    return (stats["passes"] * n * TOPK_SELECT_OPS_PER_KEY_PASS
            + b * (n * TOPK_SELECT_OPS_PER_KEY_COMPACT
                   + exchanges * TOPK_OPS_PER_COMPARE_EXCHANGE))


def ptxas_entries(log: str):
    """(kernel with its template argument, registers, spill stores, spill
    loads, stack bytes) for each entry function in an ``nvcc -Xptxas -v``
    log."""
    out = []
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
            r"(\d+) registers", log, flags=re.S):
        name = re.search(r"\d+([a-z_]+(?:\d+_)?kernel)"
                         r"(?:IL[a-z](\d+)E(?:L[a-z](\d+)E)?)?", m.group(1))
        label = name.group(1) if name else m.group(1)
        if name and name.group(2):
            label += "<" + ", ".join(a for a in name.group(2, 3) if a) + ">"
        out.append((label, int(m.group(5)), int(m.group(3)),
                    int(m.group(4)), int(m.group(2))))
    return out


def topk_edge_rows(rng, n: int, k: int):
    """Six (n,) uint32 rows for the top-k kernel's edge cells: random keys;
    all ties; ``% 7``; a tie set at the threshold that straddles the k-th
    slot (k // 2 keys below it, up to 2k + 1 at it, spread over the row
    across warp, thread and register boundaries); keys that differ only in
    their low 4 bits; zeros at the ragged end."""
    import numpy as np
    a = rng.integers(0, 2**32, (6, n), dtype=np.uint32)
    a[1] = 5
    a[2] %= 7
    a[3] = rng.integers(2**31, 2**32, n, dtype=np.uint32)
    pos = rng.permutation(n)
    a[3, pos[:k // 2]] = rng.integers(0, 1000, k // 2)
    a[3, pos[k // 2:k // 2 + 2 * k + 1]] = 1000
    a[4] = (rng.integers(0, 3, n) << 4 | rng.integers(0, 16, n)) + 0x7000
    a[5, n - 9:] = 0
    return a


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np
    from repro_torch import sort as tsort
    from repro_torch.core import bitplane as bp
    from repro_torch.core import radix_select as rs
    from repro_torch.core import ref_tns
    from repro_torch.kernels import (_build, backend, bitplane_pack,
                                     digit_read, fused_tns, masked_matmul,
                                     ops, radix_topk)
    from repro_torch.kernels.ref import (min_search_ref, pack_keys_ref,
                                         pruned_matmul_ref, topk_keys_ref,
                                         unpack_keys_f32_ref)
    from repro_torch.sort import sort

    # the plain versions' float32 products stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mods = {"fused_tns": fused_tns, "digit_read": digit_read,
            "bitplane_pack": bitplane_pack, "radix_topk": radix_topk,
            "masked_matmul": masked_matmul}
    err = {name: 0 for name in mods}

    def zero_counts():
        for mod in mods.values():
            mod.LAUNCHES = 0
            for form in getattr(mod, "FORM_LAUNCHES", ()):
                mod.FORM_LAUNCHES[form] = 0

    def counts():
        return {name: mod.LAUNCHES for name, mod in mods.items()}

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

    def mm_pair(x, w, keep, what):
        """Kernel, plain version and the float64 product on one input; both
        within ``mm_tolerance`` of the float64 product."""
        got = masked_matmul.pruned_matmul(x, w, keep)
        want = pruned_matmul_ref(x, w, keep)
        exact = (x.double() * keep.double()) @ w.double()
        tol = mm_tolerance(x, w, keep, exact)
        for name, y in (("kernel", got), ("plain version", want)):
            over = ((y.double() - exact).abs() - tol).max().item()
            expect(over <= 0, f"pruned_matmul {what}: {name} exceeds the "
                   f"tolerance by {over}")
        diff = (got.float() - want.float()).abs().max().item()
        err["masked_matmul"] = max(err["masked_matmul"], diff)
        return got

    def mm_form(x, w, keep, what, form):
        """``mm_pair`` through the named form of the matmul kernel."""
        expect(masked_matmul.form_for(x, w) == form,
               f"pruned_matmul {what}: not the {form} form")
        before = masked_matmul.FORM_LAUNCHES[form]
        got = mm_pair(x, w, keep, what)
        expect(masked_matmul.FORM_LAUNCHES[form] == before + 1,
               f"pruned_matmul {what}: the {form} form did not launch")
        return got

    def mm_nan_pair(x, w, keep, what):
        """Kernel and plain version where pruned lanes of x and pruned rows
        of w hold NaN and infinity: NaN in the same places as the plain
        version and the float64 product, the rest within tolerance of the
        product of the finite inputs."""
        got = masked_matmul.pruned_matmul(x, w, keep)
        want = pruned_matmul_ref(x, w, keep)
        exact = (x.double() * keep.double()) @ w.double()
        nan = torch.isnan(exact)
        expect(bool(nan.any()) and not bool(nan.all()),
               f"pruned_matmul {what}: the cell makes no NaN")
        for name, y in (("kernel", got), ("plain version", want)):
            expect(torch.equal(torch.isnan(y), nan), f"pruned_matmul "
                   f"{what}: {name}'s NaN positions differ from the float64 "
                   "product's")
        x0 = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        w0 = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
        exact0 = (x0.double() * keep.double()) @ w0.double()
        tol = mm_tolerance(x0, w0, keep, exact0)
        for name, y in (("kernel", got), ("plain version", want)):
            over = ((y.double() - exact0).abs() - tol)[~nan].max().item()
            expect(over <= 0, f"pruned_matmul {what}: {name} exceeds the "
                   f"tolerance by {over} off the NaN entries")
        return got

    def cuda_ms(fn, reps):
        """Device time of one call of ``fn``: CUDA events around ``reps``
        calls queued behind a sleep kernel, so that the host's cost of
        issuing a call (tens of microseconds through ctypes) does not pace
        the card; a call that issues more than the sleep covers is paced
        by the host all the same."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def rotating(t):
        """A function giving the next of enough copies of ``t`` to pass
        100 MB, twice the L2 cache: a timed call then reads its input from
        device memory, not from the L2 that the previous call left warm."""
        n = max(2, -(-100_000_000 // (t.numel() * t.element_size())))
        return itertools.cycle([t.clone() for _ in range(n)]).__next__

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
    _build.build(_build.kernel_names())
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in sorted(_build.build_logs.items()):
        print(f"ptxas {name}:", " | ".join(
            ln.strip() for ln in log.splitlines() if "Used" in ln
            or "spill" in ln), flush=True)
    # each instantiation of the redesigned kernels (the fused kernel's by
    # words of a column a thread, the top-k kernel's by form and keys a
    # lane)
    for name in ("fused_tns", "radix_topk", "masked_matmul", "digit_read"):
        print(f"{name} ptxas: " + "; ".join(
            f"{kernel}: {regs} registers, spills {st} B stored / {ld} B "
            f"loaded, stack {fr} B" for kernel, regs, st, ld, fr
            in ptxas_entries(_build.build_logs.get(name, ""))), flush=True)
    for name, log in sorted(_build.build_logs.items()):
        for ln in log.splitlines():
            if "Performance Loss" in ln or "warning" in ln.lower():
                print(f"{name} build note: {ln.strip()}", flush=True)

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
    # word edges: lane i is bit i & 31 of word i >> 5, and a thread holds
    # one word of each column up to N = 1024, more past it
    for fmt, width in FORMATS.items():
        for n in (31, 32, 33, 1023, 1025, 4096):
            x = gen(fmt, rng, (64, n))
            x[1] = x[1, 0]                     # an all-ties row
            x[2] = x[2] // 64 * 64             # heavy duplicates
            planes, sign = planes_of(x, width, fmt)
            for k in (1, 17):
                for stop in (6, None if n <= 1025 else 500):
                    fused_pair(planes, sign, f"{fmt} N={n} k={k} "
                               f"stop={stop}", k=k, fmt=fmt,
                               ascending=k == 1, stop_after=stop)
                    cells += 1
    # the widest key, then past 16384 lanes with W = 30, where the stored
    # sets leave shared memory to the columns and a walk rebuilds them
    for n, stops in ((1000, (6, None)), (20000, (64,))):
        x = rng.integers(0, 2**30, (64 if n < 2000 else 8, n))
        x[1] = x[1] % 5
        planes, sign = planes_of(x, 30, "unsigned")
        for k in (1, 2, 31):
            for stop in stops:
                fused_pair(planes, sign, f"unsigned W=30 N={n} k={k} "
                           f"stop={stop}", k=k, fmt="unsigned",
                           ascending=k != 2, stop_after=stop)
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
    # the digit read at its form edges: the warp form up to 2048 lanes
    # (a lane's 16-byte chunks: 1, 2 and 4 of them), the block form past
    # it; bytes 2 and 255 mean "not the excluded digit" to both, as to the
    # reference kernel
    t0 = time.perf_counter()
    cells = 0
    for n in (1, 31, 32, 33, 1024, 2048, 2049, 65536):
        for wd in (1, 16, 32):
            raw = rng.integers(0, 2, (4, wd, n)).astype(np.uint8)
            odd = rng.random(raw.shape)
            raw[odd < 0.03] = 2
            raw[odd > 0.97] = 255
            raw[1] = raw[1, :, :1]                # an all-ties row
            pl = torch.from_numpy(raw).to(dev)
            form = digit_read.form_for(wd, n)
            for asc in (True, False):
                before = digit_read.FORM_LAUNCHES[form]
                mask, drs = digit_read.min_search(pl, asc)
                expect(digit_read.FORM_LAUNCHES[form] == before + 1,
                       f"digit_read N={n} W={wd}: the {form} form did not "
                       "launch")
                rmask, rdrs = min_search_ref(pl, asc)
                same("digit_read", mask, rmask,
                     f"N={n} W={wd} asc={asc} mask")
                same("digit_read", drs, rdrs, f"N={n} W={wd} asc={asc} DRs")
                cells += 1
    print(f"digit_read == plain on {cells} edge cells (bytes 2 and 255; "
          f"forms {dict(digit_read.FORM_LAUNCHES)}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    special = torch.tensor([float("-inf"), -3.5, -0.0, 0.0, 1e-9, 7.25,
                            float("inf"), float("nan"), -float("nan")])
    vals = torch.cat([special, torch.from_numpy(
        rng.standard_normal(4099).astype(np.float32) * 1e3)]).to(dev)
    ints = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 4108,
                                         dtype=np.int32)).to(dev)
    for x in (vals, vals.to(torch.bfloat16), ints):
        for part, what in ((x, ""), (x[1:], " unaligned")):
            same("bitplane_pack", bitplane_pack.pack_keys(part),
                 pack_keys_ref(part), f"pack {x.dtype}{what}")
    fkeys = bitplane_pack.pack_keys(vals)
    back = bitplane_pack.unpack_keys_f32(fkeys)
    same("bitplane_pack", back.view(torch.int32),
         unpack_keys_f32_ref(fkeys).view(torch.int32), "unpack")
    same("bitplane_pack", back.view(torch.int32), vals.view(torch.int32),
         "unpack(pack(x)) bits")
    print("pack / unpack == plain (float32, bfloat16, int32; +-0, +-inf, "
          "NaN; aligned and not)", flush=True)

    cells = 0
    for n in (1, 60, 160, 1024):
        keys = bp.keys_from_numpy(rng.integers(0, 2**32, (64, n),
                                               dtype=np.uint32), device=dev)
        keys[1] = 5                            # an all-ties row
        keys[2] = keys[2] % 7                  # many ties
        for k in (1, 6, 32):
            if k > n:
                continue
            for r in (1, 3, 4, 8):
                got = radix_topk.topk_keys(keys, k, r)
                want = topk_keys_ref(keys, k, r)
                same("radix_topk", got[0], want[0], f"N={n} k={k} r={r} keys")
                same("radix_topk", got[1], want[1], f"N={n} k={k} r={r} idx")
                cells += 1
    # rows past the registers: keys staged in shared memory (16385, the
    # vocabulary's 50304), then read from global memory (70000)
    for n in (16385, OLMO_VOCAB, 70000):
        keys = bp.keys_from_numpy(rng.integers(0, 2**32, (4, n),
                                               dtype=np.uint32), device=dev)
        keys[1] = 5
        keys[2] = keys[2] % 7
        for k in (1, 6, 50):
            for r in (1, 3, 4, 8):
                got = radix_topk.topk_keys(keys, k, r)
                want = topk_keys_ref(keys, k, r)
                same("radix_topk", got[0], want[0], f"N={n} k={k} r={r} keys")
                same("radix_topk", got[1], want[1], f"N={n} k={k} r={r} idx")
                cells += 1
    # the form edges: the warp form's widest row and one past it (the radix
    # select), the widest row the select stages in shared memory and one
    # past it (read from global memory), the select's largest k and one
    # past it (the digit rounds, on two rows); every row set holds random
    # keys, all ties, % 7, a tie set at the threshold straddling the k-th
    # slot, keys differing only in their low 4 bits and a ragged run of
    # zeros, under the r whose low bits are never read
    limit = radix_topk.stage_limit()
    cap = radix_topk.SORT_CAP
    for n in (radix_topk.WARP_MAX_N, radix_topk.WARP_MAX_N + 1, limit,
              limit + 1):
        for k in (1, 32, cap, cap + 1):
            if k > n:
                continue
            rows = topk_edge_rows(rng, n, k)
            if k > cap:
                rows = rows[[1, 3]]
            keys = bp.keys_from_numpy(rows, device=dev)
            for r in (4, 5, 6, 7) if k <= 32 else (4,):
                got = radix_topk.topk_keys(keys, k, r)
                want = topk_keys_ref(keys, k, r)
                same("radix_topk", got[0], want[0],
                     f"edge N={n} k={k} r={r} keys")
                same("radix_topk", got[1], want[1],
                     f"edge N={n} k={k} r={r} idx")
                cells += 1
    for n in (160, 4099):
        keys = bp.keys_from_numpy(topk_edge_rows(rng, n, 6), device=dev)
        for r in (5, 6, 7):
            got = radix_topk.topk_keys(keys, 6, r)
            want = topk_keys_ref(keys, 6, r)
            same("radix_topk", got[0], want[0], f"N={n} k=6 r={r} keys")
            same("radix_topk", got[1], want[1], f"N={n} k=6 r={r} idx")
            cells += 1
    print(f"radix_topk == plain on {cells} cells, staging limit {limit} "
          f"lanes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    tgen = torch.Generator(device=dev).manual_seed(0)
    for dt, form in ((torch.float32, "ffma"), (torch.bfloat16, "wmma")):
        x = torch.randn(130, 257, generator=tgen, device=dev).to(dt)
        w = torch.randn(257, 120, generator=tgen, device=dev).to(dt)
        keep = torch.rand(257, generator=tgen, device=dev) > 0.3
        mm_form(x, w, keep, f"{dt} (130, 257, 120)", form)
        none = mm_form(x, w, torch.zeros_like(keep), f"{dt} all pruned",
                       form)
        expect(not none.abs().max().item(), "all-false mask: output != 0")
    # K = 0, which no tensor map can describe: the wmma form, zeros
    zk = mm_form(torch.ones(5, 0, dtype=torch.bfloat16, device=dev),
                 torch.ones(0, 16, dtype=torch.bfloat16, device=dev),
                 torch.ones(0, dtype=torch.bool, device=dev), "K=0", "wmma")
    expect(zk.shape == (5, 16) and not zk.abs().max().item(),
           "K=0: output != 0")
    # the wgmma form's edges: one row, a tile's 64-row half and one past
    # it, a ragged pair of tiles; N of one 16-byte chunk, ragged, one tile,
    # one past it; K of one chunk, one step, one step and a chunk, 32 steps
    # and a chunk; each with a random mask, all pruned and all kept
    cells = 0
    for m in (1, 64, 65, 130):
        for n in (8, 120, 256, 264):
            for kd in (8, 64, 72, 2056):
                x = torch.randn(m, kd, generator=tgen, device=dev).to(
                    torch.bfloat16)
                w = torch.randn(kd, n, generator=tgen, device=dev).to(
                    torch.bfloat16)
                keep = torch.rand(kd, generator=tgen, device=dev) > 0.3
                cell = f"bf16 ({m}, {kd}, {n})"
                mm_form(x, w, keep, cell, "wgmma")
                none = mm_form(x, w, torch.zeros_like(keep),
                               f"{cell} all pruned", "wgmma")
                expect(not none.abs().max().item(),
                       f"{cell} all pruned: output != 0")
                mm_form(x, w, torch.ones_like(keep), f"{cell} all kept",
                        "wgmma")
                cells += 3
    # NaN and infinity in pruned lanes of x (rows 3 and 70) and pruned rows
    # of w (columns 5 and 200): NaN in those rows and columns only
    x = torch.randn(130, 2056, generator=tgen, device=dev).to(torch.bfloat16)
    w = torch.randn(2056, 264, generator=tgen, device=dev).to(torch.bfloat16)
    keep = torch.rand(2056, generator=tgen, device=dev) > 0.3
    pruned = torch.nonzero(~keep).flatten()
    x[3, pruned[0]], x[70, pruned[5]] = float("nan"), float("inf")
    w[pruned[1], 5], w[pruned[7], 200] = float("-inf"), float("nan")
    expect(masked_matmul.form_for(x, w) == "wgmma", "NaN cell form")
    before = masked_matmul.FORM_LAUNCHES["wgmma"]
    mm_nan_pair(x, w, keep, "NaN / inf in pruned lanes")
    expect(masked_matmul.FORM_LAUNCHES["wgmma"] == before + 1,
           "NaN cell: the wgmma form did not launch")
    print(f"pruned_matmul within tolerance of the float64 product, as is "
          f"the plain version: float32 (ffma) and bfloat16 (wmma) ragged "
          f"and all pruned, K=0 (wmma), {cells} wgmma edge cells, NaN / inf "
          f"in pruned lanes (NaN where the plain version has it); forms "
          f"{dict(masked_matmul.FORM_LAUNCHES)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 4a. main path: sort() at full size
    x = np.random.default_rng(0).standard_normal((4096, 1024)).astype(
        np.float16)
    zero_counts()
    t0 = time.perf_counter()
    res = sort(x, engine="fused-tns", k=2)
    sort_s = time.perf_counter() - t0
    launches = counts()
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
    zero_counts()
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
    zero_counts()
    mask, dr_full = digit_read.min_search(planes)
    one_ep = fused_tns.fused_tns_planes(planes, None, k=2, fmt="unsigned",
                                        stop_after=1)
    dr_launches = counts()
    dr_forms = dict(digit_read.FORM_LAUNCHES)
    expect(dr_launches["digit_read"] > 0, "check path did not launch "
           "digit_read")
    expect(dr_forms["warp"] > 0, "check path did not run the digit read's "
           "warp form")
    expect(torch.equal(one_ep.useful_drs, dr_full),
           "full size: fused useful DRs != min_search's")
    rmask, rdrs = min_search_ref(planes)
    same("digit_read", mask, rmask, "full size mask")
    same("digit_read", dr_full, rdrs, "full size useful DRs")
    print(f"check path (4096, 16, 1024): launches {dr_launches}, digit read "
          f"forms {dr_forms}; "
          "min_search == plain == fused one-episode count", flush=True)

    # ---- 4d. the MoE router: topk() through the pack and top-k kernels
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16384, 160)).astype(np.float32)).to(dev)
    logits_q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16384, 60)).astype(np.float32)).to(dev).to(torch.bfloat16)
    zero_counts()
    routed = [(lg, kk) + tuple(tsort.topk(lg, kk, engine="fused-topk"))
              for lg, kk in ((logits, 6), (logits_q, 4))]
    torch.cuda.synchronize()
    topk_launches = counts()
    print(f"topk(fused-topk) router (16384, 160) f32 top-6 and (16384, 60) "
          f"bf16 top-4: launches {topk_launches}", flush=True)
    expect(topk_launches["bitplane_pack"] > 0, "topk() did not launch the "
           "pack kernel")
    expect(topk_launches["radix_topk"] > 0, "topk() did not launch "
           "radix_topk")
    for lg, kk, v, i in routed:
        _, want_i = topk_keys_ref(~pack_keys_ref(lg), kk)
        same("radix_topk", i, want_i, f"router {tuple(lg.shape)} indices")
        expect(torch.equal(v, torch.topk(lg, kk).values),
               f"router {tuple(lg.shape)}: values != torch.topk's")
        expect(torch.equal(v, torch.gather(lg, 1, i.long())),
               "router values != x[indices]")
        packed = bitplane_pack.pack_keys(lg)
        same("bitplane_pack", packed, pack_keys_ref(lg),
             f"router {tuple(lg.shape)} keys")
        same("bitplane_pack",
             bitplane_pack.unpack_keys_f32(packed).view(torch.int32),
             lg.float().view(torch.int32),
             f"router {tuple(lg.shape)} unpack(pack(x)) bits")
    print("router indices == plain version; values == torch.topk's; "
          "packed keys == plain version, unpack(pack(x)) == x bit for bit",
          flush=True)

    # ---- 4e/4f. 32-bit sorts: fused-topk top-32 and the radix engine
    xs = np.random.default_rng(4).standard_normal((4096, 1024)).astype(
        np.float32)
    order = np.argsort(bp.sort_key(xs, 32, "float"), axis=1, kind="stable")
    zero_counts()
    t0 = time.perf_counter()
    res_e = sort(xs, engine="fused-topk", stop_after=32)
    top32_s = time.perf_counter() - t0
    top32_launches = counts()
    expect(top32_launches["radix_topk"] > 0, "sort(fused-topk) did not "
           "launch radix_topk")
    expect(np.array_equal(res_e.indices, order[:, :32])
           and np.array_equal(res_e.values, np.take_along_axis(
               xs, order[:, :32], axis=1)), "fused-topk top-32 != stable "
           "argsort of the sort keys")
    print(f"sort(fused-topk, stop_after=32) (4096, 1024) f32: launches "
          f"{top32_launches}, {top32_s:.3f} s; == stable argsort",
          flush=True)
    zero_counts()
    t0 = time.perf_counter()
    res_f = sort(xs, engine="radix")
    radix_s = time.perf_counter() - t0
    expect(np.array_equal(res_f.indices, order),
           "radix sort != stable argsort of the sort keys")
    print(f"sort(radix) (4096, 1024) f32 full sort: launches {counts()} "
          f"(plain torch), {radix_s:.3f} s; == stable argsort", flush=True)

    # ---- 4g. in-situ pruned MLP product at olmo-1b's widths
    tgen = torch.Generator(device=dev).manual_seed(5)
    xg = torch.randn(4096, OLMO_D_MODEL, generator=tgen, device=dev).to(
        torch.bfloat16)
    wg = torch.randn(OLMO_D_MODEL, OLMO_D_FF, generator=tgen, device=dev).to(
        torch.bfloat16)
    n_prune = round(PRUNE_RATE * OLMO_D_MODEL)
    zero_counts()
    # each input lane scored by its largest |weight| (pruning/insitu.py)
    keep_g = ~tsort.prune_mask(wg.float().abs().amax(dim=-1)[None],
                               n_prune)[0]
    yg = ops.pruned_matmul(xg, wg, keep_g)
    torch.cuda.synchronize()
    mm_launches = counts()
    mm_forms = dict(masked_matmul.FORM_LAUNCHES)
    expect(mm_launches["masked_matmul"] > 0, "pruned_matmul did not launch "
           "its kernel")
    expect(mm_forms["wgmma"] > 0, "pruned_matmul did not run the wgmma "
           "form")
    expect(int(keep_g.sum()) == OLMO_D_MODEL - n_prune, "keep mask size")
    yk = mm_pair(xg, wg, keep_g, "olmo-1b MLP")
    expect(torch.equal(yg, yk), "pruned_matmul not deterministic")
    print(f"pruned_matmul (4096, 2048) @ (2048, 8192) bf16, {n_prune} lanes "
          f"pruned: launches {mm_launches}, forms {mm_forms}; kernel and "
          f"plain within "
          f"tolerance; max |kernel - plain| {err['masked_matmul']}",
          flush=True)

    # ---- 4h. top-k sampling mask over olmo-1b's vocabulary (plain torch)
    vocab = torch.randn(64, OLMO_VOCAB, generator=tgen, device=dev)
    zero_counts()
    vmask = tsort.topk_mask(vocab, 50)
    vkeys, _ = bp.sort_key_t(vocab)
    wide = vkeys.long() & 0xFFFFFFFF
    expect(bool((vmask.sum(dim=-1) == 50).all()), "topk_mask: not 50 a row")
    expect(bool((wide.masked_fill(~vmask, 1 << 32).amin(dim=-1)
                 >= wide.masked_fill(vmask, -1).amax(dim=-1)).all()),
           "topk_mask: a selected key below an unselected one")
    print(f"topk_mask (64, 50304) k=50: launches {counts()} (plain torch); "
          "50 a row, every selected key >= every unselected", flush=True)

    # ---- 4i. the default engine at full width: sort(x) through "tns"
    from repro_torch.core import catns, tns
    from repro_torch.runtime import faults
    zero_counts()
    t0 = time.perf_counter()
    res_i = sort(x, k=2)
    tns_s = time.perf_counter() - t0
    tns_launches = counts()
    expect(res_i.engine == "tns", f"sort(x) ran {res_i.engine}, not tns")
    for f in ("indices", "values", "cycles", "drs", "reload_cycles"):
        expect(np.array_equal(getattr(res_i, f), getattr(res, f)),
               f"sort(x) through tns: {f} != path a's fused-tns result")
    # the same call's steps one by one, on the host clock
    marks = [time.perf_counter()]
    digits_i, sign_i = tns._encode(x, 16, "float", 1)
    marks.append(time.perf_counter())
    d_in, s_in = tns._to_device(digits_i, sign_i, dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    out_i = tns.tns_sort_planes_batched(d_in, s_in, k=2, fmt="float")
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    expect(out_i.perm.device.type == "cuda", "the tns machine left the card")
    perm_i = out_i.perm.cpu().numpy()
    np.take_along_axis(x, perm_i, axis=-1)
    marks.append(time.perf_counter())
    expect(np.array_equal(perm_i, res.indices), "tns machine perm != a's")
    tns_steps = dict(zip(("encode on the host", "copy in", "machine",
                          "finish"),
                         ((b - a) * 1e3 for a, b in zip(marks, marks[1:]))))
    max_cyc = int(res_i.cycles.max())
    print(f"sort(x) default engine tns (4096, 1024) float16: launches "
          f"{tns_launches} (plain torch), {tns_s:.3f} s; perm, values, "
          f"cycles, DRs, reload cycles == path a's fused-tns bit for bit; "
          f"cycles a bank {int(res_i.cycles.min())}-{max_cyc}", flush=True)
    # the single instance (1-D input): registers on the host, a sync a cycle
    t0 = time.perf_counter()
    one_i = sort(x[0], k=2)
    single_s = time.perf_counter() - t0
    expect(np.array_equal(one_i.indices, res.indices[0])
           and int(one_i.cycles) == int(res.cycles[0])
           and int(one_i.drs) == int(res.drs[0])
           and int(one_i.reload_cycles) == int(res.reload_cycles[0]),
           "single instance row 0 != path a's row 0")
    print(f"single instance, row 0 (1024,): {single_s:.3f} s for "
          f"{int(one_i.cycles)} cycles == path a's row 0", flush=True)

    # ---- 4j. the other latency engines, each held to its own host run (16
    # banks: on the card the machines wait on the host to launch their
    # steps, whatever B; their host runs grow with B)
    xj = x[:16]
    xu = np.random.default_rng(7).integers(0, 2**16, (16, 1024)).astype(
        np.uint16)
    engine_s = {}
    for what, xe, kw in (("ml (level_bits 4)", xj, dict(engine="ml")),
                         ("tns ideal_lifo", xj,
                          dict(engine="tns", ideal_lifo=True)),
                         ("mb banks 4", xj, dict(engine="mb", banks=4)),
                         ("bts", xj[:2], dict(engine="bts")),
                         ("bitslice unsigned", xu, dict(engine="bitslice"))):
        zero_counts()
        t0 = time.perf_counter()
        got = sort(xe, k=2, **kw)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = sort(xe, k=2, device="cpu", **kw)
        host_s = time.perf_counter() - t0
        engine_s[what] = (card_s, host_s, tuple(xe.shape))
        for f in ("indices", "values", "cycles", "drs", "reload_cycles"):
            expect(np.array_equal(getattr(got, f), getattr(want, f)),
                   f"{what}: {f} on the card != the host run")
        keys_e = bp.sort_key(xe, 16, "float" if xe.dtype == np.float16
                             else "unsigned")
        expect(np.array_equal(got.indices, np.argsort(keys_e, axis=1,
                                                      kind="stable")),
               f"{what}: != stable argsort of the sort keys")
    print("latency engines == their host runs and the stable argsort: "
          + "; ".join(f"{w} {shape}: card {c:.3f} s, host {h:.3f} s"
                      for w, (c, h, shape) in engine_s.items()), flush=True)

    # ---- 4k. faults on the card: verify and repair
    spec = faults.FaultSpec(ber=1e-3, dead_banks=(1,), banks=4, seed=0)
    xk = x[:16]
    fault_s = {}
    fault_res = {}
    for engine, host_rows in (("resilient:tns", 16),
                              ("resilient:fused-tns", 2)):
        zero_counts()
        t0 = time.perf_counter()
        with faults.inject(spec):
            got = sort(xk, engine=engine, k=2)
        card_s = time.perf_counter() - t0
        fault_res[engine] = (got, counts())
        # the clean sort's values, bit for bit (a verified emission may
        # order equal values differently from the stable one)
        expect(np.array_equal(got.values.view(np.uint16),
                              res.values[:16].view(np.uint16))
               and not got.degraded and got.quality == 1.0,
               f"{engine}: not the clean sort")
        expect(got.faults_injected > 0 and got.repairs > 0,
               f"{engine}: no fault was injected and repaired")
        if host_rows < 16:
            # the fused kernel's plain version is slow on the host: the
            # whole batch is held to resilient:tns's repairs (the same
            # machine counts), the first rows to the host run
            for f in ("quality", "faults_injected", "repairs", "retries",
                      "degraded", "extra_cycles"):
                expect(getattr(got, f) == getattr(
                    fault_res["resilient:tns"][0], f),
                    f"{engine}: {f} != resilient:tns's")
            with faults.inject(spec):
                got = sort(xk[:host_rows], engine=engine, k=2)
        t0 = time.perf_counter()
        with faults.inject(spec):
            want = sort(xk[:host_rows], engine=engine, k=2, device="cpu")
        fault_s[engine] = (card_s, time.perf_counter() - t0, host_rows)
        for f in ("indices", "cycles", "quality", "faults_injected",
                  "repairs", "retries", "degraded", "extra_cycles"):
            expect(np.array_equal(getattr(got, f), getattr(want, f)),
                   f"{engine}: {f} on the card != the host run")
    fused_fault_launches = fault_res["resilient:fused-tns"][1]["fused_tns"]
    expect(fused_fault_launches > 0, "resilient:fused-tns did not launch "
           "fused_tns")
    # mb-ft over 4 banks with bank 1 dead: the 3 survivors split N = 1023
    # evenly, so the multi-bank machine runs on the card
    mb_calls = []
    real_mb = catns.multibank_sort

    def counted_mb(*a, **kw):
        mb_calls.append(kw["banks"])
        return real_mb(*a, **kw)

    catns.multibank_sort = counted_mb
    x1 = np.random.default_rng(8).standard_normal(1023).astype(np.float16)
    try:
        t0 = time.perf_counter()
        with faults.inject(spec):
            got = sort(x1, engine="mb-ft", banks=4, k=2)
        mbft_s = time.perf_counter() - t0
        with faults.inject(spec):
            want = sort(x1, engine="mb-ft", banks=4, k=2, device="cpu")
    finally:
        catns.multibank_sort = real_mb
    expect(mb_calls and set(mb_calls) == {3}, "mb-ft did not run the "
           "multi-bank machine over the 3 surviving banks")
    expect(got.banks == 3 and got.quality == 1.0 and not got.degraded
           and np.array_equal(got.values.view(np.uint16),
                              sort(x1, k=2).values.view(np.uint16)),
           "mb-ft: not the clean sort over 3 banks")
    for f in ("indices", "cycles", "quality", "faults_injected", "repairs",
              "retries", "degraded", "extra_cycles"):
        expect(np.array_equal(getattr(got, f), getattr(want, f)),
               f"mb-ft: {f} on the card != the host run")
    ft = fault_res["resilient:tns"][0]
    print(f"faults {spec}: resilient:tns and resilient:fused-tns (16, 1024) "
          f"== the clean sort, not degraded, faults injected "
          f"{ft.faults_injected}, repairs {ft.repairs}, retries "
          f"{ft.retries}, extra cycles {ft.extra_cycles}, == the host runs; "
          f"fused_tns launches {fused_fault_launches}; "
          + "; ".join(f"{e}: card {c:.3f} s (16 rows), host {h:.3f} s "
                      f"({r} rows)" for e, (c, h, r) in fault_s.items())
          + f"; mb-ft (1023,) over the multi-bank machine (banks "
          f"{sorted(set(mb_calls))}, {len(mb_calls)} runs), repairs "
          f"{got.repairs}, retries {got.retries}, extra cycles "
          f"{got.extra_cycles}, card {mbft_s:.3f} s", flush=True)

    # ---- 4l-4p. this slice's paths: serving, Dijkstra, in-situ pruning,
    # the autotune table; each driven with the counts set to 0 just before
    from repro_torch import serving, tree
    from repro_torch.graph import dijkstra
    from repro_torch.kernels import autotune
    from repro_torch.pruning import insitu
    from repro_torch.serving import dispatch
    new_t0 = time.perf_counter()
    slice_launches = {name: 0 for name in mods}
    phase_s = {}

    def serve_arm(what, trace, *, kind="continuous", chunk=8, device=None,
                  spec=None):
        """One serving arm on ``device``: the report, the launches and the
        seconds, every request completed with the stable order."""
        zero_counts()
        t0 = time.perf_counter()
        if kind == "oneshot":
            rep = serving.oneshot_loop(trace, device=device)
        else:
            orch = serving.Orchestrator(
                clock=serving.SimulatedClock(), device=device,
                cfg=serving.OrchestratorConfig(max_batch=8, chunk=chunk))
            if spec is None:
                rep = orch.run(trace)
            else:
                with faults.inject(spec):
                    rep = orch.run(trace)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = counts()
        where = "card" if device is None else "host"
        expect(rep["completed"] == rep["accepted"] == len(trace)
               and rep["failed"] == 0 and rep["expired"] == 0,
               f"{what} on the {where}: {rep['completed']} of {len(trace)} "
               f"completed, {rep['failed']} failed, {rep['expired']} "
               "expired")
        for r in trace:
            expect(r.status is serving.Status.DONE and r.ascending,
                   f"{what}: request {r.rid} {r.status}")
            order = np.argsort(r.x, kind="stable")[:r.target]
            expect(np.array_equal(r.indices, order), f"{what} on the "
                   f"{where}: request {r.rid} ({r.engine}) != numpy's stable "
                   "argsort prefix")
        if spec is not None:
            expect(all(e.startswith("resilient:") or e == "mb-ft"
                       for e in rep["engines"]), f"{what}: an unverified "
                   f"engine served the faulted array: {rep['engines']}")
        if device is None:
            for name, n in got.items():
                slice_launches[name] += n
            engines = rep["engines"]
            expect(("fused-tns" not in engines or got["fused_tns"] > 0)
                   and ("fused-topk" not in engines
                        or min(got["radix_topk"], got["bitplane_pack"]) > 0),
                   f"{what}: a fused engine ran without its kernels: "
                   f"{engines}, launches {got}")
        else:
            expect(not any(got.values()), f"{what}: the host run launched "
                   f"kernels {got}")
        return rep, got, secs

    def serve_point(what, make, arms):
        """Card and host runs of each arm of one serving point, printed
        side by side; returns the card runs' kernel launches summed."""
        total = {name: 0 for name in mods}
        for kind, kw in arms:
            card, launched, card_s = serve_arm(f"{what} {kind}", make(kind),
                                               kind=kind, **kw)
            host, _, host_s = serve_arm(f"{what} {kind}", make(kind),
                                        kind=kind, device="cpu", **kw)
            for name, n in launched.items():
                total[name] += n
            sim = ("sim_us", "throughput_elems_per_us", "p50_latency_us",
                   "p99_latency_us", "ticks", "mean_batch_occupancy")
            print(f"{what} {kind}: card {card_s:.3f} s, launches {launched}; "
                  "sim-time summary card / host: " + ", ".join(
                      f"{k} {card[k]} / {host[k]}" for k in sim)
                  + f"; engines card {card['engines']} / host "
                  f"{host['engines']}; every request done, == numpy's "
                  f"stable argsort prefix; host {host_s:.3f} s", flush=True)
        return total

    # 4l: the reference's own serving bench configuration
    # (benchmarks/bench_serve.py: 40 requests, n 48, chunk 8, gap 0.05 us),
    # then its faulted point
    t0 = time.perf_counter()
    bench = dict(n=48, mean_gap_us=0.05)
    fault_spec = faults.FaultSpec(ber=0.01, seed=0)

    def bench_trace(kind):
        if kind == "faulted":
            return serving.make_trace(
                6, seed=1, classes=("bulk-latency", "float-latency"),
                quality_floor=0.99, **bench)
        return serving.make_trace(40, seed=0, **bench)

    serve_l = serve_point("4l serving (40, n 48)", bench_trace, (
        ("continuous", dict(chunk=8)), ("oneshot", {})))
    faulted = serve_point("4l serving (40, n 48)", bench_trace, (
        ("faulted", dict(chunk=8, spec=fault_spec)),))
    for name, n in faulted.items():
        serve_l[name] += n
    expect(serve_l["radix_topk"] > 0 and serve_l["bitplane_pack"] > 0,
           f"4l: the serving runs launched no fused-topk kernels {serve_l}")
    print(f"4l serving launches in all: {serve_l}", flush=True)
    phase_s["4l"] = time.perf_counter() - t0

    # 4m: the paper's Table-S5 array width, all five request classes
    t0 = time.perf_counter()

    def wide_trace(kind):
        trace = serving.make_trace(16, seed=0, n=1024, mean_gap_us=0.05)
        return trace[:8] if kind == "oneshot" else trace

    serve_m = serve_point("4m serving (16, n 1024)", wide_trace, (
        ("continuous", dict(chunk=1024)), ("oneshot", {})))
    # at n 1024 the first wall-class pick goes to fused-topk only where the
    # committed autotune table gives fused-tns a prior above the generic
    # throughput prior (a card with no row in it ties the two, and the tie
    # goes to fused-tns, as the reference's goes to pallas-tns); the
    # serving path as a whole must launch the top-k and key-pack kernels
    print(f"4m serving launches in all: {serve_m}; the fused TNS wall prior "
          f"from the committed table: {dispatch._fused_tns_wall_prior()}",
          flush=True)
    expect(min(serve_l["radix_topk"] + serve_m["radix_topk"],
               serve_l["bitplane_pack"] + serve_m["bitplane_pack"]) > 0,
           "4l-4m: the serving runs launched no fused-topk kernels")
    phase_s["4m"] = time.perf_counter() - t0

    # 4n: Dijkstra on the tns machine with the Fig. 5e statistics
    t0 = time.perf_counter()
    zero_counts()
    for src, dst in ((0, 13), (3, 15), (5, 12), (15, 0)):
        got = dijkstra.shortest_path(src, dst, k=2, engine="tns")
        want = dijkstra.shortest_path(src, dst, k=2, engine="tns",
                                      device="cpu")
        expect(got.path == dijkstra.reference_shortest_path(src, dst)[1],
               f"4n: path {src} -> {dst} {got.path}")
        for f in ("path", "total_drs", "total_cycles", "fig5e_drs",
                  "fig5e_numbers", "numbers_sorted"):
            expect(getattr(got, f) == getattr(want, f),
                   f"4n {src} -> {dst}: {f} != the host run's")
        expect(2.0 <= got.fig5e_drs_per_number <= 4.0,
               f"4n: Fig. 5e DRs a number {got.fig5e_drs_per_number}")
        print(f"4n dijkstra {src} -> {dst}: path {got.path} == the "
              f"reference path and the host run; DRs {got.total_drs}, "
              f"cycles {got.total_cycles}, Fig. 5e {got.fig5e_drs} DRs over "
              f"{got.fig5e_numbers} numbers = "
              f"{got.fig5e_drs_per_number:.4f} a number; launches {counts()}",
              flush=True)
    phase_s["4n"] = time.perf_counter() - t0

    # 4o: in-situ pruning, cycle-faithful and over olmo-1b's MLP stack
    t0 = time.perf_counter()
    zero_counts()
    wts = np.random.default_rng(9).standard_normal(1024)
    for ber in (0.0, 0.01):
        got = insitu.tns_prune(wts, PRUNE_RATE, ber=ber, seed=3)
        want = insitu.tns_prune(wts, PRUNE_RATE, ber=ber, seed=3,
                                device="cpu")
        expect(np.array_equal(got[0], want[0]) and got[1:] == want[1:],
               f"4o tns_prune BER {ber}: != the host run")
        expect(len(got[0]) == round(PRUNE_RATE * 1024), "4o: prune count")
        print(f"4o tns_prune (1024,) rate {PRUNE_RATE} BER {ber}: "
              f"{len(got[0])} located, cycles {got[1]}, DRs {got[2]} == the "
              "host run", flush=True)
    wi = torch.randn(OLMO_LAYERS, OLMO_D_MODEL, 2 * OLMO_D_FF, generator=tgen,
                     device=dev).to(torch.bfloat16)
    stack = {"segments": [{"mlp": {"wi": wi}}]}
    mkey = "['segments'][0]['mlp']['wi']"
    prune_t0 = time.perf_counter()
    new_p, pstats = insitu.prune_params(stack, None, PRUNE_RATE)
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - prune_t0
    prune_launches = counts()
    keep_o = pstats["masks"][mkey]
    host_stack = tree.map_with_path(lambda _, t: t.cpu(), stack)
    host_t0 = time.perf_counter()
    host_p, host_stats = insitu.prune_params(host_stack, None, PRUNE_RATE)
    host_prune_s = time.perf_counter() - host_t0
    expect(torch.equal(keep_o.cpu(), host_stats["masks"][mkey]),
           "4o prune_params: masks != the host run")
    expect(pstats["weight_sparsity"] == host_stats["weight_sparsity"]
           and abs(pstats["weight_sparsity"] - PRUNE_RATE) <= 0.05,
           f"4o prune_params: sparsity {pstats['weight_sparsity']}")
    wo = new_p["segments"][0]["mlp"]["wi"]
    expect(not bool(wo[~keep_o].any()), "4o: a dropped lane is not zero")
    expect(torch.equal(wo[keep_o], wi[keep_o]), "4o: a kept lane changed")
    expect(torch.equal(wo.cpu(), host_p["segments"][0]["mlp"]["wi"]),
           "4o: pruned weights != the host run")
    print(f"4o prune_params {mkey} bf16 {tuple(wi.shape)} "
          f"({wi.numel() * 2 / 2**30:.2f} GiB) rate {PRUNE_RATE}: card "
          f"{prune_s:.3f} s, host {host_prune_s:.3f} s; masks == the host "
          f"run bit for bit, weight sparsity {pstats['weight_sparsity']}, "
          f"dropped lanes zero; launches {prune_launches}", flush=True)
    del wi, stack, new_p, wo, host_stack, host_p
    phase_s["4o"] = time.perf_counter() - t0

    # 4p: the autotune table at BENCH_pallas_tns.json's six cells, written
    # to build/ and read back
    t0 = time.perf_counter()
    zero_counts()
    cells = [dict(fmt="unsigned", width=16, n=n_, m=m_, b=b_)
             for n_, m_, b_ in ((1024, 1, 64), (1024, 2, 64), (256, 1, 64),
                                (256, 8, 64), (256, 32, 64), (4096, 1, 16))]
    table = autotune.sweep(cells, reps=3)
    tune_launches = counts()
    expect(tune_launches["fused_tns"] == 4 * len(cells),
           f"4p: fused_tns launches {tune_launches}")
    table_path = ROOT / "build" / autotune.BENCH_ARTIFACT
    table_path.parent.mkdir(exist_ok=True)
    autotune.save_table(table, table_path)
    expect(autotune.load_table(table_path) == table, "4p: table round trip")
    for cell in cells:
        key = autotune.cell_key(cell["fmt"], cell["n"], cell["m"], cell["b"])
        expect(autotune.nearest_cell(cell["fmt"], cell["n"], cell["m"],
                                     cell["b"], table=table) == key
               and autotune.best_params(cell["fmt"], cell["n"], cell["m"],
                                        cell["b"], table=table)
               == autotune.DEFAULT_PARAMS, f"4p: {key} not read back")
    per_emission = sorted(row["us"] / (int(k.split("|")[2][1:])
                                       * int(k.split("|")[3][1:]))
                          for k, row in table.items())
    real_default = autotune.default_table
    autotune.default_table = lambda: table
    try:
        prior = dispatch._fused_tns_wall_prior()
        d_prior = dispatch.Dispatcher()._fused_tns_prior
    finally:
        autotune.default_table = real_default
    expect(prior == d_prior == per_emission[len(per_emission) // 2],
           f"4p: the dispatcher's prior {prior} != the table's median")
    committed = dispatch._fused_tns_wall_prior()
    for name, n in tune_launches.items():
        slice_launches[name] += n
    print(f"4p autotune table (written to {table_path.relative_to(ROOT)}, "
          f"read back by best_params and the dispatcher's prior, "
          f"{prior:.4f} us an emission; the committed table's prior "
          f"{committed}); launches {tune_launches}", flush=True)
    print("autotune " + json.dumps(json.loads(table_path.read_text()),
                                   sort_keys=True), flush=True)
    phase_s["4p"] = time.perf_counter() - t0
    print("phases 4l-4p: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in phase_s.items())
          + f"; {time.perf_counter() - new_t0:.1f} s together; launches on "
          f"the card in all {slice_launches}", flush=True)

    # ---- 5. times
    B, W, N = planes.shape
    fused_ms = cuda_ms(lambda: fused_tns.fused_tns_rank(
        planes, sign, k=2, fmt="float"), 5)
    topm_ms = cuda_ms(lambda: fused_tns.fused_tns_rank(
        planes_b, sign_b, k=2, fmt="float", stop_after=64), 5)
    # four banks (one block) an SM: the time of the episode chain itself
    few = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    fused_few_ms = cuda_ms(lambda: fused_tns.fused_tns_rank(
        planes[:few], sign[:few], k=2, fmt="float"), 5)
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

    sm_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    int32_ops_per_s = (INT32_OPS_PER_CLOCK_PER_SM * sm_hz
                       * torch.cuda.get_device_properties(0)
                       .multi_processor_count)

    def word_ops(counters, n):
        """The fused episodes' operations counted on 32-lane words, from a
        run's counters: DRs (columns read) and episodes, summed over banks."""
        words = -(-n // 32)
        return words * (FUSED_OPS_PER_WORD_COLUMN * int(counters[:, 1].sum())
                        + FUSED_OPS_PER_WORD_EPISODE
                        * int(counters[:, 5].sum()))

    def ops_bounds(lane_ops, word_ops_):
        """The fused kernel's operation bounds: both counts, both rates."""
        return ", ".join(
            f"{what} {ops} ops: {ops / ALU_OPS_PER_S * 1e3:.4f} ms at 67 T/s, "
            f"{ops / int32_ops_per_s * 1e3:.4f} ms at the int32 rate "
            f"({int32_ops_per_s / 1e12:.2f} T/s, {sm_hz / 1e6:.0f} MHz)"
            for what, ops in (("per alive lane", lane_ops),
                              ("per word", word_ops_)))

    fused_bytes = planes.numel() + sign.numel() + 4 * B * N + 4 * B * 8
    fused_ops = lane_eps * FUSED_OPS_PER_LANE_EPISODE
    fused_word_ops = word_ops(cnt, N)
    dr_bytes = planes.numel() + B * N + 4 * B
    dr_ops = B * W * N * DR_OPS_PER_LANE_COLUMN

    def bound(nbytes, ops):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / ALU_OPS_PER_S * 1e3
        return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                       else "operations"), by_bytes, by_ops

    fb = bound(fused_bytes, fused_ops)
    fwb = bound(fused_bytes, fused_word_ops)   # the kernel's line: the least
    db = bound(dr_bytes, dr_ops)
    topm_ops = int(cnt_b[:, 6].sum()) * FUSED_OPS_PER_LANE_EPISODE
    topm_bytes = (planes_b.numel() + sign_b.numel() + 4 * 512 * 16384
                  + 4 * 512 * 8)
    tb = bound(topm_bytes, topm_ops)
    twb = bound(topm_bytes, word_ops(cnt_b, planes_b.shape[2]))
    keys_b = torch.from_numpy(keysb.astype(np.int32)).to(dev)
    topm_lib_ms = cuda_ms(lambda: torch.topk(keys_b, 64, largest=False), 20)
    print(f"[{card}] fused_tns (4096, 1024) full sort k=2: {fused_ms:.4f} ms;"
          f" bytes bound {fb[2]:.4f} ms ({fused_bytes} B); "
          + ops_bounds(fused_ops, fused_word_ops)
          + f" -> the least, {fwb[0]:.4f} ms, bound by {fwb[1]}; plain "
          f"{plain_s * 1e3:.1f} ms; torch.sort {lib_ms:.4f} ms; the first "
          f"{few} banks alone (4 an SM) {fused_few_ms:.4f} ms", flush=True)
    print(f"[{card}] sort(engine='fused-tns') whole call: {sort_ms:.1f} ms; "
          "steps: " + ", ".join(f"{k} {v:.1f} ms" for k, v in steps.items()),
          flush=True)
    print(f"[{card}] sort(x) default engine tns (4096, 1024) whole call: "
          f"{tns_s * 1e3:.1f} ms; steps: " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in tns_steps.items())
          + f"; the machine {tns_steps['machine'] / fused_ms:.0f}x the fused "
          f"kernel's {fused_ms:.4f} ms, {tns_steps['machine'] / max_cyc:.4f} "
          f"ms a cycle over {max_cyc} cycles; single instance (1024,) "
          f"{single_s * 1e3:.1f} ms, {single_s * 1e3 / int(one_i.cycles):.4f}"
          f" ms a cycle", flush=True)
    print(f"[{card}] fused_tns (512, 16384) stop_after=64: {topm_ms:.4f} ms;"
          f" bytes bound {tb[2]:.4f} ms; "
          + ops_bounds(topm_ops, word_ops(cnt_b, planes_b.shape[2]))
          + f" -> the least, {twb[0]:.4f} ms, bound by {twb[1]}; "
          f"torch.topk(64, largest=False) on the keys {topm_lib_ms:.4f} ms",
          flush=True)
    print(f"[{card}] min_search (4096, 16, 1024), warp form: {dr_ms:.4f} ms "
          f"(before its redesign {DIGIT_READ_MS_BEFORE} ms, PERF.md); bound "
          f"{db[0]:.4f} ms by {db[1]} ({db[0] / dr_ms:.3f} of it reached); "
          f"plain {dr_plain_ms:.3f} ms", flush=True)

    # key pack at the router's shape (inputs cold in L2), and on 256 MiB
    # for its bandwidth
    nxt = rotating(logits)
    pack_ms = cuda_ms(lambda: bitplane_pack.pack_keys(nxt()), 50)
    pack_plain_ms = cuda_ms(lambda: pack_keys_ref(nxt()), 20)
    pb = bound(8 * logits.numel(), 0)
    nxt_q = rotating(logits_q)
    pack_q_ms = cuda_ms(lambda: bitplane_pack.pack_keys(nxt_q()), 50)
    del nxt, nxt_q
    big = torch.randn(64 << 20, generator=tgen, device=dev)
    same("bitplane_pack", bitplane_pack.pack_keys(big), pack_keys_ref(big),
         "256 MiB keys")
    big_ms = cuda_ms(lambda: bitplane_pack.pack_keys(big), 20)
    big_rate = 8 * big.numel() / (big_ms * 1e-3)
    del big
    print(f"[{card}] pack_keys (16384, 160) f32: {pack_ms:.4f} ms; bound "
          f"{pb[0]:.4f} ms by {pb[1]}; plain {pack_plain_ms:.4f} ms; "
          f"(16384, 60) bf16: {pack_q_ms:.4f} ms; 256 MiB f32: "
          f"{big_ms:.4f} ms = {big_rate / 1e12:.3f} TB/s, "
          f"{big_rate / HBM_BYTES_PER_S:.3f} of 3.35 TB/s", flush=True)

    # radix top-k at the main path's three shapes, inputs cold in L2: the
    # router's (16384, 160) k=6 and path e's (4096, 1024) k=32 (the warp
    # form), olmo-1b's vocabulary (64, 50304) k=50 (the radix select, keys
    # staged in shared memory); beside each, torch.topk on the keys widened
    # to int64 and on int32 keys with the sign bit flipped (the same order),
    # and the bound: bytes (keys read once, 8 B a selected key written) and
    # the kernel's integer operations on these keys
    inv = ~bitplane_pack.pack_keys(logits)
    skeys = bp.keys_from_numpy(bp.sort_key(xs, 32, "float"), device=dev)
    vinv = ~bitplane_pack.pack_keys(vocab)
    same("radix_topk", radix_topk.topk_keys(vinv, 50)[1],
         topk_keys_ref(vinv, 50)[1], "vocabulary top-50 idx")
    topk_times = {}
    for what, keys_, kk in (("router", inv, 6), ("top-32", skeys, 32),
                            ("vocabulary", vinv, 50)):
        nxt = rotating(keys_)
        ms = cuda_ms(lambda: radix_topk.topk_keys(nxt(), kk), 20)
        plain_ms = (cuda_ms(lambda: topk_keys_ref(nxt(), kk), 3)
                    if what == "router" else None)
        del nxt
        nxt = rotating(keys_.long() & 0xFFFFFFFF)
        lib64_ms = cuda_ms(lambda: torch.topk(nxt(), kk, largest=False), 20)
        del nxt
        nxt = rotating(keys_ ^ -(1 << 31))
        lib32_ms = cuda_ms(lambda: torch.topk(nxt(), kk, largest=False), 20)
        del nxt
        ops = topk_work_ops(keys_, kk, 4)
        b_ = bound(4 * keys_.numel() + 8 * keys_.shape[0] * kk, ops)
        topk_times[what] = (ms, plain_ms, lib64_ms, lib32_ms, b_)
        print(f"[{card}] topk_keys {tuple(keys_.shape)} k={kk} r=4: "
              f"{ms:.4f} ms; bytes {b_[2]:.4f} ms "
              f"({4 * keys_.numel() + 8 * keys_.shape[0] * kk} B), ops "
              f"{b_[3]:.4f} ms ({ops} integer ops) -> bound {b_[0]:.4f} ms "
              f"by {b_[1]}"
              + (f"; plain {plain_ms:.3f} ms" if plain_ms is not None else "")
              + f"; torch.topk(largest=False) on the widened keys "
              f"{lib64_ms:.4f} ms, on sign-flipped int32 keys "
              f"{lib32_ms:.4f} ms", flush=True)
    topk_ms, topk_plain_ms, topk_lib_ms, _, kb = topk_times["router"]
    top32_ms = topk_times["top-32"][0]
    # the warp form's cost a round: path e's keys at k = 1, 32 and 64
    by_k = {}
    nxt, nxt_signed = rotating(skeys), rotating(skeys ^ -(1 << 31))
    for kk in (1, 32, 64):
        by_k[kk] = (cuda_ms(lambda: radix_topk.topk_keys(nxt(), kk), 20),
                    cuda_ms(lambda: torch.topk(nxt_signed(), kk,
                                               largest=False), 20))
    del nxt, nxt_signed
    print(f"[{card}] topk_keys (4096, 1024) r=4 by k: " + ", ".join(
        f"k={kk} {ms:.4f} ms (torch.topk on int32 keys {lib:.4f} ms)"
        for kk, (ms, lib) in by_k.items())
        + f"; {(by_k[64][0] - by_k[1][0]) / 63 * 1e3:.3f} us a round",
        flush=True)

    # the whole topk() call: host clock, its steps' device times, and the
    # device's busy share from the profiler
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tsort.topk(logits, 6, engine="fused-topk")
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / reps * 1e3
    _, ix = radix_topk.topk_keys(inv, 6)
    steps = {"pack": cuda_ms(lambda: bitplane_pack.pack_keys(logits), 20),
             "invert": cuda_ms(lambda: ~inv, 20),
             "top-k": cuda_ms(lambda: radix_topk.topk_keys(inv, 6), 20),
             "gather": cuda_ms(lambda: torch.gather(logits, -1, ix.long()),
                               20)}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            tsort.topk(logits, 6, engine="fused-topk")
        torch.cuda.synchronize()
    kernels_us = sorted(
        ((e.self_device_time_total / reps, e.key[:48])
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(t for t, _ in kernels_us) / 1e3
    print(f"[{card}] topk(fused-topk) (16384, 160) whole call (host clock, "
          f"synchronised, mean of {reps}): {call_ms:.4f} ms; device time "
          "of its steps alone: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in steps.items())
          + f" (sum {sum(steps.values()):.4f} ms); profiler: device busy "
          f"{busy_ms:.4f} ms a call, idle share "
          f"{1 - busy_ms / call_ms:.3f}; kernels (us a call): "
          + "; ".join(f"{n} {t:.1f}" for t, n in kernels_us), flush=True)

    # 32-bit sort paths, host clock around the whole call
    sort_times = {}
    for name, kw in (("fused-topk stop_after=32",
                      dict(engine="fused-topk", stop_after=32)),
                     ("radix", dict(engine="radix"))):
        t0 = time.perf_counter()
        for _ in range(3):
            sort(xs, **kw)
        sort_times[name] = (time.perf_counter() - t0) / 3 * 1e3
    radix_dev_ms = cuda_ms(lambda: rs.radix_sort_keys(skeys, r=8), 3)
    print(f"[{card}] sort() (4096, 1024) f32 whole call: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in sort_times.items())
        + f"; of which radix_sort_keys on the device keys {radix_dev_ms:.2f}"
        f" ms, the top-32 kernel {top32_ms:.4f} ms", flush=True)

    # the pruned MLP product, inputs cold in L2, and with every lane kept
    # (the mask's cost: a step with no pruned lane skips it)
    nx, nw = rotating(xg), rotating(wg)
    mm_ms = cuda_ms(lambda: masked_matmul.pruned_matmul(nx(), nw(), keep_g),
                    10)
    all_kept = torch.ones_like(keep_g)
    mm_kept_ms = cuda_ms(lambda: masked_matmul.pruned_matmul(
        nx(), nw(), all_kept), 10)
    mm_plain_ms = cuda_ms(lambda: pruned_matmul_ref(nx(), nw(), keep_g), 5)
    mm_lib_ms = cuda_ms(lambda: torch.matmul(nx() * keep_g, nw()), 10)
    del nx, nw

    def host_us(fn, reps=200):
        """Host time of one call (queued, not waited for), in us."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return host

    # the host's cost of a call of each bfloat16 form at a small shape
    # (the wgmma form encodes two TMA descriptors a call)
    hx = torch.randn(64, 64, generator=tgen, device=dev).to(torch.bfloat16)
    hw = torch.randn(64, 64, generator=tgen, device=dev).to(torch.bfloat16)
    hk = torch.ones(64, dtype=torch.bool, device=dev)
    hx60, hw60 = hx[:, :60].contiguous(), hw[:60].contiguous()
    host_wgmma = host_us(lambda: masked_matmul.pruned_matmul(hx, hw, hk))
    host_wmma = host_us(lambda: masked_matmul.pruned_matmul(hx60, hw60,
                                                            hk[:60]))
    m_, k_, n_ = xg.shape[0], xg.shape[1], wg.shape[1]
    kept = int(keep_g.sum())
    mm_bytes = 2 * (m_ * k_ + k_ * n_ + m_ * n_) + k_
    mm_by_bytes = mm_bytes / HBM_BYTES_PER_S * 1e3
    mm_by_ops = 2 * m_ * kept * n_ / BF16_FLOPS_PER_S * 1e3
    mb = (max(mm_by_bytes, mm_by_ops),
          "bytes" if mm_by_bytes >= mm_by_ops else "operations")
    print(f"[{card}] pruned_matmul (4096, 2048) @ (2048, 8192) bf16, "
          f"{kept} lanes kept, wgmma form, inputs cold in L2: {mm_ms:.4f} ms "
          f"(before its redesign {MATMUL_MS_BEFORE} ms, PERF.md; "
          f"{2 * m_ * kept * n_ / (mm_ms * 1e-3) / 1e12:.1f} T useful op/s, "
          f"{2 * m_ * k_ * n_ / (mm_ms * 1e-3) / 1e12:.1f} T op/s over the "
          f"full K); every lane kept {mm_kept_ms:.4f} ms; bytes "
          f"{mm_by_bytes:.4f} ms, ops {mm_by_ops:.4f} ms -> bound "
          f"{mb[0]:.4f} ms by {mb[1]} ({mb[0] / mm_ms:.3f} of it reached); "
          f"plain {mm_plain_ms:.4f} ms; torch.matmul(x * keep, w) "
          f"{mm_lib_ms:.4f} ms ({mm_ms / mm_lib_ms:.2f}x of it)", flush=True)
    print(f"[{card}] pruned_matmul host time a call at (64, 64) @ (64, 64): "
          f"wgmma form {host_wgmma:.1f} us, wmma form at K=60 "
          f"{host_wmma:.1f} us", flush=True)

    # ---- 6. kernel line, then the device line
    kernels = [
        {"name": "fused_tns", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_tns.cu",
         "replaces": "src/repro/kernels/fused_tns.py:155",
         "launches": (launches["fused_tns"] + fused_fault_launches
                      + slice_launches["fused_tns"]),
         "max_abs_err": float(err["fused_tns"]), "ms": fused_ms,
         "plain_ms": plain_s * 1e3, "bound_ms": fwb[0], "bound_by": fwb[1],
         "library_ms": lib_ms},
        {"name": "digit_read", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/digit_read.cu",
         "replaces": "src/repro/kernels/digit_read.py:43",
         "launches": dr_launches["digit_read"],
         "max_abs_err": float(err["digit_read"]), "ms": dr_ms,
         "plain_ms": dr_plain_ms, "bound_ms": db[0], "bound_by": db[1],
         "library_ms": None},
        {"name": "bitplane_pack", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitplane_pack.cu",
         "replaces": "src/repro/kernels/bitplane_pack.py:19",
         "launches": (topk_launches["bitplane_pack"]
                      + slice_launches["bitplane_pack"]),
         "max_abs_err": float(err["bitplane_pack"]), "ms": pack_ms,
         "plain_ms": pack_plain_ms, "bound_ms": pb[0], "bound_by": pb[1],
         "library_ms": None},
        {"name": "radix_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/radix_topk.cu",
         "replaces": "src/repro/kernels/radix_topk.py:37",
         "launches": (topk_launches["radix_topk"]
                      + slice_launches["radix_topk"]),
         "max_abs_err": float(err["radix_topk"]), "ms": topk_ms,
         "plain_ms": topk_plain_ms, "bound_ms": kb[0], "bound_by": kb[1],
         "library_ms": topk_lib_ms},
        {"name": "masked_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul.py:25",
         "launches": mm_launches["masked_matmul"],
         "max_abs_err": float(err["masked_matmul"]), "ms": mm_ms,
         "plain_ms": mm_plain_ms, "bound_ms": mb[0], "bound_by": mb[1],
         "library_ms": mm_lib_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
