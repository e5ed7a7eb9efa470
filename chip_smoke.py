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
   q. the model zoo's serving path: ``launch.serve.main(["--oneshot",
      "--arch", "qwen2_moe_a2_7b", "--full-size", "--router-impl",
      "pallas", ...])`` in-process at qwen2-moe-a2.7b's published widths
      and full depth (24 layers, bfloat16, 26.67 GiB of weights, printed
      before allocating), batch 4, prompt 16, 32 new tokens, top-32
      sampling, 30 % in-situ pruning: every logit finite, every sampled
      token inside its step's top-32, the key-pack and top-k kernels
      launched 24 times a forward; router parity: a prefill and 8
      teacher-forced decode steps under ``pallas`` (fused-topk),
      ``radix`` and ``lax`` (torch) on one set of weights give the same
      expert indices and bit-equal logits; the head's float32-output
      product against the widened product; prefill and decode times, the
      decode step's device busy time and idle share from the profiler;
      float32 decode against forward at full width and 4 layers within
      rtol = atol = 3e-3 (12 positions, no capacity drops); olmo-1b at full
      size through the CLI with ``--prune 0.3 --top-k 50``, its prune
      masks equal to the host's on a copy of the same weights, and its
      float32 decode against forward at 4 layers;
   r. the other five archs: ``launch.serve.serve()`` (the function behind
      the CLI, which has no depth-only cut) at deepseek-v2's published
      widths, 6 of its 60 layers (1 dense + 5 MoE, 39.58 GiB), batch 4,
      prompt 16, 32 new tokens, top-32 sampling, 30 % in-situ pruning,
      router ``pallas`` (fused-topk): the key-pack and top-k kernels
      launched 5 times a forward; router parity bit for bit as in q; the
      decode step's times as in q; float32 decode against forward at 2
      layers (the absorbed MLA decode against the naive prefill);
      mamba2-1.3b, zamba2-2.7b and musicgen-medium at full size through
      the ``--oneshot --full-size`` CLI, each with a float32
      decode-against-forward check at 4, 12 and 24 layers (zamba2's and
      musicgen's periodic layout kept), the fusion layers' gates at 0.5
      with the frontend stub; mamba2's prefill through the cache on the
      card == the host's at 2 layers in float32 (the reference's one-token
      cached branch, reproduced); llama-3.2-vision-90b at width and 20
      layers (two periods, 36.35 GiB) through ``serve()`` with the 1601 x
      8192 frontend stub and the gates at 0 as initialised, then its
      float32 check at 10 layers with the gates at 0.5; each model freed
      before the next, the peak device memory of each step printed;
   s. training: qwen2-moe reduced (4 MoE layers, float32, router
      ``pallas``), 3 ``make_train_step`` steps with remat ``none`` and 3
      with ``full`` on the card, each within rtol 1e-5 (losses) and 1e-4
      (gradient norms) of the same steps on the host, the router kernels
      launched once a MoE layer a forward (twice a step under ``full``);
      qwen2-moe-a2.7b at its published widths, 4 of 24 layers, bfloat16,
      its memory reckoned and printed before allocating: router parity at
      step 0 (the three engines' expert indices equal, the loss bit for
      bit, the gradient norms within 1e-6), ``launch.train.train()`` for 6
      steps at batch 4 x seq 512 (losses finite; ms a step, tokens a
      second, MFU over 989 T bf16 FLOP/s, peak memory), one step under the
      profiler (device busy time, idle share, kernels by name), then 3
      steps committing a checkpoint at step 3 and a ``train()`` that
      restores it and runs steps 4-6 within rtol 1e-5 of the
      uninterrupted losses; olmo-1b whole through ``launch.train.main``
      (6 steps, batch 4 x seq 512, a checkpoint committed); the
      reference's descent setting (olmo reduced, lr 1e-2, 20 steps on one
      batch) losing more than 0.2;
   t. sharded execution on a world of one: a NCCL group of one rank in
      this process and ``make_host_mesh()``'s (1, 1) mesh; 4s.b's model
      (qwen2-moe-a2.7b at its published widths, 4 layers, batch 4 x
      512, seed 0) through ``train(run, 3, mesh=mesh)`` against the
      one-card ``train(run, 3)``: every loss and every parameter leaf
      bit for bit, the router kernels launched 4 times a step; then a
      prefill of 16 tokens and 8 teacher-forced decode steps under the
      mesh (params and caches placed by the reference's specs) against
      the unsharded steps, logits bit for bit; ms a step, tokens a
      second, peak memory;
   u. the roofline (``launch/roofline.py``) on the card: 4s.b's train
      step (qwen2-moe-a2.7b at its published widths, 4 layers, batch 4 x
      512, remat none, router ``pallas``) timed, then counted by
      ``roofline.count`` (FLOPs, bytes, collectives, aten ops by bytes),
      its FLOPs equal within 1 % to the dry run's count of the same step
      on fake tensors at world 1 (``launch/dryrun.py``, a fake group of
      one rank) and at least ``model_flops``, the router kernels launched;
      the same for one decode step of 4q's qwen2-moe-a2.7b at full depth,
      batch 4; then ``python -m repro_torch.launch.dryrun`` in
      subprocesses for olmo-1b ``decode_32k`` and qwen2-moe-a2.7b
      ``train_4k`` on 16 x 16 (a fake group of 256 ranks): each record's
      bottleneck, terms and per-rank peak against the card's memory, and
      the world-1 dry run's peak beside the real step's;
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
import os
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


# phases 4q and 4r: the model zoo's serving path.  The one-shot loop's
# shape (tests of the reference's serve CLI: batch 4, prompt 16, 32 new)
SERVE_ARGS = ["--batch", "4", "--prompt-len", "16", "--max-new", "32"]
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 16, 32
PARITY_DECODE_STEPS = 8
# the float32 decode-against-forward check: a cut depth, 12 positions, the
# reference's tolerance (tests/test_models.py)
F32_POSITIONS, F32_TOL = 12, 3e-3
TIMED_DECODE_STEPS = 16
# phase 4q: qwen2-moe-a2.7b (src/repro/configs/qwen2_moe_a2_7b.py) served at
# its published widths and full depth, and olmo-1b at full size
QWEN_ARCH, QWEN_LAYERS, F32_LAYERS = "qwen2_moe_a2_7b", 24, 4
# phase 4r: deepseek-v2 (src/repro/configs/deepseek_v2_236b.py) at its
# published widths, depth cut from 60 to 6 (1 dense + 5 MoE layers; the
# whole model is about 440 GiB); its float32 check at 2 layers
DSV2_ARCH, DSV2_LAYERS, DSV2_F32_LAYERS = "deepseek_v2_236b", 6, 2
# llama-3.2-vision-90b at depth 20 (two periods of 9 + a fusion layer);
# its float32 check at 10 (one run of 9 and the fusion layer)
LLAMA_ARCH, LLAMA_LAYERS, LLAMA_F32_LAYERS = "llama_3_2_vision_90b", 20, 10
# served at full width and depth through the CLI; the depth of each one's
# float32 check keeps zamba2's and musicgen's periodic layout (2 reps)
CLI_ARCHS = (("mamba2_1_3b", 4), ("zamba2_2_7b", 12), ("musicgen_medium", 24))
# mamba2's prefill through the cache, card against host: float32, 2 layers
SSM_PREFILL_LAYERS, SSM_PREFILL_TOL = 2, 1e-3
GATE = 0.5          # the cross-attention gates' value in the float32 checks
GIB = 2 ** 30


def cut(cfg, n_layers: int):
    """``cfg`` at ``n_layers``, its layer pattern cut alike; every width
    as published."""
    pat = cfg.layer_pattern[:n_layers] if cfg.layer_pattern else None
    return dataclasses.replace(cfg, n_layers=n_layers, layer_pattern=pat)


def open_gates(params, value: float):
    """``params`` with every cross-attention gate set to ``value`` (at init
    the gates are 0 and the fusion layers add nothing)."""
    import torch
    from repro_torch import tree
    return tree.map_with_path(
        lambda path, t: torch.full_like(t, value) if path[-1] == "gate"
        else t, params)


def checked_run(tag: str, top_k: int, run, zero_counts, counts):
    """One serving run (``run()`` returns the one-shot result) with every
    sampled token checked to lie in its step's top-k and every logit to be
    finite.  Returns (result, launches, seconds)."""
    import torch
    from repro_torch.models import sampling
    steps_seen = []
    real = sampling.sample_logits

    def record(logits, gen, k=0, temperature=1.0):
        tok = real(logits, gen, k, temperature)
        expect(bool(torch.isfinite(logits).all()),
               f"{tag}: a logit is not finite")
        kth = torch.topk(logits.float(), top_k, dim=-1).values[:, -1]
        picked = logits.float().gather(1, tok.long()[:, None])[:, 0]
        expect(bool((picked >= kth).all()), f"{tag}: a sampled token lies "
               f"outside its step's top-{top_k}")
        steps_seen.append(tok)
        return tok

    sampling.sample_logits = record
    zero_counts()
    t0 = time.perf_counter()
    try:
        res = run()
    finally:
        sampling.sample_logits = real
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts()
    shape = (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)
    expect(len(steps_seen) == SERVE_NEW and res["tokens"].shape == shape,
           f"{tag}: {len(steps_seen)} sampling steps, tokens "
           f"{res['tokens'].shape}")
    return res, got, secs


def cli(tag: str, arch: str, top_k: int, zero_counts, counts, *extra):
    """One in-process run of the serving CLI at the arch's full size."""
    from repro_torch.launch import serve
    return checked_run(
        f"{tag} {arch}", top_k,
        lambda: serve.main(["--oneshot", "--arch", arch, "--full-size",
                            *SERVE_ARGS, "--top-k", str(top_k), *extra]),
        zero_counts, counts)


def router_parity(tag: str, cfg, params, moe_layers: int, zero_counts,
                  counts) -> dict:
    """A prefill and 8 teacher-forced decode steps under each router
    engine on one set of weights: expert indices and logits of ``radix``
    and ``lax`` (torch) equal ``pallas`` (fused-topk) bit for bit.
    Returns fused-topk's kernel launches."""
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import moe, stacked
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    batch, plen = SERVE_BATCH, SERVE_PROMPT
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, plen)),
                             dtype=torch.int32, device=dev)
    forced = torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, PARITY_DECODE_STEPS)),
        dtype=torch.int32, device=dev)
    real_route = moe.route_topk
    n_fwd = 1 + PARITY_DECODE_STEPS
    runs, launched = {}, {}
    for impl in ("pallas", "radix", "lax"):
        c = dataclasses.replace(cfg, router_impl=impl)
        picks = []

        def route(logits, k, name, picks=picks):
            gates, idx = real_route(logits, k, name)
            picks.append(idx)
            return gates, idx

        prefill = steps.make_prefill_step(c)
        decode = steps.make_decode_step(c)
        caches = stacked.init_cache(c, batch, plen + PARITY_DECODE_STEPS,
                                    dev)
        moe.route_topk = route
        zero_counts()
        try:
            logits = [prefill(params, prompt, caches)[0]]
            for i in range(PARITY_DECODE_STEPS):
                pos = torch.full((batch,), plen + i, dtype=torch.int32,
                                 device=dev)
                logits.append(decode(params, forced[:, i:i + 1], pos,
                                     caches)[0])
        finally:
            moe.route_topk = real_route
        torch.cuda.synchronize()
        got = counts()
        if impl == "pallas":
            for name in ("radix_topk", "bitplane_pack"):
                expect(got[name] == moe_layers * n_fwd, f"{tag} parity: "
                       f"{name} launched {got[name]}, not {moe_layers} x "
                       f"{n_fwd}")
            launched = got
        else:
            expect(not any(got.values()), f"{tag} parity {impl}: launched "
                   f"kernels {got}")
        expect(len(picks) == moe_layers * n_fwd,
               f"{tag} parity {impl}: {len(picks)} router calls")
        expect(all(bool(torch.isfinite(lg).all()) for lg in logits),
               f"{tag} parity {impl}: a logit is not finite")
        runs[impl] = (logits, picks)
        del caches
    base_logits, base_picks = runs["pallas"]
    for impl in ("radix", "lax"):
        lg, pk = runs[impl]
        expect(all(torch.equal(a, b) for a, b in zip(pk, base_picks)),
               f"{tag} parity: {impl}'s expert indices != fused-topk's")
        expect(all(torch.equal(a, b) for a, b in zip(lg, base_logits)),
               f"{tag} parity: {impl}'s logits != fused-topk's bit for bit")
    print(f"{tag} router parity {cfg.name} ({batch}, {plen}) prefill + "
          f"{PARITY_DECODE_STEPS} teacher-forced decode steps: expert "
          "indices and logits of radix and lax (torch) == pallas "
          f"(fused-topk) bit for bit; fused-topk launched {moe_layers} of "
          f"each kernel a forward; {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {name: launched[name] for name in ("radix_topk", "bitplane_pack")}


def decode_times(card: str, tag: str, cfg, params, counts,
                 frontend=None) -> dict:
    """Prefill and decode on the host clock (after warm-up runs), the
    decode steps' stream time by CUDA events, and the device's busy time
    from the profiler's kernel intervals, at batch 4 and prompt 16."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps
    from repro_torch.models import stacked
    dev = torch.device("cuda")
    batch, plen = SERVE_BATCH, SERVE_PROMPT
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, plen)), dtype=torch.int32, device=dev)
    fe = () if frontend is None else (frontend,)
    wf = frontend is not None
    prefill = steps.make_prefill_step(cfg, with_frontend=wf)
    decode = steps.make_decode_step(cfg, with_frontend=wf)
    max_len = plen + 1 + 2 * TIMED_DECODE_STEPS
    caches = stacked.init_cache(cfg, batch, max_len, dev)
    prefill(params, prompt, caches, *fe)          # warm-up prefill
    caches = stacked.init_cache(cfg, batch, max_len, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill(params, prompt, caches, *fe)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    pos = torch.full((batch,), plen, dtype=torch.int32, device=dev)
    decode(params, tok, pos, caches, *fe)         # warm-up step
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    before = counts()
    t0 = time.perf_counter()
    start.record()
    for i in range(TIMED_DECODE_STEPS):
        logits, _ = decode(params, tok, pos + 1 + i, caches, *fe)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
    stop.record()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    after = counts()
    # a step makes thousands of launches: more than the stream's launch
    # queue holds, so queueing the steps behind a sleep would not take the
    # host out of the event times; the profiler's kernel intervals give the
    # device's busy time instead
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(TIMED_DECODE_STEPS):
            logits, _ = decode(params, tok,
                               pos + 1 + TIMED_DECODE_STEPS + i, caches,
                               *fe)
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    expect(len(kernels) > 0, f"{tag}: the profiler saw no kernel")
    busy_us, edge, by_name = 0.0, kernels[0][0], {}
    for a, b, name in kernels:
        busy_us += max(0.0, b - max(a, edge))
        edge = max(edge, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    span_us = edge - kernels[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"prefill_ms": prefill_ms,
           "decode_tok_per_s": batch * TIMED_DECODE_STEPS / decode_s,
           "decode_step_host_ms": decode_s / TIMED_DECODE_STEPS * 1e3,
           "decode_step_events_ms": (start.elapsed_time(stop)
                                     / TIMED_DECODE_STEPS),
           "decode_step_busy_ms": busy_us / 1e3 / TIMED_DECODE_STEPS,
           "decode_idle_share": 1 - busy_us / span_us,
           "kernels_per_step": len(kernels) // TIMED_DECODE_STEPS,
           "router_launches_per_step": {
               name: (after[name] - before[name]) / TIMED_DECODE_STEPS
               for name in ("radix_topk", "bitplane_pack")}}
    print(f"[{card}] {tag} {cfg.name} bf16, {cfg.n_layers} layers, batch "
          f"{batch}, router {cfg.router_impl}: prefill ({plen} tokens a row) "
          f"{prefill_ms:.2f} ms host clock; decode "
          f"{out['decode_tok_per_s']:.1f} tok/s host clock "
          f"({out['decode_step_host_ms']:.2f} ms a step over "
          f"{TIMED_DECODE_STEPS} steps after one warm-up); a decode step's "
          f"stream time by CUDA events {out['decode_step_events_ms']:.2f} ms "
          f"(host-paced), device busy {out['decode_step_busy_ms']:.2f} ms "
          f"(profiler: {out['kernels_per_step']} kernels a step, idle share "
          f"{out['decode_idle_share']:.3f}); router kernel launches a step "
          f"{out['router_launches_per_step']}", flush=True)
    print(f"[{card}] {tag} decode step, kernel time a step by name: "
          + "; ".join(f"{name[:60]} {us / 1e3 / TIMED_DECODE_STEPS:.3f} ms"
                      for name, us in top), flush=True)
    return out


def f32_decode_vs_forward(tag: str, arch: str, layers: int, zero_counts,
                          counts, router=None, gate=None) -> dict:
    """Float32 at the arch's full width and ``layers`` deep: token-by-token
    decode through the caches from position 0 reproduces the forward
    within rtol = atol = 3e-3 over 12 positions (no capacity drops; the
    frontend stub given to every step, the gates set to ``gate``).
    Returns the kernel launches."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import accounting, stacked
    dev = torch.device("cuda")
    base = configs.get_config(arch)
    cfg = dataclasses.replace(
        cut(base, layers), param_dtype="float32", compute_dtype="float32",
        moe_capacity_factor=None, router_impl=router or base.router_impl)
    p = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(3), dev)
    if gate is not None:
        p = open_gates(p, gate)
    fe = pipeline.frontend_stub(cfg, 2, dev)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, F32_POSITIONS)), device=dev)
    zero_counts()
    full, _, _ = stacked.forward(p, cfg, toks, frontend=fe)
    caches = stacked.init_cache(cfg, 2, F32_POSITIONS + 4, dev)
    outs = []
    for t in range(F32_POSITIONS):
        lg, caches = stacked.decode_step(
            p, cfg, toks[:, t:t + 1],
            torch.full((2,), t, dtype=torch.int32, device=dev), caches,
            frontend=fe)
        outs.append(lg)
    torch.cuda.synchronize()
    got = counts()
    dec = torch.cat(outs, dim=1)
    diff = (dec - full).abs()
    over = (diff - (F32_TOL + F32_TOL * full.abs())).max().item()
    expect(bool(torch.isfinite(full).all()) and over <= 0, f"{tag} "
           f"{arch} float32 decode vs forward: exceeds rtol = atol = "
           f"{F32_TOL} by {over}")
    layout = " ".join(type(s).__name__ for s in stacked.segments(cfg))
    extra = "" if gate is None else f", gates {gate}, frontend stub"
    print(f"{tag} {arch} float32 at full width, {layers} layers ({layout}"
          f"{extra}; param_bytes {accounting.param_bytes(cfg)}), 2 x "
          f"{F32_POSITIONS} positions: token-by-token decode == forward "
          f"within rtol = atol = {F32_TOL} (max |diff| "
          f"{diff.max().item():.3e}); launches {got}", flush=True)
    del p, caches
    torch.cuda.empty_cache()
    return got


# bfloat16 against float32 forwards (no cache): MLA's naive prefill
# (deepseek-v2's dense first layer) and the SSM's chunked scan (mamba2, two
# chunks of its published 256), as published but for the depth
BF16_CHECKS = (("deepseek_v2_236b", 1, 512), ("mamba2_1_3b", 2, 512))
BF16_TOL = 3e-2


def bf16_vs_f32_forward(tag: str, arch: str, layers: int, seq: int) -> dict:
    """The forward of ``arch`` at its published widths and dtype
    (bfloat16), ``layers`` deep, on 2 x ``seq`` tokens, against the same
    weights widened to float32 with a float32 compute dtype: the logits'
    difference within ``BF16_TOL`` of the float32 logits in the Frobenius
    norm, every logit finite.  Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch import configs, tree
    from repro_torch.models import stacked
    dev = torch.device("cuda")
    cfg = cut(configs.get_config(arch), layers)
    expect(cfg.param_dtype == "bfloat16", f"{tag} {arch}: {cfg.param_dtype}")
    p = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(3), dev)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, seq)), device=dev)
    with torch.no_grad():
        low, _, _ = stacked.forward(p, cfg, toks)
        p = tree.map_with_path(lambda _, t: t.float(), p)
        wide, _, _ = stacked.forward(p, dataclasses.replace(
            cfg, param_dtype="float32", compute_dtype="float32"), toks)
    torch.cuda.synchronize()
    rel = ((low.float() - wide).norm() / wide.norm()).item()
    agree = (low.argmax(-1) == wide.argmax(-1)).float().mean().item()
    expect(bool(torch.isfinite(low).all()) and rel <= BF16_TOL,
           f"{tag} {arch} bf16 forward vs float32: relative error {rel} "
           f"over {BF16_TOL}")
    print(f"{tag} {arch} bfloat16 forward at full width, {layers} layers, "
          f"2 x {seq} tokens, no cache ({stacked.segments(cfg)}) vs the "
          f"same weights in float32: |diff| / |f32| {rel:.4e} <= "
          f"{BF16_TOL} (Frobenius), max |diff| "
          f"{(low.float() - wide).abs().max().item():.3e}, argmax agrees at "
          f"{agree:.4f} of positions", flush=True)
    del p, low, wide
    torch.cuda.empty_cache()
    return {"rel": rel, "argmax_agree": agree}


def phase_4q(card: str, zero_counts, counts) -> dict:
    """The model zoo's serving path on the card: the ``--oneshot`` CLI at
    qwen2-moe-a2.7b's full widths and depth through the fused top-k router,
    router parity across the three engines, float32 decode against forward
    at a cut depth, olmo-1b at full size with its prune masks held to the
    host's.  Returns the kernel launches of the runs that count (the CLI
    and the fused-topk runs) and the times."""
    import torch
    from repro_torch import configs
    from repro_torch.models import accounting, stacked
    from repro_torch.models.layers import matmul_f32
    from repro_torch.pruning import insitu

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    qcfg = configs.get_config(QWEN_ARCH)
    expect(qcfg.n_layers == QWEN_LAYERS and qcfg.moe_capacity_factor == 1.25,
           "4q: qwen2-moe config")
    launched = {"radix_topk": 0, "bitplane_pack": 0}

    def add(got):
        for name in launched:
            launched[name] += got[name]

    # ---- the CLI at qwen2-moe's full widths, the router on the kernels
    print(f"4q {QWEN_ARCH}: {accounting.param_count(qcfg)} parameters, "
          f"param_bytes {accounting.param_bytes(qcfg)} "
          f"({accounting.param_bytes(qcfg) / GIB:.2f} GiB) before "
          "allocating", flush=True)
    res, got, secs = cli("4q", QWEN_ARCH, 32, zero_counts, counts,
                         "--router-impl", "pallas", "--prune", "0.3")
    forwards = SERVE_NEW
    for name in launched:
        expect(got[name] == QWEN_LAYERS * forwards, f"4q CLI: {name} "
               f"launched {got[name]} times, not {QWEN_LAYERS} x {forwards}")
    add(got)
    print(f"4q serve --oneshot {QWEN_ARCH} --full-size --router-impl pallas "
          f"{' '.join(SERVE_ARGS)} --top-k 32 --prune 0.3: {secs:.1f} s in "
          f"all (init, prune, prefill, 31 decode steps); launches {got} == "
          f"{QWEN_LAYERS} x {forwards}; every logit finite, every sampled "
          f"token inside its step's top-32; CLI's prefill "
          f"{res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{res['decode_tok_per_s']:.1f} tok/s (first calls)", flush=True)
    del res
    torch.cuda.empty_cache()

    # ---- router parity on one set of weights, then the head's product
    # and the times on the same weights
    params = stacked.init_params(
        qcfg, torch.Generator(device=dev).manual_seed(1), dev)
    add(router_parity("4q", qcfg, params, QWEN_LAYERS, zero_counts, counts))

    # float32 logits from bfloat16 operands: the head through cuBLAS's
    # float32-output product, against the widened product
    x = torch.randn(SERVE_BATCH, 1, qcfg.d_model, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev).to(torch.bfloat16)
    head = params["embed"]["head"]
    f32 = matmul_f32(x, head)
    wide = x.float() @ head.float()
    rounded = (x @ head).float()
    d_wide = (f32 - wide).abs().max().item()
    d_round = (rounded - wide).abs().max().item()
    expect(f32.dtype == torch.float32 and d_wide <= 1e-3 * wide.abs().max()
           and d_wide < d_round, f"4q: float32-output head product differs "
           f"from the widened product by {d_wide} (bf16-rounded: {d_round})")
    print(f"4q head (4, 1, 2048) @ (2048, 151936) bf16 -> float32: max |out "
          f"- widened product| {d_wide:.3e}; a bf16 product rounded "
          f"{d_round:.3e}", flush=True)

    out = decode_times(card, "4q", dataclasses.replace(
        qcfg, router_impl="pallas"), params, counts)
    del params
    torch.cuda.empty_cache()

    # ---- float32 decode against forward at full width, cut depth
    got = f32_decode_vs_forward("4q", QWEN_ARCH, F32_LAYERS, zero_counts,
                                counts, router="pallas")
    n_fwd = 1 + F32_POSITIONS
    for name in launched:
        expect(got[name] == F32_LAYERS * n_fwd, f"4q float32: {name} "
               f"launched {got[name]}, not {F32_LAYERS} x {n_fwd}")
    add(got)

    # ---- olmo-1b at full size: the non-parametric norm and the pruned
    # dense MLP; the masks made on the card == the host's on a copy
    real_prune = insitu.prune_params
    held = {}

    def prune_and_check(params, cfg, rate):
        new, stats = real_prune(params, cfg, rate)
        host = {"segments": [{"mlp": {"wi": params["segments"][0]["mlp"][
            "wi"].cpu()}}]}
        _, hstats = real_prune(host, cfg, rate)
        key = "['segments'][0]['mlp']['wi']"
        expect(list(stats["masks"]) == [key] and torch.equal(
            stats["masks"][key].cpu(), hstats["masks"][key]),
            "4q olmo-1b: prune masks on the card != the host's")
        expect(stats["weight_sparsity"] == hstats["weight_sparsity"],
               "4q olmo-1b: weight sparsity != the host's")
        held["sparsity"] = stats["weight_sparsity"]
        return new, stats

    insitu.prune_params = prune_and_check
    try:
        res, got, secs = cli("4q", "olmo_1b", 50, zero_counts, counts,
                             "--prune", "0.3")
    finally:
        insitu.prune_params = real_prune
    expect(not any(got.values()), f"4q olmo-1b: launched kernels {got}")
    print(f"4q serve --oneshot olmo_1b --full-size {' '.join(SERVE_ARGS)} "
          f"--top-k 50 --prune 0.3: {secs:.1f} s; prune masks on the card == "
          f"the host's on a copy bit for bit (weight sparsity "
          f"{held['sparsity']}); every logit finite, every sampled token "
          f"inside its step's top-50; CLI's prefill "
          f"{res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{res['decode_tok_per_s']:.1f} tok/s (first calls)", flush=True)
    del res
    torch.cuda.empty_cache()
    f32_decode_vs_forward("4q", "olmo_1b", F32_LAYERS, zero_counts, counts)
    print(f"[{card}] 4q peak device memory "
          f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB", flush=True)
    out["launches"] = launched
    return out


def phase_4r(card: str, zero_counts, counts) -> dict:
    """The other five archs on the card.  deepseek-v2 at its published
    widths (6 layers) through ``serve.serve()`` with the fused top-k
    router: every sampled token inside its top-32, router parity bit for
    bit, times, float32 decode against forward at 2 layers; mamba2,
    zamba2 and musicgen at full size through the ``--oneshot`` CLI, each
    with a float32 decode-against-forward check at a cut depth, and
    mamba2's prefill through the cache on the card against the host's;
    llama-3.2-vision at width and 20 layers with the 1601 x 8192 frontend
    stub, gates at 0 as initialised, and its float32 check at 10 layers
    with the gates at 0.5.  Returns the router kernels' launches of the
    counted runs, the times and the peaks."""
    import numpy as np
    import torch
    from repro_torch import configs, tree
    from repro_torch.launch import serve
    from repro_torch.models import accounting, stacked

    dev = torch.device("cuda")
    launched = {"radix_topk": 0, "bitplane_pack": 0}
    peaks = {}

    def add(got):
        for name in launched:
            launched[name] += got[name]

    def peak(what):
        """The device's peak since the last call, printed and kept."""
        torch.cuda.synchronize()
        gib = torch.cuda.max_memory_allocated() / GIB
        peaks[what] = gib
        print(f"[{card}] 4r {what}: peak device memory {gib:.2f} GiB",
              flush=True)
        expect(gib < 80, f"4r {what}: peak {gib:.2f} GiB")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def sized(cfg):
        return (f"{accounting.param_count(cfg)} parameters, param_bytes "
                f"{accounting.param_bytes(cfg)} "
                f"({accounting.param_bytes(cfg) / GIB:.2f} GiB)")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- deepseek-v2 at its published widths, 6 layers, fused router
    full = configs.get_config(DSV2_ARCH)
    cfg = dataclasses.replace(cut(full, DSV2_LAYERS), router_impl="pallas")
    expect((cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
            cfg.n_routed_experts, cfg.d_ff_expert, cfg.n_shared_experts,
            cfg.moe_top_k, cfg.vocab, cfg.moe_capacity_factor)
           == (5120, 128, 1536, 512, 128, 64, 128, 160, 1536, 2, 6, 102400,
               1.25), "4r: deepseek-v2 widths")
    moe_layers = DSV2_LAYERS - cfg.moe_layer_start
    segs = stacked.segments(cfg)
    print(f"4r {DSV2_ARCH} at {DSV2_LAYERS} of {full.n_layers} layers "
          f"({segs}): {sized(cfg)} before allocating; the whole model "
          f"{accounting.param_bytes(full) / GIB:.2f} GiB", flush=True)
    res, got, secs = checked_run(
        f"4r {DSV2_ARCH}", 32,
        lambda: serve.serve(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW,
                            top_k=32, prune_rate=0.3),
        zero_counts, counts)
    for name in launched:
        expect(got[name] == moe_layers * SERVE_NEW, f"4r serve: {name} "
               f"launched {got[name]} times, not {moe_layers} x {SERVE_NEW}")
    add(got)
    print(f"4r serve.serve({DSV2_ARCH} at {DSV2_LAYERS} layers, batch "
          f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_NEW} new, top-k 32, "
          f"prune 0.3, router pallas): {secs:.1f} s in all (init, prune, "
          f"prefill, {SERVE_NEW - 1} decode steps); launches {got} == "
          f"{moe_layers} x {SERVE_NEW}; every logit finite, every sampled "
          f"token inside its step's top-32; prefill "
          f"{res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{res['decode_tok_per_s']:.1f} tok/s (first calls)", flush=True)
    del res
    peak(f"{DSV2_ARCH} serve (init, prune, serve)")

    params = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), dev)
    add(router_parity("4r", cfg, params, moe_layers, zero_counts, counts))
    out = {"deepseek_v2": decode_times(card, "4r", cfg, params, counts)}
    del params
    peak(f"{DSV2_ARCH} parity and times")
    got = f32_decode_vs_forward("4r", DSV2_ARCH, DSV2_F32_LAYERS,
                                zero_counts, counts, router="pallas")
    n_moe = DSV2_F32_LAYERS - cfg.moe_layer_start
    for name in launched:
        expect(got[name] == n_moe * (1 + F32_POSITIONS), f"4r float32: "
               f"{name} launched {got[name]}, not {n_moe} x "
               f"{1 + F32_POSITIONS}")
    add(got)
    peak(f"{DSV2_ARCH} float32 check")

    # ---- the SSM, hybrid and audio archs at full size through the CLI
    for arch, f32_layers in CLI_ARCHS:
        acfg = configs.get_config(arch)
        print(f"4r {arch}: {sized(acfg)} before allocating", flush=True)
        res, got, secs = cli("4r", arch, 32, zero_counts, counts,
                             "--prune", "0.3")
        expect(not any(got.values()), f"4r {arch}: launched kernels {got}")
        print(f"4r serve --oneshot {arch} --full-size {' '.join(SERVE_ARGS)} "
              f"--top-k 32 --prune 0.3 ({stacked.segments(acfg)}): "
              f"{secs:.1f} s; every logit finite, every sampled token inside "
              f"its step's top-32; CLI's prefill "
              f"{res['prefill_s'] * 1e3:.1f} ms, decode "
              f"{res['decode_tok_per_s']:.1f} tok/s (first calls)",
              flush=True)
        out[arch] = {"prefill_ms": res["prefill_s"] * 1e3,
                     "decode_tok_per_s": res["decode_tok_per_s"]}
        del res
        peak(f"{arch} serve")
        periodic = any(isinstance(s, stacked.Periodic)
                       for s in stacked.segments(cut(acfg, f32_layers)))
        expect(periodic == bool(acfg.hybrid_every or acfg.xattn_every),
               f"4r {arch}: the float32 check's layout is not periodic")
        f32_decode_vs_forward("4r", arch, f32_layers, zero_counts, counts,
                              gate=GATE if acfg.frontend_tokens else None)
        peak(f"{arch} float32 check")

    # ---- mamba2's prefill through the cache: card == host; only the
    # first prompt token enters the SSM state, as the reference's
    base = configs.get_config("mamba2_1_3b")
    scfg = dataclasses.replace(cut(base, SSM_PREFILL_LAYERS),
                               param_dtype="float32",
                               compute_dtype="float32")
    p = stacked.init_params(
        scfg, torch.Generator(device=dev).manual_seed(4), dev)
    hp = tree.map_with_path(lambda _, t: t.cpu(), p)
    toks = np.random.default_rng(4).integers(0, scfg.vocab, (2, 16))
    runs = []
    for params, where in ((p, dev), (hp, torch.device("cpu"))):
        caches = stacked.init_cache(scfg, 2, 16, where)
        lg, caches, _ = stacked.forward(params, scfg,
                                        torch.as_tensor(toks, device=where),
                                        caches=caches)
        runs.append((lg, caches))
    (lg, caches), (hlg, hcaches) = runs
    worst = 0.0
    pairs = [(lg, hlg)] + [
        (t, dict(tree.flatten_with_path(hcaches))[path])
        for path, t in tree.flatten_with_path(caches)]
    for a, b in pairs:
        a = a.cpu()
        over = ((a - b).abs() - SSM_PREFILL_TOL
                - SSM_PREFILL_TOL * b.abs()).max().item()
        worst = max(worst, (a - b).abs().max().item())
        expect(over <= 0, f"4r mamba2 cached prefill: card != host by "
               f"{over} over rtol = atol = {SSM_PREFILL_TOL}")
    fwd, _, _ = stacked.forward(p, scfg, torch.as_tensor(toks, device=dev))
    d0 = (lg[:, 0] - fwd[:, 0]).abs().max().item()
    d1 = (lg[:, 1:] - fwd[:, 1:]).abs().max().item()
    expect(d0 <= F32_TOL * (1 + fwd[:, 0].abs().max().item()) and d1 > d0,
           f"4r mamba2 cached prefill vs forward: position 0 {d0}, later "
           f"{d1}")
    print(f"4r mamba2_1_3b float32 at full width, {SSM_PREFILL_LAYERS} "
          f"layers, (2, 16) prompt through the cache: logits, conv and SSM "
          f"states on the card == the host's within rtol = atol = "
          f"{SSM_PREFILL_TOL} (max |diff| {worst:.3e}); against the forward "
          f"(the reference's one-token cached branch, reproduced): position "
          f"0 max |diff| {d0:.3e}, positions 1-15 {d1:.3e}", flush=True)
    out["ssm_cached_prefill"] = {"card_vs_host": worst, "pos0": d0,
                                 "later": d1}
    del p, hp, caches, hcaches, runs, pairs, lg, hlg, fwd
    peak("mamba2 cached prefill, card and host")

    # ---- llama-3.2-vision at width, 20 layers, the frontend stub; gates 0
    lfull = configs.get_config(LLAMA_ARCH)
    lcfg = cut(lfull, LLAMA_LAYERS)
    segs = stacked.segments(lcfg)
    expect(isinstance(segs[0], stacked.Periodic) and segs[0].reps == 2,
           f"4r {LLAMA_ARCH}: {segs} is not two periods")
    print(f"4r {LLAMA_ARCH} at {LLAMA_LAYERS} of {lfull.n_layers} layers "
          f"({segs}): {sized(lcfg)} before allocating; frontend stub "
          f"({SERVE_BATCH}, {lcfg.frontend_tokens}, {lcfg.frontend_dim}) "
          "bf16", flush=True)
    res, got, secs = checked_run(
        f"4r {LLAMA_ARCH}", 32,
        lambda: serve.serve(lcfg, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW,
                            top_k=32, prune_rate=0.3),
        zero_counts, counts)
    expect(not any(got.values()), f"4r {LLAMA_ARCH}: launched kernels {got}")
    print(f"4r serve.serve({LLAMA_ARCH} at {LLAMA_LAYERS} layers, gates 0 as "
          f"initialised, batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
          f"{SERVE_NEW} new, top-k 32, prune 0.3): {secs:.1f} s in all; every "
          f"logit finite, every sampled token inside its step's top-32; "
          f"prefill {res['prefill_s'] * 1e3:.1f} ms, decode "
          f"{res['decode_tok_per_s']:.1f} tok/s (first calls)", flush=True)
    out[LLAMA_ARCH] = {"prefill_ms": res["prefill_s"] * 1e3,
                       "decode_tok_per_s": res["decode_tok_per_s"]}
    del res
    peak(f"{LLAMA_ARCH} serve")
    f32_decode_vs_forward("4r", LLAMA_ARCH, LLAMA_F32_LAYERS, zero_counts,
                          counts, gate=GATE)
    peak(f"{LLAMA_ARCH} float32 check")

    # ---- bfloat16 MLA naive prefill and SSD chunked scan vs float32
    for arch, layers, seq in BF16_CHECKS:
        zero_counts()
        out[f"bf16 {arch}"] = bf16_vs_f32_forward("4r", arch, layers, seq)
        expect(not any(counts().values()), f"4r {arch} bf16 check: "
               f"launched {counts()}")
        peak(f"{arch} bf16 check")
    out["launches"] = launched
    out["peaks_gib"] = peaks
    return out


# phase 4s: training on one card.  a: qwen2-moe reduced (4 MoE layers,
# float32, the fused router), 3 steps on the card against the host's
TRAIN_SMALL_LAYERS, TRAIN_SMALL_STEPS, TRAIN_SMALL_SHAPE = 4, 3, (4, 16)
# b: qwen2-moe-a2.7b (src/repro/configs/qwen2_moe_a2_7b.py) at its published
# widths, depth cut from 24 to 4 (see phase_4s), through train() at batch 4,
# seq 512, remat none, router pallas, 6 steps, a checkpoint at step 3
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 512
TRAIN_STEPS, TRAIN_CKPT = 6, 3
TRAIN_PEAK_LIMIT_GIB = 70
# d: the reference's descent setting (tests/test_substrate.py: olmo
# reduced, lr 1e-2, warmup 1, no weight decay, 20 steps on one batch)
DESCENT_STEPS, DESCENT_DROP = 20, 0.2


def train_reckoning(cfg, batch: int, seq: int) -> dict:
    """Device bytes of a training step, reckoned from the shapes before
    anything is allocated: the state (params and grads in the param type,
    float32 m and v), the saved activations of a layer (the attention's
    float32 scores and softmax and bf16 probabilities, the MoE's
    expert-major buffers and dispatch tensors, about 16 d-wide token
    tensors, the shared experts), the float32 logits with their gradient
    and softmax, the head's float32 weight gradient, and the update's
    four float32 temporaries of its largest piece (adamw.PIECE_ELEMENTS,
    or one layer of a leaf whose layer is larger)."""
    from repro_torch.models import accounting, moe
    from repro_torch.optim import adamw
    from repro_torch import tree
    n, pbytes = accounting.param_count(cfg), accounting.param_bytes(cfg)
    state = 2 * pbytes + 8 * n
    tokens = batch * seq
    eb = cfg.dtype().itemsize
    scores = batch * cfg.n_heads * seq * seq * (4 + 4 + eb)
    per_layer = scores + tokens * cfg.d_model * eb * 16
    if cfg.moe:
        E, f = cfg.n_routed_experts, cfg.d_ff_expert
        C = moe._capacity(seq, cfg.moe_top_k, E, cfg.moe_capacity_factor)
        per_layer += E * batch * C * (2 * cfg.d_model + 3 * f) * eb
        per_layer += 2 * batch * seq * E * C * eb
        per_layer += tokens * 3 * cfg.n_shared_experts * f * eb
    else:
        per_layer += tokens * 3 * cfg.d_ff * eb
    acts = per_layer * cfg.n_layers
    head = 3 * tokens * cfg.vocab * 4 + cfg.d_model * cfg.vocab * 4
    from repro_torch.models import stacked
    leaves = [t for _, t in tree.flatten_with_path(
        stacked.init_params(cfg, None, "meta"))]
    piece = max(min(t.numel(), max(adamw.PIECE_ELEMENTS,
                                   t.numel() // max(t.shape[0], 1)))
                for t in leaves if t.dim())
    update = 4 * 4 * piece
    peak = state + max(acts + head, update)
    return {"params": n, "param_bytes": pbytes, "state": state,
            "activations": acts, "head": head, "update": update,
            "peak": peak}


def recorded_steps(fn):
    """``fn()`` with train()'s straggler monitor recording each step's
    seconds (the step's host clock, its batch, forward, backward and
    update, and the loss read back).  Returns (fn's result, seconds)."""
    from repro_torch.runtime import faults
    real, seen = faults.StragglerMonitor, []

    class Recording(real):
        def observe(self, step_time_s):
            seen.append(step_time_s)
            return super().observe(step_time_s)

    faults.StragglerMonitor = Recording
    try:
        return fn(), seen
    finally:
        faults.StragglerMonitor = real


def profiled_step(step, params, state, x, y) -> dict:
    """One train step under the profiler, its two halves (forward and
    backward; the AdamW update) each in a session of its own: the device's
    busy time (the union of kernel intervals), the span from the first
    kernel's start to the last's end, the kernels launched and the
    kernel time by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}

    def measure(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = fn()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        expect(len(kernels) > 0, f"4s {tag}: the profiler saw no kernel")
        busy, edge, by_name = 0.0, kernels[0][0], {}
        for a, b, name in kernels:
            busy += max(0.0, b - max(a, edge))
            edge = max(edge, b)
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        out[tag] = {"host_ms": host_ms, "busy_ms": busy / 1e3,
                    "span_ms": (edge - kernels[0][0]) / 1e3,
                    "kernels": len(kernels),
                    "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}
        return res

    grads, loss, metrics = measure(
        "forward+backward", lambda: step.grads(params, x, y))
    measure("adamw", lambda: step.apply(params, state, grads, loss, metrics))
    del grads
    return out


def phase_4s(card: str, zero_counts, counts) -> dict:
    """Training on the card.  a: qwen2-moe reduced (4 MoE layers, float32,
    the fused router), 3 train steps with remat none and 3 with remat full
    on the card, each against the same steps on the host; b: qwen2-moe-
    a2.7b at its published widths and 4 layers through train(): router
    parity at step 0, 6 timed steps, one profiled, and the step-3
    checkpoint's restore continuing to step 6; c: olmo-1b whole through
    the CLI with a checkpoint; d: the descent check.  Returns the kernel
    launches of the counted runs and the numbers."""
    import shutil
    import statistics
    import tempfile
    import numpy as np
    import torch
    from repro_torch import configs, tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch import train as trainer
    from repro_torch.models import accounting, moe, stacked
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    launched = {"radix_topk": 0, "bitplane_pack": 0}
    router = tuple(launched)
    out = {}

    def add(got):
        for name in launched:
            launched[name] += got[name]

    # ---- a. the card against the host at a reduced size, float32
    t0 = time.perf_counter()
    small = dataclasses.replace(
        configs.get_config(QWEN_ARCH).reduced(n_layers=TRAIN_SMALL_LAYERS),
        router_impl="pallas")
    moe_layers = sum(stacked.layer_sig(small, i).moe
                     for i in range(small.n_layers))
    ocfg = adamw.AdamWConfig()
    shape = ShapeConfig("4s.a", TRAIN_SMALL_SHAPE[1], TRAIN_SMALL_SHAPE[0],
                        "train")
    p0 = stacked.init_params(small, torch.Generator().manual_seed(0), "cpu")
    for remat in ("none", "full"):
        runs = {}
        for where in ("cuda", "cpu"):
            p = tree.map_with_path(lambda _, t: t.to(where, copy=True), p0)
            s = adamw.init(p, ocfg)
            step = steps.make_train_step(small, ocfg, remat=remat)
            got = []
            for i in range(TRAIN_SMALL_STEPS):
                x, y = pipeline.host_batch(small, shape, i, device=where)
                zero_counts()
                p, s, m = step(p, s, x, y)
                if where == "cuda":
                    torch.cuda.synchronize()
                n = counts()
                got.append((float(m["loss"]), float(m["grad_norm"]), n))
            runs[where] = got
        per_step = moe_layers * (2 if remat == "full" else 1)
        for i, ((ld, gd, nd), (lh, gh, nh)) in enumerate(
                zip(runs["cuda"], runs["cpu"])):
            expect(all(nd[k] == per_step for k in router), f"4s.a remat "
                   f"{remat} step {i}: router launches {nd}, not {per_step}")
            expect(not any(nh.values()), f"4s.a host launched {nh}")
            expect(abs(ld - lh) <= 1e-5 * abs(lh), f"4s.a remat {remat} step "
                   f"{i}: loss {ld} on the card, {lh} on the host")
            expect(abs(gd - gh) <= 1e-4 * abs(gh), f"4s.a remat {remat} step "
                   f"{i}: grad norm {gd} on the card, {gh} on the host")
            add(nd)
        print(f"4s.a {small.name} ({moe_layers} MoE layers, float32, router "
              f"pallas), remat {remat}, {TRAIN_SMALL_STEPS} steps at batch "
              f"{TRAIN_SMALL_SHAPE}: losses card "
              f"{[r[0] for r in runs['cuda']]} == host "
              f"{[r[0] for r in runs['cpu']]} within rtol 1e-5, grad norms "
              "within 1e-4; router kernels launched "
              f"{per_step} times a step", flush=True)
    out["a_s"] = time.perf_counter() - t0

    # ---- b. qwen2-moe-a2.7b at its published widths, 4 of 24 layers
    t0 = time.perf_counter()
    full = configs.get_config(QWEN_ARCH)
    expect(full.n_layers == QWEN_LAYERS and full.d_model == 2048
           and full.n_routed_experts == 60 and full.moe_top_k == 4
           and full.vocab == 151936, "4s.b: qwen2-moe config")
    cfg = dataclasses.replace(cut(full, TRAIN_LAYERS), router_impl="pallas")
    rk = train_reckoning(cfg, TRAIN_BATCH, TRAIN_SEQ)
    deeper = {n: train_reckoning(cut(full, n), TRAIN_BATCH, TRAIN_SEQ)
              for n in range(TRAIN_LAYERS + 1, TRAIN_LAYERS + 5)}
    print(f"4s.b {QWEN_ARCH} at {TRAIN_LAYERS} of {full.n_layers} layers, "
          f"reckoned before allocating: {rk['params']} parameters, "
          f"{rk['param_bytes'] / GIB:.2f} GiB of weights; state (params, "
          f"grads, float32 m and v) {rk['state'] / GIB:.2f} GiB, activations "
          f"{rk['activations'] / GIB:.2f}, logits and head gradient "
          f"{rk['head'] / GIB:.2f}, update temporaries "
          f"{rk['update'] / GIB:.2f}: peak {rk['peak'] / GIB:.2f} GiB; "
          "deeper: " + ", ".join(
              f"{n} layers state {r['state'] / GIB:.1f} / peak "
              f"{r['peak'] / GIB:.1f} GiB / checkpoint "
              f"{12 * r['params'] / 1e9:.1f} GB" for n, r in deeper.items())
          + f"; this cut's checkpoint {12 * rk['params'] / 1e9:.1f} GB",
          flush=True)
    expect(rk["peak"] < TRAIN_PEAK_LIMIT_GIB * GIB, "4s.b: reckoned peak "
           f"{rk['peak'] / GIB:.2f} GiB over {TRAIN_PEAK_LIMIT_GIB}")
    tshape = ShapeConfig("4s.b", TRAIN_SEQ, TRAIN_BATCH, "train")
    ocfg = adamw.AdamWConfig()

    # router parity at step 0: the three engines on one set of weights
    torch.cuda.reset_peak_memory_stats()
    params = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    x, y = pipeline.host_batch(cfg, tshape, 0, device=dev)
    real_route = moe.route_topk
    par = {}
    for impl in ("pallas", "radix", "lax"):
        picks = []

        def route(logits, k, name, picks=picks):
            gates, idx = real_route(logits, k, name)
            picks.append(idx)
            return gates, idx

        c = dataclasses.replace(cfg, router_impl=impl)
        moe.route_topk = route
        zero_counts()
        try:
            g, loss, _ = steps.make_train_step(c, ocfg, remat="none").grads(
                params, x, y)
            gnorm = float(adamw.global_norm(g))
        finally:
            moe.route_topk = real_route
        torch.cuda.synchronize()
        got = counts()
        del g
        if impl == "pallas":
            expect(all(got[k] == TRAIN_LAYERS for k in router), f"4s.b "
                   f"parity: fused-topk launched {got}")
            add(got)
        else:
            expect(not any(got.values()), f"4s.b parity {impl}: {got}")
        par[impl] = (loss, gnorm, picks)
    loss0, gnorm0, picks0 = par["pallas"]
    for impl in ("radix", "lax"):
        loss, gnorm, picks = par[impl]
        expect(len(picks) == len(picks0) == TRAIN_LAYERS and all(
            torch.equal(a, b) for a, b in zip(picks, picks0)),
            f"4s.b parity: {impl}'s expert indices != fused-topk's")
        expect(torch.equal(loss, loss0), f"4s.b parity: {impl}'s loss "
               f"{float(loss)} != fused-topk's {float(loss0)}")
        expect(abs(gnorm - gnorm0) <= 1e-6 * gnorm0, f"4s.b parity: "
               f"{impl}'s grad norm {gnorm} vs {gnorm0}")
    print(f"4s.b router parity at step 0 (batch {TRAIN_BATCH}, seq "
          f"{TRAIN_SEQ}, forward and backward): expert indices of radix and "
          f"lax (torch) == pallas (fused-topk), loss bit for bit "
          f"({float(loss0)!r}), grad norms {[par[k][1] for k in par]} within "
          f"1e-6", flush=True)
    del params, par, picks0, loss0
    torch.cuda.empty_cache()

    # 6 uninterrupted steps through train(), timed; then one step profiled
    run = trainer.TrainRun(cfg=cfg, shape=tshape, ocfg=ocfg, remat="none")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    (params, state, hist), secs = recorded_steps(
        lambda: trainer.train(run, TRAIN_STEPS, log_every=1))
    torch.cuda.synchronize()
    got = counts()
    peak_gib = torch.cuda.max_memory_allocated() / GIB
    expect(all(got[k] == TRAIN_LAYERS * TRAIN_STEPS for k in router),
           f"4s.b train(): router launches {got}, not {TRAIN_LAYERS} x "
           f"{TRAIN_STEPS}")
    expect(len(hist) == TRAIN_STEPS and all(np.isfinite(hist)),
           f"4s.b train(): losses {hist}")
    add(got)
    step_ms = statistics.median(secs[1:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = accounting.model_flops(cfg, tshape)
    mfu = flops / (step_ms * 1e-3) / BF16_FLOPS_PER_S
    x, y = pipeline.host_batch(cfg, tshape, TRAIN_STEPS, device=dev)
    zero_counts()
    prof = profiled_step(steps.make_train_step(cfg, ocfg, remat="none"),
                         params, state, x, y)
    add(counts())
    fb, up = prof["forward+backward"], prof["adamw"]
    busy = fb["busy_ms"] + up["busy_ms"]
    span = fb["span_ms"] + up["span_ms"]
    out["b"] = {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
                "mfu": mfu, "peak_gib": peak_gib, "busy_ms": busy,
                "idle_share": 1 - busy / span, "profile": prof,
                "kernels_per_step": fb["kernels"] + up["kernels"],
                "router_launches_per_step": TRAIN_LAYERS, "losses": hist}
    print(f"[{card}] 4s.b train() {cfg.name} at {TRAIN_LAYERS} layers, bf16, "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, remat none, router pallas: "
          f"losses {hist}; step times {[round(t * 1e3, 2) for t in secs]} ms "
          f"(host clock), median of steps 2-{TRAIN_STEPS} {step_ms:.2f} ms, "
          f"{tokens / step_ms * 1e3:.0f} tokens/s; model_flops {flops:.4e} "
          f"-> MFU {mfu:.4f} of {BF16_FLOPS_PER_S:.0e}; peak device memory "
          f"{peak_gib:.2f} GiB (reckoned {rk['peak'] / GIB:.2f}); router "
          f"launches {got}", flush=True)
    for tag, r in prof.items():
        print(f"[{card}] 4s.b profiled step, {tag}: host {r['host_ms']:.2f} "
              f"ms, device busy {r['busy_ms']:.2f} ms over a span of "
              f"{r['span_ms']:.2f} ms (idle share "
              f"{1 - r['busy_ms'] / r['span_ms']:.3f}), {r['kernels']} "
              "kernels; by name: " + "; ".join(
                  f"{name[:70]} {us / 1e3:.3f} ms" for name, us in r["top"]),
              flush=True)
    print(f"[{card}] 4s.b a step: device busy {busy:.2f} ms, idle share "
          f"{1 - busy / span:.3f}, {fb['kernels'] + up['kernels']} kernels "
          f"({TRAIN_LAYERS} of each router kernel)", flush=True)
    del params, state
    torch.cuda.empty_cache()

    # the step-3 checkpoint: 3 steps committing step 3, then a train()
    # that restores it and runs steps 4-6 (it drops step 3 once read, so
    # the disk holds one full-state checkpoint at a time)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_4s_")
    try:
        crun = dataclasses.replace(run, ckpt_dir=ckpt, ckpt_every=TRAIN_CKPT)
        zero_counts()
        t1 = time.perf_counter()
        _, _, head = trainer.train(crun, TRAIN_CKPT, log_every=100)
        save_s = time.perf_counter() - t1
        mgr = CheckpointManager(ckpt)
        expect(mgr.all_steps() == [TRAIN_CKPT], f"4s.b: checkpoints "
               f"{mgr.all_steps()}")
        ck_bytes = sum(f.stat().st_size for f in
                       Path(ckpt, f"step_{TRAIN_CKPT:09d}").iterdir())
        torch.cuda.empty_cache()
        resumed = {}

        def drop_restored(step, metrics):
            if not resumed:
                resumed["s"] = time.perf_counter() - t1
                shutil.rmtree(Path(ckpt, f"step_{TRAIN_CKPT:09d}"))

        t1 = time.perf_counter()
        _, state, tail = trainer.train(crun, TRAIN_STEPS - TRAIN_CKPT,
                                       log_every=100, on_step=drop_restored)
        total_s = time.perf_counter() - t1
        add(counts())
        expect(int(state.count) == TRAIN_STEPS, f"4s.b resume: count "
               f"{int(state.count)}")
        expect(mgr.all_steps() == [TRAIN_STEPS], f"4s.b resume: "
               f"checkpoints {mgr.all_steps()}")
        del state
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    gap = max(abs(a - b) / abs(b) for a, b in zip(head + tail, hist))
    expect(gap <= 1e-5, f"4s.b resume: losses {head} + {tail} vs "
           f"uninterrupted {hist}, relative gap {gap}")
    out["b"].update({"ckpt_gb": ck_bytes / 1e9, "save_s": save_s,
                     "restore_s": resumed["s"], "resume_total_s": total_s,
                     "resume_gap": gap})
    print(f"[{card}] 4s.b checkpoint at step {TRAIN_CKPT} "
          f"({ck_bytes / 1e9:.2f} GB on disk: float32 params, m and v): "
          f"train({TRAIN_CKPT} steps) with the commit {save_s:.1f} s; the "
          f"restore and the first resumed step {resumed['s']:.1f} s; steps "
          f"4-{TRAIN_STEPS} with step {TRAIN_STEPS}'s commit {total_s:.1f} s; "
          f"losses {head} + resumed {tail} vs uninterrupted {hist}: "
          + ("bit for bit" if head + tail == hist
             else f"relative gap {gap:.3e}")
          + f"; phase 4s.b {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- c. olmo-1b whole, through the CLI
    t0 = time.perf_counter()
    ocfg_olmo = configs.get_config("olmo_1b")
    ckpt = tempfile.mkdtemp(prefix="repro_torch_4s_olmo_")
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        hist, secs = recorded_steps(lambda: trainer.main([
            "--arch", "olmo_1b", "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir", ckpt]))
        got = counts()
        peak_gib = torch.cuda.max_memory_allocated() / GIB
        committed = CheckpointManager(ckpt).latest_step()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    expect(not any(got.values()), f"4s.c olmo-1b: launched kernels {got}")
    expect(len(hist) == TRAIN_STEPS and all(np.isfinite(hist)),
           f"4s.c olmo-1b: losses {hist}")
    expect(committed == TRAIN_STEPS, f"4s.c olmo-1b: committed {committed}")
    step_ms = statistics.median(secs[1:]) * 1e3
    oshape = ShapeConfig("4s.c", TRAIN_SEQ, TRAIN_BATCH, "train")
    mfu = accounting.model_flops(ocfg_olmo, oshape) / (step_ms * 1e-3) \
        / BF16_FLOPS_PER_S
    out["c"] = {"step_ms": step_ms, "mfu": mfu, "peak_gib": peak_gib,
                "tokens_per_s": tokens / step_ms * 1e3, "losses": hist}
    print(f"[{card}] 4s.c launch.train.main --arch olmo_1b --steps "
          f"{TRAIN_STEPS} --batch {TRAIN_BATCH} --seq {TRAIN_SEQ} --ckpt-dir "
          f"<tmp> ({accounting.param_count(ocfg_olmo)} parameters, "
          f"{accounting.param_bytes(ocfg_olmo) / GIB:.2f} GiB, uncut): losses "
          f"{hist}, all finite; step {TRAIN_STEPS} committed; step times "
          f"{[round(t * 1e3, 2) for t in secs]} ms, median of steps "
          f"2-{TRAIN_STEPS} {step_ms:.2f} ms, {tokens / step_ms * 1e3:.0f} "
          f"tokens/s, MFU {mfu:.4f}; peak device memory {peak_gib:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s with init and the checkpoint",
          flush=True)
    torch.cuda.empty_cache()

    # ---- d. the descent check on the card
    dcfg = configs.get_config("olmo_1b").reduced()
    docfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.0)
    dstep = steps.make_train_step(dcfg, docfg, remat="none")
    p = stacked.init_params(dcfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    s = adamw.init(p, docfg)
    x, y = pipeline.host_batch(dcfg, ShapeConfig("4s.d", 32, 8, "train"), 0,
                               device=dev)
    losses = []
    for _ in range(DESCENT_STEPS):
        p, s, m = dstep(p, s, x, y)
        losses.append(float(m["loss"]))
    expect(losses[-1] < losses[0] - DESCENT_DROP, f"4s.d: losses "
           f"{losses[::5]} do not drop by {DESCENT_DROP}")
    print(f"4s.d descent ({dcfg.name}, lr 1e-2, warmup 1, no weight decay, "
          f"{DESCENT_STEPS} steps on one batch of 8 x 32): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    out["launches"] = launched
    return out


# phase 4t: sharded execution at world 1: 4s.b's model, batch and seed
# through train(mesh=...) for 3 steps, then a prefill of 16 and 8 decode
# steps under the mesh, each against the unsharded path in this process
SHARD_STEPS, SHARD_PROMPT, SHARD_DECODE = 3, 16, 8


def phase_4t(card: str, zero_counts, counts, losses_4s) -> dict:
    """Sharded execution on a world of one: a NCCL group of one rank in
    this process, the (1, 1) mesh of ``make_host_mesh()``.  qwen2-moe-
    a2.7b at its published widths and 4 layers: ``train(run, 3,
    mesh=mesh)`` from 4s.b's seed against the one-card ``train(run, 3)``
    (every loss and every parameter leaf bit for bit), then a prefill and
    8 teacher-forced decode steps under the mesh against the unsharded
    steps (logits bit for bit; the sharded prefill returns the last
    position's, as sampling reads them).  ``losses_4s``: 4s.b's uninterrupted
    losses, printed beside the one-card run's.  Returns the router
    launches of the counted runs and the numbers."""
    import statistics
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs, tree
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding, steps
    from repro_torch.launch import train as trainer
    from repro_torch.models import stacked
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw

    dev = torch.device("cuda", 0)
    router = ("radix_topk", "bitplane_pack")
    launched = dict.fromkeys(router, 0)
    cfg = dataclasses.replace(cut(configs.get_config(QWEN_ARCH), TRAIN_LAYERS),
                              router_impl="pallas")
    tshape = ShapeConfig("4t", TRAIN_SEQ, TRAIN_BATCH, "train")
    run = trainer.TrainRun(cfg=cfg, shape=tshape, ocfg=adamw.AdamWConfig(),
                           remat="none")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh()
        expect(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
               f"4t: mesh {mesh}")

        # the one-card train() of 4s.b, then the same under the mesh
        zero_counts()
        params, state, want = trainer.train(run, SHARD_STEPS, log_every=100)
        del state
        torch.cuda.synchronize()
        expect(all(counts()[k] == TRAIN_LAYERS * SHARD_STEPS for k in router),
               f"4t one-card train(): router launches {counts()}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the one-card run's params, kept for the comparison below
        held_gib = torch.cuda.memory_allocated() / GIB
        zero_counts()
        (sp, ss, got), secs = recorded_steps(lambda: trainer.train(
            run, SHARD_STEPS, mesh=mesh, log_every=1))
        torch.cuda.synchronize()
        n = counts()
        peak_gib = torch.cuda.max_memory_allocated() / GIB
        expect(all(n[k] == TRAIN_LAYERS * SHARD_STEPS for k in router),
               f"4t train(mesh): router launches {n}, not {TRAIN_LAYERS} x "
               f"{SHARD_STEPS}")
        for k in router:
            launched[k] += n[k]
        expect(got == want, f"4t train(mesh): losses {got} != one-card "
               f"{want}")
        print(f"4t one-card train() losses {want} "
              + ("==" if want == losses_4s[:SHARD_STEPS] else "!=")
              + f" 4s.b's first {SHARD_STEPS} {losses_4s[:SHARD_STEPS]}",
              flush=True)
        unequal = [tree.keystr(path) for path, t in
                   tree.flatten_with_path(sp) if not torch.equal(
                       t.full_tensor(), tree.at(params, path))]
        expect(not unequal, f"4t train(mesh): parameters differ from the "
               f"one-card run's: {unequal[:4]}")
        expect(int(ss.count.full_tensor()) == SHARD_STEPS, "4t: count")
        del sp, ss
        torch.cuda.empty_cache()
        step_ms = statistics.median(secs[1:]) * 1e3
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"[{card}] 4t train(run, {SHARD_STEPS}, mesh=(1, 1) NCCL) "
              f"{cfg.name} at {TRAIN_LAYERS} layers, bf16, batch "
              f"{TRAIN_BATCH} x seq {TRAIN_SEQ}: losses {got} == one-card "
              f"{want} bit for bit, every parameter leaf bit for bit; step "
              f"times {[round(t * 1e3, 2) for t in secs]} ms (host clock), "
              f"median of steps 2-{SHARD_STEPS} {step_ms:.2f} ms, "
              f"{tokens / step_ms * 1e3:.0f} tokens/s; peak device memory "
              f"{peak_gib:.2f} GiB, {peak_gib - held_gib:.2f} GiB above the "
              f"{held_gib:.2f} GiB held before it (the one-card run's "
              f"params); router launches {n}", flush=True)

        # a prefill and 8 decode steps, unsharded and under the mesh, on
        # the trained weights; the tokens are the unsharded greedy ones
        axes = mesh_lib.data_axes(mesh)
        max_len = SHARD_PROMPT + SHARD_DECODE
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (TRAIN_BATCH, SHARD_PROMPT)), dtype=torch.int32,
            device=dev)
        arms = {}
        for arm in ("one card", "mesh"):
            caches = stacked.init_cache(cfg, TRAIN_BATCH, max_len, dev)
            p = params
            if arm == "mesh":
                p = sharding.place(params, mesh,
                                   sharding.param_specs(mesh, params))
                caches = sharding.place(caches, mesh, sharding.cache_specs(
                    mesh, caches, axes))
                prefill = steps.make_sharded_prefill_step(cfg, mesh)
                decode = steps.make_sharded_decode_step(cfg, mesh)
            else:
                prefill = steps.make_prefill_step(cfg)
                decode = steps.make_decode_step(cfg)
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = prefill(p, prompt, caches)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            # the sharded prefill returns the last position's logits
            lg = lg[:, -1:]
            logits, toks = [lg], arms.get("one card", {}).get("toks", [])
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            fresh = not toks
            t0 = time.perf_counter()
            for i in range(SHARD_DECODE):
                if fresh:
                    toks.append(tok)
                pos = torch.full((TRAIN_BATCH,), SHARD_PROMPT + i,
                                 dtype=torch.int32, device=dev)
                lg, caches = decode(p, toks[i], pos, caches)
                logits.append(lg)
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3 / SHARD_DECODE
            n = counts()
            expect(all(n[k] == TRAIN_LAYERS * (1 + SHARD_DECODE)
                       for k in router), f"4t {arm} serving: router "
                   f"launches {n}")
            if arm == "mesh":
                for k in router:
                    launched[k] += n[k]
            arms[arm] = {"logits": logits, "toks": toks,
                         "prefill_ms": prefill_ms, "decode_ms": decode_ms,
                         "peak_gib": torch.cuda.max_memory_allocated() / GIB,
                         "launches": n}
            del p, caches
        same = [torch.equal(a, b) for a, b in zip(arms["one card"]["logits"],
                                                   arms["mesh"]["logits"])]
        expect(len(same) == 1 + SHARD_DECODE and all(same),
               f"4t serving: logits under the mesh differ from the "
               f"unsharded ones at steps {[i for i, e in enumerate(same) if not e]}")
        for arm, r in arms.items():
            print(f"[{card}] 4t serving, {arm}: prefill of {TRAIN_BATCH} x "
                  f"{SHARD_PROMPT} {r['prefill_ms']:.2f} ms, {SHARD_DECODE} "
                  f"decode steps {r['decode_ms']:.2f} ms a step "
                  f"({TRAIN_BATCH / r['decode_ms'] * 1e3:.1f} tok/s), peak "
                  f"device memory {r['peak_gib']:.2f} GiB, router launches "
                  f"{r['launches']}", flush=True)
        print(f"4t serving: the prefill's and {SHARD_DECODE} decode steps' "
              "logits under the mesh == unsharded, bit for bit", flush=True)
        del params, arms
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"launches": launched, "step_ms": step_ms, "peak_gib": peak_gib,
            "held_gib": held_gib, "tokens_per_s": tokens / step_ms * 1e3}


# phase 4u: the roofline on the card and the dry run.  a: 4s.b's train
# step; b: one decode step of 4q's qwen2-moe at full depth, batch 4, after
# a prefill of 16; each timed, counted, and held to the dry run's count of
# the same step on fake tensors at world 1.  c: the dry run's CLI on
# 16 x 16 for these cells (the smallest serving cell and 4s.b's model at
# its reference shape)
ROOF_TIMED_STEPS, ROOF_FLOP_RTOL = 3, 0.01
DRYRUN_CELLS = (("olmo_1b", "decode_32k"), ("qwen2_moe_a2_7b", "train_4k"))
CARD_GIB = 80


def fake_count(cfg, shape):
    """The dry run's count of one step of ``cfg`` at ``shape`` (remat
    none) on fake tensors, at world 1: a fake group of one rank, the (1, 1)
    mesh, the port's sharded step (:func:`repro_torch.launch.dryrun.measure`),
    router ``radix`` (plain torch: the FLOPs of the products are the same
    as under the fused router).  Returns (counts, memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    with dryrun.fake_group(1):
        mesh = mesh_lib.make_host_mesh()
        with FakeTensorMode():
            cell = dryrun.make_cell(
                dataclasses.replace(cfg, router_impl="radix"), shape, mesh,
                remat="none", accum=1)
            return dryrun.measure(cell)


def roofline_report(card: str, tag: str, counts, fake, fake_mem, roof,
                    step_ms: float, peak_gib: float, embed_params: int,
                    active_params: int) -> None:
    """The gates of a counted step (card FLOPs == the fake count within
    1 %; at least model_flops less the share model_flops gives the token
    embedding table, ``embed_params`` of ``active_params``) and its lines:
    the roofline, the measured step beside it, aten ops by output bytes,
    the peaks."""
    from repro_torch.launch import roofline as rl
    diff = abs(counts.flops - fake.flops) / fake.flops
    expect(diff <= ROOF_FLOP_RTOL, f"{tag}: the card counted {counts.flops} "
           f"FLOPs, the fake step {fake.flops} ({diff:.4%} apart)")
    # model_flops (6 or 2 x N x D, accounting.model_flops) counts the
    # token embedding table's V x d parameters as multiplied; the step
    # gathers its rows and multiplies none of them, so at a cut depth the
    # lookup's share can exceed what the cut layers compute beyond N x D
    lookup = roof.model_flops * embed_params / active_params
    expect(roof.flops_per_device >= roof.model_flops - lookup, f"{tag}: "
           f"flops_per_device {roof.flops_per_device} < model_flops "
           f"{roof.model_flops} less the embedding lookup's {lookup}")
    print(f"[{card}] {tag} roofline: {rl.summary(roof, counts)}; "
          f"step_time_s {roof.step_time_s:.6f} (roofline_fraction "
          f"{roof.roofline_fraction:.4f}); measured {step_ms:.2f} ms a step "
          f"(host clock), the roofline's step time / measured "
          f"{roof.step_time_s * 1e3 / step_ms:.4f}; FLOPs counted on the "
          f"card {counts.flops:.6e} == the dry run's fake count at world 1 "
          f"{fake.flops:.6e} ({diff:.2e} apart), bytes "
          f"{counts.bytes_accessed:.6e} / {fake.bytes_accessed:.6e}; "
          f"model_flops {roof.model_flops:.6e}, "
          f"of it the embedding lookup's {lookup:.6e}: flops_per_device "
          + (">=" if roof.flops_per_device >= roof.model_flops else "<")
          + " model_flops", flush=True)
    print(f"[{card}] {tag} aten ops by output bytes (op, bytes, calls): "
          + "; ".join(f"{op} {b} {n}" for op, b, n
                      in rl.op_byte_profile(counts, 10)), flush=True)
    print(f"[{card}] {tag} memory: the dry run's world-1 peak_est_bytes "
          f"{fake_mem['peak_est_bytes'] / GIB:.2f} GiB (arguments "
          f"{fake_mem['argument_bytes'] / GIB:.2f}, temp "
          f"{fake_mem['temp_bytes'] / GIB:.2f}, outputs "
          f"{fake_mem['output_bytes'] / GIB:.2f}, aliased "
          f"{fake_mem['alias_bytes'] / GIB:.2f}); the real step's "
          f"torch.cuda.max_memory_allocated {peak_gib:.2f} GiB", flush=True)


def phase_4u(card: str, zero_counts, counts) -> dict:
    """The roofline of the card's train and decode steps, and the dry run.
    a: 4s.b's train step (qwen2-moe-a2.7b, 4 layers, batch 4 x 512, remat
    none, router pallas) timed (a warm-up, then 3 steps), then one step
    counted by ``roofline.count``; b: 4q's model at full depth, a prefill
    of 16 at batch 4, 8 decode steps timed, one counted; each held to the
    dry run's fake count at world 1.  c: the dry run's CLI for
    ``DRYRUN_CELLS`` on a fake 16 x 16 group.  Returns the router
    launches of the counted and timed runs and the numbers."""
    import statistics
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import steps
    from repro_torch.models import accounting, stacked
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw

    dev = torch.device("cuda")
    router = ("radix_topk", "bitplane_pack")
    launched = dict.fromkeys(router, 0)
    out = {}

    def run_counted(tag, n_calls, layers, fn):
        zero_counts()
        res = fn()
        torch.cuda.synchronize()
        got = counts()
        expect(all(got[k] == layers * n_calls for k in router), f"{tag}: "
               f"router launches {got}, not {layers} x {n_calls}")
        for k in router:
            launched[k] += got[k]
        return res

    # ---- a. 4s.b's train step
    full = configs.get_config(QWEN_ARCH)
    cfg = dataclasses.replace(cut(full, TRAIN_LAYERS), router_impl="pallas")
    tshape = ShapeConfig("4u.a", TRAIN_SEQ, TRAIN_BATCH, "train")
    ocfg = adamw.AdamWConfig()
    params = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = adamw.init(params, ocfg)
    x, y = pipeline.host_batch(cfg, tshape, 0, device=dev)
    step = steps.make_train_step(cfg, ocfg, remat="none")
    torch.cuda.reset_peak_memory_stats()

    def timed():
        secs = []
        for _ in range(1 + ROOF_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, state, x, y)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return secs

    secs = run_counted("4u.a timed steps", 1 + ROOF_TIMED_STEPS,
                       TRAIN_LAYERS, timed)
    step_ms = statistics.median(secs[1:]) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / GIB
    c = run_counted("4u.a counted step", 1, TRAIN_LAYERS,
                    lambda: rl.count(step, params, state, x, y))
    c.result = None
    del params, state
    torch.cuda.empty_cache()
    fake, fake_mem = fake_count(cfg, tshape)
    roof = rl.analyze(c, 1, accounting.model_flops(cfg, tshape))
    print(f"[{card}] 4u.a {cfg.name} at {TRAIN_LAYERS} layers, bf16, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, remat none, router pallas: "
          f"step times {[round(t * 1e3, 2) for t in secs]} ms (host clock, "
          f"the first a warm-up), median {step_ms:.2f} ms; peak device "
          f"memory {peak_gib:.2f} GiB", flush=True)
    roofline_report(card, "4u.a", c, fake, fake_mem, roof, step_ms,
                    peak_gib, cfg.vocab * cfg.d_model,
                    accounting.active_param_count(cfg))
    out["a"] = {"step_ms": step_ms, "peak_gib": peak_gib,
                "roofline": roof.to_dict(), "flops_fake": fake.flops,
                "peak_est_bytes_fake": fake_mem["peak_est_bytes"]}

    # ---- b. one decode step of 4q's qwen2-moe at full depth, batch 4
    qcfg = dataclasses.replace(full, router_impl="pallas")
    max_len = SERVE_PROMPT + 2 + ROOF_TIMED_STEPS + 8
    params = stacked.init_params(
        qcfg, torch.Generator(device=dev).manual_seed(1), dev)
    caches = stacked.init_cache(qcfg, SERVE_BATCH, max_len, dev)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, qcfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), dtype=torch.int32,
        device=dev)
    prefill = steps.make_prefill_step(qcfg)
    decode = steps.make_decode_step(qcfg)
    logits, _ = prefill(params, prompt, caches)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    pos = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int32,
                     device=dev)
    torch.cuda.reset_peak_memory_stats()

    def decoded():
        secs = []
        for i in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(params, tok, pos + i, caches)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return secs

    secs = run_counted("4u.b timed decode steps", 9, QWEN_LAYERS, decoded)
    dec_ms = statistics.median(secs[1:]) * 1e3
    dec_peak = torch.cuda.max_memory_allocated() / GIB
    c = run_counted("4u.b counted decode step", 1, QWEN_LAYERS,
                    lambda: rl.count(decode, params, tok, pos + 9, caches))
    c.result = None
    del params, caches
    torch.cuda.empty_cache()
    dshape = ShapeConfig("4u.b", max_len, SERVE_BATCH, "decode")
    fake, fake_mem = fake_count(qcfg, dshape)
    roof = rl.analyze(c, 1, accounting.model_flops(qcfg, dshape))
    print(f"[{card}] 4u.b {qcfg.name} at {QWEN_LAYERS} layers, bf16, batch "
          f"{SERVE_BATCH}, cache {max_len}, router pallas: decode step times "
          f"{[round(t * 1e3, 2) for t in secs]} ms (host clock, the first "
          f"a warm-up), median {dec_ms:.2f} ms; peak device memory "
          f"{dec_peak:.2f} GiB", flush=True)
    roofline_report(card, "4u.b", c, fake, fake_mem, roof, dec_ms, dec_peak,
                    qcfg.vocab * qcfg.d_model,
                    accounting.active_param_count(qcfg))
    out["b"] = {"step_ms": dec_ms, "peak_gib": dec_peak,
                "roofline": roof.to_dict(), "flops_fake": fake.flops}

    # ---- c. the dry run's CLI on a fake 16 x 16 group
    dr_dir = ROOT / "build" / "dryrun"
    for arch, shape_name in DRYRUN_CELLS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape_name, "--out", str(dr_dir)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=300)
        secs_c = time.perf_counter() - t0
        expect(proc.returncode == 0 and "bottleneck=" in proc.stdout,
               f"4u.c dryrun {arch} {shape_name}: rc {proc.returncode}\n"
               f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        rec = json.loads((dr_dir / f"{arch}__{shape_name}__16x16.json")
                         .read_text())
        r, m = rec["roofline"], rec["memory"]
        print(f"4u.c dryrun {arch} x {shape_name} x 16x16 ({rec['chips']} "
              f"ranks, torch {torch.__version__}): {secs_c:.1f} s; "
              f"bottleneck={r['bottleneck']}, terms(s)=C{r['compute_s']:.4f}"
              f"/M{r['memory_s']:.4f}/X{r['collective_s']:.4f}, "
              f"useful_ratio {r['useful_ratio']:.4f}; peak_est_bytes a rank "
              f"{m['peak_est_bytes'] / GIB:.2f} GiB against the card's "
              f"{CARD_GIB} GiB", flush=True)
        sites = [ln.strip() for ln in proc.stdout.splitlines()
                 if "collective bytes by site" in ln]
        print(f"4u.c dryrun {arch} x {shape_name}: "
              + (sites[0] if sites else "no site line"), flush=True)
        out[f"c {arch} {shape_name}"] = rec
    out["launches"] = launched
    return out


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

    # ---- 4q. the model zoo's serving path: qwen2-moe-a2.7b at full width
    # and depth through the --oneshot CLI, router parity, float32 decode
    # against forward, olmo-1b at full size
    t0 = time.perf_counter()
    serve_q = phase_4q(card, zero_counts, counts)
    for name, n in serve_q["launches"].items():
        slice_launches[name] += n
    print(f"phase 4q: {time.perf_counter() - t0:.1f} s; launches of the "
          f"counted runs {serve_q['launches']}", flush=True)

    # ---- 4r. the other five archs: deepseek-v2 at full width through the
    # fused router, mamba2, zamba2 and musicgen at full size through the
    # CLI, llama-3.2-vision with its frontend stub; float32 decode against
    # forward for each new layer kind
    t0 = time.perf_counter()
    serve_r = phase_4r(card, zero_counts, counts)
    for name, n in serve_r["launches"].items():
        slice_launches[name] += n
    print(f"phase 4r: {time.perf_counter() - t0:.1f} s; launches of the "
          f"counted runs {serve_r['launches']}; peak device memory a step "
          + ", ".join(f"{k} {v:.2f} GiB"
                      for k, v in serve_r["peaks_gib"].items()), flush=True)

    # ---- 4s. training on one card: the card against the host at a reduced
    # size, qwen2-moe-a2.7b at its published widths (4 layers) through
    # train() with router parity and a checkpoint's resume, olmo-1b whole
    # through the CLI, the descent check
    t0 = time.perf_counter()
    train_s = phase_4s(card, zero_counts, counts)
    for name, n in train_s["launches"].items():
        slice_launches[name] += n
    print(f"phase 4s: {time.perf_counter() - t0:.1f} s; launches of the "
          f"counted runs {train_s['launches']}", flush=True)

    # ---- 4t. sharded execution at world 1: train(mesh=...) and serving
    # under a (1, 1) NCCL mesh against the one-card paths, bit for bit
    t0 = time.perf_counter()
    shard_t = phase_4t(card, zero_counts, counts, train_s["b"]["losses"])
    for name, n in shard_t["launches"].items():
        slice_launches[name] += n
    print(f"phase 4t: {time.perf_counter() - t0:.1f} s; launches of the "
          f"counted runs {shard_t['launches']}", flush=True)

    # ---- 4u. the roofline of the card's train and decode steps, held to
    # the dry run's fake count, and the dry run on a fake 16 x 16 group
    t0 = time.perf_counter()
    roof_u = phase_4u(card, zero_counts, counts)
    for name, n in roof_u["launches"].items():
        slice_launches[name] += n
    print(f"phase 4u: {time.perf_counter() - t0:.1f} s; launches of the "
          f"counted runs {roof_u['launches']}", flush=True)

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
