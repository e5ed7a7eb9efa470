"""Trace gate: every registered engine's core and every kernel entry over a
(fmt x N x k x B) grid, shapes and dtypes checked, in seconds.

On the CPU each entry runs under ``FakeTensorMode``: shapes and dtypes
propagate through every op without computing a value.  An entry whose
host loop reads a scalar of the data (the TNS machines, the fused
controller's plain version) raises ``DataDependentOutputException``
there, and runs for real instead on the grid's tiny inputs — the case
records which way it ran (``how``: "fake" or "host").  On the card
(``how`` "card") each target runs on CUDA tensors: every kernel target
launches its kernel for real (its launch count must grow), and every
output's shape and dtype must equal the CPU run's of the same case, on
the card.  Breakage it catches: an output whose shape or dtype drifted, a
kernel wrapper that no longer takes what its callers pass, an engine
whose declared ``formats`` its core cannot run.

Engines whose core is a host oracle (``tns-oracle``, ``bts``,
``bitslice``, as the reference package maps them) and every engine,
lazily built ``resilient:*`` wrappers included, are checked against the
engine-contract call signature::

    fn(x, *, width, fmt, k, ascending, level_bits, stop_after, device)

Targets and cases carry the reference gate's names, with the reference's
``pallas-*`` engines under the port's ``fused-*`` names.  Run via
``python -m repro_torch.analysis --trace-gate [--device cpu]``.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode)

from repro_torch.core import bitplane as bp
from repro_torch.core import radix_select as rs
from repro_torch.core import tns as tt
from repro_torch.kernels import (backend, bitplane_pack, digit_read,
                                 fused_tns, masked_matmul, radix_topk)
from repro_torch.sort import registry

#: per-format word width used across the test suite
WIDTHS = {bp.UNSIGNED: 8, bp.TWOS: 8, bp.SIGNMAG: 16, bp.FLOAT: 16}

_SIGNED = (bp.SIGNMAG, bp.FLOAT)

#: the kernel module each kernel target launches through
KERNEL_MODULES = {
    "kernel:fused_tns": fused_tns, "kernel:radix_topk": radix_topk,
    "kernel:min_search": digit_read, "kernel:pack_keys": bitplane_pack,
    "kernel:pruned_matmul": masked_matmul,
}


@dataclasses.dataclass(frozen=True)
class GateResult:
    target: str                     # "engine:tns", "kernel:min_search", ...
    case: str                       # "fmt=float N=24 k=2 B=2"
    ok: bool
    detail: str = ""
    how: str = ""                   # contract | fake | host | card

    def format(self) -> str:
        status = "ok" if self.ok else "FAIL"
        tail = f" — {self.detail}" if self.detail and not self.ok else ""
        return f"{status:4s} {self.target:24s} {self.case} [{self.how}]" \
               f"{tail}"


def _run(target: str, case: str,
         fn: Callable[[], Tuple[Optional[str], str]]) -> GateResult:
    try:
        detail, how = fn()
    except Exception as e:          # trace errors are the gate's product
        detail, how = f"{type(e).__name__}: {e}", ""
    return GateResult(target, case, detail is None, detail or "", how)


# ---------------------------------------------------------------------------
# One case: inputs, the entry, the outputs it must give.
# ---------------------------------------------------------------------------

Spec = Tuple[str, Tuple[int, ...], torch.dtype]


def _outputs(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _expect(outs: Sequence[torch.Tensor], specs: Sequence[Spec]
            ) -> Optional[str]:
    for got, (what, shape, dtype) in zip(outs, specs):
        if tuple(got.shape) != shape:
            return f"{what}: shape {tuple(got.shape)} != expected {shape}"
        if got.dtype != dtype:
            return f"{what}: dtype {got.dtype} != expected {dtype}"
    return None


def _on_cpu(fn: Callable, inputs: Sequence) -> Tuple[list, str]:
    """``fn`` over fake copies of ``inputs`` ("fake"); where its host loop
    reads a scalar of the data, over the real inputs ("host")."""
    try:
        with FakeTensorMode() as mode:
            fake = [mode.from_tensor(t) if isinstance(t, torch.Tensor)
                    else t for t in inputs]
            return _outputs(fn(*fake)), "fake"
    except (DataDependentOutputException, DynamicOutputShapeException):
        return _outputs(fn(*inputs)), "host"


def _case(target: str, fn: Callable, inputs: Sequence[Optional[np.ndarray]],
          specs: Sequence[Spec], device: torch.device
          ) -> Tuple[Optional[str], str]:
    """Run one case on ``device`` and check its outputs against ``specs``;
    on the card, also against the CPU run of the same inputs, and a
    kernel target must launch its kernel."""
    cpu = [None if a is None else torch.from_numpy(a) for a in inputs]
    outs, how = _on_cpu(fn, cpu)
    err = _expect(outs, specs)
    if err or device.type == "cpu":
        return err, how
    mod = KERNEL_MODULES.get(target)
    before = mod.LAUNCHES if mod is not None else 0
    card = _outputs(fn(*[None if t is None else t.to(device) for t in cpu]))
    torch.cuda.synchronize(device)
    if mod is not None and mod.LAUNCHES == before:
        return f"{target} did not launch its kernel", "card"
    for got, want, (what, _, _) in zip(card, outs, specs):
        if got.device.type != device.type:
            return f"{what}: on {got.device}, not {device}", "card"
        if (tuple(got.shape), got.dtype) != (tuple(want.shape), want.dtype):
            return (f"{what}: {tuple(got.shape)} {got.dtype} on the card, "
                    f"{tuple(want.shape)} {want.dtype} on the CPU"), "card"
    return _expect(card, specs), "card"


def _bits(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 2, shape).astype(np.uint8)


def _sign(rng, fmt: str, shape, dtype=np.bool_) -> Optional[np.ndarray]:
    return rng.integers(0, 2, shape).astype(dtype) if fmt in _SIGNED \
        else None


# ---------------------------------------------------------------------------
# Core tracers.
# ---------------------------------------------------------------------------


def _trace_tns(fmt: str, n: int, k: int, device, rng):
    width = WIDTHS[fmt]
    return _case(
        "core:tns", functools.partial(tt.tns_sort_planes, k=k, fmt=fmt),
        [_bits(rng, (width, n)), _sign(rng, fmt, (n,))],
        [("perm", (n,), torch.int32), ("cycles", (), torch.int32),
         ("drs", (), torch.int32)], device)


def _trace_tns_batched(fmt: str, n: int, k: int, b: int, device, rng):
    width = WIDTHS[fmt]
    return _case(
        "core:tns-batched",
        functools.partial(tt.tns_sort_planes_batched, k=k, fmt=fmt),
        [_bits(rng, (b, width, n)), _sign(rng, fmt, (b, n))],
        [("perm", (b, n), torch.int32), ("cycles", (b,), torch.int32)],
        device)


def _trace_ml(fmt: str, n: int, k: int, device, rng):
    # the ml engine linearizes every format to unsigned keys and runs the
    # radix-2^n machine; trace the level_bits=4 digit-plane core
    width = WIDTHS[fmt]
    digits = rng.integers(0, 16, (width // 4, n)).astype(np.uint8)
    return _case(
        "core:ml", functools.partial(tt.tns_sort_planes, k=k,
                                     fmt=bp.UNSIGNED, level_bits=4),
        [digits, None], [("perm", (n,), torch.int32)], device)


def _trace_radix(fmt: str, n: int, b: Optional[int], device, rng):
    width = WIDTHS[fmt]
    shape = (n,) if b is None else (b, n)
    keys = rng.integers(0, 1 << width, shape).astype(np.int32)
    return _case(
        "core:radix", functools.partial(rs.radix_sort_keys, r=4,
                                        width=width),
        [keys], [("perm", shape, torch.int32)], device)


def _trace_fused_tns(fmt: str, n: int, k: int, b: int, device, rng):
    width = WIDTHS[fmt]
    return _case(
        "kernel:fused_tns",
        functools.partial(fused_tns.fused_tns_planes, k=k, fmt=fmt),
        [_bits(rng, (b, width, n)), _sign(rng, fmt, (b, n), np.uint8)],
        [("perm", (b, n), torch.int32), ("cycles", (b,), torch.int32),
         ("drs", (b,), torch.int32), ("reload_cycles", (b,), torch.int32),
         ("useful_drs", (b,), torch.int32)], device)


def _trace_topk(n: int, k: int, b: int, device, rng):
    kk = max(k, 1)
    keys = rng.integers(-2**31, 2**31, (b, n)).astype(np.int32)
    return _case(
        "kernel:radix_topk",
        lambda x: radix_topk.topk_keys(x, kk),
        [keys], [("keys", (b, kk), torch.int32),
                 ("indices", (b, kk), torch.int32)], device)


# ---------------------------------------------------------------------------
# Kernel tracers (format-agnostic: uint8 planes / int32 key bits).
# ---------------------------------------------------------------------------


def _trace_min_search(n: int, b: int, device, rng):
    return _case(
        "kernel:min_search", lambda p: digit_read.min_search(p),
        [_bits(rng, (b, 8, n))],
        [("mask", (b, n), torch.bool), ("drs", (b,), torch.int32)], device)


def _trace_pack_roundtrip(n: int, b: int, device, rng):
    def roundtrip(x):
        keys = bitplane_pack.pack_keys(x)
        return keys, bitplane_pack.unpack_keys_f32(keys)

    return _case(
        "kernel:pack_keys", roundtrip,
        [rng.standard_normal((b, n)).astype(np.float32)],
        [("keys", (b, n), torch.int32), ("values", (b, n), torch.float32)],
        device)


def _trace_pruned_matmul(n: int, device, rng):
    return _case(
        "kernel:pruned_matmul", masked_matmul.pruned_matmul,
        [rng.standard_normal((n, n)).astype(np.float32),
         rng.standard_normal((n, n)).astype(np.float32),
         rng.integers(0, 2, n).astype(np.bool_)],
        [("out", (n, n), torch.float32)], device)


# ---------------------------------------------------------------------------
# Engine contract binding.
# ---------------------------------------------------------------------------


def _bind_contract(spec: "registry.EngineSpec", fmt: str, device
                   ) -> Tuple[Optional[str], str]:
    try:
        sig = inspect.signature(spec.fn)
    except (TypeError, ValueError):
        return None, "contract"     # builtins / C callables: skip
    try:
        sig.bind(None, width=WIDTHS[fmt], fmt=fmt, k=2, ascending=True,
                 level_bits=1, stop_after=None, device=device)
    except TypeError as e:
        return f"engine fn does not bind the canonical contract: {e}", \
            "contract"
    return None, "contract"


#: engine name -> the core its gate case runs.  Engines sharing a core
#: (tns / mb / mb-ft / resilient:*) are run once via the shared entry
#: here; host-oracle engines have no entry and get the signature-contract
#: check only.
ENGINE_CORES: Dict[str, str] = {
    "tns": "tns", "mb": "tns", "mb-ft": "tns",
    "ml": "ml",
    "radix": "radix",
    "fused-topk": "fused-topk",
    "fused-tns": "fused-tns",
    "tns-oracle": "host", "bts": "host", "bitslice": "host",
}


def run_gate(ns: Sequence[int] = (8, 24), ks: Sequence[int] = (0, 2),
             batches: Sequence[int] = (2,), device=None
             ) -> List[GateResult]:
    """Run every registered engine's core and every kernel entry on
    ``device`` (the card unless named; raises without one); returns one
    result per (target, case).  All-ok iff every result's ``ok`` is
    True.  Inputs come from ``np.random.default_rng(0)``."""
    dev = backend.resolve_device(device)
    rng = np.random.default_rng(0)
    results: List[GateResult] = []
    engines = registry.available_engines()

    # lazily-built resilient wrappers join the contract check
    specs = dict(engines)
    for name in sorted(engines):
        if not name.startswith("resilient:"):
            try:
                specs[f"resilient:{name}"] = \
                    registry.get_engine(f"resilient:{name}")
            except KeyError:
                pass

    for name in sorted(specs):
        spec = specs[name]
        for fmt in spec.formats:
            results.append(_run(
                f"engine:{name}", f"contract fmt={fmt}",
                functools.partial(_bind_contract, spec, fmt, dev)))

    def run(target, case, tracer, *args):
        results.append(_run(target, case, functools.partial(
            tracer, *args, dev, rng)))

    traced_cores = set()
    for name in sorted(engines):
        core = ENGINE_CORES.get(name.split(":", 1)[-1])
        if core is None:
            results.append(GateResult(
                f"engine:{name}", "core", False,
                "engine has no trace-gate core mapping; add one to "
                "repro_torch.analysis.trace_gate.ENGINE_CORES"))
            continue
        if core in ("host",) or core in traced_cores:
            continue
        traced_cores.add(core)
        spec = engines[name]
        for fmt in spec.formats:
            for n in ns:
                for k in ks:
                    case = f"fmt={fmt} N={n} k={k}"
                    if core == "tns":
                        run("core:tns", case, _trace_tns, fmt, n, k)
                        for b in batches:
                            run("core:tns-batched", f"{case} B={b}",
                                _trace_tns_batched, fmt, n, k, b)
                    elif core == "ml" and k == ks[-1]:
                        run("core:ml", case, _trace_ml, fmt, n, k)
                    elif core == "radix" and k == ks[0]:
                        run("core:radix", f"fmt={fmt} N={n}",
                            _trace_radix, fmt, n, None)
                        for b in batches:
                            run("core:radix", f"fmt={fmt} N={n} B={b}",
                                _trace_radix, fmt, n, b)
                    elif core == "fused-topk" and fmt == spec.formats[0]:
                        for b in batches:
                            run("kernel:radix_topk", f"N={n} k={k} B={b}",
                                _trace_topk, n, k, b)
                    elif core == "fused-tns":
                        for b in batches:
                            run("kernel:fused_tns", f"{case} B={b}",
                                _trace_fused_tns, fmt, n, k, b)

    for n in ns:
        for b in batches:
            run("kernel:min_search", f"N={n} B={b}", _trace_min_search,
                n, b)
            run("kernel:pack_keys", f"N={n} B={b}", _trace_pack_roundtrip,
                n, b)
        run("kernel:pruned_matmul", f"N={n}", _trace_pruned_matmul, n)
    return results


def format_results(results: Sequence[GateResult],
                   verbose: bool = False) -> str:
    lines = [r.format() for r in results if verbose or not r.ok]
    n_fail = sum(1 for r in results if not r.ok)
    lines.append(f"trace gate: {len(results)} traces, {n_fail} failed")
    return "\n".join(lines)
