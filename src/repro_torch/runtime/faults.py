"""Declarative device-fault injection for the sort engines (paper Fig. S28).

The paper's premise is sorting on *imperfect* physical memory: multi-level
cells mis-read at a calibrated ~1.2% programming-failure rate and the
PointNet++ workload tolerates ~20% BER with graceful accuracy degradation.
This module makes those non-idealities first-class: a :class:`FaultSpec`
describes the fault processes of one array —

* ``ber`` — per-bit read-error probability (overlapping conductance
  states, :func:`repro_torch.core.device_model.apply_ber`'s process),
  re-sampled on EVERY read, so redundant reads see independent noise;
* ``stuck_zero`` / ``stuck_one`` — fractions of cells stuck at a rail
  (forming failures); persistent, the same cells on every read;
* ``dead_banks`` — whole banks whose cells all read 0 (a lost array in the
  multi-bank §2.3.1 layout; banks shard the number axis);
* ``delay_s`` / ``delay_prob`` — straggler reads (a slow or lost shard);

— and :func:`inject` installs it as a context manager hooking the
bit-plane read path (:func:`repro_torch.core.bitplane.read_planes`), so
faults reach every engine through the same interface real conductance noise
would: the digit planes the controller reads.  Throughput engines
(``radix``, ``fused-topk``) never read the array and therefore see no
injected faults — they are the software baselines, not device models.

Two *repair* processes can also be switched on per read (the resilient
wrapper escalates through them, ``repro_torch.sort.resilient``):

* ``redundant_reads=R`` — read the planes R times and majority-vote; fixes
  independent per-read BER, not persistent stuck/dead cells;
* ``parity_ecc`` — a per-number Hamming SEC code across the digit planes
  (log2(W)+1 extra parity planes, programmed alongside the data): any
  single flipped bit in a number's column is located and corrected.

Everything is deterministic given ``seed``: per-read randomness derives
from ``(seed, read_counter)``, persistent cell masks from ``seed`` alone.
The draws are numpy's, on the host planes before they are carried to the
device, so one spec flips the same bits here as in the reference package,
whatever device the engine then runs on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core import bitplane as bp


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One array's fault processes + the repair/retry policy knobs the
    resilient wrapper consumes.  Immutable; derive variants via
    :meth:`with_`."""
    ber: float = 0.0                 # per-bit flip probability per read
    stuck_zero: float = 0.0          # fraction of cells stuck at 0
    stuck_one: float = 0.0           # fraction of cells stuck at 1
    dead_banks: Tuple[int, ...] = () # bank indices reading all-0
    banks: int = 4                   # bank layout (N sharded, §2.3.1)
    delay_s: float = 0.0             # straggler: sleep per delayed read
    delay_prob: float = 0.0
    seed: int = 0
    # read-time repair processes (escalated by repro_torch.sort.resilient)
    redundant_reads: int = 1         # R reads + majority vote when > 1
    parity_ecc: bool = False         # Hamming SEC across digit planes
    # repair policy
    repair_reads: int = 3            # R the wrapper uses when it votes
    max_retries: int = 3             # full-retry budget after the ladder

    def with_(self, **kw) -> "FaultSpec":
        return dataclasses.replace(self, **kw)

    def without_dead_banks(self) -> "FaultSpec":
        """The spec after re-programming dead banks' data onto survivors."""
        return self.with_(dead_banks=())

    @property
    def faulty(self) -> bool:
        """Does any physical fault process fire on reads?"""
        return (self.ber > 0 or self.stuck_zero > 0 or self.stuck_one > 0
                or bool(self.dead_banks)
                or (self.delay_s > 0 and self.delay_prob > 0))


def parse_spec(text: str) -> FaultSpec:
    """Parse ``"ber=0.01,banks=4,dead_banks=1:2,seed=0"`` (the
    ``--fault-spec`` CLI syntax; dead banks are colon-separated)."""
    kw = {}
    for part in filter(None, (p.strip() for p in text.split(","))):
        key, val = part.split("=", 1)
        key = key.strip().replace("-", "_")
        if key == "dead_banks":
            kw[key] = tuple(int(t) for t in val.split(":") if t)
        elif key in ("banks", "seed", "redundant_reads", "repair_reads",
                     "max_retries"):
            kw[key] = int(val)
        elif key == "parity_ecc":
            kw[key] = val.strip().lower() in ("1", "true", "yes", "on")
        else:
            kw[key] = float(val)
    return FaultSpec(**kw)


@dataclasses.dataclass
class FaultCounters:
    """Mutable tallies shared across nested injection contexts."""
    reads: int = 0                   # hook invocations (array reads)
    faults_injected: int = 0         # raw bit faults drawn (pre-correction)
    corrected: int = 0               # single-bit ECC corrections
    votes: int = 0                   # majority-vote read groups taken
    delays: int = 0                  # straggler reads


class Injector:
    """The installed read hook: corrupts (and optionally repairs) every
    digit-plane matrix the engines read, deterministically."""

    def __init__(self, spec: FaultSpec,
                 counters: Optional[FaultCounters] = None):
        self.spec = spec
        self.counters = counters if counters is not None else FaultCounters()
        self._draw = itertools.count()

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng((self.spec.seed, next(self._draw)))

    # -- the bp.read_planes hook -------------------------------------------
    def read(self, planes: np.ndarray, *, kind: str = "bit",
             level_bits: int = 1, banks: Optional[int] = None) -> np.ndarray:
        spec = self.spec
        self.counters.reads += 1
        if spec.delay_s > 0 and spec.delay_prob > 0 \
                and self._rng().random() < spec.delay_prob:
            self.counters.delays += 1
            time.sleep(spec.delay_s)
        if not (spec.ber > 0 or spec.stuck_zero > 0 or spec.stuck_one > 0
                or spec.dead_banks):
            return planes
        planes = np.asarray(planes)
        if kind == "digit":
            bits = _digits_to_bits(planes, level_bits)
        else:
            bits = planes.astype(np.uint8)
        if spec.parity_ecc:
            code = _hamming_encode(bits)
            read = self._read_bits(code, banks)
            out, ncorr = _hamming_decode(read, bits.shape[-2])
            self.counters.corrected += ncorr
        else:
            out = self._read_bits(bits, banks)
        if kind == "digit":
            return _bits_to_digits(out, level_bits,
                                   planes.shape[-2]).astype(planes.dtype)
        return out.astype(planes.dtype)

    def _read_bits(self, bits: np.ndarray,
                   banks: Optional[int]) -> np.ndarray:
        """One physical read of a 0/1 matrix: persistent cell faults, then
        per-read BER (majority-voted over R samples when requested)."""
        spec = self.spec
        base = bits
        if spec.stuck_zero > 0 or spec.stuck_one > 0:
            # persistent: same cells every read of a same-shaped array
            prng = np.random.default_rng((spec.seed, 0xC311) + bits.shape)
            u = prng.random(bits.shape)
            stuck0 = u < spec.stuck_zero
            stuck1 = (u >= spec.stuck_zero) & \
                     (u < spec.stuck_zero + spec.stuck_one)
            base = np.where(stuck0, 0, np.where(stuck1, 1, base))
            base = base.astype(np.uint8)
            self.counters.faults_injected += int((base != bits).sum())
        if spec.dead_banks:
            nb = int(banks) if banks else spec.banks
            n = bits.shape[-1]
            per = -(-n // nb)
            dead = np.zeros(n, dtype=bool)
            for b in spec.dead_banks:
                if 0 <= b < nb:
                    dead[b * per:(b + 1) * per] = True
            before = base
            base = np.where(dead, 0, base).astype(np.uint8)
            self.counters.faults_injected += int((base != before).sum())
        if spec.ber <= 0:
            return base
        R = max(1, spec.redundant_reads)
        if R == 1:
            flips = (self._rng().random(base.shape) < spec.ber)
            self.counters.faults_injected += int(flips.sum())
            return (base ^ flips.astype(np.uint8)).astype(np.uint8)
        self.counters.votes += 1
        acc = np.zeros(base.shape, dtype=np.int32)
        for _ in range(R):
            flips = (self._rng().random(base.shape) < spec.ber)
            self.counters.faults_injected += int(flips.sum())
            acc += base ^ flips.astype(np.uint8)
        return (acc * 2 > R).astype(np.uint8)


# ---------------------------------------------------------------------------
# Installation: a stack of injectors; the top one is the active read hook.
# ---------------------------------------------------------------------------

_STACK: List[Injector] = []


def current() -> Optional[Injector]:
    """The innermost active injector, or None outside any context."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def inject(spec: FaultSpec, counters: Optional[FaultCounters] = None):
    """Install ``spec`` as the active fault process for every bit-plane
    read in the dynamic extent.  Nested contexts replace the outer one
    (the resilient wrapper re-enters with repair processes switched on);
    pass ``counters`` to accumulate tallies across nesting levels."""
    inj = Injector(spec, counters)
    _STACK.append(inj)
    prev = bp.set_read_hook(inj.read)
    try:
        yield inj
    finally:
        bp.set_read_hook(prev)
        _STACK.pop()


def probe_dead_banks(spec: FaultSpec, banks: Optional[int] = None,
                     heartbeat: Optional[Heartbeat] = None) -> List[int]:
    """Heartbeat-based liveness probe of the bank set: every bank posts an
    initial beat, live banks refresh within the timeout window, dead banks
    (which in hardware simply never answer) go stale and land on the
    suspect list.  This is the detection half of the §2.3.1 fault story;
    :func:`elastic_remesh` is the recovery half."""
    nb = int(banks) if banks else spec.banks
    hb = heartbeat or Heartbeat(interval_s=0.004, timeout_s=0.012)
    for b in range(nb):
        hb.beat(f"bank{b}")
    time.sleep(hb.timeout + 0.004)
    for b in range(nb):
        if b not in spec.dead_banks:
            hb.beat(f"bank{b}")
    return sorted(int(h[4:]) for h in hb.suspects()
                  if h.startswith("bank") and int(h[4:]) < nb)


# ---------------------------------------------------------------------------
# Bit/digit plumbing + the Hamming SEC parity planes.
# ---------------------------------------------------------------------------


def _digits_to_bits(digits: np.ndarray, n: int) -> np.ndarray:
    """(..., D, N) radix-2^n digits -> (..., D*n, N) binary planes."""
    shifts = np.arange(n - 1, -1, -1, dtype=np.uint32)
    bits = ((digits.astype(np.uint32)[..., None, :] >> shifts[:, None]) & 1)
    s = digits.shape
    return bits.reshape(s[:-2] + (s[-2] * n, s[-1])).astype(np.uint8)


def _bits_to_digits(bits: np.ndarray, n: int, ndig: int) -> np.ndarray:
    s = bits.shape
    b = bits.reshape(s[:-2] + (ndig, n, s[-1])).astype(np.uint32)
    shifts = np.arange(n - 1, -1, -1, dtype=np.uint32)
    return np.sum(b << shifts[:, None], axis=-2).astype(np.uint32)


def _n_parity(d: int) -> int:
    r = 1
    while (1 << r) < d + r + 1:
        r += 1
    return r


def _hamming_layout(d: int):
    r = _n_parity(d)
    total = d + r
    pos = np.arange(1, total + 1)
    is_par = (pos & (pos - 1)) == 0
    return r, total, pos, is_par


def _hamming_encode(bits: np.ndarray) -> np.ndarray:
    """Extend (..., D, N) binary planes with Hamming SEC parity planes,
    (..., D+r, N) — the parity planes the array would store alongside the
    data, computed at program time (before read faults)."""
    d = bits.shape[-2]
    r, total, pos, is_par = _hamming_layout(d)
    code = np.zeros(bits.shape[:-2] + (total, bits.shape[-1]), np.uint8)
    code[..., ~is_par, :] = bits
    for j in range(r):
        cover = ((pos & (1 << j)) != 0) & ~is_par
        parity = code[..., cover, :].sum(axis=-2) % 2
        code[..., pos == (1 << j), :] = parity[..., None, :]
    return code


def _hamming_decode(code: np.ndarray, d: int):
    """Correct single-bit errors per number column; returns (data planes,
    number of corrections applied)."""
    r, total, pos, is_par = _hamming_layout(d)
    syndrome = np.zeros(code.shape[:-2] + (code.shape[-1],), np.int64)
    for j in range(r):
        cover = (pos & (1 << j)) != 0
        syndrome += (code[..., cover, :].sum(axis=-2) % 2).astype(np.int64) << j
    err = (syndrome >= 1) & (syndrome <= total)
    row = np.clip(syndrome - 1, 0, total - 1)
    onehot = (np.arange(total)[:, None] == row[..., None, :]) & \
        err[..., None, :]
    fixed = code ^ onehot.astype(np.uint8)
    return fixed[..., ~is_par, :], int(err.sum())


# ---------------------------------------------------------------------------
# Fault-tolerance *runtime*: heartbeats, straggler detection, step retries,
# and elastic re-meshing, around a multi-device run:
#
# * ``Heartbeat``: background liveness thread per host; a missed deadline
#   marks the host suspect and triggers checkpoint-restore-rescale.
# * ``StragglerMonitor``: EMA of per-step wall time; steps slower than
#   ``threshold x`` EMA are flagged (the usual mitigation is re-sharding
#   around the slow host, which ``elastic_remesh`` prepares).
# * ``run_step_with_retries``: transient-failure wrapper (preemption, a
#   flaky link) with exponential backoff.
# * ``elastic_remesh``: rebuilds the device grid from the surviving device
#   set — elastic scale-down/up.
# ---------------------------------------------------------------------------


class Heartbeat:
    def __init__(self, interval_s: float = 5.0, timeout_s: float = 15.0):
        self.interval = interval_s
        self.timeout = timeout_s
        self._beats: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, host: str = "host0") -> None:
        with self._lock:
            self._beats[host] = time.monotonic()

    def suspects(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return [h for h, t in self._beats.items()
                    if now - t > self.timeout]

    def start_self_beat(self, host: str = "host0") -> None:
        def loop():
            while not self._stop.is_set():
                self.beat(host)
                self._stop.wait(self.interval)
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, join_timeout_s: float = 2.0) -> None:
        """Stop the self-beat thread; a wedged beat thread (e.g. blocked on
        a dead link) is abandoned after ``join_timeout_s`` rather than
        hanging shutdown — it is a daemon thread either way."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=join_timeout_s)
            self._thread = None


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    decay: float = 0.9
    ema: Optional[float] = None
    flagged_steps: int = 0

    def observe(self, step_time_s: float) -> bool:
        """Returns True if this step counts as a straggler event."""
        if self.ema is None:
            self.ema = step_time_s
            return False
        is_straggler = step_time_s > self.threshold * self.ema
        if is_straggler:
            self.flagged_steps += 1
        else:
            # only fold healthy steps into the EMA so one slow host does
            # not mask the next
            self.ema = self.decay * self.ema + (1 - self.decay) * step_time_s
        return is_straggler


def run_step_with_retries(fn: Callable, *args, retries: int = 3,
                          backoff_s: float = 0.5, jitter: float = 0.25,
                          retry_on=(RuntimeError,),
                          on_retry: Optional[Callable[[int, Exception], None]] = None,
                          rng: Optional[np.random.Generator] = None,
                          **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying transient failures with
    exponential backoff.  ``jitter`` spreads the sleep by up to that
    fraction so a fleet of retrying steps does not thundering-herd the
    same resource on the same schedule.  ``rng`` draws the jitter; pass a
    generator seeded per worker so retry timing is reproducible per seed
    (the default is seeded so bare calls stay deterministic too)."""
    if rng is None:
        rng = np.random.default_rng(0)
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:  # transient: preemption, link flap, ...
            if attempt == retries:
                raise
            if on_retry:
                on_retry(attempt, e)
            time.sleep(delay * (1.0 + jitter * float(rng.random())))
            delay *= 2


def best_mesh_shape(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid for the surviving device count, keeping
    the model axis if divisible, else shrinking it."""
    mp = model_parallel
    while mp > 1 and n_devices % mp != 0:
        mp //= 2
    return (n_devices // mp, mp)


class DeviceGrid(NamedTuple):
    """A (data, model) grid of ``torch.device``s with its axis names: what
    :func:`elastic_remesh` lays out when no process group is up (one
    process, no collective)."""
    devices: np.ndarray              # (dp, mp) object array of devices
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


# the grid's earlier name; a mesh collectives run over is torch's
# ``torch.distributed.device_mesh.DeviceMesh``
DeviceMesh = DeviceGrid


def elastic_remesh(devices: Sequence, model_parallel: int,
                   axis_names=("data", "model")):
    """Rebuild a mesh from the survivors (scale-down after failure or
    scale-up after repair): the largest (data, model) grid of
    :func:`best_mesh_shape` over the first of them.  With a process group
    up, ``devices`` are ranks and the result is a ``DeviceMesh`` that
    collectives run over; every rank of the group must call it (building a
    mesh is collective), and ranks outside it hold nothing of what is
    placed on it.  Without one, they are devices and the result a
    :class:`DeviceGrid`."""
    import torch.distributed as dist
    n = len(devices)
    dp, mp = best_mesh_shape(n, model_parallel)
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import DeviceMesh as TorchMesh
        from repro_torch.launch import mesh as mesh_lib
        ranks = torch.tensor([int(r) for r in devices[: dp * mp]])
        return TorchMesh(mesh_lib.device_type(), ranks.reshape(dp, mp),
                         mesh_dim_names=tuple(axis_names))
    grid = np.empty(dp * mp, dtype=object)
    grid[:] = [torch.device(d) for d in devices[: dp * mp]]
    return DeviceGrid(grid.reshape(dp, mp), tuple(axis_names))


def reshard_state(state, mesh, spec_fn: Callable) -> object:
    """Re-shard a state tree onto ``mesh`` using ``spec_fn(path, leaf) ->
    spec`` (a tuple, as ``launch.sharding`` gives): the elastic-rescale
    restore path.  Each leaf is made whole first (a DTensor is gathered
    over its old mesh, on every rank of it), then placed; ranks outside
    ``mesh`` hold empty shards."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch import tree
    from repro_torch.launch import sharding
    dev = sharding.mesh_device(mesh)

    def one(path, leaf):
        whole = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        return distribute_tensor(
            whole.to(dev), mesh,
            sharding.placements(mesh, spec_fn(path, leaf)),
            src_data_rank=None)

    return tree.map_with_path(one, state)
