"""Roofline terms of one step, counted by running it: the port of
``repro.launch.roofline``.

Three terms per (arch x shape x mesh), all in seconds-per-step on the
TARGET hardware (one NVIDIA H100 SXM a rank):

  compute    = FLOPs_per_rank / PEAK_FLOPS
  memory     = bytes_accessed_per_rank / HBM_BW
  collective = collective_bytes_per_rank / LINK_BW

The reference reads these from XLA: ``compiled.cost_analysis()`` for the
FLOPs and bytes of the SPMD-partitioned module, the optimized HLO for the
collectives.  PyTorch runs eagerly, so :func:`count` runs the step once
under a dispatch mode and counts each aten op as it runs, for this rank:

* FLOPs: the formulas of ``torch.utils.flop_counter`` (the ones
  ``FlopCounterMode`` applies), with the products ``aten::mm.dtype`` and
  ``aten::bmm.dtype`` (bfloat16 operands, float32 out: ``layers.matmul_f32``
  on the card) counted as their plain forms, 2*M*K*N a product.  An op on
  DTensors is counted by the work of its local shard: its global FLOPs
  divided by the mesh dims its output is sharded or partial over (a dim
  that replicates the output makes every rank do all of it).
* Bytes accessed: the bytes of every op's tensor inputs and outputs;
  views (``_unsafe_view`` among them), bare allocations (``empty``) and
  collectives are left out.  In an eager program each op is a kernel that
  reads its inputs and writes its outputs, so this is XLA's "bytes
  accessed" with no fusion.
* Collectives: output-shape bytes and counts by the reference's five HLO
  names, from the functional ops (``_c10d_functional.all_gather_into_tensor``
  and the rest: DTensor's redistributions, ``full_tensor()``) and the
  in-place ones that ``dist.all_reduce`` and its kin issue
  (``c10d.allreduce_``: the tensor-parallel collectives of
  ``models/shard.py``, ``steps.shard_reduce``).  Point-to-point ops and
  ``broadcast_`` are not counted: no step issues one, and no DTensor
  redistribution does.  ``Counts.sites`` holds their bytes by the code
  that issued them: the innermost function of ``repro_torch`` outside
  ``models/shard.py`` and ``tree.py`` (a collective of the backward pass
  counts under the function that called it, ``steps.py:_value_and_grad``).

What the counters cannot see: the ``ctypes`` kernels (``csrc/*.cu``) are
not aten ops, so no dispatch mode sees them.  On the card the router's
key pack and top-k launches are left out of FLOPs and bytes: 11.3 MB a
call at (16384, 160) float32 (``PERF.md`` kernel table, row 3), against
the GBs of a model step.  Their FLOPs are integer work no formula counts.

``hlo_byte_profile`` becomes :func:`op_byte_profile` (aten ops by output
bytes).  ``parse_collectives`` parses HLO text and has no counterpart:
:func:`count` builds its dict.  ``cost_value`` smooths over JAX versions'
``cost_analysis()`` and has no counterpart either.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM 80 GB (NVIDIA's H100 Tensor Core GPU datasheet), per GPU
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
# The link figure that stands where the reference has ICI_BW: NVLink 4,
# 900 GB/s bidirectional a GPU (the datasheet), 450e9 bytes/s a direction.
# One constant, as the reference keeps one: the 16-wide model axis of a
# 16 x 16 mesh spans two 8-GPU nodes, whose InfiniBand links are slower,
# so the collective term is a lower bound there.
LINK_BW = 450e9

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op name -> (HLO name, where its output is: "out" the op's result,
# "arg0" its first argument, written in place)
_C10D = {
    "all_reduce": ("all-reduce", "out"),
    "all_reduce_": ("all-reduce", "out"),
    "all_reduce_coalesced": ("all-reduce", "out"),
    "all_reduce_coalesced_": ("all-reduce", "out"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "all_to_all_single": ("all-to-all", "out"),
    "allreduce_": ("all-reduce", "arg0"),
    "allreduce_coalesced_": ("all-reduce", "arg0"),
    "allgather_": ("all-gather", "arg0"),
    "_allgather_base_": ("all-gather", "arg0"),
    "allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "reduce_scatter_": ("reduce-scatter", "arg0"),
    "_reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "alltoall_": ("all-to-all", "arg0"),
    "alltoall_base_": ("all-to-all", "arg0"),
}
_C10D_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_NO_TRAFFIC = {torch.ops.aten._unsafe_view, torch.ops.aten.empty,
               torch.ops.aten.empty_strided, torch.ops.aten.empty_like}
_SKIP_NAMESPACES = _C10D_NAMESPACES + ("prim",)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    chips: int
    model_flops: float           # 6*N*D (train) / 2*N*D (serve), global
    useful_ratio: float          # model_flops / (flops_per_device * chips)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline this step achieves assuming
        perfect overlap: compute / max(all terms).  1.0 == compute-bound at
        peak; lower == memory or collective dominated."""
        if self.step_time_s == 0:
            return 0.0
        return self.compute_s / self.step_time_s

    @property
    def model_flops_util(self) -> float:
        """MFU upper bound implied by the roofline: useful model FLOPs per
        second at the roofline step time over peak."""
        if self.step_time_s == 0:
            return 0.0
        return (self.model_flops / self.chips) / self.step_time_s / PEAK_FLOPS

    def to_dict(self) -> Dict:
        return {**dataclasses.asdict(self),
                "bottleneck": self.bottleneck,
                "step_time_s": self.step_time_s,
                "roofline_fraction": self.roofline_fraction,
                "model_flops_util": self.model_flops_util}


@dataclasses.dataclass
class Counts:
    """What one run of a step did on this rank: FLOPs, bytes accessed,
    collectives (``parse_collectives``'s dict), bytes and calls by aten op,
    and the step's own result."""
    flops: float
    bytes_accessed: float
    collectives: Dict
    op_bytes: Dict[str, int]
    op_calls: Dict[str, int]
    result: Any = None
    sites: Dict[str, int] = dataclasses.field(default_factory=dict)


def _mm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    m, k = a_shape
    return 2 * m * k * b_shape[1]


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def _formulas() -> Dict:
    """FlopCounterMode's formulas by op packet, ``mm`` and ``bmm`` taking
    their ``out_dtype`` overloads too (the registry's ``bmm`` formula
    rejects the extra argument)."""
    from torch.utils import flop_counter as fc
    aten = torch.ops.aten
    return {**fc.flop_registry, aten.mm: fc.shape_wrapper(_mm_flop),
            aten.bmm: fc.shape_wrapper(_bmm_flop)}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _no_traffic(func) -> bool:
    """A view (its result aliases an input), ``_unsafe_view`` (a view whose
    schema does not say so) or an allocation that writes nothing: no
    kernel reads or writes memory for it."""
    if func._overloadpacket in _NO_TRAFFIC:
        return True
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _site() -> str:
    """``file:function`` of the innermost frame of ``repro_torch`` outside
    ``models/shard.py``, ``tree.py`` and this module: the model code that
    issued a collective."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(
                ("shard.py", "roofline.py", "tree.py")):
            return f"{os.path.basename(name)}:{f.f_code.co_name}"
        f = f.f_back
    return "other"


def _shard_factor(out) -> int:
    """Ranks that split a DTensor op's work: the product of the mesh dims
    its (first) output is sharded or partial over."""
    from torch.distributed.tensor import DTensor
    for t in _tensors(out):
        if isinstance(t, DTensor):
            return math.prod(n for n, p in zip(t.device_mesh.shape,
                                               t.placements)
                             if not p.is_replicate())
    return 1


class _Counter(TorchDispatchMode):
    """The dispatch mode behind :func:`count`."""

    def __init__(self):
        super().__init__()
        self.formulas = _formulas()
        self.flops = 0
        self.bytes = 0
        self.coll = dict.fromkeys(COLLECTIVES, 0)
        self.coll_n = dict.fromkeys(COLLECTIVES, 0)
        self.op_bytes: Dict[str, int] = {}
        self.op_calls: Dict[str, int] = {}
        self.sites: Dict[str, int] = {}
        self.defer = False      # the next DTensor op goes on to DTensor
        self.in_dtensor = 0     # depth of DTensor ops being desugared

    def _collective(self, func, args, out) -> bool:
        ns = func.namespace
        if ns not in _C10D_NAMESPACES:
            return False
        kind = _C10D.get(func._overloadpacket.__name__)
        if kind is not None:
            name, where = kind
            nbytes = sum(map(_nbytes, _tensors(
                out if where == "out" else args[:1])))
            self.coll[name] += nbytes
            self.coll_n[name] += 1
            site = f"{name} {_site()}"
            self.sites[site] = self.sites.get(site, 0) + nbytes
        return True

    def _op(self, func, args, kwargs, out, flops) -> None:
        self.flops += flops
        if _no_traffic(func):
            return
        b = sum(map(_nbytes, _tensors((args, kwargs)) + _tensors(out)))
        name = str(func._overloadpacket)
        self.bytes += b
        self.op_bytes[name] = self.op_bytes.get(name, 0) + sum(
            map(_nbytes, _tensors(out)))
        self.op_calls[name] = self.op_calls.get(name, 0) + 1

    def _flops(self, func, args, kwargs, out) -> int:
        f = self.formulas.get(func._overloadpacket)
        return int(f(*args, **kwargs, out_val=out)) if f else 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self.defer:
                # the call below, back from the dispatcher: let DTensor
                # desugar it into local ops, which reach this mode again
                self.defer = False
                return NotImplemented
            self.defer = True
            self.in_dtensor += 1
            try:
                with self:
                    out = func(*args, **kwargs)
            finally:
                self.in_dtensor -= 1
                self.defer = False
            if not self.in_dtensor:
                self._op(func, args, kwargs, out,
                         self._flops(func, args, kwargs, out)
                         // _shard_factor(out))
            return out
        out = func(*args, **kwargs)
        if self._collective(func, args, out):
            return out
        # inside a DTensor op only its collectives count: its local compute
        # is counted above, and its sharding propagation runs the op at the
        # global shapes
        if not self.in_dtensor and func.namespace not in _SKIP_NAMESPACES:
            self._op(func, args, kwargs, out,
                     self._flops(func, args, kwargs, out))
        return out


def count(fn: Callable, *args, **kw) -> Counts:
    """Run ``fn(*args, **kw)`` once and count, for this rank, what the
    reference reads from ``compiled.cost_analysis()`` and the HLO: FLOPs,
    bytes accessed and collectives (module docstring).  Works on real,
    fake (``FakeTensorMode``) and DTensor arguments alike; the result is
    ``Counts.result``."""
    c = _Counter()
    with c:
        result = fn(*args, **kw)
    coll = {"bytes": dict(c.coll), "counts": dict(c.coll_n),
            "total_bytes": sum(c.coll.values())}
    return Counts(flops=float(c.flops), bytes_accessed=float(c.bytes),
                  collectives=coll, op_bytes=c.op_bytes,
                  op_calls=c.op_calls, result=result, sites=c.sites)


def op_byte_profile(counts: Counts, top: int = 15) -> list:
    """aten ops by total OUTPUT bytes (this rank), as ``[(op, bytes,
    calls)]``: the counterpart of ``hlo_byte_profile``, the profile a step
    gives without timing it."""
    rows = sorted(counts.op_bytes.items(), key=lambda kv: -kv[1])[:top]
    return [(op, int(b), counts.op_calls[op]) for op, b in rows]


def analyze(counts: Counts, chips: int, model_flops: float) -> Roofline:
    flops, byts = counts.flops, counts.bytes_accessed
    coll = counts.collectives["total_bytes"]
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=coll / LINK_BW,
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=float(coll),
        chips=chips,
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops * chips)) if flops else 0.0,
    )


def summary(roof: Roofline, counts: Optional[Counts] = None) -> str:
    """One line: bottleneck, the three terms, useful_ratio, MFU bound."""
    line = (f"bottleneck={roof.bottleneck}, terms(s)=C{roof.compute_s:.4f}/"
            f"M{roof.memory_s:.4f}/X{roof.collective_s:.4f}, flops/dev="
            f"{roof.flops_per_device:.4e}, bytes/dev="
            f"{roof.bytes_per_device:.4e}, coll bytes/dev="
            f"{roof.coll_bytes_per_device:.4e}, useful_ratio="
            f"{roof.useful_ratio:.4f}, model_flops_util="
            f"{roof.model_flops_util:.4f}")
    if counts is not None:
        line += f", collectives {counts.collectives['counts']}"
    return line
