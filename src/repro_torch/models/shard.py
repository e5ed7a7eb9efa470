"""Logical activation sharding, and the model code's view of the mesh: the
port of ``repro.models.shard``.

``constrain(x, name)`` picks the reference's spec for a logical activation
name from the rule table below (strict fallbacks included) and, for a
DTensor under an active mesh, redistributes it to that spec; a plain
tensor comes back unchanged.  The port computes on plain tensors (each
rank runs the whole model on its rows: ``launch/sharding.py``), so the
model code does not call it yet; tensor-parallel compute over the model
axis would.

The launcher enters :class:`mesh_axes` with the mesh around the model
calls.  :func:`data_mean` is how model code reads a statistic over the
whole batch under it: the MoE load-balance loss is a product of batch
means, which the mean of per-rank losses is not.

Rules map logical names to mesh axes.  Data-parallel axes are
("pod", "data") when the pod axis exists; tensor-parallel is "model".
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

_state = threading.local()

# logical name -> CANDIDATE (spec builder, strict) pairs given
# (data_axes, model_axis).  strict=True candidates are skipped when a
# sharded dim does not divide evenly (where layout compatibility matters,
# e.g. decode-cache scatters); strict=False allows an uneven split.
_RULES = {
    # (B, T, H, hd)
    "act_heads":    [(lambda dp, mp: (dp, None, mp, None), False)],
    # K/V heads feed the decode-cache scatter: stay layout-exact, fall
    # back to sharding head_dim when KV heads don't divide
    "act_kv_heads": [(lambda dp, mp: (dp, None, mp, None), True),
                     (lambda dp, mp: (dp, None, None, mp), True),
                     (lambda dp, mp: (dp, None, None, None), False)],
    # (B, H, T, S) attention scores/probs
    "act_scores":   [(lambda dp, mp: (dp, mp, None, None), False)],
    # (B, T, d)
    "act_embed":    [(lambda dp, mp: (dp, None, None), False)],
    # (B, T, ff)
    "act_ff":       [(lambda dp, mp: (dp, None, mp), False)],
    # (B, T, V)
    "act_vocab":    [(lambda dp, mp: (dp, None, mp), False)],
    # (B, T) tokens
    "act_tokens":   [(lambda dp, mp: (dp, None), False)],
    # MoE: (E, C, d) expert-major dispatch buffers
    "act_expert":   [(lambda dp, mp: (mp, None, None), True),
                     (lambda dp, mp: (None, None, mp), False)],
    # MoE: (B, T, E, C) one-hot dispatch/combine tensors
    "act_dispatch": [(lambda dp, mp: (dp, None, mp, None), True),
                     (lambda dp, mp: (dp, None, None, mp), False)],
    # MoE: (B, E, C, d) grouped expert buffers
    "act_expert_g": [(lambda dp, mp: (dp, mp, None, None), True),
                     (lambda dp, mp: (dp, None, None, mp), False)],
    # SSD state (B, H, P, S)
    "act_ssm_state": [(lambda dp, mp: (dp, mp, None, None), False)],
}


def set_mesh_axes(data_axes: Optional[Tuple[str, ...]],
                  model_axis: Optional[str],
                  axis_sizes: Optional[Dict[str, int]] = None,
                  mesh=None) -> None:
    """Enable activation constraints.  ``axis_sizes`` ({axis: size})
    enables the divisibility-aware rule fallback; ``mesh`` (a DeviceMesh)
    enables :func:`data_mean`.  Pass (None, None) to disable."""
    _state.data_axes = data_axes
    _state.model_axis = model_axis
    _state.axis_sizes = axis_sizes
    _state.mesh = mesh


def get_mesh_axes():
    return (getattr(_state, "data_axes", None),
            getattr(_state, "model_axis", None))


def get_axis_sizes() -> Optional[Dict[str, int]]:
    return getattr(_state, "axis_sizes", None)


def get_mesh():
    """The DeviceMesh of the active :class:`mesh_axes`, or None."""
    return getattr(_state, "mesh", None)


class mesh_axes:
    """Context manager used by launchers around model calls.
    ``axis_sizes`` may be a DeviceMesh: its sizes are read and the mesh is
    kept for :func:`data_mean`."""

    def __init__(self, data_axes, model_axis, axis_sizes=None):
        mesh = None
        if axis_sizes is not None and not isinstance(axis_sizes, dict):
            mesh = axis_sizes
            axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.axes = (data_axes, model_axis, axis_sizes, mesh)

    def __enter__(self):
        self.prev = get_mesh_axes() + (get_axis_sizes(), get_mesh())
        set_mesh_axes(*self.axes)
        return self

    def __exit__(self, *exc):
        set_mesh_axes(*self.prev)
        return False


def _axis_size(sizes: Dict[str, int], axis) -> int:
    axes = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _divisible(shape, spec, sizes: Dict[str, int]) -> bool:
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % _axis_size(sizes, ax) != 0:
            return False
    return True


def choose_spec(shape, name: str):
    """The spec ``constrain`` gives an activation of ``shape`` under the
    active axes (the first candidate that is not strict or divides), or
    None without active axes."""
    from repro_torch.launch import sharding
    dp, mp = get_mesh_axes()
    if dp is None and mp is None:
        return None
    sizes = get_axis_sizes()
    for builder, strict in _RULES[name]:
        # drop axes the array doesn't have (e.g. 2D tokens)
        spec = sharding.normalized(builder(dp, mp)[:len(shape)])
        if strict and sizes is not None and not _divisible(shape, spec,
                                                           sizes):
            continue
        return spec
    return None


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` redistributed to its rule's spec when it is a DTensor under
    an active mesh; otherwise ``x`` itself."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding
    spec = choose_spec(tuple(x.shape), name)
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          sharding.placements(x.device_mesh, spec))


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over a group; its backward all-reduces the
    gradient over the same group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data ranks of the active mesh, each rank
    holding an equal share of the batch; ``x`` itself without a mesh.
    Differentiable: each rank's gradient of the mean reaches every rank's
    ``x`` (the backward sums over the ranks), and the train step's
    average of the gradients over the data ranks then counts it once."""
    mesh = get_mesh()
    dp, _ = get_mesh_axes()
    if mesh is None or not dp:
        return x
    n = 1
    for axis in dp:
        x = _SumOverRanks.apply(x, mesh.get_group(axis))
        n *= get_axis_sizes()[axis]
    return x / n
