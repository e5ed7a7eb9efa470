"""Parameter / optimizer / cache / batch partition specs, and their
placements on a ``torch.distributed`` mesh: the port of
``repro.launch.sharding``.

Policy (the reference's): Megatron-style tensor parallelism over the
"model" axis combined with ZeRO/FSDP sharding of parameters and optimizer
state over the "data" axis; the batch shards over every non-model axis
(including "pod").  The pod axis deliberately does NOT shard parameters.

Every rule passes through a divisibility check: an axis that does not
divide the dimension is dropped (e.g. qwen2-moe's 60 experts on a 16-way
model axis fall back to sharding the expert FFN width instead; a batch of
1 falls back to replicated tokens).

A spec is a plain tuple, equal to ``tuple(PartitionSpec)`` of the
reference's: one entry a dimension, each ``None``, an axis name or a tuple
of two or more axis names.  The spec functions read only the mesh's axis sizes, so
they take a :class:`~torch.distributed.device_mesh.DeviceMesh` or anything
whose ``.shape`` is a dict of axis sizes: they are pure functions of leaf
paths, shapes and axis sizes.  :func:`placements` maps a spec onto DTensor
placements (the counterpart of ``NamedSharding``) and :func:`place` lays a
tree out by its specs.

How the port computes over this layout (``launch/steps.py``): every leaf
of the state is a DTensor placed by its spec.  Each rank runs the forward
and backward on plain local tensors: its own rows of the batch, and each
layer's leaves gathered over the data axes only while the layer runs,
their model-axis shard kept.  Along the model axis each rank computes its
own heads, FFN columns, experts and vocabulary block, as the reference's
GSPMD-partitioned step does (``models/shard.py``).  The gradients come
back averaged over the data axes onto each leaf's shard, and AdamW runs
on the local shards.  The kernels never see a DTensor.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch import tree
from repro_torch.tree import Attr

Spec = Tuple


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of anything whose ``.shape``
    is that dict already."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def normalized(spec) -> Spec:
    """A spec as ``tuple(PartitionSpec(*spec))`` reads: a one-axis tuple
    entry is that axis, an empty one None."""
    return tuple((e[0] if len(e) == 1 else e or None)
                 if isinstance(e, tuple) else e for e in spec)


def _fit(mesh, shape, spec: Spec) -> Spec:
    """Drop spec axes that do not divide their dimension."""
    ndim = len(shape)
    entries = list(spec) + [None] * (ndim - len(spec))
    out = []
    for dim, ax in zip(shape, entries[:ndim]):
        out.append(ax if ax and dim % _axis_size(mesh, ax) == 0 else None)
    return normalized(out)


# rule table: (regex on the last two path keys, base_ndim, spec builder)
def _rules(dp: str, tp: str):
    return [
        (r"embed/tok$",     2, (tp, dp)),
        (r"embed/head$",    2, (dp, tp)),
        (r"attn/w[qkv]$",   2, (dp, tp)),
        (r"attn/wo$",       2, (tp, dp)),
        (r"attn/wq_a$",     2, (dp, None)),
        (r"attn/wq_b$",     2, (None, tp)),
        (r"attn/wkv_a$",    2, (dp, None)),
        (r"attn/w[kv]_b$",  2, (None, tp)),
        (r"xattn/w[qkv]$",  2, (dp, tp)),
        (r"xattn/wo$",      2, (tp, dp)),
        (r"(mlp|shared)/wi$", 2, (dp, tp)),
        (r"(mlp|shared)/wo$", 2, (tp, dp)),
        (r"moe/router$",    2, (dp, None)),
        (r"moe/wi$",        3, (tp, dp, None)),   # expert-parallel first
        (r"moe/wo$",        3, (tp, None, dp)),
        (r"ssm/in_proj$",   2, (dp, tp)),
        (r"ssm/out_proj$",  2, (tp, dp)),
        (r"ssm/conv_[wb]$", 0, ()),               # small; replicate
        (r".*",             0, ()),               # norms, scalars, biases
    ]


_MOE_WI_FALLBACK = {"moe/wi": lambda dp, tp: (None, dp, tp),
                    "moe/wo": lambda dp, tp: (None, tp, dp)}


def _path_str(path) -> str:
    """The reference's path string, e.g. ``segments/0/moe/wi``: dict keys
    and sequence indices joined by '/'; a named tuple's field (an optimizer
    state's ``.m``) is left out, as ``jax.tree_util``'s attribute keys are."""
    return "/".join(str(k) for k in path if not isinstance(k, Attr))


def spec_for(mesh, path, leaf, dp: str = "data", tp: str = "model") -> Spec:
    """Spec of one param leaf.  Stacked layouts (extra leading layer axes)
    get None-padded on the left."""
    ps = _path_str(path)
    shape = leaf.shape
    for pat, base_ndim, spec in _rules(dp, tp):
        if re.search(pat, ps):
            extra = len(shape) - len(spec)
            if extra < 0:       # e.g. rule matched a scalar fallback
                spec = spec[:len(shape)]
                extra = len(shape) - len(spec)
            fitted = _fit(mesh, shape, (None,) * extra + spec)
            # MoE expert-parallel fallback: if E didn't divide, try TP
            # inside the expert FFN instead.
            if re.search(r"moe/w[io]$", ps) and fitted[extra] is None:
                key = "moe/wi" if ps.endswith("wi") else "moe/wo"
                alt = _MOE_WI_FALLBACK[key](dp, tp)
                fitted = _fit(mesh, shape, (None,) * extra + alt)
            return fitted
    return ()


def param_specs(mesh, params_tree, dp: str = "data", tp: str = "model"):
    """A tree of specs with ``params_tree``'s structure (params, grads, or
    AdamW m/v: anything param-shaped).  Its leaves are tuples, so read it
    by path (:func:`repro_torch.tree.at`), not by flattening."""
    return tree.map_with_path(lambda path, leaf: spec_for(mesh, path, leaf,
                                                          dp, tp),
                              params_tree)


def opt_specs(mesh, opt_state, dp: str = "data", tp: str = "model"):
    from repro_torch.optim.adamw import OptState
    return OptState(
        m=param_specs(mesh, opt_state.m, dp, tp),
        v=param_specs(mesh, opt_state.v, dp, tp),
        err=param_specs(mesh, opt_state.err, dp, tp)
        if opt_state.err is not None else None,
        count=(),
    )


def batch_spec(mesh, shape, batch_axes: Tuple[str, ...]) -> Spec:
    return _fit(mesh, shape, (batch_axes,) + (None,) * (len(shape) - 1))


def cache_specs(mesh, cache_tree, batch_axes: Tuple[str, ...],
                tp: str = "model", seq_shard: bool = False):
    """KV/SSM cache specs: batch over data axes; heads (attn K/V, SSM
    state heads) over the model axis, falling back to head_dim then
    replicated when head counts don't divide.  ``seq_shard=True`` shards
    the cache SEQUENCE dim over the model axis instead.  Rules are written
    from the right: stacked caches carry 1-2 leading layer axes."""
    def right(shape, n, spec):
        return (None,) * (len(shape) - n) + _fit(mesh, shape[-n:], spec)

    def one(path, leaf):
        ps = _path_str(path)
        shape = tuple(leaf.shape)
        if re.search(r"/(k|v)$", ps) and len(shape) >= 4:
            # (..., B, S, KV, hd)
            if seq_shard:
                return right(shape, 4, (batch_axes, tp, None, None))
            fitted = _fit(mesh, shape[-4:], (batch_axes, None, tp, None))
            if fitted[2] is None:   # KV heads don't divide: shard head_dim
                fitted = _fit(mesh, shape[-4:],
                              (batch_axes, None, None, tp))
            return (None,) * (len(shape) - 4) + fitted
        if re.search(r"/c_kv$|/k_rope$", ps) and len(shape) >= 3:
            if seq_shard:
                return right(shape, 3, (batch_axes, tp, None))
            return right(shape, 3, (batch_axes, None, tp))     # (B, S, L)
        if re.search(r"/ssm$", ps) and len(shape) >= 4:
            return right(shape, 4, (batch_axes, tp, None, None))  # (B,H,P,S)
        if re.search(r"/conv$", ps) and len(shape) >= 3:
            return right(shape, 3, (batch_axes, None, tp))     # (B, K-1, C)
        # placeholders / counters
        return ()

    return tree.map_with_path(one, cache_tree)


def placements(mesh, spec: Spec):
    """DTensor placements of ``spec`` on ``mesh`` (the counterpart of
    ``NamedSharding(mesh, spec)``): a mesh dim named in entry ``d`` shards
    tensor dim ``d``; a tuple entry shards ``d`` over each of its mesh
    dims, major to minor in the mesh's order (which must be the tuple's:
    that is the row order ``P(("pod", "data"))`` gives); any other mesh
    dim replicates."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        dims = [names.index(a)
                for a in (entry if isinstance(entry, tuple) else (entry,))]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for m in dims:
            out[m] = Shard(d)
    return out


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(tree_, mesh, specs):
    """``tree_`` laid out on ``mesh``: each tensor leaf becomes a DTensor
    placed by the spec at its path in ``specs``.  Every rank passes the
    same whole values (drawn from one seed); each keeps its own shard, with
    no communication.  A leaf replicated everywhere keeps the given tensor
    as its local value (no copy), so changes to one show in the other."""
    dev = mesh_device(mesh)
    return tree.map_with_path(
        lambda path, leaf: distribute_tensor(
            leaf.to(dev), mesh, placements(mesh, tree.at(specs, path)),
            src_data_rank=None),
        tree_)


def local_rows(mesh, n: int, batch_axes: Tuple[str, ...]) -> slice:
    """This rank's rows of a batch of ``n`` rows laid out by
    :func:`batch_spec`: a block, major to minor over the data axes in the
    mesh's order (every row where the axes do not divide ``n``)."""
    axes = batch_spec(mesh, (n,), batch_axes)[0]
    if axes is None:
        return slice(0, n)
    axes = axes if isinstance(axes, tuple) else (axes,)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    sizes = axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    block = 0
    for a in sorted(axes, key=names.index):
        block = block * sizes[a] + coord[names.index(a)]
    per = n // _axis_size(mesh, axes)
    return slice(block * per, (block + 1) * per)
