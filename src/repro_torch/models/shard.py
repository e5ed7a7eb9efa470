"""Logical activation sharding, and the model code's view of the mesh: the
port of ``repro.models.shard``.

``constrain(x, name)`` picks the reference's spec for a logical activation
name from the rule table below (strict fallbacks included) and, for a
DTensor under an active mesh, redistributes it to that spec; a plain
tensor comes back unchanged.  :func:`choose_spec` is the same pick, and
the model code reads it where a layout is a choice (the KV heads).

The launcher (``launch/steps.py``) enters :class:`mesh_axes` with the mesh
around the model calls, and :class:`placed` with the data-axis layout of
every parameter leaf.  The model code then computes tensor-parallel over
the model axis, Megatron-style, on plain local tensors:

* :func:`gathered` gathers a layer's leaves over the data (and pod) axes
  when the layer runs, keeping their model-axis shard; its backward
  averages the gradient over the data axes onto the leaf's own shard.
* Each rank computes its own heads, FFN columns, experts and vocabulary
  rows.  :func:`enter` (identity forward, all-reduce backward) marks where
  a value replicated over the model axis feeds a rank's own share of the
  work; :func:`reduce` (all-reduce forward, identity backward) sums the
  ranks' partial results back to the replicated ``act_embed``;
  :func:`sum_ranks` sums a statistic that each rank's share then reads.
* A leaf whose stored shard does not line up with the split a layer needs
  (a GLU's ``[gate | up]`` columns, heads the model axis does not divide,
  Mamba2's ``[z | xBC | dt]``) is re-laid by :func:`take` with one
  all-to-all over the model group (:func:`relay`); a replicated leaf is
  sliced.  :func:`gather` all-gathers an activation along a dim.

Every collective is a c10d one over the mesh's groups (so the dry run's
counters see it).  Without a mesh, or on a model axis of 1, every helper
returns its input, and the model code is the one-card code.

:func:`data_mean` is how model code reads a statistic over the whole batch
under a mesh: the MoE load-balance loss is a product of batch means, which
the mean of per-rank losses is not.

Rules map logical names to mesh axes.  Data-parallel axes are
("pod", "data") when the pod axis exists; tensor-parallel is "model".
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree

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
    sizes = get_axis_sizes() or {}
    axes = [a for a in dp or () if sizes.get(a, 1) > 1]
    if mesh is None or not axes:
        return x
    n = 1
    for axis in axes:
        x = _SumOverRanks.apply(x, mesh.get_group(axis))
        n *= sizes[axis]
    return x / n


# ---------------------------------------------------------------------------
# Tensor-parallel compute over the model axis
# ---------------------------------------------------------------------------

# per model rank, the index ranges (start, stop) it holds along one dim,
# in the order it holds them
Parts = Sequence[Sequence[Tuple[int, int]]]


def model_group():
    """(group, rank, size) of the active mesh's model axis; (None, 0, 1)
    without a mesh or on a model axis of one rank."""
    mesh = get_mesh()
    _, mp = get_mesh_axes()
    if mesh is None or mp is None:
        return None, 0, 1
    size = get_axis_sizes().get(mp, 1)
    if size == 1:
        return None, 0, 1
    return mesh.get_group(mp), mesh.get_local_rank(mp), size


def model_size() -> int:
    """The size of the active mesh's model axis (1 without a mesh)."""
    return model_group()[2]


def split(n: int, size: int) -> List[Tuple[int, int]]:
    """``n`` items over ``size`` ranks in blocks of ceil(n / size), as
    GSPMD pads a dim the axis does not divide: the last ranks may hold
    fewer items, or none."""
    c = -(-n // size)
    return [(min(r * c, n), min((r + 1) * c, n)) for r in range(size)]


def spans(blocks, width: int, offset: int = 0) -> Parts:
    """Each rank's block of items (:func:`split`) as the index range of
    items ``width`` wide from ``offset``."""
    return [[(offset + a * width, offset + b * width)] for a, b in blocks]


def even(n: int, size: int) -> Parts:
    """The blocks of a dim of ``n`` that the model axis shards evenly (a
    DTensor's ``Shard``)."""
    return [[(r * n // size, (r + 1) * n // size)] for r in range(size)]


def _merged(ranges) -> Tuple[Tuple[int, int], ...]:
    out: List[Tuple[int, int]] = []
    for a, b in ranges:
        if b <= a:
            continue
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return tuple(out)


def _pieces(x: torch.Tensor, dim: int, ranges) -> torch.Tensor:
    """The ranges of ``x`` along ``dim``, in order (a view for one)."""
    ranges = _merged(ranges)
    if len(ranges) == 1:
        a, b = ranges[0]
        return x.narrow(dim, a, b - a)
    if not ranges:
        return x.narrow(dim, 0, 0)
    return torch.cat([x.narrow(dim, a, b - a) for a, b in ranges], dim)


# the names newer torch gives ``all_gather_into_tensor`` and
# ``reduce_scatter_tensor`` (the same c10d ops)
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def _all_gather(x, dim, group, size):
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((size * xs.shape[0],) + tuple(xs.shape[1:]))
    _all_gather_single(out, xs, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim, group, size):
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // size,) + tuple(xs.shape[1:]))
    _reduce_scatter_single(out, xs, group=group)
    return out.movedim(0, dim)


class _Enter(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) over the group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over the group (even shards, rank-major);
    the backward reduce-scatters (sums) the gradient back."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.args = (dim, group, size)
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, *ctx.args), None, None, None)


@functools.lru_cache(maxsize=1024)
def _plan(src, dst, me: int, size: int):
    """The all-to-all that turns the layout ``src`` along a dim into
    ``dst`` (per rank, tuples of index ranges).  An index that several
    ranks hold in ``src`` is sent by the lowest of them.  Returns (the
    positions of this rank's ``x`` it sends, source-major by receiver;
    input splits; output splits; where each output position lies in the
    received buffer)."""
    n = max([b for parts in src + dst for _, b in parts], default=0)
    owner = np.full(n, -1, np.int64)
    pos = np.zeros(n, np.int64)
    for q in range(size):
        off = 0
        for a, b in src[q]:
            free = owner[a:b] == -1
            owner[a:b][free] = q
            pos[a:b][free] = off + np.flatnonzero(free)
            off += b - a

    def idx(parts):
        return np.concatenate([np.arange(a, b) for a, b in parts]
                              + [np.zeros(0, np.int64)])

    want = [idx(dst[p]) for p in range(size)]
    send = [pos[w[owner[w] == me]] for w in want]
    own = owner[want[me]]
    if (own < 0).any():
        raise ValueError("relay: the source layout misses indices the "
                         "destination asks for")
    order = np.argsort(own, kind="stable")
    perm = np.empty(len(order), np.int64)
    perm[order] = np.arange(len(order))
    return (np.concatenate(send), tuple(len(s) for s in send),
            tuple(int((own == q).sum()) for q in range(size)), perm)


class _Relay(torch.autograd.Function):
    """One all-to-all over the group along ``dim`` (:func:`_plan`); the
    backward sends each gradient back to the rank that sent its value,
    summing where several ranks received it."""

    @staticmethod
    def forward(ctx, x, dim, plan, group):
        send, ins, outs, perm = plan
        ctx.args = (dim, plan, group, x.shape[dim])
        xs = x.movedim(dim, 0)
        buf = xs.index_select(0, torch.as_tensor(send, device=x.device))
        out = buf.new_empty((sum(outs),) + tuple(buf.shape[1:]))
        dist.all_to_all_single(out, buf, list(outs), list(ins), group=group)
        return out.index_select(
            0, torch.as_tensor(perm, device=x.device)).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        dim, (send, ins, outs, perm), group, rows = ctx.args
        gs = g.movedim(dim, 0)
        recv = gs.new_empty((sum(outs),) + tuple(gs.shape[1:]))
        recv.index_copy_(0, torch.as_tensor(perm, device=g.device), gs)
        back = gs.new_empty((sum(ins),) + tuple(gs.shape[1:]))
        dist.all_to_all_single(back, recv, list(ins), list(outs), group=group)
        gx = gs.new_zeros((rows,) + tuple(gs.shape[1:]))
        gx.index_add_(0, torch.as_tensor(send, device=g.device), back)
        return gx.movedim(0, dim), None, None, None


def enter(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over the model axis, where each rank's own share
    of the work reads it: the backward sums the ranks' partial gradients
    (Megatron's ``f``).  ``x`` itself on one rank."""
    group, _, size = model_group()
    return x if size == 1 else _Enter.apply(x, group)


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the model axis, read by
    every rank alike: the backward passes the gradient as it is
    (Megatron's ``g``)."""
    group, _, size = model_group()
    return x if size == 1 else _Reduce.apply(x, group)


def sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model axis where each rank's own share of
    the work reads the total: the backward sums too."""
    group, _, size = model_group()
    return x if size == 1 else _SumOverRanks.apply(x, group)


def max_ranks(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model axis (no gradient)."""
    group, _, size = model_group()
    if size == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` sharded evenly over the model axis along ``dim``, all-gathered;
    the backward reduce-scatters."""
    group, _, size = model_group()
    return x if size == 1 else _Gather.apply(x, dim % x.dim(), group, size)


def relay(x: torch.Tensor, dim: int, src: Parts, dst: Parts
          ) -> torch.Tensor:
    """``x``, laid out along ``dim`` as ``src`` says (this rank holds the
    ranges ``src[rank]``, in order), re-laid as ``dst`` says, with one
    all-to-all over the model group."""
    group, me, size = model_group()
    src = tuple(_merged(p) for p in src)
    dst = tuple(_merged(p) for p in dst)
    if size == 1 or src == dst:
        return x
    return _Relay.apply(x, dim % x.dim(), _plan(src, dst, me, size), group)


def take(w: torch.Tensor, dim: int, n: int, parts: Parts) -> torch.Tensor:
    """This rank's ``parts[rank]`` of a weight whose dim ``dim`` is ``n``
    long, stored either evenly sharded over the model axis (re-laid by
    :func:`relay` where the stored blocks are not the parts) or replicated
    (sliced, through :func:`enter`)."""
    _, me, size = model_group()
    dim = dim % w.dim()
    if w.shape[dim] == n:
        w = enter(w)
        want = _merged(parts[me])
        return w if want == ((0, n),) else _pieces(w, dim, want)
    return relay(w, dim, even(n, size), parts)


def held(c: torch.Tensor, dim: int, n: int, parts: Parts) -> torch.Tensor:
    """This rank's ``parts`` of a cache leaf stored evenly sharded over the
    model axis along ``dim`` or replicated (no gradient)."""
    _, me, size = model_group()
    dim = dim % c.dim()
    if c.shape[dim] == n:
        return _pieces(c, dim, parts[me])
    return relay(c, dim, even(n, size), parts)


def store(c: torch.Tensor, dim: int, n: int, parts: Parts,
          value: torch.Tensor) -> None:
    """Write this rank's ``parts`` of a cache leaf (``value``, as
    :func:`held` read them) back into the leaf's own layout, in place.
    Every rank of the model group calls it."""
    _, _, size = model_group()
    dim = dim % c.dim()
    dst = [[(0, n)]] * size if c.shape[dim] == n else even(n, size)
    c.copy_(relay(value, dim, parts, dst))


def model_dim(shape, name: str) -> Optional[int]:
    """The dim of a local activation of ``shape`` (its dim 0 this rank's
    rows) that ``name``'s rule shards over the model axis, or None."""
    dp, mp = get_mesh_axes()
    sizes = get_axis_sizes() or {}
    rows = shape[0] * _axis_size(sizes, tuple(dp or ()))
    spec = choose_spec((rows,) + tuple(shape[1:]), name)
    for d, entry in enumerate(spec or ()):
        if entry == mp or (isinstance(entry, tuple) and mp in entry):
            return d
    return None


# ---- the parameters' data-axis layout, gathered when a layer runs


class _GatherData(torch.autograd.Function):
    """A leaf's local shard all-gathered over the data axes that shard it
    (the model-axis shard kept); the backward averages the gradient over
    every data axis onto the shard: a reduce-scatter over the axes that
    shard it, an all-reduce over the others."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        shards, _, _ = plan
        for group, size, dim in reversed(shards):     # minor axis first
            x = _all_gather(x, dim, group, size)
        return x if shards else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shards, reps, n = ctx.plan
        for group, size, dim in shards:
            g = _reduce_scatter(g, dim, group, size)
        if not shards:
            g = g.clone()
        for group in reps:
            dist.all_reduce(g, group=group)
        return g.div_(n), None


def data_plan(mesh, t, data_axes: Tuple[str, ...]):
    """How :func:`gathered` treats the DTensor leaf ``t``: the data axes
    that shard it (group, size, dim from the right), the other data axes'
    groups, and the number of data ranks; None on one data rank."""
    from torch.distributed.tensor import Shard
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in data_axes:
        n *= sizes[a]
    if n == 1:
        return None
    shards, reps = [], []
    for a, pl in zip(mesh.mesh_dim_names, t.placements):
        if a not in data_axes or sizes[a] == 1:
            continue
        if isinstance(pl, Shard):
            shards.append((mesh.get_group(a), sizes[a], pl.dim - t.dim()))
        else:
            reps.append(mesh.get_group(a))
    return tuple(shards), tuple(reps), n


class placed:
    """Context manager used by launchers around model calls on local
    shards: ``layout`` maps each parameter leaf's path to its
    :func:`data_plan`; ``seq_cache`` says the caches shard their sequence
    over the model axis."""

    def __init__(self, layout: Dict, seq_cache: bool = False):
        self.val = (layout, seq_cache)

    def __enter__(self):
        self.prev = (getattr(_state, "layout", None),
                     getattr(_state, "seq_cache", False))
        _state.layout, _state.seq_cache = self.val
        return self

    def __exit__(self, *exc):
        _state.layout, _state.seq_cache = self.prev
        return False


def seq_cache() -> bool:
    """Whether the caches shard their sequence over the model axis."""
    return getattr(_state, "seq_cache", False)


def gathered(sub, prefix: Tuple = ()):
    """``sub`` (the parameter subtree at ``prefix``) with every leaf
    gathered over the data axes under :class:`placed`; ``sub`` itself
    otherwise."""
    layout = getattr(_state, "layout", None)
    if layout is None:
        return sub

    def one(path, t):
        plan = layout.get(tuple(prefix) + tuple(path))
        return t if plan is None else _GatherData.apply(t, plan)

    return tree.map_with_path(one, sub)
