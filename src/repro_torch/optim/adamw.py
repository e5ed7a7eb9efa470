"""AdamW + global-norm clipping + int8 gradient compression: the port of
``repro.optim.adamw``.

The optimizer state is ``OptState(m, v, err, count)``; ``m`` and ``v`` are
float32 whatever the parameter's type (mixed-precision training), ``err``
is the error-feedback residual of compression (None without it) and
``count`` an int32 scalar.

:func:`update` keeps the reference's arithmetic, operation for operation,
but changes the parameters, ``m``, ``v`` and ``err`` in place, leaf by leaf.
A large leaf is taken in pieces along its leading axis (one layer of a
stacked leaf at a time, rows of an embedding), so no float32 temporary is
ever as large as a whole stacked leaf: qwen2-moe's stacked expert ``wi``
at 4 layers holds 1.38 G elements, 5.2 GiB for each float32 copy.  The
scalars (the norm, the clip scale, the learning rate, the bias
corrections) stay on the device; nothing waits on the host.

Gradient compression (``compress=True``) quantizes each leaf to int8 with
one symmetric scale per tensor, the residual carried in ``err``.

Under a mesh :func:`update` runs on each rank's local shards.  The
reductions over a whole leaf (its sum of squares for the global norm and
the clip, its int8 scale's max) then go through ``reduce(path, value,
op)``, which the sharded train step gives: it combines the shards' values
over the ranks that hold the leaf's other shards.  Without it (one
device) it is the identity and the arithmetic is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree

# the largest piece of a leaf that one float32 temporary covers (1 GiB);
# a leaf's leading axis is cut into pieces of at most this many elements,
# or into its single rows where a row is larger
PIECE_ELEMENTS = 1 << 28

# reduce(path, value, op): a leaf's partial value ("sum" or "max") made
# whole over the shards of the leaf at ``path``
Reduce = Callable[[tuple, torch.Tensor, str], torch.Tensor]


def _whole(path, value: torch.Tensor, op: str) -> torch.Tensor:
    """The reduction hook of an unsharded state: every leaf is whole."""
    return value


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    compress: bool = False


class OptState(NamedTuple):
    m: Dict
    v: Dict
    err: Optional[Dict]       # error-feedback residual (compression)
    count: torch.Tensor       # int32 scalar


def _zeros_like(params) -> Dict:
    return tree.map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params)


def init(params, cfg: AdamWConfig) -> OptState:
    device = tree.flatten_with_path(params)[0][1].device
    return OptState(m=_zeros_like(params), v=_zeros_like(params),
                    err=_zeros_like(params) if cfg.compress else None,
                    count=torch.zeros((), dtype=torch.int32, device=device))


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((count + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm.float()


def global_norm(tree_, reduce: Reduce = _whole) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32."""
    total = None
    for path, x in tree.flatten_with_path(tree_):
        s = reduce(path, _sum_squares(_float_pieces(x)), "sum")
        total = s if total is None else total + s
    return torch.sqrt(total)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _pieces(n: int, row: int) -> Iterator[slice]:
    """Slices of a leading axis of ``n`` rows of ``row`` elements each."""
    step = max(1, PIECE_ELEMENTS // max(row, 1))
    for i in range(0, n, step):
        yield slice(i, min(i + step, n))


def _split(*leaves: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """The same pieces of several leaves of one shape (a 0-d leaf whole)."""
    lead = leaves[0]
    if lead.dim() == 0:
        yield leaves
        return
    row = lead.numel() // max(lead.shape[0], 1)
    for s in _pieces(lead.shape[0], row):
        yield tuple(t[s] for t in leaves)


def _sum_squares(pieces) -> torch.Tensor:
    """The sum of squares of a leaf given as float32 pieces."""
    total = None
    for gp in pieces:
        s = torch.sum(torch.square(gp))
        total = s if total is None else total + s
    return total


def _compress(g: torch.Tensor, e: torch.Tensor, whole_max):
    """Error-feedback int8: quantize (g + e) with one scale for the whole
    leaf (``whole_max`` makes a shard's max the leaf's), and leave the
    rest, (g + e) - dequantized, in ``e``.  Returns a function giving the
    dequantized gradient as float32 pieces."""
    amax = torch.zeros((), dtype=torch.float32, device=g.device)
    for gp, ep in _split(g, e):
        amax = torch.maximum(amax, (gp.float() + ep).abs().max())
    amax = whole_max(amax)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    for gp, ep, qp in _split(g, e, q):
        t = gp.float() + ep
        qp.copy_(torch.clamp(torch.round(t / scale), -127, 127))
        ep.copy_(t - dequantize_int8(qp, scale))
    return lambda: (dequantize_int8(qp, scale) for (qp,) in _split(q))


def _float_pieces(g: torch.Tensor):
    for (gp,) in _split(g):
        yield gp.float()


@torch.no_grad()
def update(params, grads, state: OptState, cfg: AdamWConfig,
           reduce: Reduce = _whole):
    """One step: (params, state, metrics), the parameters and the state's
    tensors changed in place (the returned trees are the given ones, with a
    new ``count``).  ``grads`` has the parameters' structure; it is read,
    never written.  ``reduce`` makes a leaf's sum or max whole (see the
    module's docstring)."""
    p_leaves = tree.flatten_with_path(params)
    g_leaves = dict(tree.flatten_with_path(grads))
    m_leaves = dict(tree.flatten_with_path(state.m))
    v_leaves = dict(tree.flatten_with_path(state.v))

    # each leaf's gradient as float32 pieces, int8-compressed first
    g_list = [g_leaves[path] for path, _ in p_leaves]
    if cfg.compress:
        e_leaves = dict(tree.flatten_with_path(state.err))
        sources = [_compress(g, e_leaves[path],
                             lambda t, path=path: reduce(path, t, "max"))
                   for (path, _), g in zip(p_leaves, g_list)]
    else:
        sources = [lambda g=g: _float_pieces(g) for g in g_list]

    gnorm = None
    for (path, _), src in zip(p_leaves, sources):
        s = reduce(path, _sum_squares(src()), "sum")
        gnorm = s if gnorm is None else gnorm + s
    gnorm = torch.sqrt(gnorm)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)

    count = state.count + 1
    lr = _schedule(cfg, state.count)
    cf = count.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)

    for (path, p), src in zip(p_leaves, sources):
        for g, (pp, mp, vp) in zip(src(), _split(p, m_leaves[path],
                                                 v_leaves[path])):
            g = g * scale                                # clipped gradient
            t = g * (1 - cfg.b1)
            mp.mul_(cfg.b1).add_(t)                      # b1 m + (1-b1) g
            torch.mul(g, 1 - cfg.b2, out=t).mul_(g)
            vp.mul_(cfg.b2).add_(t)                      # b2 v + (1-b2) g g
            den = torch.div(vp, b2c, out=g).sqrt_().add_(cfg.eps)
            upd = torch.div(mp, b1c, out=t).div_(den)
            p32 = pp.float()
            upd.add_(torch.mul(p32, cfg.weight_decay, out=den)).mul_(lr)
            if p32 is pp:
                pp.sub_(upd)
            else:
                pp.copy_(p32.sub_(upd))
    return params, OptState(state.m, state.v, state.err, count), {
        "grad_norm": gnorm, "lr": lr}
