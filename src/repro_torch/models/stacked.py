"""Stacked-layer forward — the production serving path: the port of
``repro.models.stacked``.

Identical consecutive layers hold their parameters STACKED along a
leading axis (the reference's layout, leaf for leaf, so its weights carry
across with ``tree.params_from_numpy``).  Where the reference scans a run
under ``lax.scan``, the port loops over the leading axis in Python.  The
layers' parameters are taken with one ``unbind(0)`` a leaf: views, nothing
copied, and under autograd the backward of a leaf's layers is one
``stack`` (indexing ``leaf[i]`` would add each layer's gradient into a
zero tensor as large as the whole leaf, L whole-leaf writes a step).  A
cache is indexed, so that a view written in place lands in the stacked
cache.  A periodic pattern (a fusion layer every few layers, zamba2's
shared block) stacks each of its inner runs over ``(reps,)`` for a run of
one layer and ``(reps, count)`` otherwise; the port loops over the
repetitions, then over the inner runs.

Gradient checkpointing (``remat``) wraps what the reference's scan body
holds: a layer of a run of several, a repetition of a periodic pattern.
``"full"`` saves nothing (``torch.utils.checkpoint``, non-reentrant),
``"dots"`` saves the outputs of the products without batch dimensions
(``aten.mm`` and its kind, as ``dots_with_no_batch_dims_saveable``) and
recomputes the rest.

Layer grouping:

  qwen3 &c.   : [attn x N]                              -> one run
  deepseek-v2 : [mla+dense x1] + [mla+moe x59]          -> run + run
  llama-vision: 10 x ([attn x9] + [attn+xattn x1])      -> periodic
  zamba2      : 9 x ([ssm x5] + [shared-attn x1])       -> periodic
  musicgen    : 4 x ([attn x11] + [attn+xattn x1])      -> periodic
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import shard
from repro_torch.models import transformer as T
from repro_torch.models.config import ATTN, MLA, SSM, ArchConfig


@dataclasses.dataclass(frozen=True)
class Sig:
    kind: str
    moe: bool = False
    xattn: bool = False
    shared: bool = False


@dataclasses.dataclass(frozen=True)
class Run:
    sig: Sig
    count: int


@dataclasses.dataclass(frozen=True)
class Periodic:
    reps: int
    inner: Tuple[Run, ...]


def layer_sig(cfg: ArchConfig, i: int) -> Sig:
    kinds = T._layer_kinds(cfg)
    kind = kinds[i]
    shared = bool(cfg.hybrid_every) and kind == ATTN
    return Sig(kind=kind,
               moe=T._is_moe_layer(cfg, i, kind),
               xattn=T._has_xattn(cfg, i),
               shared=shared)


def _rle(sigs: Sequence[Sig]) -> List[Run]:
    runs: List[Run] = []
    for s in sigs:
        if runs and runs[-1].sig == s:
            runs[-1] = Run(s, runs[-1].count + 1)
        else:
            runs.append(Run(s, 1))
    return runs


def segments(cfg: ArchConfig) -> List:
    sigs = [layer_sig(cfg, i) for i in range(cfg.n_layers)]
    p = cfg.xattn_every or cfg.hybrid_every
    if p and cfg.n_layers % p == 0 and cfg.n_layers // p > 1:
        period = sigs[:p]
        if all(sigs[i] == period[i % p] for i in range(cfg.n_layers)):
            return [Periodic(cfg.n_layers // p, tuple(_rle(period)))]
    return list(_rle(sigs))


def _lead(run: Run, reps: int = 0) -> Tuple[int, ...]:
    """The stacked leading dims of a run's leaves: (count,) for a run of
    more than one layer; inside a periodic pattern of ``reps`` repetitions,
    (reps,) or (reps, count)."""
    rep = (reps,) if reps else ()
    return rep + ((run.count,) if run.count > 1 else ())


def _index(t, i):
    """The i-th slice of every leaf of a stacked tree: views, no copies."""
    return tree.map_with_path(lambda _, leaf: leaf[i], t)


def _unstack(t, n: int) -> List:
    """The n slices of a stacked tree along its leading axis, one
    ``unbind`` a leaf (views; under autograd, one ``stack`` a leaf)."""
    parts = {path: leaf.unbind(0) for path, leaf in tree.flatten_with_path(t)}
    return [tree.map_with_path(lambda path, _: parts[path][i], t)
            for i in range(n)]


# the products whose outputs ``remat="dots"`` keeps: no batch dimension
_DOTS = ("mm", "addmm")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    name = getattr(getattr(op, "overloadpacket", op), "__name__", "")
    return (CheckpointPolicy.MUST_SAVE if name in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, mode: str) -> Callable:
    """``fn`` under gradient checkpointing: ``none`` as is, ``full`` saving
    nothing, ``dots`` saving the batch-free products' outputs."""
    if mode == "none":
        return fn
    from torch.utils import checkpoint as ckpt
    if mode == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _dots_policy)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=context)
    if mode == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    raise ValueError(f"unknown remat {mode!r}; expected none, full or dots")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(cfg: ArchConfig, sig: Sig, gen, device) -> Dict:
    return T.init_block(cfg, sig.kind, gen, device, moe=sig.moe,
                        xattn=sig.xattn, shared=sig.shared)


def _stacked(lead: Tuple[int, ...], make: Callable[[], Dict]) -> Dict:
    """A block tree stacked over ``lead``, filled one layer at a time into
    leaves allocated once (never a whole stacked leaf drawn at once).  Only
    the layer being made lives beside the stack: each is dropped once it
    is copied in."""
    if not lead:
        return make()
    n = 1
    for s in lead:
        n *= s
    blk = make()
    out = tree.map_with_path(
        lambda _, t: torch.empty(lead + tuple(t.shape), dtype=t.dtype,
                                 device=t.device), blk)
    flat = tree.flatten_with_path(tree.map_with_path(
        lambda _, t: t.reshape((n,) + t.shape[len(lead):]), out))
    for i in range(n):
        if i:
            blk = make()
        src = dict(tree.flatten_with_path(blk))
        for path, dst in flat:
            dst[i].copy_(src[path])
        del blk, src
    return out


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                device) -> Dict:
    """Random params in the stacked layout, drawn from ``gen`` (a generator
    on ``device``; None on the meta device)."""
    device = torch.device(device)
    params: Dict = {"embed": L.init_embed(cfg, gen, device),
                    "final_norm": L.init_norm(cfg, gen, device)}
    if cfg.hybrid_every:
        params["shared_attn"] = T.init_shared_attn(cfg, gen, device)

    def stacked_run(run: Run, reps: int = 0) -> Dict:
        return _stacked(_lead(run, reps),
                        lambda: _init_block(cfg, run.sig, gen, device))

    params["segments"] = [
        stacked_run(seg) if isinstance(seg, Run)
        else {"inner": [stacked_run(run, seg.reps) for run in seg.inner]}
        for seg in segments(cfg)]
    return params


def from_layerwise(cfg: ArchConfig, lw: Dict) -> Dict:
    """Convert ``transformer.init_params`` layout to the stacked layout
    (stacked leaves are new tensors)."""
    segs = segments(cfg)
    blocks = lw["blocks"]
    out = {"embed": lw["embed"], "final_norm": lw["final_norm"]}
    if "shared_attn" in lw:
        out["shared_attn"] = lw["shared_attn"]

    def stack(blks):
        leaves = [dict(tree.flatten_with_path(b)) for b in blks]
        return tree.map_with_path(
            lambda path, _: torch.stack([lv[path] for lv in leaves]), blks[0])

    idx = 0
    seg_params = []
    for seg in segs:
        if isinstance(seg, Run):
            blks = blocks[idx: idx + seg.count]
            idx += seg.count
            seg_params.append(blks[0] if seg.count == 1 else stack(blks))
        else:
            p = sum(r.count for r in seg.inner)
            inner_lists: List[List] = [[] for _ in seg.inner]
            for rep in range(seg.reps):
                o = idx + rep * p
                for j, run in enumerate(seg.inner):
                    blks = blocks[o: o + run.count]
                    o += run.count
                    inner_lists[j].append(
                        blks[0] if run.count == 1 else stack(blks))
            idx += seg.reps * p
            seg_params.append(
                {"inner": [stack(lst) for lst in inner_lists]})
    out["segments"] = seg_params
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _run(shared, run: Run, blk, cfg, x, aux, positions, frontend, cache,
         remat: str = "none", prefix: Tuple = ()):
    """A run of layers, one at a time over the leading axis when stacked,
    each layer checkpointed under ``remat``; caches are written in place.
    A layer's leaves (``blk`` is the run's subtree at ``prefix``, and
    zamba2's ``shared`` block) are gathered over the data axes inside the
    checkpointed body (``shard.gathered``): they live while the layer
    runs, and remat gathers them again for the backward."""
    def body(x, aux, layer, c):
        x, _, a = T.apply_block(shard.gathered(shared, ("shared_attn",)),
                                shard.gathered(layer, prefix),
                                run.sig.kind, cfg, x, positions, frontend, c)
        return x, aux + a

    if run.count == 1:
        return body(x, aux, blk, cache)
    body = _remat(body, remat)
    for i, layer in enumerate(_unstack(blk, run.count)):
        x, aux = body(x, aux, layer,
                      None if cache is None else _index(cache, i))
    return x, aux


def forward(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[List] = None, remat: str = "none"):
    """tokens: (B, T) int; frontend: (B, F, frontend_dim) embeddings for
    the fusion layers, or None.  Returns (logits (B,T,V) float32, caches,
    aux); given caches are written in place and returned.  ``remat``
    (none | full | dots) checkpoints the layers for training.  Under a
    mesh (``launch/steps.py``) ``params`` and ``caches`` are this rank's
    shards, each leaf gathered over the data axes where it is used, and
    the logits are this rank's block of the vocabulary."""
    B, Tn = tokens.shape
    if positions is None:
        positions = torch.arange(Tn, dtype=torch.int32,
                                 device=tokens.device).expand(B, Tn)
    emb = params["embed"]
    x = L.embed_tokens({"tok": shard.gathered(emb["tok"], ("embed", "tok"))},
                       tokens, cfg.vocab)
    shared = params.get("shared_attn")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (seg, sp) in enumerate(zip(segments(cfg), params["segments"])):
        cache = caches[si] if caches is not None else None
        if isinstance(seg, Run):
            x, aux = _run(shared, seg, sp, cfg, x, aux, positions, frontend,
                          cache, remat, ("segments", si))
            continue

        def rep_body(x, aux, inner, c, seg=seg, si=si):
            for j, run in enumerate(seg.inner):
                x, aux = _run(shared, run, inner[j], cfg, x, aux, positions,
                              frontend, None if c is None else c[j],
                              prefix=("segments", si, "inner", j))
            return x, aux

        rep_body = _remat(rep_body, remat)
        reps = zip(*(_unstack(p, seg.reps) for p in sp["inner"]))
        for r, inner in enumerate(reps):
            x, aux = rep_body(x, aux, list(inner),
                              None if cache is None
                              else [_index(c, r) for c in cache])
    x = L.apply_norm(shard.gathered(params["final_norm"], ("final_norm",)),
                     x, cfg)
    head = {"head": shard.gathered(emb["head"], ("embed", "head"))}
    return L.lm_logits(head, x, cfg.vocab), caches, aux


def loss_fn(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, frontend: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01, remat: str = "none"):
    """Next-token cross entropy plus ``aux_weight`` times the routers'
    load-balance loss: (loss, {"nll", "aux"}), all float32 scalars."""
    logits, _, aux = forward(params, cfg, tokens, frontend, remat=remat)
    return T.nll_loss(logits, labels, aux, aux_weight, vocab=cfg.vocab)


# ---------------------------------------------------------------------------
# Serving (stacked caches)
# ---------------------------------------------------------------------------


def _cache_for_sig(cfg: ArchConfig, sig: Sig, batch: int, max_len: int,
                   device, lead: Tuple[int, ...] = ()) -> Dict:
    if sig.kind == SSM:
        return M.init_ssm_cache(cfg, batch, device, lead)
    if sig.kind == MLA:
        return L.init_mla_cache(cfg, batch, max_len, device, lead)
    return L.init_attn_cache(cfg, batch, max_len, device, lead)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> List:
    """Zeroed caches in the stacked layout: a run's stacked over its
    layers, a periodic pattern's a list over its inner runs."""
    def of(run: Run, reps: int = 0) -> Dict:
        return _cache_for_sig(cfg, run.sig, batch, max_len, device,
                              _lead(run, reps))

    return [of(seg) if isinstance(seg, Run)
            else [of(run, seg.reps) for run in seg.inner]
            for seg in segments(cfg)]


def decode_step(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                pos: torch.Tensor, caches: List,
                frontend: Optional[torch.Tensor] = None):
    """One serving step: token (B,1) at positions pos (B,).  Returns
    (logits (B,1,V), caches)."""
    positions = pos[:, None].to(torch.int32)
    logits, caches, _ = forward(params, cfg, token, frontend=frontend,
                                positions=positions, caches=caches)
    return logits, caches
