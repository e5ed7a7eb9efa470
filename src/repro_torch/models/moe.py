"""Mixture-of-Experts with the paper's comparison-free machinery inside:
the port of ``repro.models.moe``.

* **Routing top-k** (Qwen2-MoE: top-4 of 60) runs on the port's
  :func:`repro_torch.sort.topk`.  ``router_impl`` takes the reference's
  engine names or the port's: ``radix`` (plain-torch digit reads),
  ``pallas`` / ``fused-topk`` (the key-pack and top-k CUDA kernels on the
  card), ``lax`` / ``torch`` (the comparison baseline, a stable sort).

* **Dispatch**: ``einsum`` (GShard one-hot dispatch, per-row capacity, the
  default) or ``sort`` (the comparison-free LSB radix sort of
  :func:`radix_select.radix_sort_keys` orders the (token, expert) pairs,
  scattered into an (E, C, d) expert-major buffer, global capacity).
  Under a mesh each rank dispatches its own rows, so the einsum dispatch,
  whose capacity is per batch row, is unchanged, while the sort
  dispatch's capacity counts the rank's tokens only.

* **Tensor parallelism over the model axis** (under a mesh): every rank
  routes the same rows (``moe/router`` is replicated over it), so the
  router kernels see plain local tensors as on one card.  Where the model
  axis divides the experts (``act_dispatch`` / ``act_expert_g`` on E:
  deepseek-v2's 160 on 16), each rank runs its E / tp experts on their
  slots (expert parallel); where it does not (qwen2-moe's 60 on 16, the
  ``_MOE_WI_FALLBACK`` specs), each rank runs every expert on its block
  of the FFN columns.  Either way each rank's combine is a partial sum,
  added to the shared experts' (``layers.mlp_partial``) and summed over
  the model axis once.

Router weights and gating math run in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import sort as sort_engine
from repro_torch.core import radix_select as rs
from repro_torch.models import shard
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (_init, apply_mlp, glu_act, init_mlp,
                                       mlp_partial)

# router_impl -> the port's topk engine; the reference's names map onto
# the port's, and the port's own names stand for themselves
ROUTER_ENGINES = {"radix": "radix", "pallas": "fused-topk", "lax": "torch",
                  "fused-topk": "fused-topk", "torch": "torch"}


def init_moe(cfg: ArchConfig, gen, device) -> Dict:
    E, ff, d = cfg.n_routed_experts, cfg.d_ff_expert, cfg.d_model
    p = {
        "router": _init(gen, (d, E), torch.float32, device),
        # routed experts: stacked (E, ...) GLU weights
        "wi": _init(gen, (E, d, 2 * ff), cfg.pdtype(), device),
        "wo": _init(gen, (E, ff, d), cfg.pdtype(), device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, device,
                               d_ff=cfg.n_shared_experts * ff)
    return p


def router_engine(impl: str) -> str:
    """The port's topk engine for a ``router_impl`` name."""
    try:
        return ROUTER_ENGINES[impl]
    except KeyError:
        raise ValueError(f"unknown router_impl {impl!r}; expected one of "
                         f"{sorted(ROUTER_ENGINES)}") from None


def route_topk(logits: torch.Tensor, k: int, impl: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, expert_idx): top-k softmax gates over expert logits (.., E);
    indices int32."""
    vals, idx = sort_engine.topk(logits, k, engine=router_engine(impl))
    return torch.softmax(vals.float(), dim=-1), idx


def _capacity(n_tokens: int, k: int, n_experts: int,
              factor: Optional[float] = 1.25) -> int:
    """Expert buffer slots: ceil in float64, then up to a multiple of 8 with
    a floor of 8.  ``factor=None`` => the no-drop bound C = n_tokens."""
    if factor is None:
        c = n_tokens
    else:
        c = int(np.ceil(n_tokens * k / n_experts * factor))
    return max(8, -(-c // 8) * 8)


_USE_CFG = object()   # default: take the capacity factor from the config


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over n classes; an index outside [0, n)
    gives a zero row (as ``jax.nn.one_hot``)."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).float()


def dispatch_slots(eidx: torch.Tensor, n_experts: int, capacity: int):
    """The einsum dispatch's slots: (one-hot experts (B,T,k,E), slot of each
    (t, k) assignment within its expert (B,T,k) as float32, keep mask).
    Slots come from a float32 cumsum over the (t, k)-flattened one-hots, so
    the assignments past capacity that are dropped follow that order."""
    B, T, k = eidx.shape
    oh_e = _one_hot(eidx, n_experts)                       # (B,T,k,E)
    flat = oh_e.reshape(B, T * k, n_experts)
    pos = (torch.cumsum(flat, dim=1) * flat).reshape(B, T, k, n_experts)
    pos_tk = pos.sum(dim=-1) - 1.0                         # (B,T,k)
    keep = (pos_tk < capacity) & (pos_tk >= 0)
    return oh_e, pos_tk, keep


def apply_moe(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              capacity_factor=_USE_CFG, dispatch: str = "einsum"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d).  Returns (y, aux_loss)."""
    if capacity_factor is _USE_CFG:
        capacity_factor = cfg.moe_capacity_factor
    B, T, d = x.shape
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    logits = x.float() @ params["router"]                  # (B, T, E)
    gates, eidx = route_topk(logits, k, cfg.router_impl)   # (B, T, k)

    # load-balance auxiliary loss (Switch-style): a product of means over
    # the whole batch, so under a mesh both means are taken over the data
    # ranks' rows (shard.data_mean; the identity without a mesh)
    me = shard.data_mean(torch.softmax(logits, dim=-1).mean(dim=(0, 1)))
    ce = shard.data_mean(torch.zeros(
        (E,), dtype=torch.float32, device=x.device).index_add_(
        0, eidx.reshape(-1).long(),
        torch.ones(eidx.numel(), dtype=torch.float32, device=x.device)
    ) / (B * T * k))
    aux = E * (me * ce).sum()

    x_in, gates = shard.enter(x), shard.enter(gates)
    if dispatch == "sort":
        y = _sort_dispatch(params, x_in, cfg, gates, eidx, capacity_factor)
    elif dispatch == "einsum":
        y = _einsum_dispatch(params, x_in, cfg, gates, eidx, capacity_factor)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if cfg.n_shared_experts:
        y = y + mlp_partial(params["shared"], x_in, cfg,
                            d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    return shard.reduce(y), aux


def _expert_block(params, cfg: ArchConfig):
    """(first expert, wi, wo) of this rank's share of the routed experts:
    its block of experts (expert parallel, the banks' stored shard), or
    every expert on its block of the FFN columns (``wi``'s gate and up
    blocks, ``wo``'s rows), or all of them on one rank."""
    E, ff = cfg.n_routed_experts, cfg.d_ff_expert
    wi, wo = params["wi"], params["wo"]
    _, me, size = shard.model_group()
    if wi.shape[0] < E:
        return me * wi.shape[0], wi, wo
    cols = shard.split(ff, size)
    return 0, shard.take(wi, -1, 2 * ff,
                         [[(a, b), (ff + a, ff + b)] for a, b in cols]), \
        shard.take(wo, -2, ff, [[c] for c in cols])


def _experts(params, xbuf: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The routed experts' GLU on an expert-major buffer (E, n, d): one
    batched product a weight, the (E, d, f) banks read as they lie."""
    gate, up = torch.bmm(xbuf, params["wi"]).chunk(2, dim=-1)
    return torch.bmm(glu_act(gate, cfg) * up, params["wo"])


def _einsum_dispatch(params, x, cfg, gates, eidx, capacity_factor):
    B, T, d = x.shape
    E = cfg.n_routed_experts
    C = _capacity(T, cfg.moe_top_k, E, capacity_factor)   # per batch row
    dt = x.dtype
    e0, wi, wo = _expert_block(params, cfg)
    El = wi.shape[0]
    oh_e, pos_tk, keep = dispatch_slots(eidx, E, C)
    oh_c = _one_hot(pos_tk.to(torch.int32), C) * keep[..., None]
    if El < E:                          # this rank's experts' slots
        oh_e = oh_e[..., e0:e0 + El]
    disp = torch.einsum("btke,btkc->btec", oh_e, oh_c).to(dt)
    comb = torch.einsum("btke,btkc,btk->btec", oh_e, oh_c, gates).to(dt)
    # the group (= batch row) dim stays on the expert buffers: capacity
    # slots are per group, so (b, e, c) never collides across rows
    xbuf = torch.einsum("btec,btd->ebcd", disp, x)         # (El,B,C,d)
    ybuf = _experts({"wi": wi, "wo": wo}, xbuf.reshape(El, B * C, d), cfg)
    return torch.einsum("btec,ebcd->btd", comb, ybuf.reshape(El, B, C, d))


def _sort_dispatch(params, x, cfg, gates, eidx, capacity_factor):
    B, T, d = x.shape
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    n = B * T
    dev = x.device
    xt = x.reshape(n, d)
    C = _capacity(n, k, E, capacity_factor)
    e0, wi, wo = _expert_block(params, cfg)
    El = wi.shape[0]
    flat_e = eidx.reshape(-1).to(torch.int32)                     # (n*k,)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    # order pairs by expert id with the stable LSB radix sort (ties keep
    # token order, giving deterministic capacity truncation)
    perm = rs.radix_sort_keys(flat_e[None], r=4)[0].long()
    se, st_, sg = flat_e[perm].long(), flat_t[perm], flat_g[perm]
    # slot within expert = position - first position of that expert
    pos = torch.arange(n * k, device=dev)
    first = torch.full((E,), n * k, dtype=torch.long, device=dev
                       ).scatter_reduce(0, se, pos, "amin")
    slot = pos - first[se]
    keep = slot < C
    if El < E:                          # this rank's experts' pairs
        se = se - e0
        keep = keep & (se >= 0) & (se < El)
    # expert-major buffers (El, C, ...): over-capacity pairs are dropped
    xbuf = torch.zeros((El, C, d), dtype=x.dtype, device=dev)
    xbuf[se[keep], slot[keep]] = xt[st_[keep]]
    ybuf = _experts({"wi": wi, "wo": wo}, xbuf, cfg)
    ytok = ybuf[se.clamp(0, El - 1), slot.clamp(0, C - 1)]        # (n*k, d)
    contrib = torch.where(keep[:, None], ytok * sg[:, None].to(x.dtype),
                          0.0).to(x.dtype)
    y = torch.zeros((n, d), dtype=x.dtype, device=dev).index_add_(
        0, st_, contrib)
    return y.reshape(B, T, d)


def apply_moe_dense_ref(params: Dict, x: torch.Tensor, cfg: ArchConfig
                        ) -> torch.Tensor:
    """Oracle: compute every expert densely and combine by gates — no
    capacity drops.  Used by tests on tiny configs."""
    B, T, d = x.shape
    E = cfg.n_routed_experts
    xt = x.reshape(-1, d)
    logits = xt.float() @ params["router"]
    gates, eidx = route_topk(logits, cfg.moe_top_k, cfg.router_impl)
    ye = _experts(params, xt.expand(E, -1, -1), cfg)              # (E, n, d)
    w = torch.einsum("nke,nk->en", _one_hot(eidx, E), gates).to(x.dtype)
    y = torch.einsum("end,en->nd", ye, w)
    if cfg.n_shared_experts:
        y = y + apply_mlp(params["shared"], xt, cfg,
                          d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    return y.reshape(B, T, d)
