"""Backbone assembly, one block at a time (the layerwise layout): the port
of ``repro.models.transformer``.

A model is a nested dict of tensors + plain functions:

* ``init_params(cfg, gen, device)``
* ``forward(params, cfg, tokens)`` -> (logits, caches, aux)
* ``init_cache(cfg, batch, max_len, device)`` / ``decode_step(...)`` ->
  the serving path

Layer kinds per config: attn (GQA) / mla (DeepSeek-V2) / ssm (Mamba2
SSD) / an xattn layer after the block every ``xattn_every`` layers for the
VLM and audio archs.  Zamba2-style hybrids reuse ONE shared attention
block (attention, norm2, MLP) every ``hybrid_every`` layers; each of its
positions keeps its own norm1 and KV cache.  MoE layers replace the MLP
from ``moe_layer_start`` on when ``cfg.moe``.  In-situ pruning hooks into
the path via ``prune_masks`` — per-layer keep-masks over the MLP's input
lanes.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import shard
from repro_torch.models.config import ATTN, MLA, SSM, ArchConfig


def _layer_kinds(cfg: ArchConfig) -> List[str]:
    kinds = cfg.layers()
    if cfg.hybrid_every:
        # zamba2: every Nth layer position gets the shared attention block
        kinds = [ATTN if (i + 1) % cfg.hybrid_every == 0 else SSM
                 for i in range(cfg.n_layers)]
    return kinds


def _is_moe_layer(cfg: ArchConfig, i: int, kind: str) -> bool:
    return bool(cfg.moe and kind in (ATTN, MLA) and i >= cfg.moe_layer_start)


def _has_xattn(cfg: ArchConfig, i: int) -> bool:
    return bool(cfg.xattn_every and (i + 1) % cfg.xattn_every == 0)


def init_shared_attn(cfg: ArchConfig, gen, device) -> Dict:
    """Zamba2's shared block: attention, norm2 and the MLP, made once."""
    return {"attn": L.init_attn(cfg, gen, device),
            "norm2": L.init_norm(cfg, gen, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def init_block(cfg: ArchConfig, kind: str, gen, device, *,
               moe: bool = False, xattn: bool = False,
               shared: bool = False) -> Dict:
    """One block's params: norm1, then the SSM, or (unless the block uses
    the shared attention block) attention or MLA with norm2 and moe or
    mlp; then xattn and xnorm for a fusion layer."""
    blk: Dict = {"norm1": L.init_norm(cfg, gen, device)}
    if kind == SSM:
        blk["ssm"] = M.init_ssm(cfg, gen, device)
    elif not shared:
        blk["attn"] = (L.init_mla(cfg, gen, device) if kind == MLA
                       else L.init_attn(cfg, gen, device))
        blk["norm2"] = L.init_norm(cfg, gen, device)
        if moe:
            blk["moe"] = MOE.init_moe(cfg, gen, device)
        else:
            blk["mlp"] = L.init_mlp(cfg, gen, device)
    if xattn:
        blk["xattn"] = L.init_xattn(cfg, gen, device)
        blk["xnorm"] = L.init_norm(cfg, gen, device)
    return blk


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                device) -> Dict:
    """Random params drawn from ``gen`` (a generator on ``device``; None on
    the meta device, which allocates nothing)."""
    device = torch.device(device)
    params: Dict = {"embed": L.init_embed(cfg, gen, device),
                    "final_norm": L.init_norm(cfg, gen, device)}
    blocks = []
    for i, kind in enumerate(_layer_kinds(cfg)):
        shared = bool(cfg.hybrid_every) and kind == ATTN
        if shared and "shared_attn" not in params:
            params["shared_attn"] = init_shared_attn(cfg, gen, device)
        blocks.append(init_block(cfg, kind, gen, device,
                                 moe=_is_moe_layer(cfg, i, kind),
                                 xattn=_has_xattn(cfg, i), shared=shared))
    params["blocks"] = blocks
    return params


def apply_block(shared_attn: Optional[Dict], blk: Dict, kind: str,
                cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                frontend: Optional[torch.Tensor], cache: Optional[Dict],
                prune_mask: Optional[torch.Tensor] = None):
    """One block -> (x, cache, aux).  Structure is read off the param dict:
    'ssm'/'attn'/'moe'/'mlp'/'xattn' membership decides the path; a block
    without its own attention uses ``shared_attn`` (zamba2).  A given cache
    is written in place.  ``prune_mask`` (d_model,) masks the MLP's input
    lanes (in-situ pruning, paper Algorithm S2)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == SSM and "ssm" in blk:
        h = L.apply_norm(blk["norm1"], x, cfg)
        y, cache = M.apply_ssm(blk["ssm"], h, cfg, cache)
        x = x + y
    else:
        ablk = shared_attn if "attn" not in blk else blk
        h = L.apply_norm(blk["norm1"], x, cfg)
        if kind == MLA:
            y, cache = L.apply_mla(ablk["attn"], h, cfg, positions, cache)
        else:
            y, cache = L.apply_attn(ablk["attn"], h, cfg, positions, cache)
        x = x + y
        h = L.apply_norm(ablk["norm2"], x, cfg)
        if "moe" in blk:
            y, aux = MOE.apply_moe(blk["moe"], h, cfg)
        else:
            if prune_mask is not None:
                h = h * prune_mask.to(h.dtype)[None, None, :]
            y = L.apply_mlp(ablk.get("mlp", blk.get("mlp")), h, cfg)
        x = x + y
    if "xattn" in blk and frontend is not None:
        h = L.apply_norm(blk["xnorm"], x, cfg)
        x = x + L.apply_xattn(blk["xattn"], h, frontend, cfg)
    return x, cache, aux


def forward(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[List] = None,
            prune_masks: Optional[Dict] = None):
    """tokens: (B, T) int.  Returns (logits (B,T,V) float32, caches, aux);
    given caches are written in place and returned."""
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)
    x = L.embed_tokens(params["embed"], tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (blk, kind) in enumerate(zip(params["blocks"], _layer_kinds(cfg))):
        c = caches[i] if caches is not None else None
        pm = prune_masks.get(f"mlp_{i}") if prune_masks else None
        x, _, aux = apply_block(params.get("shared_attn"), blk, kind, cfg, x,
                                positions, frontend, c, pm)
        aux_total = aux_total + aux
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x), caches, aux_total


def nll_loss(logits: torch.Tensor, labels: torch.Tensor, aux: torch.Tensor,
             aux_weight: float, vocab: Optional[int] = None):
    """(nll + aux_weight * aux, {"nll", "aux"}): the mean over tokens of
    logsumexp minus the gold logit, in float32.  Logits narrower than
    ``vocab`` are this rank's block of a vocabulary sharded over the model
    axis: the logsumexp takes its max and its sum over the ranks, and the
    gold logit comes from the rank that holds it."""
    logits = logits.float()
    V = logits.shape[-1]
    if vocab is None or V == vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        _, me, _ = shard.model_group()
        lo = L.vocab_blocks(vocab)[me][0][0]
        m = shard.max_ranks(logits.amax(dim=-1))
        logz = m + torch.log(shard.reduce(
            torch.exp(logits - m[..., None]).sum(dim=-1)))
        t = labels.long() - lo
        mine = (t >= 0) & (t < V)
        g = torch.gather(logits, -1, t.clamp(0, V - 1)[..., None])[..., 0]
        gold = shard.reduce(torch.where(mine, g, torch.zeros_like(g)))
    nll = torch.mean(logz - gold)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def last_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The last position's logits (B, 1, V) over the whole vocabulary,
    what sampling reads: under a mesh that shards the vocabulary, only
    that position is gathered over the model axis."""
    last = logits[:, -1:]
    if last.shape[-1] == vocab:
        return last
    return shard.relay(last, -1, L.vocab_blocks(vocab),
                       [[(0, vocab)]] * shard.model_size())


def loss_fn(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, frontend: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01):
    """Next-token cross entropy plus ``aux_weight`` times the routers'
    load-balance loss: (loss, {"nll", "aux"}), all float32 scalars."""
    logits, _, aux = forward(params, cfg, tokens, frontend)
    return nll_loss(logits, labels, aux, aux_weight)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> List:
    caches = []
    for kind in _layer_kinds(cfg):
        if kind == SSM:
            caches.append(M.init_ssm_cache(cfg, batch, device))
        elif kind == MLA:
            caches.append(L.init_mla_cache(cfg, batch, max_len, device))
        else:
            caches.append(L.init_attn_cache(cfg, batch, max_len, device))
    return caches


def decode_step(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                pos: torch.Tensor, caches: List,
                frontend: Optional[torch.Tensor] = None,
                prune_masks: Optional[Dict] = None):
    """One serving step: token (B,1) at positions pos (B,).  Returns
    (logits (B,1,V), caches)."""
    positions = pos[:, None].to(torch.int32)
    logits, caches, _ = forward(params, cfg, token, frontend=frontend,
                                positions=positions, caches=caches,
                                prune_masks=prune_masks)
    return logits, caches


def param_count(params) -> int:
    return sum(int(t.numel()) for _, t in tree.flatten_with_path(params))
