"""Backbone assembly, one block at a time (the layerwise layout): the port
of ``repro.models.transformer``.

A model is a nested dict of tensors + plain functions:

* ``init_params(cfg, gen, device)``
* ``forward(params, cfg, tokens)`` -> (logits, caches, aux)
* ``init_cache(cfg, batch, max_len, device)`` / ``decode_step(...)`` ->
  the serving path

MoE layers replace the MLP from ``moe_layer_start`` on when ``cfg.moe``.
In-situ pruning hooks into the path via ``prune_masks`` — per-layer
keep-masks over the MLP's input lanes.  Blocks of the kinds not ported yet
(SSM, MLA, cross-attention, zamba2's shared attention block) raise
``NotImplementedError``: they are ROADMAP item A12b.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.config import ATTN, MLA, SSM, ArchConfig


def unported(what: str):
    """The error a block kind that is not ported yet raises."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md item A12b)")


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


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a config with a layer kind that is not ported yet."""
    kinds = set(_layer_kinds(cfg))
    if SSM in kinds:
        raise unported("the Mamba2 SSD block (kind 'ssm')")
    if MLA in kinds:
        raise unported("multi-head latent attention (kind 'mla')")
    if cfg.hybrid_every:
        raise unported("the hybrid shared attention block")
    if cfg.xattn_every:
        raise unported("the cross-attention layer")


def init_block(cfg: ArchConfig, moe: bool, gen, device) -> Dict:
    """One attention block's params: norm1, attn, norm2, and moe or mlp."""
    blk: Dict = {"norm1": L.init_norm(cfg, gen, device),
                 "attn": L.init_attn(cfg, gen, device),
                 "norm2": L.init_norm(cfg, gen, device)}
    if moe:
        blk["moe"] = MOE.init_moe(cfg, gen, device)
    else:
        blk["mlp"] = L.init_mlp(cfg, gen, device)
    return blk


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                device) -> Dict:
    """Random params drawn from ``gen`` (a generator on ``device``; None on
    the meta device, which allocates nothing)."""
    check_ported(cfg)
    device = torch.device(device)
    params: Dict = {"embed": L.init_embed(cfg, gen, device),
                    "final_norm": L.init_norm(cfg, gen, device)}
    params["blocks"] = [init_block(cfg, _is_moe_layer(cfg, i, kind), gen,
                                   device)
                        for i, kind in enumerate(_layer_kinds(cfg))]
    return params


def apply_block(shared_attn: Optional[Dict], blk: Dict, kind: str,
                cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                frontend: Optional[torch.Tensor], cache: Optional[Dict],
                prune_mask: Optional[torch.Tensor] = None):
    """One block -> (x, cache, aux).  Structure is read off the param dict:
    'moe'/'mlp' membership decides the path.  ``prune_mask`` (d_model,)
    masks the MLP's input lanes (in-situ pruning, paper Algorithm S2)."""
    if kind == SSM:
        raise unported("the Mamba2 SSD block (kind 'ssm')")
    if kind == MLA:
        raise unported("multi-head latent attention (kind 'mla')")
    if "attn" not in blk:
        raise unported("the hybrid shared attention block")
    if "xattn" in blk:
        raise unported("the cross-attention layer")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(blk["norm1"], x, cfg)
    y, new_cache = L.apply_attn(blk["attn"], h, cfg, positions, cache)
    x = x + y
    h = L.apply_norm(blk["norm2"], x, cfg)
    if "moe" in blk:
        y, aux = MOE.apply_moe(blk["moe"], h, cfg)
    else:
        if prune_mask is not None:
            h = h * prune_mask.to(h.dtype)[None, None, :]
        y = L.apply_mlp(blk["mlp"], h, cfg)
    return x + y, new_cache, aux


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


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> List:
    check_ported(cfg)
    return [L.init_attn_cache(cfg, batch, max_len, device)
            for _ in range(cfg.n_layers)]


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
