"""Decode loop + comparison-free top-k sampling: the port of
``repro.models.sampling``.

Top-k logit filtering goes through the sort-engine facade
(:func:`repro_torch.sort.topk_mask` — histogram radix-select, the paper's
digit-read selection applied at the vocab scale) instead of a comparison
sort.  The draw is the Gumbel-max trick over a ``torch.Generator``'s
uniforms, the algorithm of ``jax.random.categorical``; the two frameworks'
random bits differ, so a sampled token matches the reference's only in
distribution (greedy decoding, ``temperature <= 0``, matches exactly).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import sort as sort_engine
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.runtime import spans


def sample_logits(logits: torch.Tensor, gen: Optional[torch.Generator],
                  top_k: int = 0, temperature: float = 1.0) -> torch.Tensor:
    """logits: (B, V) -> int32 token ids (B,), drawn with ``gen`` (a
    generator on the logits' device).  ``top_k`` 0 disables filtering;
    masked logits are -1e30, so a draw never leaves the top-k mask."""
    with spans.span("sample", logits):
        if temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        lg = logits.float() / temperature
        if top_k:
            mask = sort_engine.topk_mask(lg, top_k, largest=True)
            lg = torch.where(mask, lg, -1e30)
        u = torch.rand(lg.shape, generator=gen, device=lg.device)
        tiny = torch.finfo(u.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
        return (lg + gumbel).argmax(dim=-1).to(torch.int32)


def generate(params, cfg: ArchConfig, prompt: torch.Tensor, max_new: int,
             gen: Optional[torch.Generator], top_k: int = 0,
             temperature: float = 1.0,
             frontend: Optional[torch.Tensor] = None,
             prune_masks: Optional[Dict] = None) -> torch.Tensor:
    """Greedy/top-k generation over layerwise params.  prompt: (B, T0).
    Returns (B, T0+max_new) int32."""
    B, T0 = prompt.shape
    dev = prompt.device
    caches = T.init_cache(cfg, B, T0 + max_new, dev)
    # prefill one token at a time keeps this reference implementation simple
    # and cache-exact; the serving CLI uses batched prefill
    logits, caches = _prefill(params, cfg, prompt, caches, frontend,
                              prune_masks)
    toks = [prompt.to(torch.int32)]
    pos = torch.full((B,), T0 - 1, dtype=torch.int32, device=dev)
    out_tok = sample_logits(logits[:, -1, :], gen, top_k,
                            temperature)[:, None]
    toks.append(out_tok)
    for _ in range(max_new - 1):
        pos = pos + 1
        logits, caches = T.decode_step(params, cfg, out_tok, pos, caches,
                                       frontend, prune_masks)
        out_tok = sample_logits(logits[:, -1, :], gen, top_k,
                                temperature)[:, None]
        toks.append(out_tok)
    return torch.cat(toks, dim=1)


def _prefill(params, cfg, prompt, caches, frontend, prune_masks):
    B, T0 = prompt.shape
    logits = None
    for t in range(T0):
        pos = torch.full((B,), t, dtype=torch.int32, device=prompt.device)
        logits, caches = T.decode_step(params, cfg, prompt[:, t:t + 1], pos,
                                       caches, frontend, prune_masks)
    return logits, caches
