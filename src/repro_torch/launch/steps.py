"""Prefill / decode step builders over the stacked model: the port of
``repro.launch.steps`` (serving half).  They are plain functions; PyTorch
runs them eagerly, so there is nothing to compile."""
from __future__ import annotations

import torch

from repro_torch.models import stacked
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig):
    """(params, tokens, caches) -> (logits, caches): batched prefill through
    the serving path (writes the KV caches)."""

    def prefill(params, tokens, caches):
        logits, caches, _ = stacked.forward(params, cfg, tokens,
                                            caches=caches)
        return logits, caches

    return prefill


def make_decode_step(cfg: ArchConfig):
    """(params, token (B,1), pos (B,), caches) -> (logits, caches): one
    serving step against the cache."""

    def decode(params, token, pos, caches):
        positions = pos[:, None].to(torch.int32)
        logits, caches, _ = stacked.forward(params, cfg, token,
                                            positions=positions,
                                            caches=caches)
        return logits, caches

    return decode
