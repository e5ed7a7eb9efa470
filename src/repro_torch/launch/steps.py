"""Prefill / decode step builders over the stacked model: the port of
``repro.launch.steps`` (serving half).  They are plain functions; PyTorch
runs them eagerly, so there is nothing to compile."""
from __future__ import annotations

import torch

from repro_torch.models import stacked
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, with_frontend: bool = False):
    """(params, tokens, caches[, frontend]) -> (logits, caches): batched
    prefill through the serving path (writes the KV / SSM caches).  The
    frontend argument is taken when ``with_frontend``."""

    def prefill(params, tokens, caches, frontend=None):
        logits, caches, _ = stacked.forward(params, cfg, tokens,
                                            frontend=frontend, caches=caches)
        return logits, caches

    if with_frontend:
        return prefill
    return lambda p, t, c: prefill(p, t, c, None)


def make_decode_step(cfg: ArchConfig, with_frontend: bool = False):
    """(params, token (B,1), pos (B,), caches[, frontend]) -> (logits,
    caches): one serving step against the cache."""

    def decode(params, token, pos, caches, frontend=None):
        positions = pos[:, None].to(torch.int32)
        logits, caches, _ = stacked.forward(params, cfg, token,
                                            frontend=frontend,
                                            positions=positions,
                                            caches=caches)
        return logits, caches

    if with_frontend:
        return decode
    return lambda p, t, z, c: decode(p, t, z, c, None)
