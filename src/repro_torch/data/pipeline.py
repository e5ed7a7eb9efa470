"""Model inputs: the port of ``repro.data.pipeline``'s frontend stub.

The VLM and audio frontends are stubs: their archs take precomputed
patch / frame embeddings, drawn here from a fixed seed as the reference
draws them.  The training inputs (``TokenSource``, ``host_batch``,
``sharded_batch``) come with the training slice (``ROADMAP.md``, A12c).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


def frontend_stub(cfg: ArchConfig, batch: int, device,
                  dtype: Optional[torch.dtype] = None
                  ) -> Optional[torch.Tensor]:
    """Precomputed patch / frame embeddings (batch, frontend_tokens,
    frontend_dim or d_model) for the VLM / audio archs on ``device``, in
    ``dtype`` (default: the compute dtype); None for an arch without a
    frontend.  The float64 draw of ``default_rng(1234)`` is rounded to
    float32 and then to a narrower type, on the host: the reference's cast
    to bfloat16 rounds through float32 the same way, so the bits agree (a
    single rounding from float64 differs in a few elements a million)."""
    if not cfg.frontend_tokens:
        return None
    rng = np.random.default_rng(1234)
    fe = rng.standard_normal(
        (batch, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model))
    out = torch.from_numpy(fe.astype(np.float32)).to(dtype or cfg.dtype())
    return out.to(device)
