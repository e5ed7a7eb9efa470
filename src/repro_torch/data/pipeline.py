"""Model inputs: the port of ``repro.data.pipeline`` on one device.

``TokenSource`` is the deterministic synthetic token stream, drawn with
numpy per (seed, step, row) exactly as the reference draws it, so both
packages train on the same batches and a restarted job replays identical
data.  ``host_batch`` carries a batch onto a device.  The VLM and audio
frontends are stubs: their archs take precomputed patch / frame
embeddings, drawn here from a fixed seed as the reference draws them.
``sharded_batch`` draws only this rank's rows of a batch laid out over a
mesh's data axes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.models.config import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class TokenSource:
    """Markov-ish synthetic token stream with a learnable signal (the next
    token depends on the previous one), deterministic in (seed, step,
    row)."""
    vocab: int
    seed: int = 0

    def batch(self, step: int, start: int, count: int, seq_len: int
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Rows [start, start+count) of the global batch for ``step``:
        (tokens, labels), int32 (count, seq_len) each."""
        toks = np.empty((count, seq_len + 1), dtype=np.int32)
        for i in range(count):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 131_071 + start + i)
            seq = rng.integers(0, self.vocab, seq_len + 1).astype(np.int32)
            # inject structure: token_{t+1} correlates with token_t
            mask = rng.random(seq_len) < 0.5
            nxt = (seq[:-1] * 31 + 7) % self.vocab
            seq[1:][mask] = nxt[mask]
            toks[i] = seq
        return toks[:, :-1], toks[:, 1:]


def host_batch(cfg: ArchConfig, shape: ShapeConfig, step: int,
               batch: Optional[int] = None, seq: Optional[int] = None,
               seed: int = 0, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole batch of ``step`` drawn on the host: (tokens, labels) as
    int32 tensors on ``device`` (None: the card)."""
    dev = backend.resolve_device(device)
    src = TokenSource(cfg.vocab, seed)
    x, y = src.batch(step, 0, batch or shape.global_batch,
                     seq or shape.seq_len)
    return (torch.from_numpy(np.ascontiguousarray(x)).to(dev),
            torch.from_numpy(np.ascontiguousarray(y)).to(dev))


def sharded_batch(cfg: ArchConfig, shape: ShapeConfig, step: int, mesh,
                  data_axes: Tuple[str, ...], seed: int = 0,
                  dtensor: bool = False):
    """This rank's rows of ``step``'s (tokens, labels), the batch dim laid
    out over ``data_axes`` of ``mesh`` (``sharding.batch_spec``): each rank
    draws its own rows, with no broadcast, and ranks along the model axis
    draw the same ones.  int32 tensors on the rank's device; with
    ``dtensor``, DTensors of the global (batch, seq) shape."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding
    b, s = shape.global_batch, shape.seq_len
    rows = sharding.local_rows(mesh, b, data_axes)
    dev = sharding.mesh_device(mesh)
    x, y = TokenSource(cfg.vocab, seed).batch(step, rows.start,
                                              rows.stop - rows.start, s)
    out = tuple(torch.from_numpy(np.ascontiguousarray(t)).to(dev)
                for t in (x, y))
    if not dtensor:
        return out
    where = sharding.placements(mesh, sharding.batch_spec(mesh, (b, s),
                                                          data_axes))
    return tuple(DTensor.from_local(t, mesh, where, run_check=False)
                 for t in out)


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
