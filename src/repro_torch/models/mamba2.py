"""Mamba2 SSD (state-space duality) blocks: the port of
``repro.models.mamba2``.

Chunked parallel form for training / prefill (intra-chunk quadratic term
+ inter-chunk state recurrence, a loop over chunks), single-step recurrent
form for decode.  Used by mamba2-1.3b (attention-free) and zamba2-2.7b
(hybrid).

Shapes: d_inner = expand * d_model, H heads of P = d_inner / H channels,
state size S per head, a single B/C group (n_groups = 1), a causal
depthwise conv (kernel 4) on the x/B/C inputs.

Dtypes are the reference's: ``A_log``, ``D`` and ``dt_bias`` are float32
leaves in a bfloat16 model, ``dt`` and the SSM state are float32.  Where
the reference's ``einsum`` promotes bfloat16 operands against a float32
one, the port widens them first (``torch.einsum`` does not promote).

Under a mesh the block is tensor-parallel over the model axis: each
rank takes its heads (blocks of ceil(H / tp)) of ``in_proj``'s z, x and
dt columns (``[z | xBC | dt]``'s column shard is not head-aligned, so
:func:`repro_torch.models.shard.take` re-lays it with one all-to-all),
every rank computes the one group's B and C, the gated norm's mean square
is summed over the ranks (it spans all of ``d_inner``), and ``out_proj``
is row-parallel, summed to ``act_embed``.  The caches stay in their
stored layout (``ssm`` on heads, ``conv`` on its channels); a step reads
and writes back this rank's heads and channels.

The cached branch is written for one token, as the reference's: given a
cache and T > 1 tokens, only token 0 enters the SSM state and its output
is broadcast against every position's gate, while the conv state advances
over all T (``ROADMAP.md``, queue C, reproduced on purpose).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import shard
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _init


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = cfg.ssm_heads or d_in // P
    S = cfg.ssm_state
    return d_in, H, P, S


def init_ssm(cfg: ArchConfig, gen, device) -> Dict:
    d_in, H, P, S = _dims(cfg)
    d_proj = 2 * d_in + 2 * S + H          # z, x, B, C, dt
    conv_ch = d_in + 2 * S
    pd = cfg.pdtype()
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _init(gen, (cfg.d_model, d_proj), pd, device),
        "conv_w": _init(gen, (cfg.conv_kernel, conv_ch), pd, device,
                        scale=1.0 / math.sqrt(cfg.conv_kernel)),
        "conv_b": torch.zeros((conv_ch,), dtype=pd, device=device),
        "A_log": torch.as_tensor(
            np.log(np.linspace(1.0, 16.0, H, dtype=np.float32)), **f32),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "gate_norm": torch.ones((d_in,), dtype=pd, device=device),
        "out_proj": _init(gen, (d_in, cfg.d_model), pd, device),
    }


def _heads(cfg: ArchConfig):
    """(this rank's block of heads, every rank's blocks)."""
    _, me, size = shard.model_group()
    blocks = shard.split(_dims(cfg)[1], size)
    return blocks[me], blocks


def _proj_parts(cfg: ArchConfig, blocks) -> shard.Parts:
    """Each rank's columns of ``in_proj`` ([z | x | B | C | dt]): its heads'
    z, x and dt columns, and the one group's B and C."""
    d_in, H, P, S = _dims(cfg)
    return [[(a * P, b * P), (d_in + a * P, d_in + b * P),
             (2 * d_in, 2 * d_in + 2 * S),
             (2 * d_in + 2 * S + a, 2 * d_in + 2 * S + b)]
            for a, b in blocks]


def _conv_parts(cfg: ArchConfig, blocks) -> shard.Parts:
    """Each rank's conv channels ([x | B | C]): its heads' x, and B, C."""
    d_in, H, P, S = _dims(cfg)
    return [[(a * P, b * P), (d_in, d_in + 2 * S)] for a, b in blocks]


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  xBC: (B, L, C); w: (K, C).  With
    ``state`` (B, K-1, C): streaming decode.  Returns (silu(conv + b), the
    last K-1 inputs as the new state).  The K taps are summed in order, in
    the input's dtype, as the reference's."""
    K = w.shape[0]
    pad = (torch.zeros_like(xBC[:, :K - 1]) if state is None else state)
    xp = torch.cat([pad, xBC], dim=1)
    L = xBC.shape[1]
    out = xp[:, 0:L] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + L] * w[i]
    return F.silu(out + b), xp[:, -(K - 1):]


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                d_in: int) -> torch.Tensor:
    """RMS norm of y * silu(z) over all ``d_in`` channels: under a mesh
    each rank holds its heads' channels, and the sum of squares is summed
    over the model axis."""
    yf = y.float() * F.silu(z.float())
    if shard.model_size() == 1:
        ms = (yf * yf).mean(dim=-1, keepdim=True)
    else:
        ms = shard.sum_ranks((yf * yf).sum(dim=-1, keepdim=True)) / d_in
    rms = torch.rsqrt(ms + 1e-6)
    return (yf * rms).to(y.dtype) * w.to(y.dtype)


def _conv_inputs(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[torch.Tensor] = None):
    """The block's projections for this rank's Hl heads: (z, xs
    (B,L,Hl,P), B (B,L,S), C (B,L,S), dt (B,L,Hl) float32, A (Hl,)
    float32, the conv's new state over this rank's channels)."""
    d_in, H, P, S = _dims(cfg)
    Bb, L, _ = x.shape
    (h0, h1), blocks = _heads(cfg)
    dl = (h1 - h0) * P
    heads = [[blk] for blk in blocks]
    proj = x @ shard.take(params["in_proj"], -1, 2 * d_in + 2 * S + H,
                          _proj_parts(cfg, blocks))
    z, xBC, dt = proj[..., :dl], proj[..., dl:2 * dl + 2 * S], \
        proj[..., 2 * dl + 2 * S:]
    dt = F.softplus(dt.float() + shard.take(params["dt_bias"], 0, H, heads))
    A = -torch.exp(shard.take(params["A_log"], 0, H, heads))
    cp = _conv_parts(cfg, blocks)
    xBC, conv_state = _causal_conv(
        xBC, shard.take(params["conv_w"], -1, d_in + 2 * S, cp),
        shard.take(params["conv_b"], 0, d_in + 2 * S, cp), state)
    xs = xBC[..., :dl].reshape(Bb, L, h1 - h0, P)
    return (z, xs, xBC[..., dl:dl + S], xBC[..., dl + S:], dt, A,
            conv_state)


def apply_ssm(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, L, d_model).  A cache means single-step decode: its conv and
    SSM states are written in place (the returned cache is the same dict);
    with L > 1 only token 0 enters the SSM state, as the reference's.
    Under a mesh: this rank's heads, ``out_proj``'s rows summed over the
    model axis."""
    d_in, n_heads, P, S = _dims(cfg)
    Bb, L, _ = x.shape
    (h0, h1), blocks = _heads(cfg)
    H = h1 - h0                                   # this rank's heads
    heads = [[blk] for blk in blocks]
    x = shard.enter(x)
    D = shard.take(params["D"], 0, n_heads, heads)
    gate_norm = shard.take(params["gate_norm"], 0, d_in,
                           shard.spans(blocks, P))
    out_proj = shard.take(params["out_proj"], -2, d_in,
                          shard.spans(blocks, P))

    if cache is not None:
        cp = _conv_parts(cfg, blocks)
        z, xs, Bmat, Cmat, dt, A, conv_state = _conv_inputs(
            params, x, cfg, shard.held(cache["conv"], -1, d_in + 2 * S, cp))
        h = shard.held(cache["ssm"], -3, n_heads, heads)      # (B,H,P,S)
        # single step (L == 1)
        a = torch.exp(A[None, :] * dt[:, 0])                  # (B,H)
        dbx = torch.einsum("bhp,bs,bh->bhps", xs[:, 0].float(),
                           Bmat[:, 0].float(), dt[:, 0])
        h = h * a[..., None, None] + dbx
        y = torch.einsum("bhps,bs->bhp", h, Cmat[:, 0].float())
        y = y + D[None, :, None] * xs[:, 0]
        y = y.reshape(Bb, 1, H * P).to(x.dtype)
        y = _gated_norm(y, z, gate_norm, d_in)
        shard.store(cache["conv"], -1, d_in + 2 * S, cp, conv_state)
        shard.store(cache["ssm"], -3, n_heads, heads, h)
        return shard.reduce(y @ out_proj), cache

    z, xs, Bmat, Cmat, dt, A, _ = _conv_inputs(params, x, cfg)

    # ---- chunked SSD ----------------------------------------------------
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"sequence length {L} must divide the SSD chunk "
                         f"size {Q}")
    nC = L // Q
    xs_c = xs.reshape(Bb, nC, Q, H, P)
    B_c = Bmat.reshape(Bb, nC, Q, S)
    C_c = Cmat.reshape(Bb, nC, Q, S)
    dt_c = dt.reshape(Bb, nC, Q, H)
    la = A[None, None, None, :] * dt_c                 # log decay (B,nC,Q,H)
    cum = torch.cumsum(la, dim=2)                      # inclusive
    # intra-chunk: scores[i,j] = C_i.B_j * exp(cum_i - cum_j) for j <= i,
    # masked in LOG space (-1e30 before exp), as the reference's
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nC,Q,Q,H)
    diff = torch.where(tri[None, None, :, :, None], diff, -1e30)
    cb = torch.einsum("bnis,bnjs->bnij", C_c, B_c)     # compute dtype
    w_ij = cb[..., None] * torch.exp(diff)
    dx = dt_c[..., None] * xs_c                        # (B,nC,Q,H,P) f32
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w_ij, dx)
    # chunk states: S_n = sum_j exp(cum_Q - cum_j) B_j (dt_j x_j)
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nC,Q,H)
    st_c = torch.einsum("bnjs,bnjh,bnjhp->bnhps", B_c.float(), dec_end, dx)
    # inter-chunk recurrence over nC: the state entering each chunk
    a_chunk = torch.exp(cum[:, :, -1, :])              # (B,nC,H)
    h = torch.zeros((Bb, H, P, S), dtype=torch.float32, device=x.device)
    h_in = []
    for n in range(nC):
        h_in.append(h)
        h = h * a_chunk[:, n, :, None, None] + st_c[:, n]
    h_in = torch.stack(h_in, dim=1)                    # (B,nC,H,P,S)
    # y_inter[i] = C_i^T exp(cum_i) . h_incoming
    y_inter = torch.einsum("bnis,bnih,bnhps->bnihp", C_c.float(),
                           torch.exp(cum), h_in)
    y = (y_intra + y_inter).reshape(Bb, L, H, P)
    y = y + D[None, None, :, None] * xs
    y = y.reshape(Bb, L, H * P).to(x.dtype)
    y = _gated_norm(y, z, gate_norm, d_in)
    return shard.reduce(y @ out_proj), None


def init_ssm_cache(cfg: ArchConfig, batch: int, device,
                   lead: Tuple[int, ...] = ()) -> Dict:
    """Zeroed conv state (*lead, batch, K-1, conv channels) in the compute
    dtype and SSM state (*lead, batch, H, P, S) in float32."""
    d_in, H, P, S = _dims(cfg)
    conv_ch = d_in + 2 * S
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv_kernel - 1, conv_ch),
                            dtype=cfg.dtype(), device=device),
        "ssm": torch.zeros(lead + (batch, H, P, S), dtype=torch.float32,
                           device=device),
    }


def apply_ssm_ref(params: Dict, x: torch.Tensor, cfg: ArchConfig
                  ) -> torch.Tensor:
    """Sequential-recurrence oracle (slow, exact) for tests."""
    d_in, H, P, S = _dims(cfg)
    Bb, L, _ = x.shape
    z, xs, Bmat, Cmat, dt, A, _ = _conv_inputs(params, x, cfg)
    h = torch.zeros((Bb, H, P, S), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(A[None, :] * dt[:, t])                  # (B,H)
        h = h * a[..., None, None] + torch.einsum(
            "bhp,bs,bh->bhps", xs[:, t].float(), Bmat[:, t].float(),
            dt[:, t])
        ys.append(torch.einsum("bhps,bs->bhp", h, Cmat[:, t].float()))
    y = torch.stack(ys, dim=1) + params["D"][None, None, :, None] * xs
    y = y.reshape(Bb, L, d_in).to(x.dtype)
    y = _gated_norm(y, z, params["gate_norm"], d_in)
    return y @ params["out_proj"]
