"""PyTorch NN layers for the model zoo: the port of ``repro.models.layers``
(attention-and-MLP half).  Params are nested dicts of tensors with the
reference's layout and leaf names, so ``tree.params_from_numpy`` carries
the reference's weights across; every layer is an (init, apply) pair.

Covers RMSNorm (+ qk_norm), non-parametric LayerNorm (OLMo), interleaved
RoPE, GQA/MQA attention with a head_dim override (Gemma) and its KV cache,
SwiGLU/GeGLU MLPs, the embedding and the LM head.  MLA and cross-attention
(DeepSeek-V2, Llama-3.2-Vision, MusicGen) are ROADMAP item A12b.

The reference's ``shard.constrain`` calls are GSPMD sharding hints; a
one-card path has no mesh, so they are left out here.

Products whose reference asks for float32 out of bfloat16 operands (the
attention scores, the LM head) go through :func:`matmul_f32`, which never
rounds the product to the operands' type.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig


def _init(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
          device: torch.device, scale: Optional[float] = None
          ) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in float32 from ``gen`` (which lives on
    ``device``), cast to ``dtype``; scale defaults to 1/sqrt(shape[0]), as
    the reference's (for a stacked (E, d, f) expert bank that is 1/sqrt(E)).
    On the meta device: the shape and dtype only, no memory."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def _ones(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.ones((n,), dtype=dtype, device=device)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a: (..., M, K), b: (K, N) or batched like a) as float32,
    the sums kept in float32 and never rounded to the operands' type: the
    reference's ``preferred_element_type=jnp.float32``.  Float32 operands
    take a plain product.  bfloat16 / float16 operands on the card take
    cuBLAS's product with a float32 output (``torch.mm`` / ``torch.bmm``
    with ``out_dtype``), so the weights are never widened; on the host they
    are widened (a product of two bfloat16 values is exact in float32)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type != "cuda":
        return a.float() @ b.float()
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(a.shape[:-1] + (b.shape[-1],))
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape((-1,) + a.shape[-2:]),
                    b.reshape((-1,) + b.shape[-2:]), out_dtype=torch.float32)
    return out.reshape(lead + out.shape[-2:])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ArchConfig, gen, device) -> Dict:
    if cfg.norm == "nonparam_ln":
        return {}
    return {"w": _ones(cfg.d_model, cfg.pdtype(), device)}


def apply_norm(params: Dict, x: torch.Tensor, cfg: ArchConfig
               ) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "nonparam_ln":
        mu = xf.mean(dim=-1, keepdim=True)
        # population variance, as jnp.var (ddof 0)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * rms).to(x.dtype) * params["w"].to(x.dtype)


def _head_rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * rms).to(x.dtype) * w.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, T, H, D) with D even; positions: (B, T).  Rotates the
    interleaved pairs (x[..., 0::2], x[..., 1::2]) and interleaves them
    back, as the reference does (not the half-split rotation)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions[..., None].float() * freqs                # (B, T, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA/MQA attention
# ---------------------------------------------------------------------------


def init_attn(cfg: ArchConfig, gen, device) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = cfg.pdtype()
    p = {
        "wq": _init(gen, (d, H * hd), pd, device),
        "wk": _init(gen, (d, KV * hd), pd, device),
        "wv": _init(gen, (d, KV * hd), pd, device),
        "wo": _init(gen, (H * hd, d), pd, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ones(hd, pd, device)
        p["k_norm"] = _ones(hd, pd, device)
    return p


def _causal_mask(q_pos, kp, kv_len):
    """(B|1, 1, T, S) mask: key position <= query position, and (decode)
    only the filled cache slots, below ``kv_len``."""
    mask = q_pos[:, None, :, None] >= kp[:, None, None, :]
    if kv_len is not None:
        mask = mask & (kp[:, None, None, :] < kv_len[:, None, None, None])
    return mask


def _sdpa(q, k, v, causal: bool, q_pos=None, kv_len=None,
          impl: str = "naive", chunk: int = 1024):
    """q: (B,T,H,hd), k/v: (B,S,KV,hd) — grouped heads expanded by repeat.

    ``impl='chunked'``: flash-style online softmax over KV chunks, never
    materialising the (T, S) score matrix (numerically equal to naive,
    pinned by tests).  Masked scores are -1e30, not -inf, and the softmax
    is cast back to q's dtype before the value product, as the
    reference's."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if KV != H:
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if impl == "chunked" and S > chunk and S % chunk == 0:
        return _sdpa_chunked(q, k, v, causal, q_pos, kv_len, chunk)
    scores = matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
    scores = scores / math.sqrt(hd)                           # (B,H,T,S)
    if causal:
        dev = q.device
        qp = q_pos if q_pos is not None else torch.arange(
            T, device=dev)[None, :]
        kp = torch.arange(S, device=dev)[None, :]
        scores = torch.where(_causal_mask(qp, kp, kv_len), scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (probs @ v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)


def _sdpa_chunked(q, k, v, causal, q_pos, kv_len, chunk):
    B, T, H, hd = q.shape
    S, dv = k.shape[1], v.shape[-1]
    dev = q.device
    qp = q_pos if q_pos is not None else torch.arange(T, device=dev)[None, :]
    qf = q.float().permute(0, 2, 1, 3)                        # (B,H,T,hd)
    m = torch.full((B, H, T), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, T, dv), dtype=torch.float32, device=dev)
    for off in range(0, S, chunk):
        kc = k[:, off:off + chunk].float().permute(0, 2, 3, 1)
        vc = v[:, off:off + chunk].float().permute(0, 2, 1, 3)
        s = (qf @ kc) / math.sqrt(hd)
        if causal:
            kp = off + torch.arange(chunk, device=dev)[None, :]
            s = torch.where(_causal_mask(qp, kp, kv_len), s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vc
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _write_rows(cache: torch.Tensor, update: torch.Tensor,
                start: torch.Tensor) -> None:
    """cache[b, start[b] : start[b] + T] = update[b], in place, each row at
    its own position; the start is clamped so that the update fits, as
    ``lax.dynamic_update_slice`` clamps it."""
    B, T = update.shape[:2]
    dev = cache.device
    s = start.clamp(0, cache.shape[1] - T).long()
    cols = s[:, None] + torch.arange(T, device=dev)[None, :]
    cache[torch.arange(B, device=dev)[:, None], cols] = update


def apply_attn(params: Dict, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, cache: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention over x (B, T, d) at ``positions`` (B, T).  With a
    cache: this step's k/v are written into it in place at the rows'
    positions, and the queries attend over the cache (the returned cache
    is the same dict)."""
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params["wq"]).reshape(B, T, H, hd)
    k = (x @ params["wk"]).reshape(B, T, KV, hd)
    v = (x @ params["wv"]).reshape(B, T, KV, hd)
    if cfg.qk_norm:
        q = _head_rms(q, params["q_norm"])
        k = _head_rms(k, params["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        idx = positions[:, 0]
        _write_rows(cache["k"], k, idx)
        _write_rows(cache["v"], v, idx)
        out = _sdpa(q, cache["k"], cache["v"], causal=True, q_pos=positions,
                    kv_len=idx + T, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    else:
        out = _sdpa(q, k, v, causal=True, q_pos=positions,
                    impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return out.reshape(B, T, H * hd) @ params["wo"], cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                    lead: Tuple[int, ...] = ()) -> Dict:
    """Zeroed k/v caches, (*lead, batch, max_len, KV, hd) in the compute
    dtype; ``lead`` stacks one per layer of a run."""
    shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype(), device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype(), device=device)}


# ---------------------------------------------------------------------------
# GLU MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, gen, device, d_ff: Optional[int] = None
             ) -> Dict:
    ff = d_ff or cfg.d_ff
    return {
        "wi": _init(gen, (cfg.d_model, 2 * ff), cfg.pdtype(), device),
        "wo": _init(gen, (ff, cfg.d_model), cfg.pdtype(), device),
    }


def glu_act(gate: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """SiLU, or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    if cfg.mlp_act == "silu":
        return F.silu(gate)
    return F.gelu(gate, approximate="tanh")


def apply_mlp(params: Dict, x: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    gate, up = (x @ params["wi"]).chunk(2, dim=-1)
    return (glu_act(gate, cfg) * up) @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embed(cfg: ArchConfig, gen, device) -> Dict:
    return {
        "tok": _init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype(), device,
                     scale=0.02),
        "head": _init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype(), device),
    }


def embed_tokens(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def lm_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, T, V) float32 logits of x (B, T, d) through the head."""
    return matmul_f32(x, params["head"])
