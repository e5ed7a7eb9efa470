"""PyTorch NN layers for the model zoo: the port of ``repro.models.layers``
(attention-and-MLP half).  Params are nested dicts of tensors with the
reference's layout and leaf names, so ``tree.params_from_numpy`` carries
the reference's weights across; every layer is an (init, apply) pair.

Covers RMSNorm (+ qk_norm), non-parametric LayerNorm (OLMo), interleaved
RoPE, GQA/MQA attention with a head_dim override (Gemma) and its KV cache,
cross-attention over frontend embeddings (Llama-3.2-Vision, MusicGen), MLA
with weight absorption for decode (DeepSeek-V2) and its latent cache,
SwiGLU/GeGLU MLPs, the embedding and the LM head.

Under a mesh (``launch/steps.py``) each layer computes tensor-parallel
over the model axis where the reference's ``shard.constrain`` calls put
the model axis (``models/shard.py``): the heads of ``act_heads`` (blocks
of ceil(H / tp), as GSPMD pads), the KV heads of ``act_kv_heads`` (or,
where the axis does not divide them, their ``head_dim``, gathered for the
product), the FFN columns of ``act_ff``, the vocabulary of
``act_vocab``; the row-parallel output products are summed to
``act_embed``.  Without a mesh, or on one rank, every collective is the
identity and the layers are the one-card ones.

Products whose reference asks for float32 out of bfloat16 operands (the
attention scores, MLA's latent scores, the LM head) go through
:func:`matmul_f32`, which never rounds the product to the operands' type.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attn
from repro_torch.models import shard
from repro_torch.models.config import ArchConfig
from repro_torch.runtime import spans


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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cuBLAS's product of two 2-D or two 3-D (batched) operands of one
    narrow type with a float32 output: float32 sums, never rounded."""
    mm = torch.mm if a.dim() == 2 else torch.bmm
    return mm(a, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """:func:`_mm_f32` with a backward (``aten::mm.dtype`` has none).

    The reference's transpose of ``einsum(..., preferred_element_type=
    float32)`` is the same product of the float32 cotangent with the other
    operand, float32 out, then cast to the operand's own type.  At the
    reference's DEFAULT precision a float32 operand enters the MXU of its
    TPU as bfloat16, so each backward product here takes the cotangent
    rounded to the operands' type and the other operand as it lies, sums in
    float32 (:func:`_mm_f32`) and rounds once to the operand's type.
    Neither operand is ever widened: at qwen2-moe's head a float32 copy of
    the (2048, 151936) weights would be 1.16 GiB a step."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mm_f32(a.transpose(-1, -2), g).to(b.dtype)
        return da, db


_form = threading.local()


class card_form:
    """Within it, :func:`matmul_f32` takes its card branch on host tensors
    too: the dry run (``launch/dryrun.py``) runs a step on fake CPU
    tensors, and counts the card's products that way.  Real host tensors
    have no float32-output product of narrow operands: use it on fake
    tensors only."""

    def __enter__(self):
        self.prev = getattr(_form, "card", False)
        _form.card = True
        return self

    def __exit__(self, *exc):
        _form.card = self.prev
        return False


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a: (..., M, K), b: (K, N) or batched like a) as float32,
    the sums kept in float32 and never rounded to the operands' type: the
    reference's ``preferred_element_type=jnp.float32``.  Float32 operands
    take a plain product.  bfloat16 / float16 operands on the card take
    cuBLAS's product with a float32 output (:class:`_MatmulF32`, whose
    backward keeps each gradient in its operand's type), so the weights are
    never widened; on the host they are widened (a product of two bfloat16
    values is exact in float32), and autograd differentiates the widened
    product as the reference's CPU run does."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type != "cuda" and not getattr(_form, "card", False):
        return a.float() @ b.float()
    if b.dim() == 2:
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(a.shape[:-1] + (b.shape[-1],))
    lead = a.shape[:-2]
    out = _MatmulF32.apply(a.reshape((-1,) + a.shape[-2:]),
                           b.reshape((-1,) + b.shape[-2:]))
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


def yarn_mscale(scale: float, m: float) -> float:
    """YaRN's attention factor ``0.1 m ln(scale) + 1`` (1 for scale <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_inv_freq(d: int, theta: float, device,
                  yarn: Optional[ArchConfig] = None) -> torch.Tensor:
    """The (d/2,) float32 inverse frequencies of RoPE over d dims:
    ``theta^(-2i/d)``, or, where ``yarn`` has a scaling factor s > 1,
    YaRN's blend of them with their interpolation by s (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): the dims that turn fewer than
    ``beta_slow`` times over the original context are divided by s, those
    that turn more than ``beta_fast`` times kept, a linear ramp between."""
    pw = theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                device=device) / d)
    s = yarn.rope_scaling_factor if yarn is not None else 1.0
    if s <= 1:
        return 1.0 / pw
    L0 = yarn.rope_original_max_position
    # the dim that turns r times over the original context
    dim = lambda r: (d * math.log(L0 / (r * 2 * math.pi))
                     / (2 * math.log(theta)))
    low = max(math.floor(dim(yarn.rope_beta_fast)), 0)
    high = min(math.ceil(dim(yarn.rope_beta_slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return 1.0 / (s * pw) * ramp + 1.0 / pw * (1 - ramp)


def mla_score_div(cfg: ArchConfig) -> float:
    """What MLA's scores are divided by, the inverse of its softmax scale:
    sqrt(key width), over YaRN's ``mscale(s, mscale_all_dim)`` squared
    where the config scales RoPE (over 1 where it does not, so the plain
    divisor exactly)."""
    return (math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
            / yarn_mscale(cfg.rope_scaling_factor, cfg.rope_mscale_all_dim)
            ** 2)


def rope_cos_sin(positions: torch.Tensor, d: int, theta: float, device,
                 yarn: Optional[ArchConfig] = None):
    """(cos, sin) (B, T, 1, d/2) of RoPE over d dims at ``positions`` (B,
    T); ``yarn``: a config whose YaRN scaling applies
    (:func:`rope_inv_freq`; cos and sin times ``mscale(s, mscale) /
    mscale(s, mscale_all_dim)``)."""
    freqs = rope_inv_freq(d, theta, device, yarn)
    ang = positions[..., None].float() * freqs                # (B, T, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    if yarn is not None:
        s = yarn.rope_scaling_factor
        m = (yarn_mscale(s, yarn.rope_mscale)
             / yarn_mscale(s, yarn.rope_mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    return cos, sin


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x: (B, T, H, D) rotated by :func:`rope_cos_sin`'s angles: the
    interleaved pairs (x[..., 0::2], x[..., 1::2]) interleaved back, as the
    reference does (not the half-split rotation)."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         yarn: Optional[ArchConfig] = None) -> torch.Tensor:
    """x: (B, T, H, D) with D even; positions: (B, T).  Rotates the
    interleaved pairs (x[..., 0::2], x[..., 1::2]) and interleaves them
    back, as the reference does (not the half-split rotation); ``yarn`` as
    :func:`rope_cos_sin`."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta, x.device,
                                   yarn))


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
          impl: str = "naive", chunk: int = 1024,
          div: Optional[float] = None):
    """q: (B,T,H,hd), k/v: (B,S,KV,hd) — grouped heads expanded by repeat.

    ``impl='chunked'``: flash-style online softmax over KV chunks, never
    materialising the (T, S) score matrix (numerically equal to naive,
    pinned by tests).  Scores are divided by ``div`` (sqrt(hd) by
    default).  Masked scores are -1e30, not -inf, and the softmax is cast
    back to q's dtype before the value product, as the reference's."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    div = div or math.sqrt(hd)
    if KV != H:
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if impl == "chunked" and S > chunk and S % chunk == 0:
        return _sdpa_chunked(q, k, v, causal, q_pos, kv_len, chunk, div)
    scores = matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
    scores = scores / div                                     # (B,H,T,S)
    if causal:
        dev = q.device
        qp = q_pos if q_pos is not None else torch.arange(
            T, device=dev)[None, :]
        kp = torch.arange(S, device=dev)[None, :]
        scores = torch.where(_causal_mask(qp, kp, kv_len), scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (probs @ v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)


def _sdpa_chunked(q, k, v, causal, q_pos, kv_len, chunk, div):
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
        s = (qf @ kc) / div
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


def _cached(cache: torch.Tensor, update: torch.Tensor,
            start: torch.Tensor) -> torch.Tensor:
    """Write this step's ``update`` (B, T, ..., w) into a cache leaf at the
    rows' positions and return the whole cache the attention reads.  The
    leaf holds all of it, or (under a mesh) this rank's even block of the
    last dim (the ``head_dim`` fallback, MLA's latent), written from
    ``update``'s block and gathered for the read, or this rank's block of
    the sequence (``seq_shard``), gathered, written and put back."""
    if shard.seq_cache():
        _, me, _ = shard.model_group()
        whole = shard.gather(cache, 1)
        _write_rows(whole, update, start)
        n = cache.shape[1]
        cache.copy_(whole.narrow(1, me * n, n))
        return whole
    w = cache.shape[-1]
    if w == update.shape[-1]:
        _write_rows(cache, update, start)
        return cache
    _, me, _ = shard.model_group()
    _write_rows(cache, update.narrow(-1, me * w, w), start)
    return shard.gather(cache, -1)


def _kv_parts(cfg: ArchConfig, lay: Optional[int], size: int):
    """Each rank's columns of ``wk`` / ``wv`` (KV heads of hd) for the KV
    layout ``lay``: its heads (2), its block of every head's ``head_dim``
    (3), or all of them (None)."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    if lay == 2:
        return shard.spans(shard.split(KV, size), hd)
    if lay == 3:
        return [[(j * hd + a, j * hd + b) for j in range(KV)]
                for a, b in shard.split(hd, size)]
    return [[(0, KV * hd)]] * size


def _own_kv(k: torch.Tensor, heads: Tuple[int, int], n_heads: int
            ) -> torch.Tensor:
    """The KV heads (B, S, KV, hd) that this rank's query heads read, one
    a query head: the grouped expansion of :func:`_sdpa`, for a block of
    the heads."""
    rep = n_heads // k.shape[2]
    sel = torch.arange(heads[0], heads[1], device=k.device) // rep
    return k.index_select(2, sel)


def _project_qkv(params: Dict, x: torch.Tensor, kv_in: torch.Tensor,
                 cfg: ArchConfig, cached: bool):
    """This rank's query heads (B, T, Hl, hd) and the keys and values (B,
    S, ., hd) in the ``act_kv_heads`` layout: its KV heads (layout 2), or
    its block of every KV head's ``head_dim`` (3), gathered over the model
    axis (the head norm and RoPE read all of it), or all of them (None).
    Returns (q, k, v, layout, this rank's block of query heads)."""
    B, T, _ = x.shape
    S = kv_in.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    _, me, size = shard.model_group()
    heads = shard.split(H, size)
    lay = shard.model_dim((B, T, KV, hd), "act_kv_heads")
    if cached and shard.seq_cache():
        lay = None                       # the cache holds every head
    h0, h1 = heads[me]
    q = x @ shard.take(params["wq"], -1, H * hd, shard.spans(heads, hd))
    q = q.reshape(B, T, h1 - h0, hd)
    kv_cols = _kv_parts(cfg, lay, size)
    k = kv_in @ shard.take(params["wk"], -1, KV * hd, kv_cols)
    v = kv_in @ shard.take(params["wv"], -1, KV * hd, kv_cols)
    if lay == 3:
        k = shard.gather(k.reshape(B, S, KV, -1), 3)
        v = shard.gather(v.reshape(B, S, KV, -1), 3)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    return q, k, v, lay, heads[me]


def apply_attn(params: Dict, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, cache: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention over x (B, T, d) at ``positions`` (B, T).  With a
    cache: this step's k/v are written into it in place at the rows'
    positions, and the queries attend over the cache (the returned cache
    is the same dict); one query token (T = 1, a decode step) attends
    through :func:`repro_torch.kernels.decode_attn.decode_attention`, which
    on the card reads the cache in its stored layout, and counts
    ``attn.decode_rows`` (B) and ``attn.cache_slots`` (B·S).  Under a mesh:
    this rank's heads, ``wo``'s rows summed over the model axis."""
    with spans.span("attn", x):
        B, T, d = x.shape
        H, hd = cfg.n_heads, cfg.hd
        x = shard.enter(x)
        q, k, v, lay, heads = _project_qkv(params, x, x, cfg,
                                           cache is not None)
        if cfg.qk_norm:
            q = _head_rms(q, shard.enter(params["q_norm"]))
            k = _head_rms(k, shard.enter(params["k_norm"]))
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cache is not None:
            idx = positions[:, 0]
            k = _cached(cache["k"], k, idx)
            v = _cached(cache["v"], v, idx)
        if lay != 2 and shard.model_size() > 1:
            k, v = _own_kv(k, heads, H), _own_kv(v, heads, H)
        if cache is not None and T == 1:
            # one query token reads the cache where it lies
            spans.count("attn.decode_rows", B)
            spans.count("attn.cache_slots", B * k.shape[1])
            out = decode_attn.decode_attention(q, k, v, idx)
        else:
            out = _sdpa(q, k, v, causal=True, q_pos=positions,
                        kv_len=None if cache is None else idx + T,
                        impl=cfg.attn_impl, chunk=cfg.attn_chunk)
        wo = shard.take(params["wo"], -2, H * hd,
                        shard.spans(shard.split(H, shard.model_size()), hd))
        out = out.reshape(B, T, (heads[1] - heads[0]) * hd)
        return shard.reduce(out @ wo), cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                    lead: Tuple[int, ...] = ()) -> Dict:
    """Zeroed k/v caches, (*lead, batch, max_len, KV, hd) in the compute
    dtype; ``lead`` stacks one per layer of a run."""
    shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype(), device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype(), device=device)}


# ---------------------------------------------------------------------------
# Cross-attention (VLM image-fusion layers; Llama-3.2-Vision style gating)
# ---------------------------------------------------------------------------


def init_xattn(cfg: ArchConfig, gen, device) -> Dict:
    """Queries from the text stream, keys and values projected from the
    frontend's ``frontend_dim``; the tanh gate starts at 0, so at init the
    layer adds exactly 0, as the reference's."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    fd = cfg.frontend_dim or d
    pd = cfg.pdtype()
    return {
        "wq": _init(gen, (d, H * hd), pd, device),
        "wk": _init(gen, (fd, KV * hd), pd, device),
        "wv": _init(gen, (fd, KV * hd), pd, device),
        "wo": _init(gen, (H * hd, d), pd, device),
        "gate": torch.zeros((), dtype=pd, device=device),
    }


def apply_xattn(params: Dict, x: torch.Tensor, enc: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """x: (B,T,d) text stream; enc: (B,F,frontend_dim) frontend embeddings.
    Non-causal GQA over the F frontend tokens, scaled by tanh(gate); under
    a mesh, tensor-parallel as :func:`apply_attn`."""
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q, k, v, lay, heads = _project_qkv(params, shard.enter(x),
                                       shard.enter(enc), cfg, False)
    if lay != 2 and shard.model_size() > 1:
        k, v = _own_kv(k, heads, H), _own_kv(v, heads, H)
    out = _sdpa(q, k, v, causal=False)
    wo = shard.take(params["wo"], -2, H * hd,
                    shard.spans(shard.split(H, shard.model_size()), hd))
    out = out.reshape(B, T, (heads[1] - heads[0]) * hd)
    out = shard.reduce(out @ wo)
    return torch.tanh(params["gate"]).to(x.dtype) * out


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(cfg: ArchConfig, gen, device) -> Dict:
    """A low-rank query (``q_lora_rank`` > 0) or a full one (``wq``), the
    joint latent ``wkv_a`` (kv_lora_rank + the shared RoPE key), and the
    per-head up-projections of the latent to keys and values."""
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    L, pd = cfg.kv_lora_rank, cfg.pdtype()
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = _init(gen, (d, cfg.q_lora_rank), pd, device)
        p["q_norm"] = _ones(cfg.q_lora_rank, pd, device)
        p["wq_b"] = _init(gen, (cfg.q_lora_rank, H * (dn + dr)), pd, device)
    else:
        p["wq"] = _init(gen, (d, H * (dn + dr)), pd, device)
    p["wkv_a"] = _init(gen, (d, L + dr), pd, device)
    p["kv_norm"] = _ones(L, pd, device)
    p["wk_b"] = _init(gen, (L, H * dn), pd, device)
    p["wv_b"] = _init(gen, (L, H * dv), pd, device)
    p["wo"] = _init(gen, (H * dv, d), pd, device)
    return p


def _mla_q(params: Dict, x: torch.Tensor, cfg: ArchConfig, cs,
           heads: List[Tuple[int, int]]):
    """(q_nope (B,T,Hl,dn), q_rope (B,T,Hl,dr) rotated by ``cs``, the
    positions' (cos, sin)) of this rank's heads; the low-rank query's
    latent is replicated over the model axis and enters the rank's
    heads."""
    B, T, _ = x.shape
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cols = shard.spans(heads, dn + dr)
    if cfg.q_lora_rank:
        ql = shard.enter(_head_rms(x @ params["wq_a"], params["q_norm"]))
        q = ql @ shard.take(params["wq_b"], -1, H * (dn + dr), cols)
    else:
        q = shard.enter(x) @ shard.take(params["wq"], -1, H * (dn + dr),
                                        cols)
    _, me, _ = shard.model_group()
    q = q.reshape(B, T, heads[me][1] - heads[me][0], dn + dr)
    return q[..., :dn], rotate(q[..., dn:], *cs)


def apply_mla(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Without a cache (training / prefill): the naive expansion, the one
    RoPE key of a token broadcast over the heads, through :func:`_sdpa`
    (key width dn + dr, value width dv).  With a cache (decode, one token
    or a whole prompt): the latent and the RoPE key are written into it in
    place, and the queries attend in latent space with the key and value
    up-projections absorbed into them (the returned cache is the same
    dict).  Both score products come out in float32; ``q_lat``, ``o_lat``
    and the probabilities are in the compute dtype, as the reference's.
    Both paths take the config's YaRN (:func:`rope_inv_freq`,
    :func:`mla_score_div`).  Under a mesh: this rank's heads of
    ``wq_b`` / ``wk_b`` / ``wv_b``, the latent (``wkv_a``, replicated)
    computed by every rank, ``wo``'s rows summed over the model axis; a
    cache sharded on the latent is gathered for the read.

    Spans: ``mla`` the whole layer, ``mla.attend`` its attention (the key
    and value up-projections through the value product without a cache;
    ``q_lat`` through the value up-projection with one); counter
    ``mla.cache_slots``: the B x S cache positions a cached call reads."""
    with spans.span("mla", x):
        B, T, d = x.shape
        H = cfg.n_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        L = cfg.kv_lora_rank
        div = mla_score_div(cfg)
        heads = shard.split(H, shard.model_size())
        _, me, _ = shard.model_group()
        Hl = heads[me][1] - heads[me][0]
        # the query's and the key's RoPE dims turn by the same angles
        cs = rope_cos_sin(positions, dr, cfg.rope_theta, x.device, cfg)
        q_nope, q_rope = _mla_q(params, x, cfg, cs, heads)

        kv = x @ params["wkv_a"]                              # (B,T,L+dr)
        c_kv = _head_rms(kv[..., :L], params["kv_norm"])      # latent
        k_rope = rotate(kv[..., L:][:, :, None, :], *cs)
        wk_b = shard.take(params["wk_b"], -1, H * dn, shard.spans(heads, dn))
        wv_b = shard.take(params["wv_b"], -1, H * dv, shard.spans(heads, dv))
        wo = shard.take(params["wo"], -2, H * dv, shard.spans(heads, dv))

        if cache is None:
            with spans.span("mla.attend", x):
                c = shard.enter(c_kv)
                k_nope = (c @ wk_b).reshape(B, T, Hl, dn)
                v = (c @ wv_b).reshape(B, T, Hl, dv)
                k = torch.cat([k_nope,
                               shard.enter(k_rope).expand(B, T, Hl, dr)],
                              dim=-1)
                q = torch.cat([q_nope, q_rope], dim=-1)
                out = _sdpa(q, k, v, causal=True, q_pos=positions,
                            impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                            div=div)
            return shard.reduce(out.reshape(B, T, Hl * dv) @ wo), None

        # ---- decode: absorbed attention in latent space -------------
        idx = positions[:, 0]
        cc = _cached(cache["c_kv"], c_kv, idx)                # (B,S,L)
        cr = _cached(cache["k_rope"], k_rope[:, :, 0, :], idx)  # (B,S,dr)
        S = cc.shape[1]
        spans.count("mla.cache_slots", B * S)
        with spans.span("mla.attend", x):
            # absorb W_uk into q: q_lat (B,T,Hl,L)
            q_lat = torch.einsum("bthn,lhn->bthl", q_nope,
                                 wk_b.reshape(L, Hl, dn))
            # (B, Hl*T, L|dr) @ (B, L|dr, S): the two score products in
            # float32
            scores = (matmul_f32(q_lat.permute(0, 2, 1, 3).reshape(
                          B, Hl * T, L), cc.transpose(1, 2))
                      + matmul_f32(q_rope.permute(0, 2, 1, 3).reshape(
                          B, Hl * T, dr), cr.transpose(1, 2))
                      ).reshape(B, Hl, T, S)
            scores = scores / div
            kp = torch.arange(S, device=x.device)[None, :]
            scores = torch.where(_causal_mask(positions, kp, idx + T), scores,
                                 -1e30)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            o_lat = (probs.reshape(B, Hl * T, S) @ cc).reshape(B, Hl, T, L)
            out = torch.einsum("bhtl,lhv->bthv", o_lat,
                               wv_b.reshape(L, Hl, dv))
        return shard.reduce(out.reshape(B, T, Hl * dv) @ wo), cache


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                   lead: Tuple[int, ...] = ()) -> Dict:
    """Zeroed latent and RoPE-key caches, (*lead, batch, max_len,
    kv_lora_rank | qk_rope_head_dim) in the compute dtype."""
    shape = lead + (batch, max_len)
    return {"c_kv": torch.zeros(shape + (cfg.kv_lora_rank,),
                                dtype=cfg.dtype(), device=device),
            "k_rope": torch.zeros(shape + (cfg.qk_rope_head_dim,),
                                  dtype=cfg.dtype(), device=device)}


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


def mlp_partial(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                d_ff: Optional[int] = None) -> torch.Tensor:
    """The GLU MLP on this rank's FFN columns (``act_ff``): ``wi``'s gate
    and up blocks of those columns and ``wo``'s rows, a partial sum over
    the model axis.  ``x`` has entered the model axis."""
    ff = d_ff or cfg.d_ff
    cols = shard.split(ff, shard.model_size())
    wi = shard.take(params["wi"], -1, 2 * ff,
                    [[(a, b), (ff + a, ff + b)] for a, b in cols])
    gate, up = (x @ wi).chunk(2, dim=-1)
    wo = shard.take(params["wo"], -2, ff, [[c] for c in cols])
    return (glu_act(gate, cfg) * up) @ wo


def apply_mlp(params: Dict, x: torch.Tensor, cfg: ArchConfig,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The GLU MLP of width ``d_ff`` (the config's by default); under a
    mesh tensor-parallel over its columns (:func:`mlp_partial`)."""
    return shard.reduce(mlp_partial(params, shard.enter(x), cfg, d_ff))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embed(cfg: ArchConfig, gen, device) -> Dict:
    return {
        "tok": _init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype(), device,
                     scale=0.02),
        "head": _init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype(), device),
    }


def embed_tokens(params: Dict, tokens: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """The rows of ``tok`` (vocab ``vocab``, the leaf's own rows by
    default).  Under a mesh whose model axis shards the vocabulary, each
    rank looks up the tokens in its block of rows, zeroes the others, and
    the ranks' rows are summed (exactly: one term is nonzero)."""
    tok = params["tok"]
    n = tok.shape[0]
    if vocab is None or n == vocab:
        return tok[tokens.long()]
    _, me, _ = shard.model_group()
    t = tokens.long() - me * n
    mine = (t >= 0) & (t < n)
    rows = tok[t.clamp(0, n - 1)]
    return shard.reduce(torch.where(mine[..., None], rows,
                                    torch.zeros((), dtype=rows.dtype,
                                                device=rows.device)))


def vocab_blocks(vocab: int) -> shard.Parts:
    """Each model rank's block of the vocabulary (``act_vocab``: blocks of
    ceil(V / tp), as GSPMD pads a vocabulary the axis does not divide)."""
    return [[b] for b in shard.split(vocab, shard.model_size())]


def lm_logits(params: Dict, x: torch.Tensor, vocab: Optional[int] = None
              ) -> torch.Tensor:
    """(B, T, V) float32 logits of x (B, T, d) through the head (vocab
    ``vocab``, the leaf's own columns by default); under a mesh, this
    rank's block of the vocabulary (:func:`vocab_blocks`)."""
    head = params["head"]
    if vocab is None:
        return matmul_f32(x, head)
    return matmul_f32(shard.enter(x),
                      shard.take(head, -1, vocab, vocab_blocks(vocab)))
