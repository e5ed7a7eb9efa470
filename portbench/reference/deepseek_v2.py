"""Plain float32 reference of DeepSeek-V2 as published (the Hugging Face
``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2), one sequence at a
time, layer by layer, so that it fits beside the served bf16 weights: each
layer's weights are widened to float32 while that layer runs.  It imports
nothing of the program and takes nothing the program made: the weights
are the benchmark's (``drivers/lm_mla.py`` makes them from the seed and
hands the same tensors to both sides).

The layer: RMSNorm (eps ``rms_norm_eps``, scaled by its weight); MLA in its
expanded form: the query through its low-rank latent (``wq_a``, RMSNorm,
``wq_b``) split into 128 "nope" and 64 RoPE dims a head, the joint latent
``wkv_a`` split into the 512-wide KV latent (RMSNorm) and one 64-wide RoPE
key shared by every head, the keys' nope part and the values
up-projected from the normed latent (``wk_b``, ``wv_b``), YaRN RoPE (factor
40 over an original 4096 positions, beta_fast 32, beta_slow 1; cos and sin
times mscale(40, 0.707) / mscale(40, 0.707) = 1) on the query's and the
key's RoPE dims, the causal softmax of the scores times (192)^-1/2 x
mscale(40, 0.707)^2, the value product, ``wo``; a residual; RMSNorm; then
the first ``first_k_dense_replace`` layers a SwiGLU MLP of 12288
(``mlp_wi`` = [gate | up]), the others the MoE: float32 router logits over
all 160 experts, their softmax, group-limited greedy selection (the top 3
of 8 groups of 20 by their best score, then the top 6 of the scores in
those groups, ties to the lowest index), gates the chosen experts' scores
times ``routed_scaling_factor`` (16, not renormalised), SwiGLU experts of
1536, and the 2 shared experts as one SwiGLU of 3072 with no gate; a
residual.  Then RMSNorm and the head, in float32.  Dropless, as the
published model serves: every routed token reaches its experts.

RoPE rotates interleaved pairs (dims 2i, 2i + 1 at frequency i), where the
published code first permutes q_pe and k_pe to the half-split order and
rotates dims i, i + 32: the same pairs at the same frequencies, so every
score is the same.  The expert share is the configuration's deployment,
not a departure: the layer holds experts [first, first + held) of the 160
it routes over and adds only their part (``deployment`` in the
configuration's file), as the program does.

``weights``: a dict of the benchmark's leaves: ``tok`` (V, d), ``head``
(d, V), ``final_norm`` (d,), over all L layers ``norm1``, ``norm2`` (L, d),
``wq_a`` (L, d, q_lora), ``q_norm`` (L, q_lora), ``wq_b`` (L, q_lora,
H*(dn+dr)), ``wkv_a`` (L, d, kv_lora+dr), ``kv_norm`` (L, kv_lora),
``wk_b`` (L, kv_lora, H*dn), ``wv_b`` (L, kv_lora, H*dv), ``wo`` (L, H*dv,
d); over the dense layers ``mlp_wi`` (n, d, 2*dff), ``mlp_wo`` (n, dff,
d); over the MoE layers ``router`` (m, d, E) float32, ``wi`` (m, held, d,
2ff), ``we`` (m, held, ff, d), ``swi`` (m, d, 2sff), ``swo`` (m, sff, d).

``fp8=True`` is the control: every bf16 weight of a product rounded to
float8 e4m3 with a scale per output column (the router stays float32, as
the configuration states it), the arithmetic float32 as above.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.qwen2_moe import _fp8, _no_tf32, _topk
from portbench.reference.qwen2_moe import gaps, head_rows  # noqa: F401

# leaves whose last dim is the output of a product: quantized per column
_PRODUCTS = ("head", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo",
             "mlp_wi", "mlp_wo", "wi", "we", "swi", "swo")


def _w(weights: Dict, name: str, layer: Optional[int], fp8: bool
       ) -> torch.Tensor:
    t = weights[name] if layer is None else weights[name][layer]
    if fp8 and name in _PRODUCTS:
        return _fp8(t)
    return t.float()


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _yarn(cfg: dict, T: int, device):
    """(cos, sin) (T, 1, dr/2) of YaRN RoPE at positions 0..T-1, the
    frequencies in float64."""
    dr, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    s, L0 = float(rs["factor"]), rs["original_max_position_embeddings"]
    i = torch.arange(0, dr, 2, dtype=torch.float64, device=device)
    extra = 1.0 / base ** (i / dr)
    inter = 1.0 / (s * base ** (i / dr))
    dim = lambda r: (dr * math.log(L0 / (r * 2 * math.pi))
                     / (2 * math.log(base)))
    low = max(math.floor(dim(rs["beta_fast"])), 0)
    high = min(math.ceil(dim(rs["beta_slow"])), dr - 1)
    ramp = ((torch.arange(dr // 2, dtype=torch.float64, device=device) - low)
            / (high - low)).clamp(0, 1)
    inv_freq = inter * ramp + extra * (1 - ramp)
    ang = (torch.arange(T, dtype=torch.float64, device=device)[:, None]
           * inv_freq).float()
    m = _mscale(s, rs["mscale"]) / _mscale(s, rs["mscale_all_dim"])
    return (torch.cos(ang) * m)[:, None, :], (torch.sin(ang) * m)[:, None, :]


def _rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x (T, H, dr), interleaved pairs rotated."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    m = _mscale(float(rs["factor"]), rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def _mla(h, w, cfg, rope, block: int):
    """Multi-head latent attention in its expanded form over h (T, d)."""
    T = h.shape[0]
    H = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    kvl, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    q = (_rms(h @ w("wq_a"), w("q_norm"), eps) @ w("wq_b")).view(T, H, dn + dr)
    q_nope, q_pe = q[..., :dn], _rope(q[..., dn:], *rope)
    kv = h @ w("wkv_a")
    c = _rms(kv[:, :kvl], w("kv_norm"), eps)
    k_pe = _rope(kv[:, None, kvl:], *rope)[:, 0]             # (T, dr)
    k_nope = (c @ w("wk_b")).view(T, H, dn)
    v = (c @ w("wv_b")).view(T, H, dv)
    scale = softmax_scale(cfg)
    out = torch.empty((T, H, dv), dtype=torch.float32, device=h.device)
    keys = torch.arange(T, device=h.device)
    for a in range(0, T, block):             # (H, block, T) scores at once
        b = min(a + block, T)
        s = (torch.einsum("qhn,khn->hqk", q_nope[a:b], k_nope)
             + torch.einsum("qhr,kr->hqk", q_pe[a:b], k_pe)) * scale
        later = keys[None, :] > torch.arange(a, b, device=h.device)[:, None]
        p = torch.softmax(s.masked_fill(later[None], float("-inf")), dim=-1)
        out[a:b] = torch.einsum("hqk,khv->qhv", p, v)
    return out.reshape(T, H * dv) @ w("wo")


def _swiglu(h, wi, wo):
    a = h @ wi
    f = wi.shape[-1] // 2
    return (F.silu(a[:, :f]) * a[:, f:]) @ wo


def route(h: torch.Tensor, router: torch.Tensor, cfg: dict):
    """(gates (T, k), experts (T, k)) of group-limited greedy routing over
    all the layer's experts, as published: on the softmax scores."""
    T = h.shape[0]
    G, k = cfg["n_group"], cfg["num_experts_per_tok"]
    scores = torch.softmax(h @ router, dim=-1)
    E = scores.shape[-1]
    _, gidx = _topk(scores.view(T, G, E // G).amax(dim=-1), cfg["topk_group"])
    keep = torch.zeros((T, G), dtype=torch.bool, device=h.device)
    keep.scatter_(1, gidx, True)
    masked = scores.masked_fill(~keep.repeat_interleave(E // G, dim=1), 0.0)
    _, idx = _topk(masked, k)
    return torch.gather(scores, 1, idx) * cfg["routed_scaling_factor"], idx


def _moe(h, router, wi, we, swi, swo, cfg):
    """The held experts' part of the routed sum, plus the shared experts."""
    gates, idx = route(h, router, cfg)
    first = cfg["deployment"]["first_expert_held"]
    y = _swiglu(h, swi, swo)
    for j in range(wi.shape[0]):
        rows, slot = (idx == first + j).nonzero(as_tuple=True)
        if rows.numel():
            y.index_add_(0, rows, _swiglu(h[rows], wi[j], we[j])
                         * gates[rows, slot, None])
    return y


def hidden(weights: Dict, cfg: dict, tokens: torch.Tensor, prompt_len: int,
           fp8: bool = False, block: int = 512) -> torch.Tensor:
    """The final normed hidden states (T, d), float32, of one sequence
    ``tokens`` (T,).  Routing drops nothing, so how the served path split
    the sequence into calls (``prompt_len``) does not change them."""
    _no_tf32()
    T = tokens.shape[0]
    x = weights["tok"][tokens.long()].float()
    rope = _yarn(cfg, T, x.device)
    nd, eps = cfg["first_k_dense_replace"], cfg["rms_norm_eps"]
    for l in range(cfg["num_hidden_layers"]):
        w = lambda n, i=l: _w(weights, n, i, fp8)
        x = x + _mla(_rms(x, w("norm1"), eps), w, cfg, rope, block)
        h = _rms(x, w("norm2"), eps)
        if l < nd:
            x = x + _swiglu(h, w("mlp_wi", l), w("mlp_wo", l))
        else:
            m = l - nd
            x = x + _moe(h, weights["router"][m].float(), w("wi", m),
                         w("we", m), w("swi", m), w("swo", m), cfg)
    return _rms(x, _w(weights, "final_norm", None, fp8), eps)


def control_choice(weights: Dict, cfg: dict, tokens: torch.Tensor,
                   prompt_len: int, positions: torch.Tensor, k: int = 1,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """The token the fp8 control serves at each checked position: its
    first choice (every row of the cell is greedy)."""
    if k != 1:
        raise ValueError("the cell's rows are all greedy")
    h = hidden(weights, cfg, tokens, prompt_len, fp8=True)[positions.long()]
    return torch.cat([lg.argmax(dim=-1)
                      for _, lg in head_rows(weights, h, fp8=True)])
