"""Plain float32 reference of qwen2-moe-a2.7b as the port serves it, one
sequence at a time, layer by layer, so that it fits beside the served
bf16 weights: each layer's weights are widened to float32 while that
layer runs.  It imports nothing of the program and takes nothing the
program made: the weights are the benchmark's (``drivers/lm.py`` makes
them from the seed and hands the same tensors to both sides).

The layer, as the port computes it (each departure from the published
Qwen1.5-MoE is the port's, noted in PERF.md): RMSNorm (eps 1e-6, scaled
by its weight); attention with 16 heads of 128, no projection bias, RoPE
over interleaved pairs (theta 1e6), causal softmax; a residual; RMSNorm;
the MoE: float32 router logits, the top 4 of 60 experts (ties to the
lowest index), gates a softmax over those 4 logits, SwiGLU experts of
1408 (``wi`` = [gate | up]); the shared experts one SwiGLU of 5632 with no
gate; a residual.  Then RMSNorm and the head, in float32.

Capacity: the port gives each expert C = max(8, 8 * ceil(ceil(T * 4 / 60
* 1.25) / 8)) slots a sequence for a call of T tokens, and drops an
expert's assignments past C in token order.  A served sequence is one
call of its prompt (T = P), then one call a decoded token (C = 8 >= 4:
nothing dropped), so the reference drops within the prompt alone.

``weights``: a dict of the benchmark's leaves, stacked over layers:
``tok`` (V, d), ``head`` (d, V), ``final_norm`` (d,), ``norm1``,
``norm2`` (L, d), ``wq``, ``wk``, ``wv`` (L, d, H*hd), ``wo`` (L, H*hd,
d), ``router`` (L, d, E) float32, ``wi`` (L, E, d, 2ff), ``we`` (L, E, ff,
d), ``swi`` (L, d, 2sff), ``swo`` (L, sff, d).

``fp8=True`` is the control: every bf16 weight rounded to float8 e4m3
with a scale per output column (the router stays float32, as the
configuration states it), the arithmetic float32 as above.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

# leaves whose last dim is the output of a product: quantized per column
_PRODUCTS = ("head", "wq", "wk", "wv", "wo", "wi", "we", "swi", "swo")


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(w: torch.Tensor) -> torch.Tensor:
    """w rounded through float8 e4m3 with one scale per output column (the
    last dim), back in float32."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _w(weights: Dict, name: str, layer: Optional[int], fp8: bool
       ) -> torch.Tensor:
    t = weights[name] if layer is None else weights[name][layer]
    if fp8 and name in _PRODUCTS:
        return _fp8(t)
    return t.float()


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, hd) at positions 0..T-1, interleaved pairs rotated."""
    T, _, hd = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                          device=x.device) / hd))
    ang = (torch.arange(T, dtype=torch.float64, device=x.device)[:, None]
           * freqs).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def _attention(h, wq, wk, wv, wo, cfg):
    T = h.shape[0]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    q = _rope((h @ wq).view(T, H, hd), cfg["rope_theta"])
    k = _rope((h @ wk).view(T, KV, hd), cfg["rope_theta"])
    v = (h @ wv).view(T, KV, hd)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    out = torch.empty((T, H, hd), dtype=torch.float32, device=h.device)
    causal = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    for i in range(H):                      # a head at a time: (T, T)
        s = (q[:, i] @ k[:, i].T) / math.sqrt(hd)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out[:, i] = p @ v[:, i]
    return out.reshape(T, H * hd) @ wo


def capacity(tokens: int, cfg: dict) -> int:
    c = math.ceil(tokens * cfg["num_experts_per_tok"] / cfg["num_experts"]
                  * cfg["port"]["moe_capacity_factor"])
    return max(8, -(-c // 8) * 8)


def _topk(logits: torch.Tensor, k: int):
    """The k largest of each row, descending; ties to the lowest index."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    idx = order[:, :k]
    return torch.gather(logits, 1, idx), idx


def _moe(h, router, wi, we, swi, swo, cfg, prompt_len):
    T = h.shape[0]
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    ff, sff = cfg["moe_intermediate_size"], cfg["shared_expert_intermediate_size"]
    vals, idx = _topk(h @ router, k)
    gates = torch.softmax(vals, dim=-1)
    chosen = torch.zeros((T, E), dtype=torch.bool, device=h.device)
    chosen.scatter_(1, idx, True)
    g = torch.zeros((T, E), dtype=torch.float32, device=h.device)
    g.scatter_(1, idx, gates)
    # the prompt's call drops an expert's assignments past its capacity,
    # in token order; each later token is a call of its own and drops none
    P = min(prompt_len, T)
    before = torch.cumsum(chosen[:P].int(), dim=0) - chosen[:P].int()
    keep = chosen.clone()
    keep[:P] &= before < capacity(P, cfg)
    y = torch.zeros_like(h)
    for e in range(E):
        rows = keep[:, e].nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        a = h[rows] @ wi[e]
        out = (torch.nn.functional.silu(a[:, :ff]) * a[:, ff:]) @ we[e]
        y.index_add_(0, rows, out * g[rows, e:e + 1])
    a = h @ swi
    return y + (torch.nn.functional.silu(a[:, :sff]) * a[:, sff:]) @ swo


def hidden(weights: Dict, cfg: dict, tokens: torch.Tensor, prompt_len: int,
           fp8: bool = False) -> torch.Tensor:
    """The final normed hidden states (T, d), float32, of one sequence
    ``tokens`` (T,) whose first ``prompt_len`` were prefilled in one
    call and the rest decoded one at a time."""
    _no_tf32()
    x = weights["tok"][tokens.long()].float()
    for l in range(cfg["num_hidden_layers"]):
        w = lambda n: _w(weights, n, l, fp8)
        h = _rms(x, w("norm1"))
        x = x + _attention(h, w("wq"), w("wk"), w("wv"), w("wo"), cfg)
        h = _rms(x, w("norm2"))
        x = x + _moe(h, weights["router"][l].float(), w("wi"), w("we"),
                     w("swi"), w("swo"), cfg, prompt_len)
    return _rms(x, _w(weights, "final_norm", None, fp8))


def head_rows(weights: Dict, h: torch.Tensor, fp8: bool = False,
              block: int = 512):
    """Yields (first row, float32 logits) of h's rows in blocks."""
    head = _w(weights, "head", None, fp8)
    for a in range(0, h.shape[0], block):
        yield a, h[a:a + block] @ head


def gaps(weights: Dict, h: torch.Tensor, chosen: torch.Tensor, k: int = 1
         ) -> torch.Tensor:
    """For each row of the reference's hidden states ``h`` (at the checked
    positions), how far the reference's logit of ``chosen`` lies below the
    reference's k-th best (k 1: its best), or 0 where it is not below:
    (rows,) float32."""
    out = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
    ch = chosen.long().to(h.device)
    for a, lg in head_rows(weights, h):
        sel = torch.gather(lg, 1, ch[a:a + lg.shape[0], None])[:, 0]
        kth = lg.topk(k, dim=-1).values[:, -1]
        out[a:a + lg.shape[0]] = (kth - sel).clamp(min=0)
    return out


def control_choice(weights: Dict, cfg: dict, tokens: torch.Tensor,
                   prompt_len: int, positions: torch.Tensor, k: int = 1,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """The token the fp8 control serves at each checked position: its
    first choice (k 1), or a draw from its k best, each weighted by the
    softmax of its logit (top-k sampling, the Gumbel-max way)."""
    h = hidden(weights, cfg, tokens, prompt_len, fp8=True)[positions.long()]
    out = []
    for _, lg in head_rows(weights, h, fp8=True):
        if k == 1:
            out.append(lg.argmax(dim=-1))
            continue
        v, i = lg.topk(k, dim=-1)
        u = torch.rand(v.shape, generator=gen, device=v.device)
        g = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
        out.append(torch.gather(i, 1, (v + g).argmax(dim=-1, keepdim=True))
                   [:, 0])
    return torch.cat(out)
