"""Work counts of the latent-attention cells, from the configuration's
own sizes and the driver's schedule, never from the program.

``active_params`` is this card's share a token: every layer's MLA
projections and norms, the dense layers' MLP, and in each MoE layer the
router over all E experts, the shared experts, and the routed experts a
token uses here on average (top-k times the held share, held / E); then
the final norm and the head (the token embedding, a gather, is left
out).  ``model_flops`` is 2 x that a token, plus the attention's two
products over the positions each token attends to at the model's
expanded widths, 2 H (dn + dr + dv) a position a layer: the same work
whatever form computes it.  ``attend_bytes`` is what any form of the
attention must read of the cache: each attended position's latent and
RoPE key, (kv_lora_rank + qk_rope_head_dim) values, once a layer.
"""
from __future__ import annotations


def experts_per_layer(cfg: dict) -> int:
    """The experts a MoE layer routes over (the file's ``n_routed_experts``
    counts those held here)."""
    return cfg["deployment"]["routed_experts_per_layer"]


def active_params(cfg: dict) -> float:
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    H, ql, kvl = (cfg["num_attention_heads"], cfg["q_lora_rank"],
                  cfg["kv_lora_rank"])
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    E, held, k = (experts_per_layer(cfg), cfg["n_routed_experts"],
                  cfg["num_experts_per_tok"])
    ff = cfg["moe_intermediate_size"]
    sff = cfg["n_shared_experts"] * ff
    nd = cfg["first_k_dense_replace"]
    attn = (d * ql + ql + ql * H * (dn + dr)       # query latent, norm, up
            + d * (kvl + dr) + kvl                 # joint latent, norm
            + kvl * H * (dn + dv) + H * dv * d)    # key / value up, out
    dense = 3 * d * cfg["intermediate_size"]
    moe = d * E + k * held / E * 3 * d * ff + 3 * d * sff
    return L * (attn + 2 * d) + nd * dense + (L - nd) * moe + d + d * V


def model_flops(cfg: dict, tokens: int, attended: int) -> float:
    """``tokens`` computed, attending to ``attended`` positions in all (the
    sum over the tokens of each one's filled cache length)."""
    H = cfg["num_attention_heads"]
    w = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    return (2.0 * active_params(cfg) * tokens
            + 2.0 * H * w * attended * cfg["num_hidden_layers"])


def attend_bytes(cfg: dict, attended: int, itemsize: int = 2) -> int:
    return (attended * cfg["num_hidden_layers"]
            * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) * itemsize)
