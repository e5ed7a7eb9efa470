"""Work counts the benchmark divides by, from the configuration's own
sizes and the call's shapes, never from the program.

``active_params`` follows ``repro_torch.models.accounting`` (the routed
experts counted at top-k over E, everything else whole), less the token
embedding, whose lookup is a gather and no arithmetic.  ``model_flops``
is 2 x active parameters a token, as that module's serve steps count.
"""
from __future__ import annotations


def active_params(cfg: dict) -> int:
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    ff, sff = cfg["moe_intermediate_size"], cfg["shared_expert_intermediate_size"]
    attn = 2 * d * H * hd + 2 * d * KV * hd
    layer = (attn + 2 * d                 # attention, two norms
             + d * E                      # router
             + k * 3 * d * ff             # the routed experts a token uses
             + 3 * d * sff)               # the shared experts
    return L * layer + d + d * cfg["vocab_size"]   # final norm, head


def model_flops(cfg: dict, tokens: int) -> float:
    return 2.0 * active_params(cfg) * tokens


def tns_call_bytes(banks: int, n: int, width: int) -> int:
    """Bytes a sort call needs on the device, each once: the digit planes
    in at one bit a digit, the permutation out as int32, and three int32
    counters a bank (cycles, digit reads, reload cycles) out."""
    return banks * width * n // 8 + banks * n * 4 + banks * 3 * 4
