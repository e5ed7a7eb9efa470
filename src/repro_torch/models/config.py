"""Architecture configuration schema for the model zoo (the counterpart
of ``repro.models.config``, field for field, and beyond it the fields of
DeepSeek-V2's group routing and gates, a layer's held experts and YaRN,
whose defaults keep the reference's behaviour).

One ``ArchConfig`` describes any of the assigned families:
dense / MoE / SSM (Mamba2-SSD) / hybrid (Zamba2) / VLM (cross-attn) /
audio (decoder over codec tokens).  Per-layer kinds are expanded from
``layer_pattern`` so hybrids interleave freely.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

# layer kinds
ATTN = "attn"          # self-attention (GQA/MQA) + MLP
MLA = "mla"            # multi-head latent attention (DeepSeek-V2) + MoE/MLP
SSM = "ssm"            # Mamba2 SSD block
XATTN = "xattn"        # cross-attention layer (VLM image fusion)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: Optional[int] = None    # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    # MLP
    d_ff: int = 0
    mlp_act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    # norms
    norm: str = "rmsnorm"             # rmsnorm | nonparam_ln (OLMo)
    # MoE
    moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    moe_layer_start: int = 0          # dense layers before the first MoE one
    # expert-capacity factor for the dispatch buffers; None => no-drop
    # capacity (C >= n_tokens), which makes batched forward bit-match the
    # token-by-token decode path (drops are a throughput knob, not part of
    # the paper's technique)
    moe_capacity_factor: Optional[float] = 1.25
    # DeepSeek-V2's router (the defaults keep the top-k softmax router):
    # group-limited greedy routing takes the top ``topk_group`` of
    # ``n_group`` equal groups of experts, each scored by its best expert,
    # then the top-k experts inside them; with ``norm_topk_prob`` False an
    # expert's gate is its probability under the softmax over all experts
    # times ``routed_scaling_factor`` (True: the softmax over the top-k)
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # the routed experts a MoE layer holds (its share of an expert-parallel
    # deployment): [first_expert_held, first_expert_held + n_experts_held)
    # of the n_routed_experts it routes over; 0 holds them all
    n_experts_held: int = 0
    first_expert_held: int = 0
    # YaRN scaling of MLA's RoPE (DeepSeek-V2's rope_scaling); a factor of
    # 1 leaves RoPE and the softmax scale plain
    rope_scaling_factor: float = 1.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    # MLA (DeepSeek-V2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # layer pattern: e.g. ("ssm",)*N, or hybrid interleavings; None => attn
    layer_pattern: Optional[Tuple[str, ...]] = None
    # hybrid (zamba2): shared attention block applied every `hybrid_every`
    hybrid_every: int = 0
    # VLM / audio frontends are stubs: inputs arrive as precomputed
    # embeddings with this many extra tokens (0 => none)
    frontend_tokens: int = 0
    frontend_dim: int = 0
    xattn_every: int = 0              # cross-attn layer cadence (VLM)
    # audio: number of codec books sharing the same backbone step
    n_codebooks: int = 0
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # technique integration (the paper's feature): the reference's names
    # (radix | pallas | lax) or the port's (radix | fused-topk | torch)
    router_impl: str = "radix"
    sub_quadratic: bool = False       # can serve 500k contexts
    # attention implementation: naive (materialize scores) or chunked
    # (flash-style online softmax over KV chunks — beyond-paper perf path)
    attn_impl: str = "naive"
    attn_chunk: int = 1024
    # serving: replay the decode step from CUDA graphs on the card
    # (``launch.steps.make_decode_step``), where a step's launches take
    # the host longer to issue than the card to run
    decode_graphs: bool = False

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def layers(self) -> List[str]:
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.n_layers
            return list(self.layer_pattern)
        return [ATTN] * self.n_layers

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def reduced(self, n_layers: int = 2, d_model: int = 64, vocab: int = 256,
                d_ff: Optional[int] = None) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        scale = d_model / self.d_model
        heads = max(2, min(4, self.n_heads)) if self.n_heads else 0
        kvh = max(1, min(heads, max(1, int(self.n_kv_heads * heads / max(self.n_heads, 1))))) if self.n_kv_heads else 0
        pat = None
        if self.layer_pattern is not None:
            pat = tuple(self.layer_pattern[:n_layers])
            if len(pat) < n_layers:
                pat = pat + (self.layer_pattern[-1],) * (n_layers - len(pat))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            vocab=vocab,
            n_heads=heads,
            n_kv_heads=kvh,
            head_dim=(32 if self.head_dim else None),
            d_ff=d_ff or max(64, int(self.d_ff * scale)) if self.d_ff else 0,
            n_routed_experts=min(8, self.n_routed_experts),
            n_shared_experts=min(1, self.n_shared_experts),
            moe_top_k=min(2, self.moe_top_k),
            # smoke configs route with random-init params, which
            # concentrates load: disable capacity drops so the decode
            # path reproduces the forward path exactly
            moe_capacity_factor=None,
            d_ff_expert=64 if self.d_ff_expert else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_head_dim=16 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=min(16, self.ssm_state),
            ssm_heads=min(4, self.ssm_heads) if self.ssm_heads else 0,
            ssm_head_dim=16 if self.ssm_heads else 64,
            ssm_chunk=16,
            layer_pattern=pat,
            hybrid_every=min(2, self.hybrid_every) if self.hybrid_every else 0,
            frontend_tokens=min(4, self.frontend_tokens),
            frontend_dim=min(32, self.frontend_dim) if self.frontend_dim else 0,
            xattn_every=min(2, self.xattn_every) if self.xattn_every else 0,
            n_codebooks=min(2, self.n_codebooks) if self.n_codebooks else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ArchConfig) -> List[ShapeConfig]:
    """long_500k needs sub-quadratic attention — skipped for pure
    full-attention archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out
