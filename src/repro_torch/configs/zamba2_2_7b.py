"""zamba2-2.7b [hybrid] — Mamba2 blocks + SHARED attention block every 6
layers (spec: "Mamba2 + shared attn blocks"), ssm_state=64.
[arXiv:2411.15242; hf].  Hybrid's shared attention is windowed for the
long_500k shape (sub-quadratic serving) — see the serving notes."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, vocab=32000,
    n_heads=32, n_kv_heads=32,
    d_ff=10240,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    hybrid_every=6,
    sub_quadratic=True,
    rope_theta=1e4,
)
