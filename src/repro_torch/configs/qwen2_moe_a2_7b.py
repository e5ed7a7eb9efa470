"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, vocab=151936,
    n_heads=16, n_kv_heads=16,
    d_ff=5632,                     # shared-path MLP width (4 x 1408)
    moe=True, n_routed_experts=60, n_shared_experts=4, moe_top_k=4,
    d_ff_expert=1408, moe_layer_start=0,
    rope_theta=1e6,
)
