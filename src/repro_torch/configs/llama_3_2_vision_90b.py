"""llama-3.2-vision-90b [vlm] — cross-attn image layers; vision frontend is
a STUB providing precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, vocab=128256,
    n_heads=64, n_kv_heads=8,
    d_ff=28672,
    xattn_every=10,                 # 10 cross-attention fusion layers
    frontend_tokens=1601,           # ViT-H/14 @ 560px patch embeddings
    frontend_dim=8192,              # projected to d_model by the stub
    rope_theta=5e5,
)
