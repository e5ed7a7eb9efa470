"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a STUB providing conditioning frame embeddings.
[arXiv:2306.05284; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, vocab=2048,
    n_heads=24, n_kv_heads=24,
    d_ff=6144,
    n_codebooks=4,
    xattn_every=12,                 # text-conditioning cross-attention
    frontend_tokens=64,             # conditioning sequence (stub)
    frontend_dim=1536,
    rope_theta=1e4,
)
