"""qwen3-14b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, vocab=151936,
    n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, qk_norm=True,
    rope_theta=1e6,
)
