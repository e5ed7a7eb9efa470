"""deepseek-7b [dense] — llama-arch. [arXiv:2401.02954; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, vocab=102400,
    n_heads=32, n_kv_heads=32,
    d_ff=11008,
    rope_theta=1e4,
)
