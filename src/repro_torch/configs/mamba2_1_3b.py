"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab=50280,
    d_ff=0,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    layer_pattern=("ssm",) * 48,
    sub_quadratic=True,
)
