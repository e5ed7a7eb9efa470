"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

The registry preset keeps parity with the JAX package's config: it leaves
the port's group-limited routing (n_group 8, topk_group 3), the published
gates (the softmax over all 160 times 16, not renormalised) and YaRN
(factor 40, mscale 0.707) at their defaults, off.  The published model, with
all three on, is served by the benchmark's configuration
``portbench/configs/deepseek-v2-236b-ep8.json``
(``portbench/drivers/lm_mla.py::arch_config``)."""
from repro_torch.models.config import ArchConfig, MLA

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, vocab=102400,
    n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288,                    # dense layers (first moe_layer_start)
    moe=True, n_routed_experts=160, n_shared_experts=2, moe_top_k=6,
    d_ff_expert=1536, moe_layer_start=1,
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    layer_pattern=("mla",) * 60,
    rope_theta=1e4,
)
