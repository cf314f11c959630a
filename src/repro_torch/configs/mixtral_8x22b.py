"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA [arXiv:2401.04088; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    vocab=32768,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    n_experts=8,
    top_k=2,
    layer_pattern="swa",
    window=4096,
    expert_shard="tp",       # 8 experts < 16-way model axis: TP inside experts
).validate()
