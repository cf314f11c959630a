"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
local+global alternating, logit softcap [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    vocab=256000,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    mlp_type="geglu",
    layer_pattern="local_global",
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    embed_scale=True,
    tie_embeddings=True,
).validate()
