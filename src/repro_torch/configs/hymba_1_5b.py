"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads
[arXiv:2411.13676; hf].

Blocks run attention and mamba in parallel on the same normed input and
average the branch outputs.  3 layers (first/middle/last) use global
attention, the rest sliding-window — the 'hymba' layer pattern.  Meta
tokens are not modeled (as in the reference).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    vocab=32001,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    layer_pattern="hymba",
    window=1024,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=16,   # the reference's scan chunk (as falcon-mamba)
    tie_embeddings=True,
).validate()
