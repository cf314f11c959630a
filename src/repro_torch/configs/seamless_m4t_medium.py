"""seamless-m4t-medium [audio] — 12L d_model=1024 16H d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Backbone only: the speech frontend is a STUB; ``input_specs`` provides
precomputed frame embeddings [B, S_src, 1024] consumed by the encoder.
12 encoder + 12 decoder layers with cross-attention.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    vocab=256206,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    mlp_type="gelu",
    frontend="audio",
    frontend_dim=1024,
    frontend_len=0,   # src length comes from the shape spec, not fixed
).validate()
