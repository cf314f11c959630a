"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — phi3-mini + CLIP [hf:microsoft/Phi-3-vision-128k-instruct; hf].

The CLIP frontend is a STUB per the assignment: ``input_specs`` provides
precomputed patch embeddings [B, 256, 1024] that a learned projector maps
into the backbone width, prefixed to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    vocab=32064,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    frontend="vision",
    frontend_dim=1024,
    frontend_len=256,
).validate()
