"""falcon-mamba-7b [ssm] — 64L d_model=4096 attn-free, vocab=65024, state=16.

Mamba1 architecture [arXiv:2410.05355; unverified].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    vocab=65024,
    d_ff=0,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_dt_rank=256,
    ssm_chunk=16,   # the reference's scan chunk; S must be a multiple
    tie_embeddings=True,
).validate()
