"""Unified model configuration covering all assigned architecture families.

One frozen dataclass drives every architecture: dense / MoE / SSM (mamba1)
/ hybrid (parallel attn+ssm) / VLM (stub frontend) / audio enc-dec.
Per-architecture instances live in ``repro_torch.configs.<arch>``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False          # qwen3-style per-head RMSNorm on q/k
    attn_softcap: Optional[float] = None    # gemma2 attention logit softcap
    logit_softcap: Optional[float] = None   # gemma2 final logit softcap
    window: Optional[int] = None   # sliding-window size for local layers
    layer_pattern: str = "global"  # global | local_global | swa | hymba
    sandwich_norm: bool = False    # gemma2 pre+post norms
    # --- mlp ---
    d_ff: int = 0
    mlp_type: str = "swiglu"       # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # 0 -> d_ff
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    moe_group: int = 2048          # GShard dispatch group size (tokens)
    expert_shard: str = "ep"       # ep: experts over 'model'; tp: ff over 'model'
    moe_impl: str = "onehot"       # onehot: GShard einsum dispatch (baseline)
    #                                gather: index-based dispatch (no
    #                                T*E*k*cf*d dispatch flops)
    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> d_model // 16
    ssm_chunk: int = 256           # remat chunk for the selective scan
    # --- encoder-decoder ---
    enc_layers: int = 0            # >0 -> encoder-decoder
    # --- modality frontend stub ---
    frontend: Optional[str] = None  # vision | audio
    frontend_dim: int = 0          # precomputed embedding dim (e.g. CLIP 1024)
    frontend_len: int = 0          # patches/frames prefixed to the sequence
    # --- misc ---
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma-style sqrt(d_model) embed scaling
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def eff_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run the 500k-context decode shape?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.layer_pattern == "swa" and self.window is not None

    def layer_kinds(self) -> Tuple[int, ...]:
        """Per-layer attention kind: 0 = global, 1 = local/window."""
        if self.layer_pattern == "global":
            return tuple(0 for _ in range(self.n_layers))
        if self.layer_pattern == "swa":
            return tuple(1 for _ in range(self.n_layers))
        if self.layer_pattern == "local_global":   # gemma2: alternate L,G
            return tuple(i % 2 for i in range(self.n_layers))
        if self.layer_pattern == "hymba":
            # 3 global layers (first / middle / last), SWA elsewhere
            g = {0, self.n_layers // 2, self.n_layers - 1}
            return tuple(0 if i in g else 1 for i in range(self.n_layers))
        raise ValueError(self.layer_pattern)

    def validate(self) -> "ModelConfig":
        if self.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.family == "encdec":
            assert self.enc_layers > 0
        if self.frontend:
            assert self.frontend_dim > 0
            if self.enc_layers == 0:   # decoder-prefix frontends (VLM)
                assert self.frontend_len > 0
        return self
