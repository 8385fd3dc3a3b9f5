"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

Simplification recorded in DESIGN.md: the shared attention+MLP block (single
weight set) is applied every ``hybrid_attn_every`` SSM layers; Zamba2's
per-invocation LoRA deltas are omitted.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    hybrid_attn_every=6,
    source="arXiv:2411.15242",
)
