"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060].
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,  # attention-free
    kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
