"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local+global alternating attention, logit softcaps
[arXiv:2408.00118].
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    local_window=4096,
    local_global_pattern=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    sandwich_norms=True,
    act="gelu",
    scale_embed=True,
    source="arXiv:2408.00118",
)
