"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024
— 2d RoPE (applied to half of head dim), GQA [arXiv:2406.12793].
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_fraction=0.5,
    source="arXiv:2406.12793",
)
