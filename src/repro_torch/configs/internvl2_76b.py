"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT + InternLM2 [arXiv:2404.16821]. Backbone only: the vision frontend
is a STUB — ``input_specs()`` provides precomputed patch embeddings occupying
the first ``frontend_positions`` sequence slots.
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=28672,
    vocab=128256,
    frontend="vision",
    frontend_positions=256,
    source="arXiv:2404.16821",
)
