"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(num_experts=128, top_k=1, shared_experts=1),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
