"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B].
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=1408,
    vocab=163840,
    moe=MoEConfig(num_experts=64, top_k=6, shared_experts=1),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
