"""hubert-xlarge [audio]: 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504.

Encoder-only transformer (same arch as wav2vec2) [arXiv:2106.07447].
The audio frontend (conv feature extractor) is a STUB: ``input_specs()``
provides precomputed frame embeddings of shape (batch, seq, d_model).
"""
from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    frontend="audio",
    frontend_positions=0,  # every position is a frame embedding
    source="arXiv:2106.07447",
)
