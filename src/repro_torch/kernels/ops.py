"""Public kernel ops: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version.

There is no switch that sends a CUDA tensor to the plain version: on the
card the kernel launches or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    local_window: int = 0,
    logit_softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention in BSHD layout; scale fixed at rsqrt(true head dim)."""
    kw = dict(
        causal=causal,
        local_window=local_window,
        logit_softcap=logit_softcap,
        scale=1.0 / q.shape[-1] ** 0.5,
        q_offset=q_offset,
    )
    if q.device.type == "cpu":
        return fa.flash_attention_plain(q, k, v, **kw)
    return fa.flash_attention(q, k, v, **kw)
