"""Plain PyTorch oracles for the port's kernels.

``attention_ref`` is the ground truth the flash-attention kernel is held
against, and the kernel's plain version on CPU tensors.
``attention_chunked`` is the same function by online softmax over key
chunks (O(S * chunk) memory), the flash recurrence in plain tensor code.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(
    q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, local_window: int
) -> torch.Tensor:
    """Which (query, key) pairs may attend: bool (q_len, k_len)."""
    ok = torch.ones(
        (q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device
    )
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if local_window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < local_window
    return ok


def _mask_bias(
    q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, local_window: int
) -> torch.Tensor:
    """Additive mask bias (q_len, k_len) from position vectors."""
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(_mask(q_pos, k_pos, causal, local_window), zero, NEG_INF)


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    local_window: int = 0,
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Naive GQA attention (materializes scores), computed in float32.

    The arithmetic follows the reference's kernel over one key block: q is
    scaled before the product, masked scores are set to NEG_INF, and the
    sum of exp(s - max) divides the product with V, not the weights before
    it. The function is the softmax's; the order keeps each float32 result
    where the reference's is, so that the cast to bfloat16 after it rounds
    the same way in both packages."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if H % K:
        raise ValueError(f"q heads {H} not a multiple of kv heads {K}")
    G = H // K
    scale = (1.0 / D**0.5) if scale is None else scale
    qq = q.reshape(B, Sq, K, G, D).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qq, k.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    s = torch.where(_mask(q_pos, k_pos, causal, local_window), s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).clamp_min(1e-37)  # (B, K, G, Sq)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()) / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    local_window: int = 0,
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """Online-softmax attention: a loop over key chunks carrying the running
    max ``m``, sum ``l`` and float32 accumulator."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
    scale = (1.0 / D**0.5) if scale is None else scale
    if Sk <= chunk:
        return attention_ref(
            q, k, v, causal=causal, local_window=local_window,
            logit_softcap=logit_softcap, scale=scale, q_offset=q_offset,
        )
    qq = (q.reshape(B, Sq, K, G, D) * scale).float()
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((B, K, G, Sq), NEG_INF, **f32)
    l = torch.zeros((B, K, G, Sq), **f32)
    acc = torch.zeros((B, K, G, Sq, D), **f32)
    for k0 in range(0, Sk, chunk):
        kc = k[:, k0 : k0 + chunk].float()
        vc = v[:, k0 : k0 + chunk].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qq, kc)
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        k_pos = k0 + torch.arange(kc.shape[1], device=q.device)
        s = s + _mask_bias(q_pos, k_pos, causal, local_window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]  # (B, K, G, Sq, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return out.to(q.dtype)
