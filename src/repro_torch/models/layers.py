"""Transformer layer primitives: norms, RoPE, GQA attention, gated MLP.

Matrices are stored in bfloat16 (the reference keeps float32 and casts each
to bfloat16 before use, so the products are the same); norm scales stay
float32. Every projection multiplies bfloat16 operands with a float32
result, as the reference's ``preferred_element_type=float32`` einsums, and
casts to bfloat16 where the reference does.

Weights are drawn with the reference init's distributions from a
``torch.Generator`` on the parameter's device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref

COMPUTE_DTYPE = torch.bfloat16


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis and w's first: bfloat16 operands,
    float32 accumulation and a float32 result. The CPU backend has no
    bfloat16 product with a float32 result, so there the operands (exact in
    float32) are widened first."""
    lead, d = x.shape[:-1], x.shape[-1]
    w2 = w.reshape(d, -1)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, d), w2, out_dtype=torch.float32)
    else:
        y = x.reshape(-1, d).float() @ w2.float()
    return y.reshape(*lead, *w.shape[1:])


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, dtype=dtype, device=device), requires_grad=False
    )


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), torch.float32, device)

    def reset_parameters(self, gen: torch.Generator):
        self.scale.zero_()

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# RoPE (fractional / 2d-style partial rotary)
# ---------------------------------------------------------------------------


def apply_rope(x, positions, fraction: float = 1.0, base: float = 10000.0):
    """x: (B, S, H, D); positions: (B, S) int. Rotates first fraction of D."""
    D = x.shape[-1]
    rot = int(D * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, :, None, None].float() * freq  # (B, S, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.cfg = cfg
        d, H, K = cfg.d_model, cfg.n_heads, cfg.kv_heads
        hd = cfg.resolved_head_dim
        self.wq = _param((d, H, hd), COMPUTE_DTYPE, device)
        self.wk = _param((d, K, hd), COMPUTE_DTYPE, device)
        self.wv = _param((d, K, hd), COMPUTE_DTYPE, device)
        self.wo = _param((H, hd, d), COMPUTE_DTYPE, device)

    def reset_parameters(self, gen: torch.Generator):
        cfg = self.cfg
        s = cfg.d_model**-0.5
        for w in (self.wq, self.wk, self.wv):
            w.normal_(0.0, s, generator=gen)
        self.wo.normal_(0.0, (cfg.n_heads * cfg.resolved_head_dim) ** -0.5, generator=gen)

    def forward(
        self,
        x,  # (B, S, d) bf16
        positions,  # (B, S) int
        *,
        is_local: bool = False,
        cache=None,  # {"k", "v"} for decode, or None
        return_kv: bool = False,  # prefill: hand back (k, v) for the cache
    ):
        """Returns (y, new_cache). No cache and no return_kv -> new_cache None.
        Prefill (return_kv): new_cache = {"k","v"} post-RoPE full-seq tensors."""
        cfg = self.cfg
        q = dot(x, self.wq).to(COMPUTE_DTYPE)
        k = dot(x, self.wk).to(COMPUTE_DTYPE)
        v = dot(x, self.wv).to(COMPUTE_DTYPE)
        if cfg.causal:
            q = apply_rope(q, positions, cfg.rope_fraction)
            k = apply_rope(k, positions, cfg.rope_fraction)

        window = cfg.local_window if is_local else 0
        new_cache = None
        if cache is None:
            o = ops.flash_attention(
                q, k, v,
                causal=cfg.causal,
                local_window=window,
                logit_softcap=cfg.attn_logit_softcap,
            )
            if return_kv:
                new_cache = {"k": k, "v": v}
        else:
            rotating = window > 0 and cache["k"].shape[1] == window
            o, new_cache = decode_attention(
                q, k, v, cache, positions,
                local_window=window,
                logit_softcap=cfg.attn_logit_softcap,
                rotating=rotating,
            )
        y = dot(o.flatten(2), self.wo.reshape(-1, cfg.d_model))
        return y.to(COMPUTE_DTYPE), new_cache


# ---------------------------------------------------------------------------
# Decode attention over a KV cache (direct or rotating)
# ---------------------------------------------------------------------------


def _partial_attn(q, k, v, valid, scale, logit_softcap):
    """q (B,1,H,D) vs k/v (B,T,K,D) with validity mask (B,T) -> (m, l, acc)."""
    B, _, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qq = (q.reshape(B, K, G, D) * scale).float()
    s = torch.einsum("bkgd,btkd->bkgt", qq, k.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = torch.where(valid[:, None, None, :], s, ref.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return m, l, acc


def decode_attention(
    q, k_new, v_new, cache, positions, *, local_window, logit_softcap,
    rotating: bool = False,
):
    """One-token attention against the cache; returns (out (B,1,H,D), cache).

    The new token's k/v are written into ``cache`` in place (the reference
    returns an updated copy and its engine donates the old one):
    - direct: {"k","v": (B, Smax, K, D)}, written at its position
    - rotating (sliding window): the same keys, written at pos % window
    positions: (B, 1) absolute position of the new token.
    """
    if "k_ring" in cache:
        raise NotImplementedError(
            "the ring cache layout needs a sequence-sharded mesh "
            "(ROADMAP Queue 1 item 6)"
        )
    B, _, H, D = q.shape
    scale = 1.0 / D**0.5
    pos = positions[:, 0]  # (B,)
    W = cache["k"].shape[1]
    slot = pos % W if rotating else pos
    rows = torch.arange(B, device=q.device)
    cache["k"][rows, slot] = k_new[:, 0]
    cache["v"][rows, slot] = v_new[:, 0]
    t_idx = torch.arange(W, device=q.device)
    if rotating:
        # slot t holds absolute position pos - ((pos - t) mod W)
        abs_t = pos[:, None] - torch.remainder(pos[:, None] - t_idx[None, :], W)
        valid = abs_t >= 0
    else:
        valid = t_idx[None, :] <= pos[:, None]
        if local_window > 0:
            valid &= (pos[:, None] - t_idx[None, :]) < local_window
    m, l, acc = _partial_attn(q, cache["k"], cache["v"], valid, scale, logit_softcap)
    out = acc / torch.clamp_min(l, 1e-37)[..., None]  # (B, K, G, D)
    return out.reshape(B, 1, H, D).to(q.dtype), cache


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------


def silu(h):
    """``h * sigmoid(h)``, as ``jax.nn.silu`` defines it. ``F.silu`` rounds
    another way in float32 (about one element in four differs by an ulp),
    and after the cast to bfloat16 that follows it, such an ulp can flip a
    rounding that the two packages would otherwise share."""
    return h * torch.sigmoid(h)


def _act(h, kind: str):
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    return silu(h)


class MLP(nn.Module):
    def __init__(
        self, cfg: ArchConfig, device, d_ff: Optional[int] = None,
        act: Optional[str] = None,
    ):
        super().__init__()
        d = cfg.d_model
        f = cfg.d_ff if d_ff is None else d_ff
        self.act = cfg.act if act is None else act
        self.wi_gate = _param((d, f), COMPUTE_DTYPE, device)
        self.wi_up = _param((d, f), COMPUTE_DTYPE, device)
        self.wo = _param((f, d), COMPUTE_DTYPE, device)

    def reset_parameters(self, gen: torch.Generator):
        d, f = self.wi_gate.shape
        self.wi_gate.normal_(0.0, d**-0.5, generator=gen)
        self.wi_up.normal_(0.0, d**-0.5, generator=gen)
        self.wo.normal_(0.0, f**-0.5, generator=gen)

    def forward(self, x):
        h = dot(x, self.wi_gate)
        u = dot(x, self.wi_up)
        h = (_act(h, self.act) * u).to(COMPUTE_DTYPE)
        return dot(h, self.wo).to(COMPUTE_DTYPE)
