"""Mamba-2 SSD block and its decode recurrence.

The block: in-projections of z, x, B|C and dt, a causal depthwise conv over
x and over B|C, the SSD chunked scan (``ops.ssd_scan``, the CUDA kernel on
the card), the skip term, a gated RMSNorm and the out-projection. Parameter
names and init distributions are the reference's ``ssd_init``; the
projections are stored in bfloat16 and the six small leaves (``conv_x``,
``conv_bc``, ``dt_bias``, ``A_log``, ``Dskip``, ``norm``) in float32, as the
reference reads them. Casts follow the reference's ``ssd_apply``: z, x and
B|C are bfloat16 after their projections, dt and its softplus float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import COMPUTE_DTYPE, _param, dot, rms_norm

F32_LEAVES = ("conv_x", "conv_bc", "dt_bias", "A_log", "Dskip", "norm")


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    nheads = inner // s.head_dim
    return inner, nheads, s.head_dim, s.state_dim, s.conv_width


def _causal_conv(x, w, cache: Optional[torch.Tensor]):
    """Depthwise causal conv. x (B, S, C), w (W, C) float32; cache
    (B, W-1, C) or None. Sums the W taps in float32 in the reference's
    order. Returns (y (B, S, C) in x's dtype, new cache (B, W-1, C))."""
    S = x.shape[1]
    W = w.shape[0]
    if cache is None:
        ctx = F.pad(x, (0, 0, W - 1, 0))
    else:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + ctx[:, i : i + S, :].float() * w[i].float()
    new_cache = ctx[:, S:, :]  # the last W - 1 rows
    return y.to(x.dtype), new_cache


def _silu(x):
    """``jax.nn.silu`` of a bfloat16 tensor, rounded where the reference
    rounds it: its logistic is ``1 / (1 + exp(-x))`` with every step rounded
    to bfloat16 (``torch.sigmoid`` rounds once, and a third of its results
    then differ by a bfloat16 ulp), then the product."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in its own order."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def ssd_cache_shapes(cfg: ArchConfig, batch: int):
    """{leaf: (shape, dtype)} of one layer's decode cache."""
    inner, H, Pd, N, W = _dims(cfg)
    return {
        "conv_x": ((batch, W - 1, inner), COMPUTE_DTYPE),
        "conv_bc": ((batch, W - 1, 2 * N), COMPUTE_DTYPE),
        "state": ((batch, H, Pd, N), torch.float32),
    }


class SSD(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        inner, H, Pd, N, W = _dims(cfg)
        bf16, f32 = COMPUTE_DTYPE, torch.float32
        self.w_z = _param((d, inner), bf16, device)
        self.w_x = _param((d, inner), bf16, device)
        self.w_bc = _param((d, 2 * N), bf16, device)
        self.w_dt = _param((d, H), bf16, device)
        self.conv_x = _param((W, inner), f32, device)
        self.conv_bc = _param((W, 2 * N), f32, device)
        self.dt_bias = _param((H,), f32, device)
        self.A_log = _param((H,), f32, device)
        self.Dskip = _param((H,), f32, device)
        self.norm = _param((inner,), f32, device)
        self.w_out = _param((inner, d), bf16, device)

    def reset_parameters(self, gen: torch.Generator):
        """The distributions of the reference's ``ssd_init``."""
        d = self.cfg.d_model
        inner, H, _, _, _ = _dims(self.cfg)
        for w in (self.w_z, self.w_x, self.w_bc, self.w_dt):
            w.normal_(0.0, d**-0.5, generator=gen)
        self.conv_x.normal_(0.0, 0.1, generator=gen)
        self.conv_bc.normal_(0.0, 0.1, generator=gen)
        self.dt_bias.fill_(math.log(math.expm1(0.01)))
        self.A_log.copy_(torch.log(torch.linspace(1.0, 8.0, H)))
        self.Dskip.fill_(1.0)
        self.norm.zero_()
        self.w_out.normal_(0.0, inner**-0.5, generator=gen)

    def forward(
        self,
        x,  # (B, S, d) bf16
        *,
        cache: Optional[Dict[str, torch.Tensor]] = None,  # decode: one layer's cache
        return_cache: bool = False,  # prefill: the conv tails and the final state
    ):
        """Returns (y (B, S, d) bf16, new cache). Three modes, as the
        reference's ``ssd_apply``: no cache (the cache-free forward, new
        cache None), ``return_cache`` (prefill: the conv tails in bf16 and
        the final state in float32), and ``cache`` (decode of one token:
        the cache's tensors are updated in place and returned)."""
        cfg = self.cfg
        B, S, _ = x.shape
        inner, H, Pd, N, W = _dims(cfg)

        z = dot(x, self.w_z).to(COMPUTE_DTYPE)
        xi = dot(x, self.w_x).to(COMPUTE_DTYPE)
        bc = dot(x, self.w_bc).to(COMPUTE_DTYPE)
        dt_raw = dot(x, self.w_dt)  # float32

        cx = cache["conv_x"] if cache is not None else None
        cb = cache["conv_bc"] if cache is not None else None
        xi, ncx = _causal_conv(xi, self.conv_x, cx)
        bc, ncb = _causal_conv(bc, self.conv_bc, cb)
        xi = _silu(xi)
        bc = _silu(bc)
        Bm, Cm = bc[..., :N], bc[..., N:]

        dt = _softplus(dt_raw + self.dt_bias.float())
        A = -torch.exp(self.A_log.float())
        xh = xi.reshape(B, S, H, Pd)

        new_cache = None
        if cache is None and return_cache:
            y, state = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk, return_state=True)
            new_cache = {
                "conv_x": ncx.to(COMPUTE_DTYPE),
                "conv_bc": ncb.to(COMPUTE_DTYPE),
                "state": state,
            }
        elif cache is None:
            y = ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk)
        else:
            y1, new_state = ops.ssd_decode(
                xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], cache["state"]
            )
            y = y1[:, None]
            cache["conv_x"].copy_(ncx)
            cache["conv_bc"].copy_(ncb)
            cache["state"].copy_(new_state)
            new_cache = cache

        y = y + self.Dskip.to(y.dtype)[None, None, :, None] * xh
        y = y.reshape(B, S, inner)
        y = rms_norm(y.to(COMPUTE_DTYPE) * _silu(z), self.norm, cfg.norm_eps)
        out = dot(y, self.w_out)
        return out.to(COMPUTE_DTYPE), new_cache
