"""Public kernel ops: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version.

There is no switch that sends a CUDA tensor to the plain version: on the
card the kernel launches or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gather_rows as gr
from repro_torch.kernels import ref
from repro_torch.kernels import ssd


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


# ---------------------------------------------------------------------------
# Mamba-2 SSD scan and its one-token recurrence
# ---------------------------------------------------------------------------


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) float32, after softplus
    A: torch.Tensor,  # (H,) float32, negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int,
    return_state: bool = False,
):
    """The SSD chunked scan from a zero state, chunked as the reference
    chunks it: ``chunk = min(chunk, S)``, and x, dt, B and C zero-padded to a
    multiple of it. A padded row has dt = 0: decay 1 and no update, so the
    final state is the state at S. Returns y, or (y, final state float32)
    with ``return_state``."""
    S = x.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    if x.device.type == "cpu":
        y, state = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    else:
        y, state = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y = y[:, :S] if pad else y
    return (y, state) if return_state else y


def ssd_decode(x, dt, A, Bm, Cm, state):
    """One token of the SSD recurrence, plain PyTorch on every device (it is
    a few elementwise passes over the state): (y, new state)."""
    return ref.ssd_decode_ref(x, dt, A, Bm, Cm, state)


# ---------------------------------------------------------------------------
# MoE dispatch/combine row permutation (gather-only in both directions)
# ---------------------------------------------------------------------------


def _rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(G, N, d) gathered by (G, M) -> (G, M, d); idx -1 -> zero row."""
    if src.device.type == "cpu":
        return gr.gather_rows_plain(src, idx)
    return gr.gather_rows(src, idx)


class _MoePermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, out_idx, inv_idx, k_inv):
        ctx.save_for_backward(inv_idx)
        ctx.k_inv = k_inv
        ctx.src_shape = src.shape
        return _rows(src, out_idx)

    @staticmethod
    def backward(ctx, dout):
        (inv_idx,) = ctx.saved_tensors
        G, N, d = ctx.src_shape
        g = _rows(dout.contiguous(), inv_idx)  # (G, N * k_inv, d)
        dsrc = g.reshape(G, N, ctx.k_inv, d).sum(dim=2).to(dout.dtype)
        return dsrc, None, None, None


def moe_permute(
    src: torch.Tensor,  # (G, N, d)
    out_idx: torch.Tensor,  # (G, M) int32
    inv_idx: torch.Tensor,  # (G, N * k_inv) int32
    k_inv: int,
) -> torch.Tensor:
    """out[g, i] = src[g, out_idx[g, i]] (-1 -> zeros).

    The transpose is also a row gather: ``inv_idx`` lists, for each source
    row, the k_inv output rows that read it, so the backward gathers the
    output's gradient by it and sums each row's k_inv copies. No scatter-add
    runs in either direction."""
    return _MoePermute.apply(src, out_idx, inv_idx, k_inv)
