"""Plain PyTorch oracles for the port's kernels.

``attention_ref`` is the ground truth the flash-attention kernel is held
against, and the kernel's plain version on CPU tensors.
``attention_chunked`` is the same function by online softmax over key
chunks (O(S * chunk) memory), the flash recurrence in plain tensor code.
``ssd_ref`` is the Mamba-2 chunked scan that the SSD kernel is held
against, and ``ssd_decode_ref`` its one-token recurrence.
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


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise sums: out[..., i, j] = sum_{j<k<=i} x[..., k],
    -inf above the diagonal. The reference's order: cumsum, then c_i - c_j,
    then the mask."""
    T = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)      (post-softplus, positive)
    A: torch.Tensor,  # (H,)            (negative)
    Bm: torch.Tensor,  # (B, S, N)      (single group)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
    return_state: bool = False,
):
    """Mamba-2 SSD (state-space duality) chunked scan from a zero state.

    Intra-chunk quadratic term plus the inter-chunk recurrent state, as
    ``ssd_minimal_discrete`` of the Mamba-2 paper. ``x * dt`` is taken in
    float32, as the reference's oracle takes it (its Pallas path rounds it
    to x's dtype first). Returns y (x's dtype), and with ``return_state``
    also the final state (B, H, P, N) float32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    xb = (x * dt[..., None]).to(f32)  # dt-weighted input
    dA = (dt * A[None, None, :]).to(f32)  # (B, S, H) log-decay increments

    xc = xb.reshape(B, nc, chunk, H, P)
    dAc = dA.reshape(B, nc, chunk, H)
    Bc = Bm.reshape(B, nc, chunk, N).to(f32)
    Cc = Cm.reshape(B, nc, chunk, N).to(f32)

    # 1. intra-chunk (diagonal blocks): Y = (C B^T * L) X
    L = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))  # (B, nc, H, cs, cs)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B, nc, cs, cs)
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", scores, L, xc)

    # 2. per-chunk final states: sum_i exp(cum[-1] - cum[i]) * x_i B_i^T
    cum = torch.cumsum(dAc, dim=2)  # (B, nc, cs, H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    chunk_states = torch.einsum("bcihp,bcih,bcin->bchpn", xc, decay_to_end, Bc)

    # 3. inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    state = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    # 4. inter-chunk output: C_i decayed against the incoming state
    state_decay = torch.exp(cum)  # (B, nc, cs, H)
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, prev_states, state_decay)

    y = (y_diag + y_off).reshape(B, S, H, P).to(x.dtype)
    if return_state:
        return y, state
    return y


def ssd_decode_ref(
    x: torch.Tensor,  # (B, H, P) single token
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, N)
    Cm: torch.Tensor,  # (B, N)
    state: torch.Tensor,  # (B, H, P, N) float32
):
    """Single-token SSD recurrence: state' = e^{dt A} state + dt x B^T.
    Returns (y (B, H, P) in x's dtype, new state float32)."""
    f32 = torch.float32
    dA = torch.exp((dt * A[None, :]).to(f32))  # (B, H)
    upd = torch.einsum("bhp,bn->bhpn", (x * dt[..., None]).to(f32), Bm.to(f32))
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.to(f32))
    return y.to(x.dtype), new_state
