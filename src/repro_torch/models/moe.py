"""Mixture-of-Experts layer: top-k routing, capacity dispatch and combine.

The counterpart of ``src/repro/models/moe.py`` on one device. Routing is
float32 end to end (router weights, logits, softmax, top-k), because the
winning experts and the assignments that lose a full expert decide the
output. Tokens move through ``ops.moe_permute``, the row-gather kernel, in
both directions: dispatch gathers each capacity slot's token, combine
gathers each token's k slots. That is the reference's grouped branch at one
group, which computes the same function as its one-device baseline (a
scatter into the slot buffer and a gather back). The expert products are
batched matrix products with bfloat16 operands and float32 results.

Parameters are named as ``moe_init`` names them: ``router`` (d, E) float32,
``wi_gate`` and ``wi_up`` (E, d, f), ``wo`` (E, f, d) and the shared expert
``shared.{wi_gate, wi_up, wo}`` with f = d_ff x shared_experts, bfloat16.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25


def capacity(tokens: int, top_k: int, experts: int) -> int:
    """Slots per expert for ``tokens`` tokens routed to ``top_k`` experts."""
    return int(CAPACITY_FACTOR * tokens * top_k / experts) + 1


def route(
    eids: torch.Tensor, E: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity slots for the assignments ``eids`` (T, k) of one token group.

    Returns int32 index vectors, the payload untouched:
    - ``buf_src`` (E * cap,): the token in each slot, -1 for an empty slot;
    - ``tok_slots`` (T * k,): the slot holding copy j of token t at t*k + j,
      -1 for a dropped assignment;
    - ``flat_of_slot`` (E * cap,): the assignment t*k + j in each slot, -1
      for an empty one.
    Assignments take an expert's slots in the order of a stable sort by
    expert, so among those of one expert the earlier tokens win and the
    later ones past ``cap`` are dropped. Everything stays on the device:
    the counts are a scatter-add, not a ``bincount`` that reads its maximum
    back to the host.
    """
    T, k = eids.shape
    dev = eids.device
    flat_e = eids.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e)
    )
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e]
    slot = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e, E * cap)  # overflow bin
    src_tok = (order // k).to(torch.int32)
    buf_src = torch.full((E * cap + 1,), -1, dtype=torch.int32, device=dev)
    buf_src[slot] = src_tok
    slot_of_flat = torch.empty_like(slot)
    slot_of_flat[order] = slot
    tok_slots = torch.where(slot_of_flat < E * cap, slot_of_flat, -1).to(torch.int32)
    flat_of_slot = torch.full((E * cap + 1,), -1, dtype=torch.int32, device=dev)
    flat_of_slot[slot] = order.to(torch.int32)
    return buf_src[: E * cap], tok_slots, flat_of_slot[: E * cap]


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with bfloat16 operands and a float32 result; on the
    CPU, which has no such product, the operands are widened first, as
    ``layers.dot`` does."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.cfg = cfg
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        bf16 = L.COMPUTE_DTYPE
        self.router = L._param((d, E), torch.float32, device)
        self.wi_gate = L._param((E, d, f), bf16, device)
        self.wi_up = L._param((E, d, f), bf16, device)
        self.wo = L._param((E, f, d), bf16, device)
        self.shared = None
        if cfg.moe.shared_experts:
            self.shared = L.MLP(cfg, device, d_ff=f * cfg.moe.shared_experts, act="silu")

    def reset_parameters(self, gen: torch.Generator):
        """``moe_init``'s distributions; the shared expert is an ``L.MLP``
        and is drawn by its own ``reset_parameters``."""
        d, f = self.cfg.d_model, self.cfg.d_ff
        self.router.normal_(0.0, d**-0.5, generator=gen)
        self.wi_gate.normal_(0.0, d**-0.5, generator=gen)
        self.wi_up.normal_(0.0, d**-0.5, generator=gen)
        self.wo.normal_(0.0, f**-0.5, generator=gen)

    def gate(self, xt: torch.Tensor):
        """xt (T, d) -> (probs (T, E), gate values (T, k), expert ids (T, k)):
        float32 routing, the k gate values renormalised to sum to 1."""
        probs = torch.softmax(xt.float() @ self.router, dim=-1)
        vals, eids = torch.topk(probs, self.cfg.moe.top_k, dim=-1)
        vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        return probs, vals, eids

    def _experts(self, buf: torch.Tensor) -> torch.Tensor:
        """(E, cap, d) bfloat16 -> (E, cap, d) bfloat16."""
        h = _bmm(buf, self.wi_gate)
        u = _bmm(buf, self.wi_up)
        h = (L.silu(h) * u).to(L.COMPUTE_DTYPE)
        return _bmm(h, self.wo).to(L.COMPUTE_DTYPE)

    def forward(self, x: torch.Tensor):
        """x (B, S, d) bfloat16 -> (y (B, S, d) bfloat16, aux loss float32)."""
        B, S, d = x.shape
        E, k = self.cfg.moe.num_experts, self.cfg.moe.top_k
        T = B * S
        xt = x.reshape(T, d)
        probs, gates, eids = self.gate(xt)

        # Switch-style load-balance auxiliary loss
        ce = torch.zeros(E, device=x.device).index_add_(
            0, eids.reshape(-1), torch.ones(T * k, device=x.device)
        ) / (T * k)
        aux = E * (probs.mean(dim=0) * ce).sum()

        cap = capacity(T, k, E)
        buf_src, tok_slots, flat_of_slot = route(eids, E, cap)
        buf = ops.moe_permute(
            xt[None].to(L.COMPUTE_DTYPE), buf_src[None], tok_slots[None], k
        )  # dispatch: (1, E * cap, d)
        yb = self._experts(buf.reshape(E, cap, d))
        y_flat = ops.moe_permute(
            yb.reshape(1, E * cap, d), tok_slots[None], flat_of_slot[None], 1
        )  # combine: (1, T * k, d)
        y = (y_flat.reshape(T, k, d).float() * gates[..., None]).sum(dim=1)
        y = y.to(L.COMPUTE_DTYPE)
        if self.shared is not None:
            y = y + self.shared(xt)
        return y.reshape(B, S, d), aux
