"""Model assembly: groups of [attention + MLP or MoE] or SSD layers driven by an ExecutionPlan.

The reference scans each group's stacked layers; here a group holds a
``ModuleList`` and the scan is a Python loop over it. Parameter names follow
the reference's tree: ``embed.table``, ``g0.layers.<i>.attn.wq``, ...,
``final_norm.scale``, ``unembed.kernel``.

Modes: ``train`` (logits), ``prefill`` (logits + the layers' k/v, or
their conv tails and SSD states, for the decode cache), ``decode`` (one
token against the cache, updated in place). The ``attn_mlp`` and
``attn_moe`` groups of dense and MoE decoder-only architectures and the
``ssd`` groups of Mamba-2 (``family == "ssm"``) are ported; local/global
pairs and hybrids raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models import layers as L
from repro_torch.models import mamba
from repro_torch.models.moe import MoE
from repro_torch.models.sharding import MeshCtx

DECODE_MARGIN = 128  # extra slots past the prefilled context

_TODO = {
    "pair_local_global": "local/global layer pairs (ROADMAP Queue 1 item 6)",
}


def padded_vocab(cfg: ArchConfig) -> int:
    return -(-cfg.vocab // 512) * 512


@dataclasses.dataclass(frozen=True)
class GroupDef:
    name: str
    kind: str  # "attn_mlp" | "attn_moe" | "ssd" | "pair_local_global"
    n_layers: int  # layers (or layer-pairs) stacked in this group
    unit_names: Tuple[str, ...]


def make_groups(cfg: ArchConfig, plan: ExecutionPlan) -> List[GroupDef]:
    """Derive group structure from the plan's unit names."""
    names = [u.name for u in plan.units]
    g_ids = sorted({int(n.split("/")[0][1:]) for n in names if n.startswith("g")})
    G = len(g_ids)
    groups: List[GroupDef] = []
    if cfg.family in ("ssm", "hybrid"):
        if cfg.family == "hybrid":
            per = cfg.hybrid_attn_every
            sizes = []
            left = cfg.n_layers
            while left > 0:
                sizes.append(min(per, left))
                left -= per
            assert len(sizes) == G, (sizes, G)
        else:
            sizes = [
                cfg.n_layers // G + (1 if i < cfg.n_layers % G else 0)
                for i in range(G)
            ]
        for i, sz in enumerate(sizes):
            groups.append(GroupDef(f"g{i}", "ssd", sz, (f"g{i}/ssd",)))
        return groups

    pairs = cfg.local_global_pattern
    total = cfg.n_layers // 2 if pairs else cfg.n_layers
    kind = (
        "pair_local_global"
        if pairs
        else ("attn_moe" if cfg.moe is not None else "attn_mlp")
    )
    sizes = [total // G + (1 if i < total % G else 0) for i in range(G)]
    ffn_tag = "moe" if cfg.moe is not None else "ffn"
    for i, sz in enumerate(sizes):
        groups.append(GroupDef(f"g{i}", kind, sz, (f"g{i}/attn", f"g{i}/{ffn_tag}")))
    return groups


def _device(device) -> torch.device:
    """The requested device; a CUDA request without a CUDA device raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


class Block(nn.Module):
    """One attention + feed-forward layer (pre-norm residual); the
    feed-forward is a gated MLP, or an MoE in ``attn_moe`` groups."""

    def __init__(self, cfg: ArchConfig, device, kind: str):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.d_model, cfg.norm_eps
        self.norm_attn = L.RMSNorm(d, eps, device)
        self.norm_ffn = L.RMSNorm(d, eps, device)
        self.attn = L.Attention(cfg, device)
        if kind == "attn_moe":
            self.moe = MoE(cfg, device)
        else:
            self.mlp = L.MLP(cfg, device)
        if cfg.sandwich_norms:
            self.norm_attn_post = L.RMSNorm(d, eps, device)
            self.norm_ffn_post = L.RMSNorm(d, eps, device)

    def forward(self, x, positions, *, cache=None, return_kv=False):
        """Returns (x, new_cache, aux): aux is the MoE's load-balance loss,
        None for an MLP layer."""
        a, new_cache = self.attn(
            self.norm_attn(x), positions, cache=cache, return_kv=return_kv
        )
        if self.cfg.sandwich_norms:
            a = self.norm_attn_post(a)
        x = x + a
        h = self.norm_ffn(x)
        if hasattr(self, "moe"):
            f, aux = self.moe(h)
        else:
            f, aux = self.mlp(h), None
        if self.cfg.sandwich_norms:
            f = self.norm_ffn_post(f)
        return x + f, new_cache, aux


class SSDBlock(nn.Module):
    """One Mamba-2 layer: ``x + ssd(x)``, with no norm before it, as the
    reference's ``_apply_block`` applies an ``ssd`` layer."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.ssd = mamba.SSD(cfg, device)

    def forward(self, x, positions, *, cache=None, return_kv=False):
        """Returns (x, new_cache, None); positions are not read."""
        h, new_cache = self.ssd(x, cache=cache, return_cache=return_kv)
        return x + h, new_cache, None


class Model(nn.Module):
    """The decoder on ``device`` (CUDA unless the caller asks for the CPU).

    Weights are ``params`` (the port's state dict, e.g. from
    ``convert.params_from_jax``) or, when None, drawn from ``seed`` on the
    device with the reference init's distributions.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        plan: ExecutionPlan,
        *,
        device="cuda",
        params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.mctx = MeshCtx()
        self.device = _device(device)
        self.groups = make_groups(cfg, plan)
        for g in self.groups:
            if g.kind not in ("attn_mlp", "attn_moe", "ssd"):
                raise NotImplementedError(f"{cfg.name}: {_TODO[g.kind]}")
        if cfg.family not in ("dense", "moe", "ssm"):
            raise NotImplementedError(
                f"{cfg.name}: {cfg.family} models (ROADMAP Queue 1 item 6)"
            )
        if any(u.bf16_intermediates for u in plan.units):
            raise NotImplementedError("bf16_intermediates plans are not ported")
        self.vp = padded_vocab(cfg)
        dev, bf16 = self.device, L.COMPUTE_DTYPE
        self.embed = nn.ParameterDict(
            {"table": L._param((self.vp, cfg.d_model), bf16, dev)}
        )
        for g in self.groups:
            self.add_module(g.name, nn.ModuleDict({"layers": nn.ModuleList(
                SSDBlock(cfg, dev) if g.kind == "ssd" else Block(cfg, dev, g.kind)
                for _ in range(g.n_layers)
            )}))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if not cfg.tie_embeddings:
            self.unembed = nn.ParameterDict(
                {"kernel": L._param((cfg.d_model, self.vp), bf16, dev)}
            )
        if params is None:
            self.reset_parameters(seed)
        else:
            self.load_state_dict(params)

    def reset_parameters(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        s = self.cfg.d_model**-0.5
        self.embed["table"].normal_(0.0, s, generator=gen)
        for m in self.modules():
            if isinstance(m, (L.RMSNorm, L.Attention, L.MLP, MoE, mamba.SSD)):
                m.reset_parameters(gen)
        if not self.cfg.tie_embeddings:
            self.unembed["kernel"].normal_(0.0, s, generator=gen)

    def layers(self, g: GroupDef) -> nn.ModuleList:
        return self.get_submodule(g.name)["layers"]

    # ------------------------------------------------------------------
    # forward pieces
    # ------------------------------------------------------------------
    def _embed(self, tokens):
        x = self.embed["table"][tokens]
        if self.cfg.scale_embed:
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=L.COMPUTE_DTYPE)
        return x

    def _logits(self, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = L.dot(x, self.embed["table"].t())
        else:
            logits = L.dot(x, self.unembed["kernel"])
        if cfg.final_logit_softcap > 0:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        if self.vp > cfg.vocab:
            logits[..., cfg.vocab:] = -1e30
        return logits

    def _hidden(self, tokens, positions, cache, mode):
        """Embedding and every layer; returns (hidden states, raw kv, aux).

        prefill: raw kv = {group: {"k","v": (n, B, S, K, hd)}}, or for an
        SSD group {"conv_x", "conv_bc", "state": (n, B, ...)};
        decode: ``cache`` is updated in place and returned. aux: the MoE
        layers' load-balance losses summed, float32 (0 without MoE)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        x = self.mctx.wsc(self._embed(tokens))
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        raw: Dict[str, Any] = {}
        auxs = []
        for g in self.groups:
            kvs = []
            for i, block in enumerate(self.layers(g)):
                c = None
                if mode == "decode":
                    c = {key: t[i] for key, t in cache[g.name].items()}
                x, kv, aux = block(x, positions, cache=c, return_kv=(mode == "prefill"))
                kvs.append(kv)
                if aux is not None:
                    auxs.append(aux)
            x = self.mctx.wsc(x)
            if mode == "prefill":
                raw[g.name] = {
                    key: torch.stack([kv[key] for kv in kvs]) for key in kvs[0]
                }
        x = self.final_norm(x)
        aux = torch.stack(auxs).sum() if auxs else torch.zeros((), device=x.device)
        return x, (cache if mode == "decode" else raw), aux

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def forward(self, tokens, positions=None, cache=None, mode: str = "train"):
        """tokens (B, S) -> (logits (B, S, vp) float32, raw kv or cache,
        aux loss float32), as the reference's ``forward``."""
        x, kv, aux = self._hidden(tokens, positions, cache, mode)
        return self._logits(x), kv, aux

    @torch.inference_mode()
    def prefill(self, tokens, ctx_len: Optional[int] = None):
        """Full-context forward; returns (last-position logits, decode cache)."""
        S = tokens.shape[1]
        ctx_len = ctx_len or S
        if S > ctx_len + DECODE_MARGIN:
            raise ValueError(f"prompt of {S} tokens over the cache of {ctx_len}")
        x, raw, _ = self._hidden(tokens, None, None, "prefill")
        cache = self.init_cache(tokens.shape[0], ctx_len)
        for g in self.groups:
            for key, t in raw[g.name].items():
                if g.kind == "ssd":  # conv tails and the state: the whole leaf
                    cache[g.name][key].copy_(t)
                else:  # k/v: the prompt's positions of the context
                    cache[g.name][key][:, :, :S] = t
        return self._logits(x[:, -1]), cache

    @torch.inference_mode()
    def decode_step(self, cache, tokens, positions):
        """tokens (B,1), positions (B,1) -> (logits (B, vp), cache).

        The cache is updated in place; the reference's engine donates it."""
        x, cache, _ = self._hidden(tokens, positions, cache, "decode")
        return self._logits(x[:, -1]), cache

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, ctx_len: int):
        """Zero decode cache, per group: for attention, the direct layout
        {"k","v": (n, batch, ctx_len + DECODE_MARGIN, K, hd)} bfloat16; for
        SSD, {"conv_x", "conv_bc": (n, batch, W-1, C) bfloat16, "state":
        (n, batch, H, P, N) float32}, whatever the context. Axis 1 is the
        batch (the engine's slot) in every leaf."""
        cfg = self.cfg
        kv = (batch, ctx_len + DECODE_MARGIN, cfg.kv_heads, cfg.resolved_head_dim)
        cache = {}
        for g in self.groups:
            if g.kind == "ssd":
                leaves = mamba.ssd_cache_shapes(cfg, batch)
            else:
                leaves = {key: (kv, L.COMPUTE_DTYPE) for key in ("k", "v")}
            cache[g.name] = {
                key: torch.zeros((g.n_layers, *shape), dtype=dt, device=self.device)
                for key, (shape, dt) in leaves.items()
            }
        return cache
