"""Architecture / shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every workload shape a
``ShapeConfig``. The registry maps ``--arch <id>`` / ``--shape <name>`` CLI
selections to configs, and encodes the applicability rules (encoder-only archs
have no decode step; ``long_500k`` requires sub-quadratic attention).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Shape configs (assigned input-shape set for the LM family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """A workload cell: sequence length x global batch x step kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    shared_experts: int = 0  # extra always-on experts (Llama-4 style)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int  # N: SSM state size per head
    head_dim: int = 64  # P: channels per SSD head
    expand: int = 2  # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture. Field values follow the assignment sheet."""

    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "encoder" | "vlm"
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    # --- optional per-family extensions -----------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # attention structure
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_fraction: float = 1.0  # chatglm-style partial rotary
    local_window: int = 0  # >0: sliding-window size for local layers
    local_global_pattern: bool = False  # gemma2: alternate local/global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    causal: bool = True  # False for encoder-only
    # hybrid structure: attention block shared + applied every k ssm layers
    hybrid_attn_every: int = 0
    # modality frontend stub ("none" | "audio" | "vision")
    frontend: str = "none"
    # number of frontend embedding positions occupied at the head of the seq
    frontend_positions: int = 256
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sandwich_norms: bool = False  # gemma2 pre+post block norms
    act: str = "silu"
    scale_embed: bool = False  # gemma2 multiplies embeddings by sqrt(d)
    source: str = ""

    # -- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def encoder_only(self) -> bool:
        return self.family == "encoder"

    @property
    def subquadratic(self) -> bool:
        """True when a 512k-token decode cell is tractable for this arch."""
        if self.family in ("ssm", "hybrid"):
            return True  # SSM state is O(1) in sequence length
        # local+global alternating (gemma2): local layers windowed; global
        # layers at decode are O(KV) per token -> tractable.
        return self.local_global_pattern

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks), for roofline math."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            inner = self.ssm.expand * d
            nheads = inner // self.ssm.head_dim
            # in_proj: d -> 2*inner + 2*ngroups*N + nheads ; out_proj inner->d
            per_layer = d * (2 * inner + 2 * self.ssm.state_dim + nheads)
            per_layer += inner * d + self.ssm.conv_width * (
                inner + 2 * self.ssm.state_dim
            )
        else:
            qkv = d * hd * (self.n_heads + 2 * self.kv_heads) + self.n_heads * hd * d
            if self.moe is not None:
                nexp = self.moe.num_experts + self.moe.shared_experts
                ff = nexp * 3 * d * f + d * self.moe.num_experts
            else:
                ff = 3 * d * f
            per_layer = qkv + ff
            if self.family == "hybrid":
                # SSM backbone layers; the attention+MLP block is SHARED
                # (single weight set applied every hybrid_attn_every layers).
                inner = self.ssm.expand * d
                nheads = inner // self.ssm.head_dim
                per_layer = (
                    d * (2 * inner + 2 * self.ssm.state_dim + nheads) + inner * d
                )
                return embed + L * per_layer + (qkv + ff)
        return embed + L * per_layer

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        qkv = d * hd * (self.n_heads + 2 * self.kv_heads) + self.n_heads * hd * d
        act_ff = (self.moe.top_k + self.moe.shared_experts) * 3 * d * f
        return embed + L * (qkv + act_ff + d * self.moe.num_experts)

    # -- shape applicability --------------------------------------------------
    def shapes(self) -> Tuple[ShapeConfig, ...]:
        out = []
        for s in ALL_SHAPES:
            if s.is_decode and self.encoder_only:
                continue  # no autoregressive step exists
            if s.name == "long_500k" and not self.subquadratic:
                continue  # needs sub-quadratic attention
            out.append(s)
        return tuple(out)

    def skipped_shapes(self) -> Tuple[Tuple[str, str], ...]:
        out = []
        for s in ALL_SHAPES:
            if s.is_decode and self.encoder_only:
                out.append((s.name, "encoder-only: no autoregressive decode step"))
            elif s.name == "long_500k" and not self.subquadratic:
                out.append((s.name, "pure full-attention arch: 512k decode excluded"))
        return tuple(out)

    # -- reduced config for CPU smoke tests ----------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config: runs a real step on one CPU device."""
        kv = max(1, min(self.kv_heads, 2))
        heads = max(kv, min(self.n_heads, 4))
        moe = None
        if self.moe is not None:
            moe = MoEConfig(
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                shared_experts=min(self.moe.shared_experts, 1),
            )
        ssm = None
        if self.ssm is not None:
            ssm = SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=32)
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if self.hybrid_attn_every == 0 else 4),
            d_model=64,
            n_heads=heads,
            kv_heads=kv,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            moe=moe,
            ssm=ssm,
            local_window=32 if self.local_window else 0,
            frontend_positions=8 if self.frontend != "none" else 0,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "hubert-xlarge",
    "internvl2-76b",
    "moonshot-v1-16b-a3b",
    "llama4-maverick-400b-a17b",
    "gemma2-27b",
    "glm4-9b",
    "chatglm3-6b",
    "stablelm-3b",
    "zamba2-1.2b",
    "mamba2-1.3b",
)

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.ARCH


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def all_cells() -> Sequence[Tuple[ArchConfig, ShapeConfig]]:
    """Every runnable (arch x shape) cell under the applicability rules."""
    cells = []
    for aid in ARCH_IDS:
        arch = get_arch(aid)
        for s in arch.shapes():
            cells.append((arch, s))
    return cells
