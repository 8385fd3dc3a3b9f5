"""Static analysis: build offload units + assign directives (paper Step 1-2).

The part of the reference's analysis that ``build_plan`` needs: units are
the stage groups of the model graph, and the directive per unit comes from
structural applicability tests (divisibility of heads/experts/channels by
the model axis).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import Directive, ExecutionPlan, UnitPlan
from repro_torch.models.sharding import MeshCtx, attn_tp_mode

DEFAULT_GROUPS = 4


def n_groups_for(cfg: ArchConfig, n_groups: int = DEFAULT_GROUPS) -> int:
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.hybrid_attn_every)
    total = cfg.n_layers // 2 if cfg.local_global_pattern else cfg.n_layers
    return min(n_groups, total)


def attention_directive(cfg: ArchConfig, mctx: MeshCtx) -> Directive:
    """kernels when the tight structure holds (head-sharded flash kernel);
    parallel (sequence-sharded) otherwise."""
    mode = attn_tp_mode(cfg.n_heads, cfg.kv_heads, mctx)
    if mode in ("heads", "qheads"):
        return Directive.KERNELS
    return Directive.PARALLEL


def ffn_directive(cfg: ArchConfig, mctx: MeshCtx) -> Directive:
    if cfg.moe is not None:
        ok = mctx.mesh is None or cfg.moe.num_experts % mctx.model_size == 0
        return Directive.PARALLEL if ok else Directive.VECTOR
    ok = mctx.mesh is None or cfg.d_ff % mctx.model_size == 0
    return Directive.PARALLEL if ok else Directive.VECTOR


def ssd_directive(cfg: ArchConfig, mctx: MeshCtx) -> Directive:
    inner = cfg.ssm.expand * cfg.d_model
    heads = inner // cfg.ssm.head_dim
    ok = mctx.mesh is None or (
        inner % mctx.model_size == 0 and heads % mctx.model_size == 0
    )
    return Directive.KERNELS if ok else Directive.VECTOR


def build_units(
    cfg: ArchConfig, mesh=None, n_groups: int = DEFAULT_GROUPS
) -> List[UnitPlan]:
    mctx = MeshCtx(mesh)
    G = n_groups_for(cfg, n_groups)
    units: List[UnitPlan] = []
    if cfg.family != "encoder":
        units.append(UnitPlan("embed", Directive.VECTOR))
    if cfg.family in ("ssm", "hybrid"):
        d = ssd_directive(cfg, mctx)
        for i in range(G):
            units.append(UnitPlan(f"g{i}/ssd", d))
        if cfg.family == "hybrid":
            units.append(UnitPlan("shared/attn", attention_directive(cfg, mctx)))
            units.append(UnitPlan("shared/ffn", ffn_directive(cfg, mctx)))
    else:
        da = attention_directive(cfg, mctx)
        df = ffn_directive(cfg, mctx)
        tag = "moe" if cfg.moe is not None else "ffn"
        for i in range(G):
            units.append(UnitPlan(f"g{i}/attn", da))
            units.append(UnitPlan(f"g{i}/{tag}", df))
    units.append(UnitPlan("unembed", Directive.PARALLEL))
    return units


GROUP_GATHER_BUDGET = 4 << 30  # bytes: max bulk-gathered group weight size


def group_weight_bytes(cfg: ArchConfig, n_groups: int) -> int:
    """bf16 bytes of one stacked layer-group's gathered weights."""
    per_layer = (cfg.n_params() - cfg.vocab * cfg.d_model * 2) // max(
        cfg.n_layers, 1
    )
    layers_per_group = -(-cfg.n_layers // max(n_groups, 1))
    return int(2 * per_layer * layers_per_group)


def build_plan(
    cfg: ArchConfig,
    mesh=None,
    n_groups: int = DEFAULT_GROUPS,
    *,
    genes: Optional[Tuple[int, ...]] = None,
    bulk_gather: Optional[bool] = None,
    keep_sharded: bool = True,
    staged: bool = True,
    remat: str = "full",
    overlap_collectives: bool = True,
    microbatches: int = 1,
    optimized: bool = False,
) -> ExecutionPlan:
    """Default plan = the paper's proposed method output: every unit
    offloaded with all three transfer reductions on. ``genes`` overrides the
    offload vector (GA individuals); flags toggle the §3.3 ablations.

    ``optimized=True`` enables the beyond-paper §Perf flags (grouped MoE
    dispatch, bf16 intermediates) on top of the paper-faithful plan.
    """
    units = build_units(cfg, mesh, n_groups)
    if bulk_gather is None:
        # bulk "data copy" batching is bounded by device memory: gathering a
        # whole stacked group only when it fits the budget.
        bulk_gather = group_weight_bytes(cfg, n_groups) <= GROUP_GATHER_BUDGET
    plan = ExecutionPlan(
        units=tuple(units),
        overlap_collectives=overlap_collectives,
        microbatches=microbatches,
    ).with_flags(
        bulk_gather=bulk_gather,
        keep_sharded=keep_sharded,
        staged=staged,
        remat=remat,
        grouped_dispatch=optimized,
        bf16_intermediates=optimized,
    )
    if genes is not None:
        plan = plan.with_genes(genes)
    return plan
