"""Execution plans: the genome's phenotype.

The paper maps a binary gene string onto OpenACC directives inserted into
loop statements. Here the same gene string maps onto per-unit execution
treatments of a model's stage graph:

- ``Directive`` is assigned per unit by static analysis (``core.analysis``),
  exactly as pgcc's loop classification chooses kernels / parallel loop /
  parallel loop vector in the paper. It is NOT searched by the GA.
- ``offload`` (the 0/1 gene) decides whether the unit receives its directive
  treatment (TP/EP sharding + fused kernels) or runs in the baseline
  data-parallel ("CPU") mode.
- The transfer-reduction flags are set per individual by ``core.transfer``
  (the paper applies data copy / present / temp-area to every individual).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Sequence, Tuple


class Directive(str, enum.Enum):
    #: fused Pallas kernel path (tightly-structured compute) — `acc kernels`
    KERNELS = "kernels"
    #: explicit model-axis sharding: TP / EP / sequence-parallel — `acc parallel loop`
    PARALLEL = "parallel"
    #: no model-axis parallelism available; batch-vectorized only —
    #: `acc parallel loop vector`
    VECTOR = "vector"


@dataclasses.dataclass(frozen=True)
class UnitPlan:
    """Execution treatment for one offload unit (e.g. group 3's attention)."""

    name: str
    directive: Directive
    offload: bool = True  # the GA gene
    # --- transfer-reduction flags (paper §3.3 analogues) -------------------
    bulk_gather: bool = True  # multi-file bulk `data copy`: coalesced FSDP gather
    keep_sharded: bool = True  # `data present`: no reshard between offloaded units
    staged: bool = True  # temp-area: explicit internal sharding constraints
    # --- additional plan knobs ---------------------------------------------
    remat: str = "full"  # none | dots | full
    compress_grads: bool = False
    # --- beyond-paper optimization flags (§Perf; default off = baseline) ----
    # MoE: dispatch tokens locally per data-shard group and let the
    # (group, expert, cap, d) buffer reshard group->expert as an all-to-all
    # instead of a global (unshardable) sort.
    grouped_dispatch: bool = False
    # write projection-einsum outputs in bf16 (MXU still accumulates f32
    # per shard): halves activation HBM traffic AND halves the bytes of the
    # row-parallel partial-sum all-reduce.
    bf16_intermediates: bool = False

    @property
    def active_directive(self) -> Directive:
        return self.directive if self.offload else Directive.VECTOR


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Whole-model plan: one UnitPlan per offload unit, in graph order."""

    units: Tuple[UnitPlan, ...]
    overlap_collectives: bool = True
    microbatches: int = 1

    def __post_init__(self):
        names = [u.name for u in self.units]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate unit names: {names}")

    @property
    def by_name(self) -> Dict[str, UnitPlan]:
        return {u.name: u for u in self.units}

    def unit(self, name: str) -> UnitPlan:
        return self.by_name[name]

    def get(self, name: str, default: Optional[UnitPlan] = None):
        return self.by_name.get(name, default)

    def genes(self) -> Tuple[int, ...]:
        return tuple(int(u.offload) for u in self.units)

    def with_genes(self, genes: Sequence[int]) -> "ExecutionPlan":
        assert len(genes) == len(self.units)
        units = tuple(
            dataclasses.replace(u, offload=bool(g))
            for u, g in zip(self.units, genes)
        )
        return dataclasses.replace(self, units=units)

    def with_flags(self, **flags) -> "ExecutionPlan":
        """Set transfer/remat flags uniformly across units."""
        units = tuple(dataclasses.replace(u, **flags) for u in self.units)
        return dataclasses.replace(self, units=units)

    def describe(self) -> str:
        rows = []
        for u in self.units:
            rows.append(
                f"  {u.name:14s} {u.directive.value:9s} gene={int(u.offload)} "
                f"bulk={int(u.bulk_gather)} present={int(u.keep_sharded)} "
                f"staged={int(u.staged)} remat={u.remat}"
            )
        return "\n".join(rows)


def default_unit(name: str, directive: Directive, **kw) -> UnitPlan:
    return UnitPlan(name=name, directive=directive, **kw)
