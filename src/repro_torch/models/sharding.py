"""Mesh context for the port: one device, no model axis yet.

``MeshCtx`` keeps the reference's interface so that the directive analysis
(``core.analysis``) reads the same structure. Tensor parallelism over
``torch.distributed`` comes later; until then ``model_size`` is 1 and
``wsc`` (the reference's sharding constraint) is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "repro_torch runs on one device; a mesh needs the "
                "tensor-parallel port (ROADMAP Queue 1 item 6)"
            )

    @property
    def model_size(self) -> int:
        return 1

    def wsc(self, x, *entries, enabled: bool = True):
        """Sharding constraint: the identity on one device."""
        return x


def attn_tp_mode(n_heads: int, kv_heads: int, mctx: MeshCtx) -> str:
    """Directive-applicability analysis for attention tensor parallelism.

    - "heads":   q and kv heads both shard over the model axis
    - "qheads":  only q heads shard; kv weights/cache replicated (small kv)
    - "seq":     neither shards -> sequence-parallel attention
    """
    m = mctx.model_size
    if m == 1:
        return "heads"
    if n_heads % m == 0 and kv_heads % m == 0:
        return "heads"
    if n_heads % m == 0:
        return "qheads"
    return "seq"
