"""Carry the reference's weights into the port.

``params_from_jax(tree)`` takes the JAX parameter tree as numpy arrays
(nested dicts with the names of the reference's ``Model.init``, each
group's layers stacked on a leading axis) and returns the port's state dict
for ``Model(..., params=...)``: each stacked leaf is split into its layers
(``g0.layers.<i>.<name>``), matrices become bfloat16, and the leaves that
the reference reads in float32 stay float32: norm scales; MoE routers
(``moe_apply`` reads ``router.astype(float32)``; a bfloat16 router would
pick other experts); and the six small leaves of an SSD layer, ``A_log``,
``dt_bias``, ``conv_x``, ``conv_bc``, ``norm`` and ``Dskip``, which
``ssd_apply`` reads without a cast to bfloat16 (``A_log`` in bfloat16
would move every head's decay by up to 0.4%).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.mamba import F32_LEAVES


def _leaves(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _leaves(val, path + ".")
        else:
            yield path, np.array(val, np.float32)  # a writable copy


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        tail = path.split(".")[-2:]
        f32 = (
            path.endswith(".scale")
            or tail == ["moe", "router"]
            or (tail[0] == "ssd" and tail[1] in F32_LEAVES)
        )
        dtype = torch.float32 if f32 else torch.bfloat16
        head, sep, rest = path.partition(".layers.")
        if sep:  # stacked (n, ...) leaf of a layer group
            for i in range(arr.shape[0]):
                out[f"{head}.layers.{i}.{rest}"] = torch.from_numpy(arr[i]).to(dtype)
        else:
            out[path] = torch.from_numpy(arr).to(dtype)
    return out
