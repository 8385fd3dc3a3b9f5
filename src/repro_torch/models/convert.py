"""Carry the reference's weights into the port.

``params_from_jax(tree)`` takes the JAX parameter tree as numpy arrays
(nested dicts with the names of the reference's ``Model.init``, each
group's layers stacked on a leading axis) and returns the port's state dict
for ``Model(..., params=...)``: each stacked leaf is split into its layers
(``g0.layers.<i>.<name>``), matrices become bfloat16, and norm scales and
MoE routers stay float32: the reference routes in float32
(``moe_apply`` reads ``router.astype(float32)``), and a bfloat16 router
would pick other experts.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
        f32 = path.endswith(".scale") or path.split(".")[-2:] == ["moe", "router"]
        dtype = torch.float32 if f32 else torch.bfloat16
        head, sep, rest = path.partition(".layers.")
        if sep:  # stacked (n, ...) leaf of a layer group
            for i in range(arr.shape[0]):
                out[f"{head}.layers.{i}.{rest}"] = torch.from_numpy(arr[i]).to(dtype)
        else:
            out[path] = torch.from_numpy(arr).to(dtype)
    return out
