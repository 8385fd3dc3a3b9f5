"""Flash attention: the hand-written CUDA kernel, its wrapper, its plain version.

The kernel (``csrc/flash_attention.cu``) replaces
``src/repro/kernels/flash_attention.py::_flash_kernel``. At prefill lengths
it is bound by operations, not bytes. Its present design is simple: one
block per (64-row query tile, head, batch) loops over the key tiles with its
softmax state in registers and K/V staged in shared memory, and every
product is a float32 FMA, so the tensor cores stay unused.

``flash_attention`` launches the kernel on CUDA tensors and raises on
anything else; ``flash_attention_plain`` is the same function in plain
PyTorch (``ref.attention_ref``). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

launches = 0

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # the kernel's grid puts heads on y and batch on z

_c_ll = ctypes.c_longlong
_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 7
    + [_c_ll] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    + [ctypes.c_void_p]
)


def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, causal, local_window, logit_softcap, q_offset):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on {t.device}, not CUDA")
        if t.device != q.device:
            raise ValueError("flash_attention kernel: q, k, v on different devices")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(
                f"flash_attention kernel takes float32 or bfloat16 q, k, v of "
                f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
            )
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be (B, S, heads, D)")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name} needs unit stride on D")
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention kernel: shapes {q.shape} {k.shape} {v.shape}")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention kernel: {H} q heads over {K} kv heads")
    if not (1 <= D <= MAX_HEAD_DIM) or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention kernel: D={D}, Sq={Sq}, Sk={Sk}")
    if B > _GRID_LIMIT or H > _GRID_LIMIT:
        raise ValueError(f"flash_attention kernel: B={B}, H={H} over {_GRID_LIMIT}")
    if local_window < 0 or logit_softcap < 0:
        raise ValueError("flash_attention kernel: negative window or softcap")


def flash_attention(
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
    """Launch the kernel on CUDA tensors; the output has q's shape and dtype.
    Raises on a tensor or an argument it does not take."""
    global launches
    _check(q, k, v, causal, local_window, logit_softcap, q_offset)
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    scale = (1.0 / D**0.5) if scale is None else scale
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, K, Sq, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            scale, int(causal), int(local_window), float(logit_softcap),
            int(q_offset), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
