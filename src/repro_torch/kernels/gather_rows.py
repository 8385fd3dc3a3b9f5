"""Row gather: the hand-written CUDA kernel, its wrapper, its plain version.

The kernel (``csrc/gather_rows.cu``) replaces
``src/repro/kernels/gather_rows.py::_gather_kernel``, vmapped over a
leading group axis as the reference's ``ops._rows`` does:
``out[g, i] = src[g, idx[g, i]]``, where an index below 0 gives a zero row
and one past the last row reads the last row. It is a copy, bound by bytes:
one warp per output row, 16-byte vector loads and stores where the rows are
aligned to them.

``gather_rows`` launches the kernel on CUDA tensors and raises on anything
else; ``gather_rows_plain`` is the same function in plain PyTorch.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535  # the kernel's grid puts the group axis on y

_c_ll = ctypes.c_longlong
_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [_c_ll] * 6 + [ctypes.c_void_p]
)


def _kernel():
    fn = _build.load("gather_rows").gather_rows_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(G, N, d) gathered by (G, M) -> (G, M, d); the reference's ``_rows``
    without its kernel: indices clipped into [0, N), rows of negative
    indices zeroed."""
    safe = idx.long().clamp(0, src.shape[1] - 1)
    out = torch.gather(src, 1, safe[..., None].expand(*idx.shape, src.shape[2]))
    return out.masked_fill(idx[..., None] < 0, 0)


def _check(src, idx):
    if src.dtype not in _DTYPES:
        raise TypeError(f"gather_rows kernel takes float32 or bfloat16 src, got {src.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows kernel takes int32 indices, got {idx.dtype}")
    if src.dim() != 3 or idx.dim() != 2 or idx.shape[0] != src.shape[0]:
        raise ValueError(
            f"gather_rows kernel: src (G, N, d) and idx (G, M), got "
            f"{tuple(src.shape)} and {tuple(idx.shape)}"
        )
    G, N, d = src.shape
    if src.stride(2) != 1:
        raise ValueError("gather_rows kernel: src needs unit stride on d")
    if not 1 <= G <= _GRID_LIMIT:
        raise ValueError(f"gather_rows kernel: G={G} outside [1, {_GRID_LIMIT}]")
    if N < 1 or d < 1:
        raise ValueError(f"gather_rows kernel: N={N}, d={d}")
    for name, t in (("src", src), ("idx", idx)):
        if not t.is_cuda:
            raise ValueError(f"gather_rows kernel: {name} is on {t.device}, not CUDA")
    if idx.device != src.device:
        raise ValueError("gather_rows kernel: src and idx on different devices")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: src (G, N, d) float32 or bfloat16,
    idx (G, M) int32 -> (G, M, d) of src's dtype. Raises on a tensor it does
    not take."""
    global launches
    _check(src, idx)
    G, N, d = src.shape
    M = idx.shape[1]
    out = torch.empty((G, M, d), dtype=src.dtype, device=src.device)
    if M == 0:
        return out
    with torch.cuda.device(src.device):
        err = _kernel()(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.element_size(),
            G, N, M, d, src.stride(0), src.stride(1), *idx.stride(),
            out.stride(0), out.stride(1), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {err}")
    launches += 1
    return out
