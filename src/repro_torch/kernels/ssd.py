"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel, its wrapper, its
plain version.

The kernel (``csrc/ssd.cu``) replaces ``src/repro/kernels/ssd.py::_ssd_kernel``
and, unlike it, also writes the final state, so that prefill runs through it.
It computes ``ref.ssd_ref(..., return_state=True)`` from a zero state in two
passes: C B^T of every chunk once, into a float32 scratch that the wrapper
allocates (it is the same for every head), then the scan, one block per
(batch, head, 16 channels) looping over the chunks with the state in shared
memory and the decay matrix taken tile by tile from the cumulative sums,
never built whole. Every product is a float32 FMA on the CUDA cores.

``ssd_scan`` launches the kernel on CUDA tensors and raises on anything
else; ``ssd_scan_plain`` is the same function in plain PyTorch. Both take a
sequence that is a multiple of the chunk (``ops.ssd_scan`` pads) and return
``(y, final_state)``. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

launches = 0

MAX_STATE = 128  # N
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # the kernel's grid puts heads on y and batch on z

_c_ll = ctypes.c_longlong
_ARGTYPES = (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [_c_ll] * 13 + [ctypes.c_void_p]
)


def _kernel():
    fn = _build.load("ssd").ssd_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int):
    """(y, final state): ``ref.ssd_ref`` with ``return_state``."""
    return ref.ssd_ref(x, dt, A, Bm, Cm, chunk=chunk, return_state=True)


def _check(x, dt, A, Bm, Cm, chunk):
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_cuda:
            raise ValueError(f"ssd kernel: {name} is on {t.device}, not CUDA")
        if t.device != x.device:
            raise ValueError("ssd kernel: inputs on different devices")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(
            f"ssd kernel takes x, Bm, Cm of one dtype, float32 or bfloat16, got "
            f"{x.dtype}, {Bm.dtype}, {Cm.dtype}"
        )
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd kernel takes float32 dt and A, got {dt.dtype}, {A.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3:
        raise ValueError(
            f"ssd kernel: x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N), "
            f"got {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, {tuple(Bm.shape)}"
        )
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != Cm.shape or Bm.shape[:2] != (B, S):
        raise ValueError(
            f"ssd kernel: shapes {tuple(x.shape)} {tuple(dt.shape)} {tuple(A.shape)} "
            f"{tuple(Bm.shape)} {tuple(Cm.shape)}"
        )
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1 or not A.is_contiguous():
        raise ValueError("ssd kernel: x, Bm, Cm need unit stride on their last axis, A contiguous")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd kernel: state size N={N} outside [1, {MAX_STATE}]")
    if not 1 <= chunk <= MAX_CHUNK or S < 1 or S % chunk:
        raise ValueError(
            f"ssd kernel: chunk {chunk} outside [1, {MAX_CHUNK}] or sequence {S} "
            f"not a multiple of it"
        )
    if P < 1 or not 1 <= B <= _GRID_LIMIT or not 1 <= H <= _GRID_LIMIT:
        raise ValueError(f"ssd kernel: B={B}, H={H}, P={P}")


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Launch the kernel on CUDA tensors: x (B, S, H, P), Bm, Cm (B, S, N)
    float32 or bfloat16, dt (B, S, H) and A (H,) float32, S a multiple of
    ``chunk`` -> (y (B, S, H, P) of x's dtype, final state (B, H, P, N)
    float32). Raises on a tensor or an argument it does not take."""
    global launches
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    scores = torch.empty((B, S // chunk, chunk, chunk), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), scores.data_ptr(), _DTYPES[x.dtype],
            B, S, H, P, N, chunk,
            *x.stride()[:3], *dt.stride(), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), *y.stride()[:3],
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state
