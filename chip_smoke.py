"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

  python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers it prints) and the CUDA
toolkit's ``nvcc``; run from the root of a checkout. Phases, each of which
raises on failure (the script then exits non-zero and prints no result):

1. the environment: card name and power limit, torch, CUDA and nvcc;
2. build every kernel of the port from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and on a small grid of the options it takes, and
   time the kernel, the plain version and one library call of the same
   function where PyTorch has one: flash attention (tolerances below), the
   MoE row gather (``torch.equal``: it is a copy), with ``moe_permute``'s
   backward, and the Mamba-2 SSD scan (``check_ssd``; no library call);
4. serve each model of ``ARCHS`` at its published widths and depth
   through ``repro_torch.launch.serve`` (glm4-9b; moonshot-v1-16b-a3b,
   whose MoE layers dispatch and combine through the gather kernel;
   mamba2-1.3b, whose every prefill layer scans through the SSD kernel): 8
   requests, 4 slots, prompts of 128-2048 tokens, 32 new tokens each, with
   every kernel's launch count set to 0 before the run and read after it;
   time and trace one 2048-token prefill and one decode step of the served
   model (``torch.profiler``: device busy share, top kernels); then check a
   two-layer full-width model's logits on the card against the same
   weights on the CPU, where every kernel is its plain version (for the
   MoE model, after checking that both routers choose the same experts on
   the same input, and reporting where the two runs chose others; for
   mamba2, the prefill and the cache-free forward of a 300-token prompt,
   a full chunk and a padded one);
5. one JSON line of the kernels, the card line, and last the result line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
ARCHS = ("glm4-9b", "moonshot-v1-16b-a3b", "mamba2-1.3b")  # the main paths, each served in turn
N_REQUESTS, SLOTS, MAX_NEW, CTX_LEN = 8, 4, 32, 4096
PROMPT_LENS = (128, 2048)
# The main path's attention shape: one 2048-token glm4-9b prefill.
MAIN = dict(B=1, S=2048, H=32, K=2, D=128, dtype=torch.bfloat16)
# The gather's main shapes are those of one prefill of the longest prompt
# in the MoE model (moonshot-v1-16b-a3b: dispatch reads 2048 tokens into
# 64 experts x 241 slots, combine reads the slots back into 2048 x 6 rows).
MOE_ARCH = ARCHS[1]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # atol = rtol, as the JAX kernel tests
ROW_TOL = 1e-2  # bf16 relative L2 error of one output row; one ulp is at most 2^-7
# The profile phase: one prefill of the longest prompt, decode steps over
# the filled slots.
PROFILE_PROMPT, PROFILE_STEPS, PROFILE_ROWS = PROMPT_LENS[1], 8, 8

# The SSD scan's main shape: one layer of a 2048-token mamba2-1.3b prefill.
SSD_MAIN = dict(B=1, S=2048, H=64, P=64, N=128, chunk=256, dtype=torch.bfloat16)
SSD_TOL = dict(atol=2e-4, rtol=2e-3)  # f32 y and every state, as the JAX SSD kernel tests
SSD_ROW_TOL = 1e-2  # bf16 y: relative L2 error of each (batch, head)
# At the main shape the kernel's bf16 y may be off its plain version by at
# most this (max |err|), a limit set from the error measured on the card
# (3.125e-2, one bf16 ulp at |y| in [4, 8), with |y| up to 17.75 there):
# one bf16 ulp of the largest |y|, which lies in [16, 32).
SSD_MAIN_LIMIT = 0.125
SSD_CPU_PROMPT = 300  # the card-vs-CPU check of mamba2: a full chunk of 256 and a padded one

# Published peaks of one H100 SXM (dense, at its 700 W limit).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1-2: environment and build
# ---------------------------------------------------------------------------


def environment() -> None:
    from repro_torch.kernels import _build

    nvcc = subprocess.run(
        [_build.nvcc(), "--version"], check=True, capture_output=True, text=True
    ).stdout.strip().splitlines()[-1]
    log(f"[env] card: {card_line()}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, nvcc: {nvcc}")
    log(f"[env] device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    # float32 products in full float32: the MoE router's top-k and capacity
    # drops would move with TF32's rounding.
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls are set to round through TF32")


def build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {lib.name}")
        for ln in ptxas:
            log(f"[build]   {ln}")


# ---------------------------------------------------------------------------
# 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _qkv(gen, B, Sq, Sk, H, K, D, dtype):
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return mk(B, Sq, H, D), mk(B, Sk, K, D), mk(B, Sk, K, D)


def _err(got, want, dtype):
    """max |got - want|; raises beyond atol + rtol * |want|.

    For bf16 it also holds each output row (one query of one head, D
    values) to ``ROW_TOL`` in relative L2 error: both sides round an f32
    result to bf16, so they differ by at most one bf16 ulp (2^-7 of the
    value) per element, while a kernel that drops a share of some rows'
    keys moves those rows by far more, yet can stay inside 2e-2 at the
    small output values of long causal rows (about 0.04)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = TOL[dtype]
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output is not finite")
    bad = diff > tol + tol * w.abs()
    if bad.any():
        raise AssertionError(
            f"kernel disagrees with its plain version at {int(bad.sum())} "
            f"elements, max |err| {float(diff.max()):.3e}, tolerance {tol}"
        )
    if dtype == torch.bfloat16:
        row = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        if float(row.max()) > ROW_TOL:
            raise AssertionError(
                f"{int((row > ROW_TOL).sum())} output rows off their plain version by "
                f"more than {ROW_TOL} relative L2 error (worst {float(row.max()):.3e})"
            )
    return float(diff.max())


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, by CUDA events
    on the current stream, so gaps in which the device waits for the host
    count too (the inputs stay resident in L2 between calls, as they are
    when a prefill's projections have just written them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _valid_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """Number of (query, key) pairs the mask lets through."""
    qp = torch.arange(Sq, device="cuda")[:, None] + q_offset
    kp = torch.arange(Sk, device="cuda")[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    return int(ok.sum())


def attention_bound_ms(B, Sq, Sk, H, K, D, dtype, causal=True, window=0, q_offset=0):
    """Least time for the same work: the larger of the two products' flops
    over the peak rate for the input type, and q, k, v read once plus the
    output written once over the memory rate. Returns (ms, bound_by)."""
    flops = 4.0 * B * H * D * _valid_pairs(Sq, Sk, causal, window, q_offset)
    nbytes = (B * Sq * H * D * 2 + 2 * B * Sk * K * D) * torch.finfo(dtype).bits // 8
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


GRID = [  # (name, B, Sq, Sk, H, K, D, dtype, kwargs)
    ("glm4 heads, small S", 2, 64, 64, 32, 2, 128, torch.bfloat16, dict(causal=True)),
    ("glm4 heads, served ragged S", 1, 1762, 1762, 32, 2, 128, torch.bfloat16,
     dict(causal=True)),
    ("f32 D=80 ragged S", 2, 197, 197, 4, 2, 80, torch.float32, dict(causal=True)),
    ("f32 D=32", 1, 130, 130, 4, 4, 32, torch.float32, dict(causal=True)),
    ("f32 D=256", 1, 100, 100, 2, 1, 256, torch.float32, dict(causal=True)),
    ("window 16", 1, 300, 300, 4, 2, 64, torch.float32, dict(causal=True, local_window=16)),
    ("window 64 bf16", 2, 300, 300, 4, 2, 128, torch.bfloat16, dict(causal=True, local_window=64)),
    ("softcap 30", 1, 256, 256, 4, 2, 64, torch.float32, dict(causal=True, logit_softcap=30.0)),
    ("non-causal", 1, 150, 150, 4, 2, 64, torch.float32, dict(causal=False)),
    ("q_offset, Sq < Sk", 2, 37, 300, 4, 2, 64, torch.float32, dict(causal=True, q_offset=263)),
    ("q_offset inside", 1, 64, 200, 4, 2, 128, torch.bfloat16, dict(causal=True, q_offset=70)),
    ("GQA group 1", 1, 128, 128, 16, 16, 64, torch.float32, dict(causal=True)),
    ("GQA group 4", 1, 128, 128, 16, 4, 64, torch.float32, dict(causal=True)),
    ("GQA group 16", 1, 128, 128, 16, 1, 64, torch.float32, dict(causal=True)),
    ("rows before key 0", 1, 40, 40, 2, 1, 64, torch.float32, dict(causal=True, q_offset=-5)),
    ("window past last key", 1, 64, 64, 2, 1, 64, torch.float32,
     dict(causal=True, local_window=8, q_offset=100)),
]


def check_flash_attention() -> dict:
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, B, Sq, Sk, H, K, D, dt, kw in GRID:
        q, k, v = _qkv(gen, B, Sq, Sk, H, K, D, dt)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = _err(got, fa.flash_attention_plain(q, k, v, **kw), dt)
        log(f"[kernel] flash_attention {name}: B={B} Sq={Sq} Sk={Sk} H={H} K={K} "
            f"D={D} {str(dt)[6:]} {kw}: max |err| {err:.3e} (tol {TOL[dt]})")

    m = MAIN
    B, S, H, K, D, dt = m["B"], m["S"], m["H"], m["K"], m["D"], m["dtype"]
    q, k, v = _qkv(gen, B, S, S, H, K, D, dt)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = _err(got, fa.flash_attention_plain(q, k, v, causal=True), dt)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), reps=20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), reps=5)
    # Yardstick only, never called by the port: PyTorch's fused attention on
    # the same inputs in its (B, H, S, D) layout, kv heads expanded first.
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(H // K, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(H // K, dim=1)
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_err = float((lib.transpose(1, 2).float() - got.float()).abs().max())
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), reps=20
    )
    bound_ms, bound_by = attention_bound_ms(B, S, S, H, K, D, dt)
    log(f"[kernel] flash_attention main shape B={B} S={S} H={H} K={K} D={D} bf16 "
        f"causal: max |err| {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (|sdpa - kernel| {lib_err:.3e}), "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": None,  # filled from the main path's run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _equal(got, want, what: str) -> float:
    """Raises unless the kernel's output equals its plain version's, bit for
    bit; returns max |got - want| (0.0)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        bad = (got != want).sum() if got.shape == want.shape else "shape"
        raise AssertionError(f"gather_rows {what}: kernel differs from its plain version ({bad})")
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def _gather_grid(gen):
    """(name, src, idx) cases on the options the kernel takes."""
    def src(G, N, d, dt):
        return torch.randn((G, N, d), generator=gen, device="cuda").to(dt)

    def idx(G, M, lo, hi):
        return torch.randint(lo, hi, (G, M), generator=gen, device="cuda", dtype=torch.int32)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        cases += [
            (f"d=1 M=29 {name}", src(3, 37, 1, dt), idx(3, 29, -1, 37)),
            (f"d=80 M=45 {name}", src(3, 50, 80, dt), idx(3, 45, -1, 50)),
            (f"d=2048 M=101 {name}", src(3, 64, 2048, dt), idx(3, 101, -1, 64)),
            (f"every index -1 {name}", src(3, 64, 2048, dt), torch.full(
                (3, 101), -1, dtype=torch.int32, device="cuda")),
            (f"indices >= N {name}", src(3, 20, 80, dt), idx(3, 33, -1, 30)),
            (f"rows 16-byte unaligned {name}", src(3, 40, 65, dt)[:, :, 1:], idx(3, 50, -1, 40)),
            (f"strided rows {name}", src(3, 80, 256, dt)[:, ::2], idx(3, 50, -1, 40)),
        ]
        nan_src = src(3, 40, 128, dt)
        nan_src[:, 1::2] = float("nan")  # odd rows, which no index reads
        cases.append((f"NaN rows unread {name}", nan_src, 2 * idx(3, 50, 0, 20)))
    return cases


def gather_bound_ms(src, idx):
    """Least time for the same work, bound by bytes: the indices read, each
    source row that an index names read once (indices past N name the last
    row) and every output row written once, over the memory rate."""
    row = src.shape[2] * src.element_size()
    named = torch.unique(idx[idx >= 0].clamp_max(src.shape[1] - 1)).numel()
    nbytes = idx.numel() * 4 + named * row + idx.numel() * row
    return 1e3 * nbytes / PEAK_BYTES, nbytes


def _permute_grad(device, x, bs, ts, fs, k, c, r):
    """d/dx of sum(r * combine(c * dispatch(x))) through ops.moe_permute."""
    from repro_torch.kernels import ops

    x = x.detach().to(device).requires_grad_()
    bs, ts, fs, c, r = (t.to(device) for t in (bs, ts, fs, c, r))
    y = ops.moe_permute(ops.moe_permute(x, bs, ts, k) * c, ts, fs, 1)
    (y * r).sum().backward()
    return x.grad


def check_gather_rows() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import gather_rows as gr
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    err = 0.0
    for name, src, idx in _gather_grid(gen):
        err = max(err, _equal(gr.gather_rows(src, idx), gr.gather_rows_plain(src, idx), name))
        log(f"[kernel] gather_rows {name}: src {tuple(src.shape)} strides {src.stride()} "
            f"idx {tuple(idx.shape)}: equal")

    # moe_permute's backward (a gather by inv_idx, then a sum over k_inv)
    # through the kernel, against the plain version on the CPU: the same
    # gathers and sums, elementwise factors only, so the gradients are equal.
    G, T, k, E, d = 2, 40, 2, 4, 64
    cap = moe.capacity(T, k, E)
    eids = torch.stack([torch.topk(torch.rand((T, E), generator=gen, device="cuda"), k).indices
                        for _ in range(G)])
    eids[1, :, 0] = 0  # group 1 overflows expert 0: some assignments drop
    bs, ts, fs = (torch.stack(v) for v in zip(*(moe.route(e, E, cap) for e in eids)))
    x = torch.randn((G, T, d), generator=gen, device="cuda")
    c = torch.randn((G, E * cap, d), generator=gen, device="cuda")
    r = torch.randn((G, T * k, d), generator=gen, device="cuda")
    launches = gr.launches
    got = _permute_grad("cuda", x, bs, ts, fs, k, c, r)
    if gr.launches - launches != 4:
        raise AssertionError(f"moe_permute forward and backward launched {gr.launches - launches}")
    want = _permute_grad("cpu", x, bs, ts, fs, k, c, r)
    if not (ts < 0).any() or not torch.equal(got.cpu(), want):
        raise AssertionError("moe_permute backward through the kernel differs from the plain version")
    log(f"[kernel] moe_permute backward G={G} T={T} k={k} E={E} cap={cap} d={d} f32, "
        f"{int((ts < 0).sum())} assignments dropped: equal to the plain version")

    cfg = get_arch(MOE_ARCH)
    T, E, k, d = PROMPT_LENS[1], cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    # The main path's index vectors: a real route of a random top-k routing.
    probs = torch.softmax(torch.randn((T, E), generator=gen, device="cuda"), dim=-1)
    cap = moe.capacity(T, k, E)
    buf_src, tok_slots, _ = (i[None] for i in moe.route(torch.topk(probs, k).indices, E, cap))
    x = torch.randn((1, T, d), generator=gen, device="cuda")
    yb = torch.randn((1, E * cap, d), generator=gen, device="cuda")
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for what, src32, idx in (("dispatch", x, buf_src), ("combine", yb, tok_slots)):
        for dt in (torch.float32, torch.bfloat16):
            src = src32.to(dt)
            err = max(err, _equal(gr.gather_rows(src, idx), gr.gather_rows_plain(src, idx),
                                  f"{what} main shape {str(dt)[6:]}"))
        src = src32.to(torch.bfloat16)
        ms = time_ms(lambda: gr.gather_rows(src, idx), reps=50)
        plain_ms = time_ms(lambda: gr.gather_rows_plain(src, idx), reps=50)
        # Yardstick only, never called by the port: PyTorch's row gather of
        # the same rows, zeroed where the index is -1.
        i0 = idx[0]
        library_ms = time_ms(lambda: torch.index_select(src[0], 0, i0.clamp_min(0)).masked_fill_(
            i0[:, None] < 0, 0), reps=50)
        bound_ms, nbytes = gather_bound_ms(src, idx)
        for key, val in zip(total, (ms, plain_ms, bound_ms, library_ms)):
            total[key] += val
        log(f"[kernel] gather_rows {what} main shape: src {tuple(src.shape)} bf16, idx "
            f"{tuple(idx.shape)} ({int((idx < 0).sum())} of -1), E={E} cap={cap}: equal in "
            f"f32 and bf16; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, bytes)")
    return {
        "name": "gather_rows",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gather_rows.cu",
        "replaces": "src/repro/kernels/gather_rows.py:31",
        "launches": None,  # filled from the main paths' runs
        "max_abs_err": err,
        # one dispatch plus one combine, as one MoE layer of a 2048-token prefill runs them
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes",
        "library_ms": total["library_ms"],
    }


def _ssd_inputs(gen, B, S, H, P, N, dtype, dt_range=(1e-3, 0.1)):
    """x, dt, A, B, C on the card: A as ``ssd_init`` makes it (-1 to -8),
    dt in the range a softplus of the init's dt_bias gives."""
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    lo, hi = dt_range
    dt = lo + (hi - lo) * torch.rand((B, S, H), generator=gen, device="cuda")
    A = -torch.linspace(1.0, 8.0, H, device="cuda")
    return mk(B, S, H, P).to(dtype), dt, A, mk(B, S, N).to(dtype), mk(B, S, N).to(dtype)


def _ssd_err(got, want, what: str):
    """max |y err| and max |state err|; raises beyond the tolerances: f32 y
    and every state at ``SSD_TOL``; bf16 y at 2e-2 elementwise and
    ``SSD_ROW_TOL`` relative L2 error per (batch, head)."""
    (gy, gs), (wy, ws) = got, want
    torch.cuda.synchronize()
    if not (torch.isfinite(gy.float()).all() and torch.isfinite(gs).all()):
        raise AssertionError(f"ssd_scan {what}: output not finite")
    if gy.shape != wy.shape or gy.dtype != wy.dtype or gs.shape != ws.shape:
        raise AssertionError(f"ssd_scan {what}: shapes {gy.shape} {gs.shape}, want {wy.shape} {ws.shape}")
    g, w = gy.float(), wy.float()
    tol = SSD_TOL if gy.dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for name, a, b, t in (("y", g, w, tol), ("state", gs, ws, SSD_TOL)):
        bad = (a - b).abs() > t["atol"] + t["rtol"] * b.abs()
        if bad.any():
            raise AssertionError(
                f"ssd_scan {what}: {name} off its plain version at {int(bad.sum())} elements, "
                f"max |err| {float((a - b).abs().max()):.3e}, tolerance {t}")
    if gy.dtype == torch.bfloat16:
        d = (g - w).transpose(1, 2).flatten(2)  # (B, H, S * P)
        row = d.norm(dim=-1) / w.transpose(1, 2).flatten(2).norm(dim=-1).clamp_min(1e-30)
        if float(row.max()) > SSD_ROW_TOL:
            raise AssertionError(f"ssd_scan {what}: a (batch, head) off by {float(row.max()):.3e} "
                                 f"relative L2 error, over {SSD_ROW_TOL}")
    return float((g - w).abs().max()), float((gs - ws).abs().max())


def ssd_bound_ms(B, S, H, P, N, chunk, dtype):
    """Least time for one scan: the larger of its bytes (x, dt, A, B, C read
    once, y and the final state written once) over the memory rate and its
    operations over the peak rate for the input type. Operations: per chunk,
    C B^T over the causal half once (it is the same for every head), and
    per head the causal product with X, the carried state's part (none in
    the first chunk, whose state is zero) and the state update."""
    es = torch.finfo(dtype).bits // 8
    nc = S // chunk
    nbytes = (2 * B * S * H * P * es + B * S * H * 4 + H * 4 + 2 * B * S * N * es
              + B * H * P * N * 4)
    causal = chunk * (chunk + 1) // 2
    flops = B * nc * 2.0 * causal * N + B * H * (
        nc * 2.0 * causal * P + (nc - 1) * 2.0 * chunk * N * P + nc * 2.0 * chunk * P * N)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), nbytes, flops


def _ptxas(lib_name: str) -> str:
    from repro_torch.kernels import _build

    lib = _build.build_all()[lib_name]
    lines = lib.with_suffix(".log").read_text().splitlines()
    return "; ".join(ln.split("ptxas info    :")[-1].strip() for ln in lines
                     if "registers" in ln or "spill" in ln)


def check_ssd() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = []
    for S in (1, 37, 256, 300, 2048):
        for P, N in ((64, 128), (16, 16)):
            for dt in (torch.bfloat16, torch.float32):
                cases.append((f"S={S} P={P} N={N} {str(dt)[6:]}", S, P, N, dt, (1e-3, 0.1)))
    cases.append(("large dt: decays underflow to 0", 300, 64, 128, torch.bfloat16, (5.0, 50.0)))
    cases.append(("large dt f32", 37, 16, 16, torch.float32, (5.0, 50.0)))
    for i, (name, S, P, N, dt, dt_range) in enumerate(cases):
        B, H, return_state = 1 + i % 2, 4, i % 3 != 2
        x, d, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, N, dt, dt_range)
        got = ops.ssd_scan(x, d, A, Bm, Cm, chunk=256, return_state=return_state)
        # the plain version on the same padded inputs, with its state
        chunk = min(256, S)
        pad = (-S) % chunk
        xp, dp, Bp, Cp = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, d, Bm, Cm))
        wy, ws = ssd.ssd_scan_plain(xp, dp, A, Bp, Cp, chunk=chunk)
        want = (wy[:, :S], ws)
        if not return_state:
            gs = ssd.ssd_scan(xp, dp, A, Bp, Cp, chunk=chunk)[1]  # the state is checked all the same
            got = (got, gs)
        ey, es = _ssd_err(got, want, name)
        log(f"[kernel] ssd_scan {name}: B={B} S={S} (chunk {chunk}, pad {pad}) H={H} P={P} "
            f"N={N}, return_state={return_state}: max |err| y {ey:.3e}, state {es:.3e}")

    m = SSD_MAIN
    B, S, H, P, N, chunk, dt = (m[k] for k in ("B", "S", "H", "P", "N", "chunk", "dtype"))
    x, d, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, N, dt)
    got = ssd.ssd_scan(x, d, A, Bm, Cm, chunk=chunk)
    want = ssd.ssd_scan_plain(x, d, A, Bm, Cm, chunk=chunk)
    err, state_err = _ssd_err(got, want, "main shape")
    if err > SSD_MAIN_LIMIT:
        raise AssertionError(f"ssd_scan main shape: max |err| {err:.3e} over {SSD_MAIN_LIMIT}")
    ymax = float(want[0].float().abs().max())
    ms = time_ms(lambda: ssd.ssd_scan(x, d, A, Bm, Cm, chunk=chunk), reps=20)
    plain_ms = time_ms(lambda: ssd.ssd_scan_plain(x, d, A, Bm, Cm, chunk=chunk), reps=5)
    bound_ms, bound_by, nbytes, flops = ssd_bound_ms(B, S, H, P, N, chunk, dt)
    log(f"[kernel] ssd_scan main shape B={B} S={S} H={H} P={P} N={N} chunk {chunk} bf16: max "
        f"|err| y {err:.3e} (|y| max {ymax:.2f}, limit {SSD_MAIN_LIMIT}), state {state_err:.3e}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no library call, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); ptxas: {_ptxas('ssd')}")
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:26",
        "launches": None,  # filled from the main path's run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# 4: the main paths
# ---------------------------------------------------------------------------


def serve_full_width(arch: str) -> dict:
    """Serve ``arch`` at full width; returns each kernel's launches in the run."""
    from repro_torch.launch import serve as launcher

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = launcher.build_engine(
        arch, full_width=True, ctx_len=CTX_LEN, slots=SLOTS, device="cuda", seed=SEED
    )
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    if cfg.ssm:
        s = cfg.ssm
        inner = s.expand * cfg.d_model
        layer = (f"SSD: inner {inner}, {inner // s.head_dim} heads of {s.head_dim}, state "
                 f"{s.state_dim}, conv {s.conv_width}, chunk {s.chunk}")
    else:
        moe = (f", MoE {cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
               f"{cfg.moe.shared_experts} shared" if cfg.moe else "")
        layer = (f"{cfg.n_heads}/{cfg.kv_heads} heads of {cfg.resolved_head_dim}, "
                 f"d_ff {cfg.d_ff}{moe}")
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {layer}, "
        f"vocab {cfg.vocab}: {n_params / 1e9:.3f} B parameters drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    lens = np.random.default_rng(SEED).integers(
        PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=N_REQUESTS
    )
    reqs = launcher.random_requests(cfg.vocab, lens.tolist(), MAX_NEW, SEED)

    for mod in launcher.KERNELS.values():
        mod.launches = 0
    stats = launcher.serve(engine, reqs)
    launches = {name: mod.launches for name, mod in launcher.KERNELS.items()}

    done = stats["done"]
    prefills, steps = len(engine.prefill_s), stats["decode_steps"]
    if len(done) != N_REQUESTS or prefills != N_REQUESTS:
        raise AssertionError(f"{len(done)} of {N_REQUESTS} requests done, {prefills} prefills")
    for r in done:
        if len(r.output) != MAX_NEW or not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"request {r.request_id}: output {r.output}")
    # Every prefill runs each layer's attention through the flash kernel,
    # or each SSD layer's scan through the SSD kernel; every prefill and
    # decode step runs each MoE layer's dispatch and combine through the
    # gather kernel.
    want = {
        "flash_attention": 0 if cfg.ssm else cfg.n_layers * prefills,
        "gather_rows": 2 * cfg.n_layers * (prefills + steps) if cfg.moe else 0,
        "ssd_scan": cfg.n_layers * prefills if cfg.ssm else 0,
    }
    if launches != want or stats["launches"] != want:
        raise AssertionError(f"kernel launches in the run {launches} (the launcher counted "
                             f"{stats['launches']}), want {want} ({cfg.n_layers} layers, "
                             f"{prefills} prefills, {steps} decode steps)")
    pre = ", ".join(f"{n}:{ms:.1f}" for n, ms in zip(lens.tolist(), stats["prefill_ms"]))
    log(f"[serve] {len(done)} requests, {stats['tokens']} tokens in {stats['wall_s']:.2f} s; "
        f"{prefills} prefills, {steps} decode steps; kernel launches {launches} "
        f"({cfg.n_layers} layers: " + ("the scan once a layer a prefill" if cfg.ssm else
        "attention once a layer a prefill") + (", dispatch and combine twice a layer a prefill "
        "and a decode step" if cfg.moe else "") + ")")
    log(f"[serve] prefill ms per prompt (tokens:ms, host clock to the first token): {pre}")
    log(f"[serve] decode {stats['decode_tokens']} tokens at {stats['decode_tok_s']:.1f} tok/s "
        f"over {SLOTS} slots; peak device memory {stats['peak_mem_gb']:.2f} GB")
    for r in done[:2]:
        log(f"[serve]   req{r.request_id} ({len(r.prompt)} prompt tokens): {r.output[:8]} ...")
    engine.cache = None  # the profile below makes a cache of its own
    profile(engine)
    del engine
    torch.cuda.empty_cache()
    return launches


def _trace(fn, label: str) -> None:
    """One traced call of ``fn``: the device's busy share of the traced wall
    time and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels only: the host-side operator events carry their kernels' time too.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler recorded no device events")
    busy = sum(e.self_device_time_total for e in events) / 1e6  # us -> s
    log(f"[{label}] traced wall {1e3 * wall:.3f} ms, device busy {1e3 * busy:.3f} ms "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%, "
        f"{sum(e.count for e in events)} kernel launches")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:PROFILE_ROWS]:
        log(f"[{label}]   {e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d} x  "
            f"{e.key[:90]}")


def profile(engine) -> None:
    """Where the served model spends its time: one prefill of the longest
    prompt and one decode step over the filled slots, each timed and then
    traced with ``torch.profiler``."""
    model, cfg = engine.model, engine.cfg
    rng = np.random.default_rng(SEED + 2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, PROFILE_PROMPT)), device="cuda")
    cache = model.init_cache(SLOTS, CTX_LEN)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(SLOTS, 1)), device="cuda")
    positions = torch.full((SLOTS, 1), PROFILE_PROMPT, device="cuda")

    def prefill():
        return model.prefill(prompt, ctx_len=CTX_LEN)

    def decode():
        return model.decode_step(cache, tokens, positions)

    pre_ms = time_ms(prefill, reps=3, warmup=1)
    step_ms = time_ms(decode, reps=PROFILE_STEPS, warmup=1)
    log(f"[profile] prefill of {PROFILE_PROMPT} tokens: {pre_ms:.3f} ms (CUDA events, mean of 3)")
    log(f"[profile] decode over {SLOTS} slots: {step_ms:.3f} ms a step, "
        f"{1e3 * SLOTS / step_ms:.1f} tok/s (CUDA events, mean of {PROFILE_STEPS})")
    _trace(prefill, "prefill trace")
    _trace(decode, "decode trace")


def _routing(model) -> list:
    """Hooks that record, for every MoE layer of ``model`` in its next
    forward, the layer's input (T, d) and its router's probabilities (T, E)
    and chosen experts (T, k), with the MoE module itself."""
    from repro_torch.models.moe import MoE

    seen = []

    def hook(mod, args, out):
        x = args[0].flatten(0, 1)
        probs, _, eids = mod.gate(x)
        seen.append((mod, x, probs.cpu(), eids.cpu()))

    for m in model.modules():
        if isinstance(m, MoE):
            m.register_forward_hook(hook)
    return seen


def _gap(probs, k: int) -> float:
    """A token's gap between its k-th and (k+1)-th router probability."""
    p = probs.sort(descending=True).values
    return float(p[k - 1] - p[k])


def _check_routing(gpu_seen: list, cpu_seen: list, k: int) -> None:
    """Every MoE layer's router on the CPU, given the card's input to that
    layer, chooses the same set of k experts as on the card for every
    token: float32 routing on both, no TF32. (The order within a token's k
    routes nothing: capacity slots go by expert, then by token.) Then the
    two prefills, each on its own hidden states, are compared and every
    token whose set differs is printed with its probability gap at the
    k-th expert on both devices: the hidden states of the two devices
    differ by a few bf16 ulps after a layer, which moves near ties."""
    if len(gpu_seen) != len(cpu_seen) or not gpu_seen:
        raise AssertionError(f"routing of {len(gpu_seen)} and {len(cpu_seen)} MoE layers")
    rows = reordered = 0
    flips = []
    for layer, ((_, x, gp, ge), (cpu_moe, _, wp, we)) in enumerate(zip(gpu_seen, cpu_seen)):
        sp, _, se = cpu_moe.gate(x.cpu())
        gs, ss, ws = (e.sort(dim=-1).values for e in (ge, se, we))
        if not torch.equal(gs, ss):
            for t in (gs != ss).any(dim=-1).nonzero().flatten().tolist():
                log(f"[check] layer {layer} token {t}, same input: card {ge[t].tolist()}, CPU "
                    f"{se[t].tolist()}; top-{k} gap card {_gap(gp[t], k):.3e}, "
                    f"CPU {_gap(sp[t], k):.3e}")
            raise AssertionError(
                f"MoE layer {layer}: on the same input the CPU's router chose other experts")
        rows += ge.shape[0]
        reordered += int((ge != se).any(dim=-1).sum())
        for t in (gs != ws).any(dim=-1).nonzero().flatten().tolist():
            flips.append(f"layer {layer} token {t} (card {ge[t].tolist()}, gap "
                         f"{_gap(gp[t], k):.3e}; CPU {we[t].tolist()}, gap {_gap(wp[t], k):.3e})")
    log(f"[check] routers on the same input: the card and the CPU chose the same {k} experts "
        f"for all {rows} (token, layer) rows ({reordered} of them in another order)")
    log(f"[check] the two prefills on their own hidden states: {len(flips)} of {rows} rows "
        f"chose another expert set" + ("".join(f"\n[check]   {f}" for f in flips)))


def check_logits_against_cpu(arch: str) -> None:
    """Prefill logits of a two-layer ``arch`` at full width on the card
    against the same weights on the CPU, where the model runs the kernels'
    plain versions. bf16 products accumulate in another order on the two
    devices and round the hidden states at other places, so the logits are
    held at 5e-2 absolute + relative (about 4 bf16 ulps at |logit| ~ 3).
    In an MoE model the routers are checked first (``_check_routing``): a
    flip of an expert is a discrete change, not a rounding, and is reported
    as one."""
    from repro_torch.core import analysis
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model

    from repro_torch.kernels import ssd

    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    plan = analysis.build_plan(cfg, None, n_groups=2)
    gpu = Model(cfg, plan, device="cuda", seed=SEED)
    cpu = Model(cfg, plan, device="cpu",
                params={k: v.cpu() for k, v in gpu.state_dict().items()})
    S = SSD_CPU_PROMPT if cfg.ssm else 96
    tokens = np.random.default_rng(SEED + 1).integers(0, cfg.vocab, size=(1, S))
    gpu_routing, cpu_routing = _routing(gpu), _routing(cpu)
    launches = ssd.launches
    got, _ = gpu.prefill(torch.as_tensor(tokens, device="cuda"))
    want, _ = cpu.prefill(torch.as_tensor(tokens))
    if cfg.moe:
        _check_routing(gpu_routing, cpu_routing, cfg.moe.top_k)
    pairs = [("prefill", got[..., : cfg.vocab], want[..., : cfg.vocab], (1, cfg.vocab))]
    if cfg.ssm:
        if ssd.launches - launches != cfg.n_layers:
            raise AssertionError(f"the prefill launched the SSD kernel {ssd.launches - launches} times")
        launches = ssd.launches
        with torch.inference_mode():
            got_t, _, _ = gpu(torch.as_tensor(tokens, device="cuda"))
            want_t, _, _ = cpu(torch.as_tensor(tokens))
        if ssd.launches - launches != cfg.n_layers:
            raise AssertionError(f"the forward launched the SSD kernel {ssd.launches - launches} times")
        pairs.append(("mode=train forward", got_t[..., : cfg.vocab], want_t[..., : cfg.vocab],
                      (1, S, cfg.vocab)))
    for what, got, want, shape in pairs:
        got, want = got.float().cpu(), want.float()
        if got.shape != shape or not torch.isfinite(got).all():
            raise AssertionError(f"{what} logits {tuple(got.shape)}, finite={bool(torch.isfinite(got).all())}")
        diff = (got - want).abs()
        bad = diff > 5e-2 + 5e-2 * want.abs()
        same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        log(f"[check] {cfg.name} 2-layer full-width {what} logits ({S} tokens), card vs CPU: max "
            f"|err| {float(diff.max()):.3e}, |logit| max {float(want.abs().max()):.2f}, argmax "
            f"equal at {100 * same:.1f}% of positions")
        if bad.any():
            raise AssertionError(f"{int(bad.sum())} {what} logits beyond 5e-2 of the CPU's")
    del gpu, cpu
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke runs on the GPU")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a checkout")
        return 1
    if shutil.which("nvidia-smi") is None:
        log("chip_smoke: nvidia-smi not found")
        return 1
    t0 = time.perf_counter()
    environment()
    build()
    kernels = {"flash_attention": check_flash_attention(), "gather_rows": check_gather_rows(),
               "ssd_scan": check_ssd()}
    for k in kernels.values():
        k["launches"] = 0
    for arch in ARCHS:
        for name, n in serve_full_width(arch).items():
            kernels[name]["launches"] += n
        check_logits_against_cpu(arch)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
