"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

  python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers it prints) and the CUDA
toolkit's ``nvcc``; run from the root of a checkout. Phases, each of which
raises on failure (the script then exits non-zero and prints no result):

1. the environment: card name and power limit, torch, CUDA and nvcc;
2. build every kernel of the port from ``src/repro_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shape and on a small grid of the options it takes, and time
   the kernel, the plain version and one library call of the same function;
4. serve glm4-9b at its published widths through
   ``repro_torch.launch.serve``: 8 requests, 4 slots, prompts of 128-2048
   tokens, 32 new tokens each, with the kernels' launch counts read around
   the run; time and trace one 2048-token prefill and one decode step of
   the served model (``torch.profiler``: device busy share, top kernels);
   then check a two-layer full-width model's prefill logits on the
   card against the same weights on the CPU, where every kernel is its
   plain version;
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
ARCH = "glm4-9b"
N_REQUESTS, SLOTS, MAX_NEW, CTX_LEN = 8, 4, 32, 4096
PROMPT_LENS = (128, 2048)
# The main path's attention shape: one 2048-token glm4-9b prefill.
MAIN = dict(B=1, S=2048, H=32, K=2, D=128, dtype=torch.bfloat16)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # atol = rtol, as the JAX kernel tests
ROW_TOL = 1e-2  # bf16 relative L2 error of one output row; one ulp is at most 2^-7
# The profile phase: one prefill of the longest prompt, decode steps over
# the filled slots.
PROFILE_PROMPT, PROFILE_STEPS, PROFILE_ROWS = PROMPT_LENS[1], 8, 8

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


# ---------------------------------------------------------------------------
# 4: the main path
# ---------------------------------------------------------------------------


def serve_full_width() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as launcher

    t0 = time.perf_counter()
    engine = launcher.build_engine(
        ARCH, full_width=True, ctx_len=CTX_LEN, slots=SLOTS, device="cuda", seed=SEED
    )
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.kv_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}: {n_params / 1e9:.3f} B parameters drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    lens = np.random.default_rng(SEED).integers(
        PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=N_REQUESTS
    )
    reqs = launcher.random_requests(cfg.vocab, lens.tolist(), MAX_NEW, SEED)

    fa.launches = 0
    stats = launcher.serve(engine, reqs)
    launches = fa.launches

    done = stats["done"]
    prefills = len(engine.prefill_s)
    if len(done) != N_REQUESTS or prefills != N_REQUESTS:
        raise AssertionError(f"{len(done)} of {N_REQUESTS} requests done, {prefills} prefills")
    for r in done:
        if len(r.output) != MAX_NEW or not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"request {r.request_id}: output {r.output}")
    if launches != cfg.n_layers * prefills:
        raise AssertionError(
            f"flash_attention launched {launches} times in the run, "
            f"want {cfg.n_layers} x {prefills} prefills"
        )
    pre = ", ".join(f"{n}:{ms:.1f}" for n, ms in zip(lens.tolist(), stats["prefill_ms"]))
    log(f"[serve] {len(done)} requests, {stats['tokens']} tokens in {stats['wall_s']:.2f} s; "
        f"flash_attention launches {launches} = {cfg.n_layers} x {prefills} prefills")
    log(f"[serve] prefill ms per prompt (tokens:ms, host clock to the first token): {pre}")
    log(f"[serve] decode {stats['decode_tokens']} tokens at {stats['decode_tok_s']:.1f} tok/s "
        f"over {SLOTS} slots; peak device memory {stats['peak_mem_gb']:.2f} GB")
    for r in done[:2]:
        log(f"[serve]   req{r.request_id} ({len(r.prompt)} prompt tokens): {r.output[:8]} ...")
    profile(engine)
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "prefills": prefills}


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


def check_logits_against_cpu() -> None:
    """Prefill logits of a two-layer glm4-9b at full width on the card
    against the same weights on the CPU, where the model runs the kernels'
    plain versions. bf16 products accumulate in another order on the two
    devices and round the hidden states at other places, so the logits are
    held at 5e-2 absolute + relative (about 4 bf16 ulps at |logit| ~ 3)."""
    from repro_torch.core import analysis
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_arch(ARCH), n_layers=2)
    plan = analysis.build_plan(cfg, None, n_groups=2)
    gpu = Model(cfg, plan, device="cuda", seed=SEED)
    cpu = Model(cfg, plan, device="cpu",
                params={k: v.cpu() for k, v in gpu.state_dict().items()})
    tokens = np.random.default_rng(SEED + 1).integers(0, cfg.vocab, size=(1, 96))
    got, _ = gpu.prefill(torch.as_tensor(tokens, device="cuda"))
    want, _ = cpu.prefill(torch.as_tensor(tokens))
    got, want = got.float().cpu()[..., : cfg.vocab], want.float()[..., : cfg.vocab]
    if got.shape != (1, cfg.vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)}, finite={bool(torch.isfinite(got).all())}")
    diff = (got - want).abs()
    bad = diff > 5e-2 + 5e-2 * want.abs()
    log(f"[check] 2-layer full-width prefill logits, card vs CPU: max |err| "
        f"{float(diff.max()):.3e}, |logit| max {float(want.abs().max()):.2f}, "
        f"argmax {int(got.argmax())} vs {int(want.argmax())}")
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} logits beyond 5e-2 of the CPU's")
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
    kernels = [check_flash_attention()]
    counts = serve_full_width()
    kernels[0]["launches"] = counts["launches"]
    check_logits_against_cpu()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
