"""Serving launcher: batched requests against the port's model on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --full-width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --full-width

Without ``--full-width`` the architecture is cut to its reduced smoke size,
as the reference launcher always does; with it the model has its published
widths and depth, and ``--ctx-len`` sets the context per slot. Weights are
drawn on the device from ``--seed``. ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core import analysis
from repro_torch.kernels import flash_attention, gather_rows, ssd
from repro_torch.serve.engine import Engine, Request, ServeConfig

KERNELS = {"flash_attention": flash_attention, "gather_rows": gather_rows, "ssd_scan": ssd}

REDUCED_CTX_LEN = 128


def build_engine(
    arch: str,
    *,
    full_width: bool = False,
    ctx_len: int = 4096,
    slots: int = 4,
    device="cuda",
    seed: int = 0,
) -> Engine:
    cfg = get_arch(arch)
    if not full_width:
        cfg, ctx_len = cfg.reduced(), REDUCED_CTX_LEN
    plan = analysis.build_plan(cfg, None, n_groups=2)
    return Engine(
        cfg, plan, scfg=ServeConfig(slots=slots, ctx_len=ctx_len),
        device=device, seed=seed,
    )


def serve(engine: Engine, requests: Sequence[Request]) -> Dict[str, object]:
    """Run every request to completion; returns what the run measured,
    with each CUDA kernel's launches during the run (0 on the CPU, where
    the kernels' plain versions run). Peak device memory is read only on a
    CUDA device."""
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(engine.device)
    before = {name: mod.launches for name, mod in KERNELS.items()}
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(r)
    done = engine.run_until_done()
    wall = time.perf_counter() - t0
    return {
        "launches": {name: mod.launches - before[name] for name, mod in KERNELS.items()},
        "requests": len(done),
        "tokens": sum(len(r.output) for r in done),
        "wall_s": wall,
        "prefill_ms": [1e3 * s for s in engine.prefill_s],
        "decode_tokens": engine.decode_tokens,
        "decode_steps": engine.decode_steps,
        "decode_tok_s": engine.decode_tokens / engine.decode_s if engine.decode_s else 0.0,
        "peak_mem_gb": torch.cuda.max_memory_allocated(engine.device) / 1e9 if cuda else None,
        "done": done,
    }


def random_requests(
    vocab: int, prompt_lens: Sequence[int], max_new: int, seed: int
) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [
        Request(
            request_id=i,
            prompt=rng.integers(0, vocab, size=n).astype(np.int32),
            max_new_tokens=max_new,
        )
        for i, n in enumerate(prompt_lens)
    ]


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="published widths and depth instead of the reduced config")
    ap.add_argument("--ctx-len", type=int, default=4096,
                    help="context per slot (with --full-width)")
    args = ap.parse_args(argv)

    engine = build_engine(
        args.arch, full_width=args.full_width, ctx_len=args.ctx_len,
        slots=args.slots, device=args.device, seed=args.seed,
    )
    reqs = random_requests(
        engine.cfg.vocab, [args.prompt_len] * args.requests, args.max_new, args.seed
    )
    stats = serve(engine, reqs)
    print(
        f"[serve] {engine.cfg.name} on {engine.device}: {stats['requests']} requests, "
        f"{stats['tokens']} tokens in {stats['wall_s']:.2f}s "
        f"(decode {stats['decode_tok_s']:.1f} tok/s, slots={args.slots})"
    )
    print("  kernel launches: " + ", ".join(f"{k} {n}" for k, n in stats["launches"].items()))
    for r in stats["done"][:4]:
        print(f"  req{r.request_id}: {r.output}")
    return stats


if __name__ == "__main__":
    main()
