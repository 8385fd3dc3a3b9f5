"""Batched serving engine: prefill + decode over the port's Model.

Continuous-batching-lite, as the reference: a request queue is packed into
fixed decode slots; finished sequences release their slot, the next prefill
fills it. One batched decode step serves every slot each tick, idle ones
included, as the reference's does: in an MoE model their tokens take
expert capacity too. The decode
cache is updated in place, where the reference donates it to its jitted step.
Prefill and decode run under ``torch.inference_mode()``: nothing here is
differentiated, and leaving autograd's bookkeeping out of every operator
shortens the host's work per step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 16
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeConfig:
    slots: int = 4  # concurrent decode slots
    ctx_len: int = 256  # max context per slot


class Engine:
    """Serves requests on ``device`` (CUDA unless the caller asks for the
    CPU), with weights ``params`` (the port's state dict) or drawn from
    ``seed``. Host wall times of every prefill and of the decode steps are
    kept in ``prefill_s``, ``decode_s`` and ``decode_tokens``; each ends on
    a read of the result, so they include the device's work. ``decode_steps``
    counts the batched decode steps run."""

    def __init__(
        self,
        cfg: ArchConfig,
        plan: ExecutionPlan,
        params: Optional[Dict[str, torch.Tensor]] = None,
        scfg: ServeConfig = ServeConfig(),
        *,
        device="cuda",
        seed: int = 0,
    ):
        if cfg.encoder_only:
            raise ValueError("no autoregressive serving for encoders")
        self.cfg = cfg
        self.scfg = scfg
        self.model = Model(cfg, plan, device=device, params=params, seed=seed)
        self.device = self.model.device
        self.cache = None
        self.positions = np.zeros((scfg.slots,), np.int64)
        self.last_token = np.zeros((scfg.slots,), np.int64)
        self.slot_req: List[Optional[Request]] = [None] * scfg.slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.prefill_s: List[float] = []
        self.decode_s = 0.0
        self.decode_tokens = 0
        self.decode_steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    @torch.inference_mode()
    def _prefill_one(self, slot: int, req: Request):
        """Single-sequence prefill into the slot's cache rows."""
        t0 = time.perf_counter()
        prompt = torch.as_tensor(req.prompt[None, :], dtype=torch.long, device=self.device)
        logits, cache1 = self.model.prefill(prompt, ctx_len=self.scfg.ctx_len)
        tok = int(torch.argmax(logits[0, : self.cfg.vocab]))
        if self.cache is None:
            self.cache = self.model.init_cache(self.scfg.slots, self.scfg.ctx_len)
        # Axis 1 is the batch axis of every stacked leaf, k/v and SSD alike.
        for g, kv in cache1.items():
            for key, t in kv.items():
                self.cache[g][key][:, slot] = t[:, 0]
        self.slot_req[slot] = req
        self.positions[slot] = len(req.prompt)
        self.last_token[slot] = tok
        req.output.append(tok)
        self.prefill_s.append(time.perf_counter() - t0)

    def _fill_slots(self):
        for slot in range(self.scfg.slots):
            if self.slot_req[slot] is None and self.queue:
                self._prefill_one(slot, self.queue.pop(0))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """One engine tick: fill free slots, run one batched decode step.
        Returns number of active slots served."""
        self._fill_slots()
        active = [s for s in range(self.scfg.slots) if self.slot_req[s]]
        if not active:
            return 0
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self.last_token[:, None], device=self.device)
        positions = torch.as_tensor(self.positions[:, None], device=self.device)
        logits, self.cache = self.model.decode_step(self.cache, tokens, positions)
        nxt = torch.argmax(logits[:, : self.cfg.vocab], dim=-1).cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.decode_tokens += len(active)
        self.decode_steps += 1
        for s in active:
            req = self.slot_req[s]
            req.output.append(int(nxt[s]))
            self.positions[s] += 1
            self.last_token[s] = nxt[s]
            hit_limit = len(req.output) >= req.max_new_tokens
            full = self.positions[s] >= self.scfg.ctx_len - 1
            if hit_limit or full:
                req.done = True
                self.finished.append(req)
                self.slot_req[s] = None
        return len(active)

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or any(self.slot_req)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
