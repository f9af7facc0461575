"""Batched serving engine: prefill + decode with continuous batching.

Port of ``repro.serve.engine``.  A fixed pool of ``max_batch`` decode
slots; requests prefill individually (cache written into their slot)
and decode advances all active slots in one step per token.  Finished
slots (EOS or budget) are freed and backfilled from the queue — the
standard continuous-batching discipline, with a static-shape slot pool.

The decode cache is allocated once at (max_batch, max_len) on the
model's device; prefill writes a prefix, decode appends in place.
Admission is lockstep, as the reference's: every occupied slot shares
one write position per step.  A decode step runs the whole pool: empty
slots feed token 0, as the reference's do, and in an MoE LM those rows
take expert capacity like any other, in slot order.

Beside the reference's bookkeeping the engine counts its prefills and
decode steps and the host seconds each took (``timings()``): both end
in a read of the sampled tokens, so the seconds cover the device work.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.serve.slots import SlotPool


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    max_new_tokens: int = 64
    eos_id: int = -1                 # -1: never stops early
    temperature: float = 0.0         # 0 → greedy


@dataclass
class Request:
    prompt: List[int]
    request_id: int = 0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class Engine(SlotPool):
    """``generator`` draws the samples when ``temperature > 0``; by
    default a generator on the model's device seeded with 0."""

    def __init__(self, model, params, cfg: ServeConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg.max_batch)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.cache = model.init_cache(cfg.max_batch, cfg.max_len)
        self.pos = [0] * cfg.max_batch                  # next write slot
        self.generator = generator if generator is not None \
            else torch.Generator(device=model.device).manual_seed(0)
        self._timings = {"prefills": 0, "prefill_s": 0.0,
                         "decode_steps": 0, "decode_s": 0.0}

    # -- slot management (pool bookkeeping lives in SlotPool) ------------
    def _write_slot_cache(self, slot: int, cache_one, plen: int):
        """Copy a single-request prefill cache into the pool cache: its
        prefix at [0, plen) of the slot, zeros after it, as the
        reference pads the update to max_len."""
        for key, entry in cache_one.items():
            for name, one in entry.items():
                pool = self.cache[key][name]
                if not (pool.ndim >= 3 and one.ndim == pool.ndim
                        and pool.shape[1] == self.cfg.max_batch):
                    continue
                upd = one.to(pool.dtype)
                if upd.shape[2] == plen and pool.shape[2] == self.cfg.max_len:
                    pool[:, slot, :plen] = upd[:, 0]
                    pool[:, slot, plen:] = 0
                else:
                    pool[:, slot] = upd[:, 0]

    def submit(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        # lockstep admission: the pool shares one position counter per
        # decode step, so a request can only join an occupied pool if its
        # prompt length matches the pool's current position (otherwise it
        # waits for the next wave).  Per-slot positions are future work.
        occupied = [self.pos[i] for i, r in enumerate(self.active)
                    if r is not None]
        if occupied and len(req.prompt) != int(min(occupied)):
            return False
        t0 = time.perf_counter()
        batch = {"tokens": torch.tensor([list(req.prompt)], dtype=torch.int64,
                                        device=self.model.device)}
        logits, cache_one = self.model.prefill(self.params, batch)
        tok = self._sample(logits)
        req.out_tokens.append(int(tok[0]))
        self._write_slot_cache(slot, cache_one, len(req.prompt))
        self._timings["prefills"] += 1
        self._timings["prefill_s"] += time.perf_counter() - t0
        self.pos[slot] = len(req.prompt)
        self.active[slot] = req
        return True

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.cfg.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    # -- one engine tick: advance every active slot by one token ----------
    def step(self):
        live = self.live()
        if not live:
            return
        t0 = time.perf_counter()
        toks = torch.zeros((self.cfg.max_batch, 1), dtype=torch.int64)
        for i, r in live:
            toks[i, 0] = r.out_tokens[-1]
        # all slots share one step; every slot writes at the shared
        # position (lockstep admission keeps the live ones equal)
        pos = int(max(self.pos[i] for i, _ in live))
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, toks.to(self.model.device), pos)
        nxt = self._sample(logits).tolist()
        self._timings["decode_steps"] += 1
        self._timings["decode_s"] += time.perf_counter() - t0
        for i, r in live:
            t = int(nxt[i])
            r.out_tokens.append(t)
            self.pos[i] += 1
            if (t == self.cfg.eos_id
                    or len(r.out_tokens) >= self.cfg.max_new_tokens
                    or self.pos[i] >= self.cfg.max_len - 1):
                r.done = True
                self.active[i] = None
        self._note_step(len(live))

    def timings(self) -> Dict[str, float]:
        """Prefills and decode steps run, and the host seconds each
        kind took in all."""
        return dict(self._timings)

    # run() is inherited from SlotPool: heap-ordered queue backfill +
    # step until both the queue and the slot pool are empty.
