"""Batched serving engine: prefill + decode with continuous batching.

Port of ``repro.serve.engine``.  A fixed pool of ``max_batch`` decode
slots; requests prefill individually (cache written into their slot)
and decode advances all active slots in one step per token.  Finished
slots (EOS or budget) are freed and backfilled from the queue — the
standard continuous-batching discipline, with a static-shape slot pool.

The decode cache is allocated once at (max_batch, max_len) on the
model's device; prefill writes a prefix, decode appends in place.
``ServeConfig.admission`` picks the admission rule:

``"per_slot"`` (the default)  any prompt shorter than ``max_len`` takes
    a free slot; every slot keeps its own position, and a decode step
    passes the slots' positions as a (max_batch,) tensor (one upload
    with the tokens), so each row rotates, writes and attends at its
    own.  An empty slot decodes token 0 at position 0, a write the next
    admission's prefill overwrites.
``"lockstep"``  the reference's rule: a request joins an occupied pool
    only if its prompt is as long as the pool's shared position, and a
    step passes that one position as an int; empty slots decode token 0
    there.  The tests that hold the engine to the reference's use it.

A decode step runs the whole pool: in an MoE LM the empty rows take
expert capacity like any other, in slot order.

Beside the reference's bookkeeping the engine counts its prefills and
decode steps and the host seconds each took, the requests it admitted,
the submissions it refused for want of a free slot, and ``slot_steps``,
the live slots summed over decode steps (``timings()``): prefills and
steps end in a read of the sampled tokens, so the seconds cover the
device work.  While ``torch.profiler`` records, the engine records its
spans (``ops.spans``)::

    engine.submit          one admission (refused ones end at once)
      engine.prefill         the prompt's upload and the model's prefill
      engine.sample          sampling the first token and its read-back
      engine.cache_write     the prefill's cache copied into the slot
    engine.step            one decode step over the pool: the tokens'
                           (and positions') upload, then
      engine.decode          the model's decode step
      engine.sample          sampling and the tokens' read-back
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.ops import spans
from repro_torch.serve.slots import SlotPool

ADMISSIONS = ("per_slot", "lockstep")


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    max_new_tokens: int = 64
    eos_id: int = -1                 # -1: never stops early
    temperature: float = 0.0         # 0 → greedy
    admission: str = "per_slot"      # per_slot | lockstep (the reference's)


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
        if cfg.admission not in ADMISSIONS:
            raise ValueError(f"admission {cfg.admission!r}: one of "
                             f"{ADMISSIONS}")
        super().__init__(cfg.max_batch)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.cache = model.init_cache(cfg.max_batch, cfg.max_len)
        self.pos = [0] * cfg.max_batch                  # next write slot
        self.generator = generator if generator is not None \
            else torch.Generator(device=model.device).manual_seed(0)
        self._timings = {"prefills": 0, "prefill_s": 0.0,
                         "decode_steps": 0, "decode_s": 0.0,
                         "admitted": 0, "refused_no_slot": 0,
                         "slot_steps": 0}

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
        """Prefill ``req`` into a free slot; False when it must wait (no
        free slot, or in lockstep a prompt the pool's position does not
        match).  Per slot, a prompt that can never fit ``max_len``
        raises ``ValueError``."""
        with spans.span("engine.submit"):
            return self._submit(req)

    def _submit(self, req: Request) -> bool:
        plen = len(req.prompt)
        if self.cfg.admission == "per_slot" and plen >= self.cfg.max_len:
            raise ValueError(f"a prompt of {plen} tokens leaves no decode "
                             f"position below max_len {self.cfg.max_len}")
        slot = self._free_slot()
        if slot is None:
            self._timings["refused_no_slot"] += 1
            return False
        if self.cfg.admission == "lockstep":
            # the pool shares one position counter per decode step, so a
            # request can only join an occupied pool if its prompt
            # length matches the pool's current position (otherwise it
            # waits for the next wave)
            occupied = [self.pos[i] for i, r in enumerate(self.active)
                        if r is not None]
            if occupied and plen != int(min(occupied)):
                return False
        t0 = time.perf_counter()
        with spans.span("engine.prefill"):
            batch = {"tokens": torch.tensor([list(req.prompt)],
                                            dtype=torch.int64,
                                            device=self.model.device)}
            logits, cache_one = self.model.prefill(self.params, batch)
        with spans.span("engine.sample"):
            tok = int(self._sample(logits)[0])
        req.out_tokens.append(tok)
        with spans.span("engine.cache_write"):
            self._write_slot_cache(slot, cache_one, plen)
        self._timings["prefills"] += 1
        self._timings["admitted"] += 1
        self._timings["prefill_s"] += time.perf_counter() - t0
        self.pos[slot] = plen
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
        with spans.span("engine.step"):
            self._step(live)

    def _inputs(self, live):
        """The step's tokens (max_batch, 1) and position on the model's
        device: per slot, one upload of the tokens beside each slot's
        position (an empty slot's token 0 at 0); in lockstep, the
        tokens and the pool's shared position, an int."""
        toks = [0] * self.cfg.max_batch
        for i, r in live:
            toks[i] = r.out_tokens[-1]
        dev = self.model.device
        if self.cfg.admission == "lockstep":
            # all slots share one step; every slot writes at the shared
            # position (lockstep admission keeps the live ones equal)
            pos = int(max(self.pos[i] for i, _ in live))
            return torch.tensor(toks, dtype=torch.int64)[:, None] \
                .to(dev), pos
        pos = [0] * self.cfg.max_batch
        for i, _ in live:
            pos[i] = self.pos[i]
        both = torch.tensor([toks, pos], dtype=torch.int64).to(dev)
        return both[0][:, None], both[1]

    def _step(self, live):
        t0 = time.perf_counter()
        # the upload ends (the host waits for a pageable copy) just
        # before ``engine.decode`` starts: a trace reader anchors there
        toks, pos = self._inputs(live)
        with spans.span("engine.decode"):
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, toks, pos)
        with spans.span("engine.sample"):
            nxt = self._sample(logits).tolist()
        self._timings["decode_steps"] += 1
        self._timings["slot_steps"] += len(live)
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
        """Prefills and decode steps run and the host seconds each kind
        took in all; requests admitted, submissions refused for want of
        a free slot, and the live slots summed over decode steps."""
        return dict(self._timings)

    # run() is inherited from SlotPool: heap-ordered queue backfill +
    # step until both the queue and the slot pool are empty.
