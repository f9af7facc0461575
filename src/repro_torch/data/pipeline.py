"""Deterministic, restart-safe token pipeline.

Port of ``repro.data.pipeline``, kept numpy (the port imports nothing of
the reference): ``batch_at`` gives the reference's batches bit for bit.

Sources:
  * ``synthetic`` — Zipf-distributed tokens with injected n-gram structure
    (so a real model shows a falling loss curve), seeded by (seed, step) —
    any worker can regenerate any step, which is what makes restart and
    elastic rescaling deterministic with NO data-state checkpointing: the
    loader is a pure function of the step counter.
  * ``memmap``   — flat uint32 token file (numpy memmap), sharded by step
    offset; the same pure-function-of-step contract.

Packing: fixed-length windows with next-token labels; document boundaries
carry label -100 (masked out in the loss).  The host loader prefetches one
batch ahead of the device step (double buffering).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    source: str = "synthetic"        # synthetic | memmap
    path: Optional[str] = None       # for memmap
    seed: int = 0
    mean_doc_len: int = 512


def _synthetic_batch(cfg: DataConfig, step: int) -> np.ndarray:
    rng = np.random.default_rng((cfg.seed, step))
    b, s = cfg.global_batch, cfg.seq_len
    # Zipf body (clipped) + deterministic bigram structure
    toks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
    toks = np.clip(toks, 1, cfg.vocab_size - 1)
    # inject learnable structure: token t at even idx forces (t*7)%V next
    even = toks[:, 0:s:2]
    toks[:, 1:s + 1:2] = (even * 7 + 13) % cfg.vocab_size
    return toks.astype(np.int32)


def _memmap_batch(cfg: DataConfig, step: int, data: np.ndarray) -> np.ndarray:
    b, s = cfg.global_batch, cfg.seq_len
    need = b * (s + 1)
    start = (step * need) % max(len(data) - need, 1)
    return np.array(data[start:start + need]).reshape(b, s + 1) \
        .astype(np.int32)


def batch_at(cfg: DataConfig, step: int, data=None) -> dict:
    toks = _synthetic_batch(cfg, step) if cfg.source == "synthetic" \
        else _memmap_batch(cfg, step, data)
    rng = np.random.default_rng((cfg.seed, step, 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    # document boundaries: mask a few label positions
    n_bound = max(1, cfg.seq_len // cfg.mean_doc_len)
    cols = rng.integers(0, cfg.seq_len, size=(cfg.global_batch, n_bound))
    rows = np.arange(cfg.global_batch)[:, None]
    batch["labels"][rows, cols] = -100
    return batch


def make_pipeline(cfg: DataConfig, start_step: int = 0,
                  prefetch: int = 2) -> Iterator[dict]:
    """Background-prefetching iterator, resumable at any step."""
    data = None
    if cfg.source == "memmap":
        data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
    q: Queue = Queue(maxsize=prefetch)

    def worker():
        step = start_step
        while True:
            q.put((step, batch_at(cfg, step, data)))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def gen():
        while True:
            _, b = q.get()
            yield b

    return gen()
