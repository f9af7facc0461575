"""Fault-tolerant training loop.

Port of ``repro.train.loop``:
  * checkpoint/restart — periodic atomic checkpoints; on (re)start the loop
    restores the newest committed step and the data pipeline resumes from
    it deterministically (a batch is a pure function of the step index);
  * preemption safety — KeyboardInterrupt, or the RuntimeError that
    ``fail_at_step`` raises to simulate a preemption, writes a checkpoint
    of the steps done before it propagates;
  * straggler visibility — a per-step wall-time ring buffer with
    p50/p95/max published every log interval.

Each step's time runs until its loss is on the host, so it covers the
device's work.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.data import DataConfig
from repro_torch.data.pipeline import batch_at
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.step import make_train_step


@dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    microbatches: int = 1
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    fail_at_step: Optional[int] = None   # test hook: simulated preemption


class StepTimer:
    def __init__(self, window: int = 100):
        self.times = []
        self.window = window

    def add(self, dt: float):
        self.times.append(dt)
        self.times = self.times[-self.window:]

    def stats(self):
        if not self.times:
            return {}
        a = np.array(self.times)
        return {"p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "max_ms": float(np.max(a) * 1e3)}


def train(model, data_cfg: DataConfig, tcfg: TrainConfig,
          *, params=None, log: Callable = print):
    """Runs (or resumes) training on ``model``'s device; returns (params,
    opt_state, history).  Without ``params`` it draws them from
    ``torch.Generator(device).manual_seed(0)``."""
    ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
    step_fn = make_train_step(model, tcfg.opt, lr=tcfg.lr,
                              microbatches=tcfg.microbatches)

    if params is None:
        params = model.init(torch.Generator(model.device).manual_seed(0))
    opt_state = adamw_init(params, tcfg.opt)
    start = 0

    latest = ckpt.latest_step()
    if latest is not None:
        start, state = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        log(f"[train] resumed from step {start}")

    timer = StepTimer()
    history = []
    step = start
    try:
        for step in range(start, tcfg.steps):
            if tcfg.fail_at_step is not None and step == tcfg.fail_at_step:
                raise RuntimeError(f"simulated preemption at step {step}")
            batch = batch_at(data_cfg, step)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics["loss"].item()               # wait for the device
            timer.add(time.time() - t0)
            if (step + 1) % tcfg.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(timer.stats())
                history.append({"step": step + 1, **m})
                log(f"[train] step {step + 1}: loss={m['loss']:.4f} "
                    f"p50={m.get('p50_ms', 0):.0f}ms "
                    f"p95={m.get('p95_ms', 0):.0f}ms")
            if (step + 1) % tcfg.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
    except (KeyboardInterrupt, RuntimeError):
        # preemption path: commit progress before propagating
        ckpt.save(step, {"params": params, "opt": opt_state})
        raise
    ckpt.save(tcfg.steps, {"params": params, "opt": opt_state})
    return params, opt_state, history
