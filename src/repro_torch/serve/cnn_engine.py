"""Plan-driven CNN inference engine: dynamic batching over fixed slots,
executing through ``repro_torch.runtime.CompiledCNN``.

Port of ``repro.serve.cnn_engine``.  A fixed pool of ``max_batch`` image
slots fills from the request queue; each tick gathers only the live
images and hands them to the compiled backend, which dispatches to the
smallest prepared batch bucket ≥ the live count.  A tick ends by copying
the output to the host, which waits for the device, so a request is
resolved only once its result has been computed.

Construction is plan-driven: ``CNNEngine.from_plan`` takes a
``DeploymentPlan`` — typically one loaded from a JSON artifact — and
serves exactly the per-layer (block, data_bits, coeff_bits) assignment
the planner chose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.blocks import BlockLike
from repro_torch.core.cnn import CNNConfig
from repro_torch.device import DeviceLike
from repro_torch.runtime.compiled import (CompiledCNN, CompiledModel,
                                          dtype_name)
from repro_torch.serve.slots import SlotPool


@dataclass
class CNNServeConfig:
    max_batch: int = 8             # slot-pool size = top batch bucket
    aot_warmup: bool = True        # prepare all buckets at init


@dataclass
class ImageRequest:
    """One request payload: an (H, W, C) quantized container-int image,
    validated by the engine's compiled backend at admission."""
    image: np.ndarray
    request_id: int = 0
    priority: int = 0              # higher = more urgent (policy="edf")
    deadline: Optional[float] = None   # absolute engine-clock deadline
    output: Optional[np.ndarray] = None
    done: bool = False


class CNNEngine(SlotPool):
    def __init__(self, cfg: Optional[CNNConfig] = None, params=None,
                 blocks: Optional[Sequence[BlockLike]] = None,
                 serve_cfg: Optional[CNNServeConfig] = None, mesh=None, *,
                 compiled: Optional[CompiledModel] = None,
                 exec_cache=None, device: DeviceLike = "cuda"):
        serve_cfg = serve_cfg if serve_cfg is not None else CNNServeConfig()
        super().__init__(serve_cfg.max_batch)
        if compiled is None:
            compiled = CompiledCNN(cfg, params, blocks,
                                   max_batch=serve_cfg.max_batch,
                                   device=device, mesh=mesh,
                                   warmup=serve_cfg.aot_warmup,
                                   exec_cache=exec_cache)
        elif compiled.max_batch < serve_cfg.max_batch:
            raise ValueError(
                f"compiled max_batch={compiled.max_batch} smaller than the "
                f"slot pool ({serve_cfg.max_batch}): a full pool could "
                f"never dispatch")
        self.compiled = compiled
        self.cfg = getattr(compiled, "cfg", None)
        self.params = getattr(compiled, "params", None)
        self.blocks = getattr(compiled, "blocks", None)
        self.serve = serve_cfg
        self.mesh = getattr(compiled, "mesh", None)
        self.device = compiled.device
        self.in_shape = compiled.in_shape
        self.in_dtype = compiled.in_dtype
        self._np_dtype = np.dtype(dtype_name(compiled.in_dtype))
        self.images_served = 0

    # -- construction from a deployment plan ----------------------------
    @classmethod
    def from_plan(cls, plan, cfg: Optional[CNNConfig] = None, *,
                  params=None, generator: Optional[torch.Generator] = None,
                  serve_cfg: Optional[CNNServeConfig] = None, mesh=None,
                  exec_cache=None, device: DeviceLike = "cuda"
                  ) -> "CNNEngine":
        """Engine for a planned deployment: the plan's ``WorkloadSpec``
        builds the compiled backend (``runtime.compile_plan``).  ``cfg``
        overrides the network embedded in the plan; ``params`` default
        to a seeded draw at the planned precisions.  ``mesh`` (a
        ``parallel.sharding.CNNDataMesh``) shards each bucket's batch
        over its devices (CNN plans)."""
        serve_cfg = serve_cfg if serve_cfg is not None else CNNServeConfig()
        if serve_cfg.max_batch < 1:       # fail before preparing anything
            raise ValueError(f"max_batch={serve_cfg.max_batch} must be ≥ 1")
        if cfg is not None:
            compiled = CompiledCNN.from_plan(
                plan, cfg, params=params, generator=generator,
                max_batch=serve_cfg.max_batch, device=device, mesh=mesh,
                warmup=serve_cfg.aot_warmup, exec_cache=exec_cache)
        else:
            from repro_torch.runtime.workloads import compile_plan
            compiled = compile_plan(
                plan, params=params, generator=generator,
                max_batch=serve_cfg.max_batch, device=device, mesh=mesh,
                warmup=serve_cfg.aot_warmup, exec_cache=exec_cache)
        return cls(serve_cfg=serve_cfg, compiled=compiled)

    # -- admission -------------------------------------------------------
    def submit(self, req: ImageRequest) -> bool:
        """Place a request into a free slot; False when the pool is full
        (the request waits in the caller's queue for the next step).
        Shape and container range are validated by the compiled
        backend's ``validate_input``."""
        self.compiled.validate_input(req.image, req.request_id)
        slot = self._free_slot()
        if slot is None:
            return False
        self.active[slot] = req
        return True

    # -- one engine tick: run every occupied slot through the CNN --------
    def step(self) -> int:
        """One bucketed forward over the live slots; returns how many
        images were served.  Copying the result to the host waits for
        the device before any request is marked done."""
        live = self.live()
        if not live:
            return 0
        batch = torch.from_numpy(np.stack(
            [np.asarray(r.image, self._np_dtype) for _, r in live]))
        out = self.compiled(batch).cpu().numpy()
        for k, (i, r) in enumerate(live):
            r.output = out[k]
            r.done = True
            self.release(i)
        self._note_step(len(live))
        self.images_served += len(live)
        return len(live)

    def stats(self) -> dict:
        """Serving counters plus occupancy/bucket telemetry, from one
        ``SlotPool.snapshot()`` capture."""
        snap = self.snapshot(served=self.images_served)
        return {
            "images_served": snap.served,
            "steps": snap.steps,
            "images_per_step": snap.served / max(snap.steps, 1),
            "max_batch": snap.max_batch,
            "occupancy_hist": dict(snap.occupancy_hist),
            "bucket_hits": dict(self.compiled.bucket_hits),
            "aot_warmed_up": self.compiled.warmed_up,
        }
