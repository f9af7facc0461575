"""``CompiledModel``: batch-bucketed prepared launches for a planned
workload — with ``CompiledCNN`` as the convolution backend.

Port of ``repro.runtime.compiled``.  The reference AOT-compiles one XLA
executable per (layer, bucket) over a power-of-two bucket ladder and
dispatches a batch to the smallest bucket that holds it, padding with
zero images that are sliced off.  PyTorch runs eagerly, so here the
"executable" is a prepared launch: a ``LayerLaunch`` that fixes the
layer's block, bits and input shape, and whose preparation builds the
CUDA kernels (the port's compile step, off the serving path).  It is
cached under the reference's key tuple, with the torch device in place
of the mesh.  Like the reference's executables it takes the layer's
weights per call — they live on the device from construction — so a
shared ``ExecutableCache`` never mixes two plans' weights.

Kept from the reference: the bucket ladder, padding to the bucket and
slicing off, chunking above ``max_batch``, ``should_abort`` polled
between layers, the single-flight cache with its ``on_event`` seam and
its ``_produce`` seam (where ``ops.PersistentExecutableCache`` adds a
disk tier of ``LayerLaunch`` records), and the telemetry of
``stats()``.  Outputs are bit-exact against ``cnn_forward_ref`` at
every batch size.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.blocks import BlockLike, ConvBlock, get_block
from repro_torch.core.cnn import CNNConfig, ConvLayerSpec, init_cnn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build, conv2d
from repro_torch.ops import spans


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.int8`` → ``"int8"``, as numpy names it in messages."""
    return str(dtype).removeprefix("torch.")


class DispatchAborted(RuntimeError):
    """A bucketed dispatch was abandoned mid-flight: every request it
    was serving has been cancelled.  Raised by ``CompiledModel.__call__``
    when its ``should_abort`` callback returns True between layers."""


class ExecutableCache:
    """Shareable ``(layer spec, bucket) → prepared launch`` map.

    Keys carry the full layer identity — for a CNN layer (block, bits,
    shift, channels, geometry, device, bucket) — so two plans whose
    layers coincide share one preparation per (layer, bucket).

    Thread-safe and **single-flight**: lookups/inserts take a lock,
    production runs outside it, and a key already being produced by
    another thread is waited on, never produced twice (``coalesced``
    counts those waits).  ``on_event`` (``callable(event, fields)``)
    receives the rare cache transitions — compiles — never per-dispatch
    hits.  ``kernel_dir`` is the directory a card's preparation builds
    and loads the kernel libraries from (None: ``build.BUILD_DIR``).
    """

    kernel_dir: Optional[Path] = None

    def __init__(self, *, on_event: Optional[Callable[[str, dict],
                                                      None]] = None):
        self._execs: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._building: set = set()    # keys with a production in flight
        self.compiles = 0              # builds that entered the cache
        self.hits = 0                  # lookups served without building
        self.coalesced = 0             # waits piggybacked on another build
        self.on_event = on_event

    def __len__(self) -> int:
        with self._lock:
            return len(self._execs)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._execs

    def _emit(self, event: str, **fields) -> None:
        """Report a rare cache transition to ``on_event``.  A
        misbehaving observer must never break serving."""
        cb = self.on_event
        if cb is None:
            return
        try:
            cb(event, fields)
        except Exception:              # noqa: BLE001 — observer only
            pass

    def _produce(self, key: tuple, build: Callable[[], object]
                 ) -> Tuple[object, bool]:
        """Produce the executable for a missing ``key`` — called
        outside the lock, single-flighted per key.  Returns
        ``(executable, compiled)`` where ``compiled`` says ``build()``
        actually ran (a disk tier returns False for a load)."""
        t0 = time.perf_counter()
        exe = build()
        self._emit("cache_compile", key=repr(key)[:160],
                   seconds=time.perf_counter() - t0)
        return exe, True

    def get_or_build(self, key: tuple, build: Callable[[], object]):
        with self._cond:
            while True:
                exe = self._execs.get(key)
                if exe is not None:
                    self.hits += 1
                    return exe
                if key not in self._building:
                    self._building.add(key)
                    break
                # another thread is producing this very key: wait for it
                self.coalesced += 1
                self._cond.wait()
        try:
            exe, compiled = self._produce(key, build)   # outside the lock
        except BaseException:
            with self._cond:
                # failed production frees the key: a parked waiter (or
                # the next caller) becomes the new producer and retries
                self._building.discard(key)
                self._cond.notify_all()
            raise
        with self._cond:
            self._building.discard(key)
            self._execs[key] = exe
            if compiled:
                self.compiles += 1
            self._cond.notify_all()
        return exe

    def stats(self) -> dict:
        with self._lock:
            return {"executables": len(self._execs),
                    "compiles": self.compiles, "hits": self.hits,
                    "coalesced": self.coalesced}


def bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two batch buckets up to ``max_batch`` (which is always
    the top rung, even when it is not itself a power of two)."""
    if max_batch < 1:
        raise ValueError(f"max_batch={max_batch} must be ≥ 1")
    rungs = []
    b = 1
    while b < max_batch:
        rungs.append(b)
        b <<= 1
    rungs.append(max_batch)
    return tuple(rungs)


def validate_container_input(x, in_shape, in_dtype: torch.dtype,
                             request_id=0, *, noun: str = "input"
                             ) -> np.ndarray:
    """Shape + dtype admission check for integer-container workloads
    (the CNN input contract).  A float array must carry exact
    container-range integers, and no value may wrap in the container."""
    x = np.asarray(x)
    if tuple(x.shape) != tuple(in_shape):
        raise ValueError(
            f"request {request_id}: {noun} shape {tuple(x.shape)} "
            f"!= engine input {tuple(in_shape)}")
    if not np.issubdtype(x.dtype, np.integer):
        if not np.all(np.isfinite(x)) or np.any(x != np.round(x)):
            raise ValueError(
                f"request {request_id}: {noun} dtype {x.dtype} "
                f"carries non-integral values — quantize explicitly "
                f"(e.g. ops.quantize_fixed) before submitting")
    info = torch.iinfo(in_dtype)
    if np.any(x < info.min) or np.any(x > info.max):
        raise ValueError(
            f"request {request_id}: {noun} values outside the "
            f"{dtype_name(in_dtype)} container range "
            f"[{info.min}, {info.max}] — would wrap, not clamp")
    return x


class CompiledModel:
    """Batch-bucketed executor for one planned workload.

    The generic machinery — bucket ladder, ``ExecutableCache``, warmup,
    smallest-bucket dispatch with padding, chunking above ``max_batch``,
    between-layer ``should_abort`` polling, telemetry — lives here.  A
    backend subclass supplies:

    ``num_layers``             how many sequential launches a forward is
    ``in_shape``/``in_dtype``  the per-request input contract
    ``input_noun``             what a request payload is called in errors
    ``device``                 where the layers run
    ``_layer_key(i, bucket)``  the full-identity cache key (incl. device)
    ``_prepare_layer(i, b)``   the ``(params, x) -> y`` launch for a bucket
    ``_layer_params(i)``       the device-resident params passed per call
    ``_empty_output()``        the zero-batch result
    ``_place_batch``/``_gather_batch``  optional placement of a padded
                               bucket and the gathering of its output
    ``sample_inputs(k)``       canonical request generator
    ``validate_input(x)``      per-workload admission check
    """

    kind = "model"
    input_noun = "input"

    # subclass contract: set before delegating to ``__init__``
    num_layers: int
    in_shape: Tuple[int, ...]
    in_dtype: torch.dtype
    device: torch.device

    def __init__(self, *, max_batch: int = 16, warmup: bool = True,
                 exec_cache: Optional[ExecutableCache] = None):
        self.max_batch = max_batch
        self.buckets = bucket_ladder(max_batch)
        self.cache = exec_cache if exec_cache is not None \
            else ExecutableCache()
        self.compiles = 0              # preparations this instance made
        self.bucket_hits: Dict[int, int] = {b: 0 for b in self.buckets}
        self.calls = 0
        self._stats_lock = threading.Lock()
        if warmup:
            self.warmup()

    # -- backend hooks ----------------------------------------------------
    def _layer_key(self, i: int, bucket: int) -> tuple:
        raise NotImplementedError

    def _prepare_layer(self, i: int, bucket: int):
        raise NotImplementedError

    def _layer_params(self, i: int):
        raise NotImplementedError

    def _empty_output(self):
        raise NotImplementedError

    def _place_batch(self, xb, bucket: int):
        """Optional pre-dispatch placement of a padded bucket (mesh
        sharding); the identity here."""
        return xb

    def _gather_batch(self, act, bucket: int):
        """The bucket's output on ``device`` from whatever the last
        launch returned; the identity here."""
        return act

    def sample_inputs(self, k: int, seed: int = 0):
        """``k`` random requests matching this executor's input
        contract — the canonical workload generator."""
        raise NotImplementedError

    def validate_input(self, x, request_id: int = 0) -> np.ndarray:
        """Admission check: shape (backends add their own contract)."""
        x = np.asarray(x)
        if tuple(x.shape) != tuple(self.in_shape):
            raise ValueError(
                f"request {request_id}: {self.input_noun} shape "
                f"{tuple(x.shape)} != engine input {tuple(self.in_shape)}")
        return x

    # -- preparation (the port's compile step) ----------------------------
    def _compile_layer(self, i: int, bucket: int):
        def produce():
            with self._stats_lock:
                self.compiles += 1
            return self._prepare_layer(i, bucket)

        return self.cache.get_or_build(self._layer_key(i, bucket), produce)

    def warmup(self) -> "CompiledModel":
        """Prepare every (layer, bucket) launch now, so no call pays a
        kernel build on the serving critical path."""
        for b in self.buckets:
            for i in range(self.num_layers):
                self._compile_layer(i, b)
        return self

    @property
    def warmed_up(self) -> bool:
        return all(self._layer_key(i, b) in self.cache
                   for b in self.buckets
                   for i in range(self.num_layers))

    # -- dispatch ----------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket ≥ n (n must be ≤ max_batch)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch {n} exceeds max_batch={self.max_batch}")

    def _run_bucket(self, xb: torch.Tensor, should_abort=None):
        """xb: (n, *in_shape) on the device, n ≤ max_batch →
        (n, *out_shape)."""
        n = xb.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            xb = torch.cat([xb, xb.new_zeros((bucket - n,) + xb.shape[1:])])
        act = self._place_batch(xb, bucket)
        with spans.span("runtime.layers"):
            for i in range(self.num_layers):
                if should_abort is not None and should_abort():
                    raise DispatchAborted(
                        f"dispatch abandoned before layer {i} "
                        f"(all served requests cancelled)")
                act = self._compile_layer(i, bucket)(self._layer_params(i),
                                                     act)
        with self._stats_lock:
            self.bucket_hits[bucket] += 1
        return self._gather_batch(act, bucket)[:n]

    def __call__(self, x, *, should_abort=None) -> torch.Tensor:
        """x: one ``in_shape`` request or an ``(N, *in_shape)`` batch
        (numpy or torch, on any device); the result is on ``device``.
        Batches larger than ``max_batch`` run in max_batch-sized chunks.
        ``should_abort`` (optional zero-arg callable) is polled between
        layers; returning True raises ``DispatchAborted``."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))     # a writable host copy
        single = x.ndim == len(self.in_shape)
        if single:
            x = x[None]
        if tuple(x.shape[1:]) != tuple(self.in_shape):
            raise ValueError(
                f"{self.input_noun} shape {tuple(x.shape[1:])} != "
                f"compiled input {tuple(self.in_shape)}")
        if x.dtype != self.in_dtype:
            raise ValueError(
                f"{self.input_noun} dtype {dtype_name(x.dtype)} != "
                f"compiled input {dtype_name(self.in_dtype)}")
        with self._stats_lock:
            self.calls += 1
        if x.shape[0] == 0:            # empty queue tick: nothing to run
            return self._empty_output()
        with spans.span("runtime.copy_in"):
            x = x.to(self.device)
        outs = [self._run_bucket(x[s:s + self.max_batch], should_abort)
                for s in range(0, x.shape[0], self.max_batch)]
        y = outs[0] if len(outs) == 1 else torch.cat(outs)
        return y[0] if single else y

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """Dispatch + preparation telemetry, lock-consistent.
        ``compiles`` counts preparations this instance made; with a
        shared cache a second plan over identical layers reports 0."""
        with self._stats_lock:
            hits = dict(self.bucket_hits)
            calls = self.calls
            compiles = self.compiles
        cache = self.cache.stats()
        return {
            "kind": self.kind,
            "buckets": list(self.buckets),
            "bucket_hits": hits,
            "executables": cache["executables"],
            "compiles": compiles,
            "cache_compiles": cache["compiles"],
            "cache_hits": cache["hits"],
            "calls": calls,
            "warmed_up": self.warmed_up,
        }


class LayerLaunch:
    """One prepared (layer, bucket) launch: the block's layer and its
    requantize (``ConvBlock.apply_batched_requant``) at a fixed input
    shape and container — one kernel launch for the dot blocks, whose
    epilogue requantizes (``fused_dot_layer_requant``,
    ``packed_dot_layer_requant``); Conv1's layer kernel, then
    ``conv2d.requantize``.  Preparing one for the card builds and binds
    the kernel libraries the block's layer launches
    (``ConvBlock.serving_kernels``: K1 for conv2, conv4 and unpacked
    conv3, K2 for packed conv3, K3 for conv1) in ``kernel_dir``
    (``build.BUILD_DIR`` by default); on the CPU there are none.
    Called as ``launch(w, x)`` with the layer's device-resident
    weights, like the reference's executables.

    ``record()`` is everything a disk entry needs to make the launch
    again with no preparation — its identity and the libraries it
    launches — and ``from_record`` makes it, checking each library in
    ``kernel_dir`` against its hash (``build.prepare``)."""

    def __init__(self, block: ConvBlock, spec: ConvLayerSpec,
                 in_shape: Tuple[int, ...], in_dtype: torch.dtype,
                 device: torch.device, *,
                 kernel_dir: Optional[Path] = None):
        self.block, self.spec = block, spec
        self.in_shape, self.in_dtype, self.device = in_shape, in_dtype, device
        self.libraries: Tuple[str, ...] = (
            block.serving_kernels(spec.data_bits, spec.coeff_bits)
            if device.type == "cuda" else ())
        if self.libraries:
            build.prepare(self.libraries, kernel_dir)

    def record(self) -> dict:
        """The launch as JSON-ready fields (see the class docstring)."""
        return {"block": self.block.name,
                "spec": dataclasses.asdict(self.spec),
                "in_shape": list(self.in_shape),
                "in_dtype": dtype_name(self.in_dtype),
                "device": str(self.device),
                "libraries": list(self.libraries)}

    @classmethod
    def from_record(cls, record: dict, *,
                    kernel_dir: Optional[Path] = None) -> "LayerLaunch":
        """The launch ``record()`` describes; raises ``ValueError`` on a
        record that names no such launch."""
        dtype = getattr(torch, record["in_dtype"])
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"not a dtype: {record['in_dtype']!r}")
        try:
            device = torch.device(record["device"])
        except RuntimeError as e:
            raise ValueError(f"not a device: {record['device']!r}") from e
        launch = cls(get_block(record["block"]),
                     ConvLayerSpec(**record["spec"]),
                     tuple(int(d) for d in record["in_shape"]), dtype,
                     device, kernel_dir=kernel_dir)
        if list(launch.libraries) != list(record["libraries"]):
            raise ValueError(
                f"record names libraries {record['libraries']}, the "
                f"block launches {list(launch.libraries)}")
        return launch

    def __call__(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.in_shape or x.dtype != self.in_dtype \
                or x.device != self.device:
            raise ValueError(
                f"layer launch prepared for {self.in_shape} "
                f"{dtype_name(self.in_dtype)} on {self.device}, got "
                f"{tuple(x.shape)} {dtype_name(x.dtype)} on {x.device}")
        return self.block.apply_batched_requant(
            x, w, data_bits=self.spec.data_bits,
            coeff_bits=self.spec.coeff_bits, shift=self.spec.shift)


class ShardedLaunch:
    """One (layer, bucket) launch over a ``CNNDataMesh``: a
    ``LayerLaunch`` per device at the slice that device runs (the
    bucket split over the devices where it divides their count, else
    the whole bucket on each), called as ``launch(ws, xs)`` with the
    per-device weights and slices, each on its own card."""

    def __init__(self, launches: Sequence[LayerLaunch]):
        self.launches = tuple(launches)

    def __call__(self, ws, xs):
        from repro_torch.core.cnn import on_device
        return [on_device(launch.device, launch, w, x)
                for launch, w, x in zip(self.launches, ws, xs)]


class CompiledCNN(CompiledModel):
    """The convolution backend: batch-bucketed executor for one planned
    CNN deployment, on ``device`` (``"cuda"`` unless the caller asks for
    the CPU; asking for ``cuda`` without a card raises).  Bit-exact vs
    ``cnn_forward_ref`` at every batch size.

    ``mesh`` (a ``parallel.sharding.CNNDataMesh``) serves data-parallel:
    each bucket splits over the mesh's devices by
    ``cnn_batch_sharding`` (replicated where it does not divide them),
    every device holds the weights and runs its slice through its own
    launches (``ShardedLaunch``), and the output is joined on the first
    device, which is ``device``.  The mesh is part of every cache key,
    as in the reference."""

    kind = "cnn"
    input_noun = "image"

    def __init__(self, cfg: CNNConfig, params, blocks: Sequence[BlockLike],
                 *, max_batch: int = 16, device: DeviceLike = "cuda",
                 mesh=None, warmup: bool = True,
                 exec_cache: Optional[ExecutableCache] = None):
        blocks = [get_block(b) for b in blocks]
        if len(blocks) != len(cfg.layers):
            raise ValueError(
                f"need one block per layer: {len(blocks)} blocks "
                f"for {len(cfg.layers)} layers")
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else resolve_device(device)
        self.cfg = cfg
        self.params: List[torch.Tensor] = [
            torch.as_tensor(w).to(self.device).contiguous() for w in params]
        # every device of the mesh holds the weights
        self._replicas = None if mesh is None else [
            [w.to(dev) for w in self.params] for dev in mesh.devices]
        self.blocks = blocks
        self.num_layers = len(cfg.layers)

        spec0 = cfg.layers[0]
        self.in_shape = (cfg.img_h, cfg.img_w, spec0.in_channels)
        self.in_dtype = conv2d.container_dtype(spec0.data_bits)
        super().__init__(max_batch=max_batch, warmup=warmup,
                         exec_cache=exec_cache)

    # -- construction from a deployment plan -----------------------------
    @classmethod
    def from_plan(cls, plan, cfg: Optional[CNNConfig] = None, *,
                  params=None, generator: Optional[torch.Generator] = None,
                  max_batch: int = 16, device: DeviceLike = "cuda",
                  mesh=None, warmup: bool = True,
                  exec_cache: Optional[ExecutableCache] = None
                  ) -> "CompiledCNN":
        """Executor for a planned deployment: each layer runs the
        (block, bits) the planner assigned.  ``cfg`` defaults to the
        network embedded in the plan; ``params`` default to an
        ``init_cnn`` draw at the planned precisions from ``generator``
        (seeded with 0 when none is given)."""
        from repro_torch.core import deploy
        pcfg = deploy.plan_config(plan, cfg)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = init_cnn(generator, pcfg)
        return cls(pcfg, params, plan.block_names(), max_batch=max_batch,
                   device=device, mesh=mesh, warmup=warmup,
                   exec_cache=exec_cache)

    @classmethod
    def from_json(cls, text: str, **kw) -> "CompiledCNN":
        """Executor straight from a serialized plan artifact."""
        from repro_torch.core import deploy
        return cls.from_plan(deploy.DeploymentPlan.from_json(text), **kw)

    def warmup(self) -> "CompiledCNN":
        """Prepare every (layer, bucket) launch now.  On the card the
        plan's kernel libraries are made ready first, all in one
        ``build.prepare`` (the missing ones built together, one ``nvcc``
        each), where preparing layer by layer would build them one
        after another."""
        if any(d.type == "cuda" for d in self._devices()):
            build.prepare(sorted({
                lib for blk, spec in zip(self.blocks, self.cfg.layers)
                for lib in blk.serving_kernels(spec.data_bits,
                                               spec.coeff_bits)}),
                self.cache.kernel_dir)
        return super().warmup()

    # -- backend hooks ----------------------------------------------------
    def _devices(self) -> Tuple[torch.device, ...]:
        return self.mesh.devices if self.mesh is not None else (self.device,)

    def _layer_key(self, i: int, bucket: int) -> tuple:
        spec = self.cfg.layers[i]
        mesh = () if self.mesh is None else (self.mesh.token,)
        return (self.blocks[i].name, spec.data_bits, spec.coeff_bits,
                spec.shift, spec.in_channels, spec.out_channels,
                self.cfg.img_h, self.cfg.img_w, self.device) + mesh \
            + (bucket,)

    def _prepare_layer(self, i: int, bucket: int):
        spec = self.cfg.layers[i]

        def launch(n, device):
            return LayerLaunch(
                self.blocks[i], spec,
                (n, self.cfg.img_h, self.cfg.img_w, spec.in_channels),
                conv2d.container_dtype(spec.data_bits), device,
                kernel_dir=self.cache.kernel_dir)

        if self.mesh is None:
            return launch(bucket, self.device)
        from repro_torch.parallel.sharding import cnn_batch_sharding
        sharded = cnn_batch_sharding(self.mesh, bucket).sharded
        n = bucket // self.mesh.size if sharded else bucket
        return ShardedLaunch([launch(n, d) for d in self.mesh.devices])

    def _layer_params(self, i: int):
        if self.mesh is None:
            return self.params[i]
        return [ws[i] for ws in self._replicas]

    def _place_batch(self, xb, bucket: int):
        if self.mesh is None:
            return xb
        from repro_torch.parallel.sharding import cnn_batch_sharding
        return cnn_batch_sharding(self.mesh, bucket).split(xb)

    def _gather_batch(self, act, bucket: int):
        if self.mesh is None:
            return act
        from repro_torch.parallel.sharding import cnn_batch_sharding
        return cnn_batch_sharding(self.mesh, bucket).join(act)

    def _empty_output(self) -> torch.Tensor:
        last = self.cfg.layers[-1]
        return torch.zeros(
            (0, self.cfg.img_h, self.cfg.img_w, last.out_channels),
            dtype=conv2d.container_dtype(last.data_bits), device=self.device)

    # -- workload helpers --------------------------------------------------
    def sample_inputs(self, k: int, seed: int = 0) -> List[np.ndarray]:
        """``k`` random quantized images matching this executor's input
        contract — the reference's generator (numpy, then
        ``quantize_fixed``), so the same seed gives the same images."""
        from repro_torch.kernels import ops
        rng = np.random.default_rng(seed)
        d0 = self.cfg.layers[0].data_bits
        return [ops.quantize_fixed(torch.from_numpy(
            rng.integers(0, 1 << (d0 - 1),
                         self.in_shape).astype(np.float32)), d0).numpy()
            for _ in range(k)]

    def validate_input(self, x, request_id: int = 0) -> np.ndarray:
        return validate_container_input(
            x, self.in_shape, self.in_dtype, request_id,
            noun=self.input_noun)
