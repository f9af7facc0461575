"""Model facade: one object per architecture, plus dry-run input specs.

Port of ``repro.models.registry``: ``Model`` (``init``, ``init_cache``,
``forward_train``, ``prefill``, ``decode_step``) and ``build_model``, for
every architecture of the zoo.  The modality frontends are stubs, as in
the reference: ``patches`` / ``frames`` arrive in the batch as
precomputed embeddings.

The dry-run helpers ``init_abstract``, ``cache_abstract`` and
``input_specs`` return tensors on ``meta`` — the counterpart of
``jax.ShapeDtypeStruct`` stand-ins: the reference's shapes and dtypes,
shardable, and never allocated.

A decode step at per-row positions (``pos`` a tensor: the serving
``Engine``'s per-slot steps) on a CUDA card replays one CUDA graph of the
step (``DecodeGraph``), captured at the first such call for its
parameters and cache and replayed while the caller passes the same
ones: an eager step of a large model is bound by the host's launches
(the published Qwen3-30B-A3B: about 6,000 a step), a replay is one.
The first call runs the step eagerly and captures it after; a replay
runs the captured kernels on the same tensors, so it returns what the
eager step would; its logits live in the graph's memory and the next
step overwrites them.  The launch counter ``kernels.build.LAUNCHES``
moves by what the step's Python adds; what the capture added is taken
back and added again at every replay, so it counts the kernels that ran,
whichever they are.  The graph is launched through libcuda holding
the interpreter's lock (``_launch``): ``torch.profiler`` starts and
stops while holding it, and a stop whose activity flush met a graph
launch on another thread deadlocked (an H100 host, 2 of 7 traced runs
of the serving benchmark).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.build import LAUNCHES
from repro_torch.models import transformer as tf

META = torch.device("meta")


_LIBCUDA: Optional[ctypes.PyDLL] = None


def _launch(graph: "torch.cuda.CUDAGraph") -> None:
    """``graph.replay()`` (the graph holds no random state) as one
    ``cuGraphLaunch`` on the current stream, called without releasing
    the interpreter's lock, so that no profiler start or stop on another
    thread overlaps the launch."""
    global _LIBCUDA
    if _LIBCUDA is None:
        _LIBCUDA = ctypes.PyDLL("libcuda.so.1")
    rc = _LIBCUDA.cuGraphLaunch(
        ctypes.c_void_p(graph.raw_cuda_graph_exec()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"cuGraphLaunch failed with CUresult {rc}")


class DecodeGraph:
    """``transformer.decode_step`` over one (params, cache) pair with
    static token and position inputs: the first step eager, then
    captured into a CUDA graph, every later step a replay.  ``first``
    holds the eager step's logits until the caller takes them."""

    def __init__(self, cfg: ModelConfig, params, cache, token, pos):
        self.params, self.cache = params, cache
        self.token = token.clone()
        self.pos = torch.as_tensor(pos, dtype=torch.int64,
                                   device=token.device).clone()
        # the eager step on a side stream, as a capture wants warmed up
        side = torch.cuda.Stream(token.device)
        side.wait_stream(torch.cuda.current_stream(token.device))
        with torch.cuda.stream(side):
            self.first, _ = tf.decode_step(params, cache, self.token,
                                           self.pos, cfg)
        torch.cuda.current_stream(token.device).wait_stream(side)
        self.first.record_stream(torch.cuda.current_stream(token.device))
        # a capture records and runs nothing: its counts are a replay's
        before = LAUNCHES.copy()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = tf.decode_step(params, cache, self.token,
                                            self.pos, cfg)
        self.counts = LAUNCHES - before
        LAUNCHES.subtract(self.counts)

    def serves(self, params, cache, token) -> bool:
        return (params is self.params and cache is self.cache
                and token.shape == self.token.shape)

    def __call__(self, token, pos):
        if self.first is not None:
            first, self.first = self.first, None
            return first
        self.token.copy_(token)
        self.pos.copy_(pos)
        _launch(self.graph)
        LAUNCHES.update(self.counts)
        return self.logits


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    _decode_graph: Optional[DecodeGraph] = field(
        default=None, init=False, repr=False, compare=False)

    # ---- param / cache construction ----------------------------------
    def init(self, generator: torch.Generator):
        """Parameters drawn from ``generator``, which must live on the
        model's device."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        return tf.init_params(generator, self.cfg)

    def init_abstract(self):
        """Shape-only params on ``meta`` (no allocation) for the dry run."""
        return tf.init_params(None, self.cfg)

    def init_cache(self, batch: int, max_len: int):
        enc_len = self.cfg.frontend_len if self.cfg.enc_dec else 0
        return tf.init_cache(self.cfg, batch, max_len, enc_len, self.device)

    def cache_abstract(self, batch: int, max_len: int):
        """The decode cache of ``init_cache`` on ``meta``."""
        enc_len = self.cfg.frontend_len if self.cfg.enc_dec else 0
        return tf.init_cache(self.cfg, batch, max_len, enc_len, META)

    # ---- forwards ------------------------------------------------------
    def forward_train(self, params, batch):
        return tf.forward_train(params, batch, self.cfg)

    def prefill(self, params, batch):
        return tf.prefill(params, batch, self.cfg)

    def decode_step(self, params, cache, token, pos):
        """One decode step; at per-row positions on a CUDA card, a
        ``DecodeGraph`` step (made anew, its first step eager, when the
        parameters, the cache or the batch differ from the last
        one's)."""
        if not (torch.is_tensor(pos) and self.device.type == "cuda"):
            return tf.decode_step(params, cache, token, pos, self.cfg)
        token = torch.as_tensor(token, dtype=torch.int64, device=self.device)
        graph = self._decode_graph
        if graph is None or not graph.serves(params, cache, token):
            self._decode_graph = None          # free the old capture first
            graph = self._decode_graph = DecodeGraph(self.cfg, params,
                                                     cache, token, pos)
        return graph(token, pos), cache

    # ---- dry-run input specs -------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Every model input of an (arch × shape) cell on ``meta``: the
        train or prefill batch (tokens, labels, patches, frames), or the
        decode cache of length ``seq_len``, one token per sequence and
        the position (an int32 scalar)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, dt = torch.int32, cfg.torch_dtype

        def sds(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device=META)

        def token_batch(n_tok):
            batch = {"tokens": sds((b, n_tok), i32)}
            if cfg.frontend == "vision":
                batch["patches"] = sds((b, cfg.frontend_len, cfg.d_model), dt)
            if cfg.enc_dec:
                batch["frames"] = sds((b, cfg.frontend_len, cfg.d_model), dt)
            return batch

        n_tok = s - (cfg.frontend_len if cfg.frontend == "vision" else 0)
        if shape.kind == "train":
            batch = token_batch(n_tok)
            batch["labels"] = sds((b, n_tok), i32)
            return {"batch": batch}
        if shape.kind == "prefill":
            return {"batch": token_batch(n_tok)}
        # decode: one new token against a cache of length s
        return {"cache": self.cache_abstract(b, s),
                "token": sds((b, 1), i32),
                "pos": sds((), i32)}


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    return Model(cfg, resolve_device(device))
