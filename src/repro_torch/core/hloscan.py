"""Step analysis: the counterpart of the reference's compiled-artifact
analysis (``repro.core.hloscan``).

The reference reads XLA's compiled, per-device HLO: FLOPs, HBM traffic
at fusion boundaries and the collectives' wire bytes, walked through
while-loop trip counts.  PyTorch runs the step eagerly, so here the step
itself is traced as it runs, one device's view of it: ``OpCounter``, a
dispatch mode that counts every aten operator on *local* tensors.  An
operator on DTensors is handed back to DTensor (the mode returns
``NotImplemented``), so what is counted is what DTensor runs on this
device's shards — the local products, the redistributions' collectives,
the replicated heads and the remat recompute — never the global shapes
(``torch.utils.flop_counter.FlopCounterMode`` over DTensor code counts
those).  DTensor's shape propagation, which runs each operator once more
on fake global tensors, is skipped.

* ``flops``: the matrix products and convolutions, by
  ``torch.utils.flop_counter``'s formulas, plus what the port's kernels
  report (``kernels.build.report_work``: a ctypes launch is no aten
  operator).  On ``meta`` tensors the model takes its plain path (the
  chunked attention and conv the reference's dry run lowers too).
* ``hbm_bytes``: each operator's operands plus results — eager mode
  fuses nothing, so every operator is a boundary — except views (no
  bytes) and, as the reference's walker counts them, gathers and slices
  (twice their output) and scatters (twice their small operands).
* collectives: each functional collective's result bytes times the
  ring factor (``_COLLECTIVE_FACTOR``), per class, and their counts.
* memory (``memory_summary``): the arguments' local bytes exactly, the
  outputs, what they alias of the arguments, and the peak of live
  temporaries (storages the step allocated and still holds), tracked at
  each allocation.

The HLO-text parser (``HloModule``) has no counterpart — there is no HLO
— but ``analyze_step`` returns the keys ``analyze_hlo`` returns.  The
jaxpr census ``jaxpr_resources`` is ``core.census``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# bytes per element by HLO type name, as the reference's table; the port's
# dtypes map onto it through ``_TORCH_TYPE``
_DTYPE_BYTES = {
    "pred": 1, "s4": 0.5, "u4": 0.5, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}
_TORCH_TYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.uint16: "u16", torch.int32: "s32",
    torch.uint32: "u32", torch.int64: "s64", torch.uint64: "u64",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

# wire-traffic factor per result byte (ring algorithms, large-n limit)
_COLLECTIVE_FACTOR = {
    "all-gather": 1.0,        # each chip receives (n-1)/n of the result
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# the torch operators of each collective class (functional and c10d)
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def dtype_bytes(dtype: torch.dtype) -> float:
    return _DTYPE_BYTES[_TORCH_TYPE[dtype]]


def _nbytes(t: torch.Tensor) -> float:
    return t.numel() * dtype_bytes(t.dtype)


def _tensors(tree) -> Iterable[torch.Tensor]:
    """The local tensors of a tree of dicts, lists and tuples (a
    DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree


def _is_fake_propagation() -> bool:
    """Whether DTensor is running an operator on fake global tensors to
    learn its output's shape (a FakeTensorMode on the mode stack)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def _op_name(func) -> str:
    return func.overloadpacket.__name__


def _traffic(name: str, ins: List[float], out_b: float) -> float:
    """HBM bytes of one operator, by the reference's macro-op rule."""
    if "empty" in name:
        return 0.0
    if "scatter" in name or name in ("index_put", "index_put_",
                                     "index_copy", "index_copy_",
                                     "index_add", "index_add_"):
        return 2.0 * (sum(ins) - (max(ins) if ins else 0.0))
    if "gather" in name or name in ("index", "index_select", "embedding",
                                    "slice", "select") or "slice" in name:
        return 2.0 * out_b
    return out_b + sum(ins)


class OpCounter(TorchDispatchMode):
    """One device's operators, FLOPs, bytes, collectives and memory while
    it is active (``with OpCounter() as c: ...``; ``c.summary()``).
    ``trace`` keeps one record per counted operator."""

    def __init__(self, keep_trace: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.res: Dict[str, float] = defaultdict(float)
        self.coll: List[Dict[str, Any]] = []
        self.keep_trace = keep_trace
        self.trace: List[Dict[str, Any]] = []
        self.n_ops = 0
        self._known: set = set()        # storages of the arguments
        self._live: list = []           # (weak storage ref, bytes, key)
        self._live_keys: set = set()
        self.live_bytes = 0.0
        self.peak_temp_bytes = 0.0
        self.kernel_work: Dict[str, Dict[str, float]] = {}

    # -- arguments and memory --------------------------------------------
    def add_arguments(self, tree) -> float:
        """Mark ``tree``'s storages as arguments (never temporaries);
        returns their bytes (each storage once)."""
        total = 0.0
        for t in _tensors(tree):
            key = self._storage_key(t)
            if key not in self._known:
                self._known.add(key)
                total += t.untyped_storage().nbytes()
        return total

    @staticmethod
    def _storage_key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _track(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        key = self._storage_key(t)
        if key in self._known:
            return
        # frees only lower the level: sweep them at each allocation
        alive, live = [], 0.0
        for ref, nb, k in self._live:
            if ref.expired():
                self._live_keys.discard(k)
            else:
                alive.append((ref, nb, k))
                live += nb
        self._live = alive
        if key not in self._live_keys:       # an in-place result: no new
            st = t.untyped_storage()
            nb = float(st.nbytes())
            self._live.append((StorageWeakRef(st), nb, key))
            self._live_keys.add(key)
            live += nb
        self.live_bytes = live
        self.peak_temp_bytes = max(self.peak_temp_bytes, live)

    # -- kernels ------------------------------------------------------------
    def _kernel(self, entry: str, flops: float, nbytes: float) -> None:
        w = self.kernel_work.setdefault(entry, {"launches": 0, "flops": 0.0,
                                                "hbm_bytes": 0.0})
        w["launches"] += 1
        w["flops"] += flops
        w["hbm_bytes"] += nbytes
        self.res["flops"] += flops
        self.res["hbm_bytes"] += nbytes
        if self.keep_trace:
            self.trace.append({"op": f"kernel.{entry}", "flops": flops,
                               "bytes": nbytes})

    def __enter__(self):
        from repro_torch.kernels import build
        build.WORK_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import build
        build.WORK_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    # -- the operators --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it on the shards
        out = func(*args, **kwargs)
        if _is_fake_propagation():
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = _op_name(func)
        if name in ("wait_tensor", "_wrap_tensor_autograd", "detach"):
            return
        self.n_ops += 1
        outs = list(_tensors(out))
        out_b = sum(_nbytes(t) for t in outs)
        flops = 0.0
        packet = func.overloadpacket
        if packet in self._flop_registry:
            flops = float(self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
            self.res["flops"] += flops
        klass = _COLLECTIVE_OPS.get(name)
        if klass is not None:
            wire = out_b * _COLLECTIVE_FACTOR[klass]
            self.res[f"coll_{klass}"] += wire
            self.res[f"colln_{klass}"] += 1
            self.coll.append({"op": klass, "bytes": out_b})
        nbytes = 0.0
        if not func.is_view:
            ins = [_nbytes(t) for t in _tensors((args, kwargs))]
            nbytes = _traffic(name, ins, out_b)
            self.res["hbm_bytes"] += nbytes
            for t in outs:
                self._track(t)
        if self.keep_trace:
            self.trace.append({
                "op": str(func), "flops": flops, "bytes": nbytes,
                "shapes": [list(t.shape) for t in _tensors(args)],
                "out": [list(t.shape) for t in outs]})

    def summary(self) -> Dict[str, Any]:
        """The keys ``analyze_hlo`` returns: ``flops``, ``hbm_bytes``,
        ``coll_<class>`` and ``colln_<class>``, ``collective_total`` and
        ``collectives`` (wire bytes by class), plus ``ops`` and the
        kernels' reported work."""
        out = {"flops": 0.0, "hbm_bytes": 0.0, **self.res}
        out["collective_total"] = sum(
            v for k, v in out.items() if k.startswith("coll_"))
        out["collectives"] = {
            k.removeprefix("coll_"): v for k, v in out.items()
            if k.startswith("coll_")}
        out["ops"] = self.n_ops
        out["kernels"] = {k: dict(v) for k, v in self.kernel_work.items()}
        return out


def analyze_step(fn, *args, keep_trace: bool = False, **kwargs
                 ) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under an ``OpCounter`` and return
    its ``summary()`` with ``memory`` (``memory_summary``) and, with
    ``keep_trace``, ``trace`` (one record per operator)."""
    counter = OpCounter(keep_trace=keep_trace)
    arg_bytes = counter.add_arguments((args, kwargs))
    with counter:
        result = fn(*args, **kwargs)
    out = counter.summary()
    out_storages = {}
    for t in _tensors(result):
        out_storages[counter._storage_key(t)] = float(
            t.untyped_storage().nbytes())
    alias = sum(nb for k, nb in out_storages.items() if k in counter._known)
    out["memory"] = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sum(out_storages.values()),
        "temp_size_in_bytes": counter.peak_temp_bytes,
        "alias_size_in_bytes": alias,
    }
    out["memory"]["total_hbm_bytes"] = (
        out["memory"]["argument_size_in_bytes"]
        + out["memory"]["output_size_in_bytes"]
        + out["memory"]["temp_size_in_bytes"]
        - out["memory"]["alias_size_in_bytes"])
    if keep_trace:
        out["trace"] = counter.trace
    out["collective_ops"] = counter.coll
    return out


def collective_bytes(ops: Iterable[Dict[str, Any]]) -> Dict[str, float]:
    """Per-collective-class wire bytes (per device) of a step's
    collectives (``analyze_step``'s ``collective_ops``: the class and
    result bytes of each)."""
    out: Dict[str, float] = defaultdict(float)
    for rec in ops:
        out[rec["op"]] += rec["bytes"] * _COLLECTIVE_FACTOR[rec["op"]]
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return dict(out)


def count_collectives(ops: Iterable[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = defaultdict(int)
    for rec in ops:
        out[rec["op"]] += 1
    return dict(out)


def cost_summary(analysis: Dict[str, Any]) -> Dict[str, float]:
    """The reference's ``cost_analysis`` keys from an ``analyze_step``
    result."""
    return {"flops": float(analysis["flops"]),
            "bytes_accessed": float(analysis["hbm_bytes"])}


def memory_summary(analysis: Dict[str, Any]) -> Dict[str, float]:
    """The reference's ``memory_analysis`` keys from an ``analyze_step``
    result."""
    return dict(analysis["memory"])
