"""Sharding rules: param/batch/cache partition specs for DP / TP / EP / SP.

Port of ``repro.parallel.sharding``.  Two weight-sharding modes:

* ``tp``   — tensor parallelism only: heads / FFN-hidden / experts / vocab
             sharded over the ``model`` axis; weights replicated across the
             data axes (the Megatron layout).
* ``fsdp`` — additionally shards every weight's largest remaining dimension
             over the data axes (ZeRO-3 style); DTensor gathers it where an
             op needs it whole.

Rules are *path-driven* over the port's parameter dictionaries (the
paths ``stack/s0/attn/wq``, ... that ``convert.py`` maps), so they apply
uniformly to every architecture in the zoo.  Any dimension that does not
divide the mesh axis stays unsharded (e.g. Granite's single KV head).

A spec is the port's own ``P``: one entry per tensor dimension, a mesh
axis name, a tuple of names (``("pod", "data")``) or None, so specs
compare with the reference's ``PartitionSpec`` leaf by leaf.
``to_placements`` turns one into DTensor ``Shard``/``Replicate``
placements on a ``torch.distributed.device_mesh.DeviceMesh`` with the
same axis names, and ``place`` puts a tensor there (``DTensor.from_local``
on a one-device mesh, so the tensor is wrapped, not copied).

The CNN's data parallelism (``cnn_data_mesh``, ``cnn_batch_sharding``)
runs in one process over a list of local devices, the counterpart of the
reference's single-controller mesh: a bucket splits over the devices
where it divides their count, else every device runs it whole
(replicated) and the first device's result is kept.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import leaves_with_paths


class P(tuple):
    """A partition spec: one entry per tensor dimension — a mesh axis
    name, a tuple of names, or None (unsharded)."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes alone: what the rules read of a mesh, for
    specs without a process group (tests, planning)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a ``MeshShape`` or a
    ``CNNDataMesh``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """Returns (data_axes, model_axis) for single- or multi-pod meshes."""
    if "pod" in axis_sizes(mesh):
        return ("pod", "data"), "model"
    return ("data",), "model"


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _tree_map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn(prefix, tree)


class ShardingRules:
    def __init__(self, cfg: ModelConfig, mesh, mode: str = "tp"):
        if mode not in ("tp", "fsdp"):
            raise ValueError(f"mode {mode!r}: tp or fsdp")
        self.cfg = cfg
        self.mesh = mesh
        self.mode = mode
        self.dp, self.tp = mesh_axes(mesh)
        sizes = axis_sizes(mesh)
        self.tp_size = sizes.get(self.tp, 1)
        self.dp_size = 1
        for a in self.dp:
            self.dp_size *= sizes.get(a, 1)

    # -- helpers ---------------------------------------------------------
    def _dp_entry(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]

    def _fsdp_wrap(self, spec: Tuple, shape: Tuple[int, ...]) -> P:
        """In fsdp mode, shard the largest unsharded dim over the data
        axes (the first of equals).  Leading stacked-cycle dims (handled
        by the caller) are not candidates."""
        if self.mode != "fsdp":
            return P(*spec)
        spec = list(spec)
        cands = sorted(
            (i for i in range(len(spec))
             if spec[i] is None and _divides(shape[i], self.dp_size)),
            key=lambda i: -shape[i])
        if cands:
            spec[cands[0]] = self._dp_entry()
        return P(*spec)

    def _leaf_spec(self, path: str, shape: Tuple[int, ...]) -> P:
        tp, cfg = self.tp, self.cfg
        stacked = path.startswith("stack/") or path.startswith("enc_stack/")
        core = shape[1:] if stacked else shape

        def tpif(dim):
            return tp if _divides(dim, self.tp_size) else None

        def out(*spec):
            spec = self._fsdp_wrap(spec, core)
            return P(None, *spec) if stacked else spec

        leaf = path.rsplit("/", 1)[-1]
        # --- embeddings ------------------------------------------------
        if leaf == "embed":
            if cfg.tie_embeddings and _divides(shape[0], self.tp_size):
                return P(tp, None)       # vocab-sharded: free tied unembed
            if _divides(shape[1], self.tp_size):
                return P(None, tp)       # d_model-sharded: free gather
            return P(None, None)
        if leaf == "unembed":
            return P(None, tpif(shape[1]))
        # --- attention ---------------------------------------------------
        if leaf in ("wq", "wk", "wv"):
            return out(None, tpif(core[1]), None)
        if leaf == "wo":
            return out(tpif(core[0]), None, None)
        # --- MoE -----------------------------------------------------------
        if re.search(r"moe/(w_up|w_gate|w_down)$", path):
            return out(tpif(core[0]), None, None)
        if leaf == "router":
            return out(None, None)
        if leaf in ("shared_up", "shared_gate"):
            return out(None, tpif(core[1]))
        if leaf == "shared_down":
            return out(tpif(core[0]), None)
        # --- dense MLP ------------------------------------------------------
        if leaf in ("w_up", "w_gate"):
            return out(None, tpif(core[1]))
        if leaf == "w_down":
            return out(tpif(core[0]), None)
        # --- mamba -----------------------------------------------------------
        if leaf in ("w_z", "w_x", "w_dt", "conv_x"):
            return out(None, tpif(core[1]))
        if leaf in ("w_B", "w_C", "conv_B", "conv_C"):
            return out(*(None,) * len(core))
        if leaf in ("dt_bias", "a_log", "d_skip"):
            return out(tpif(core[0]))
        if leaf == "norm" and len(core) == 1 and core[0] != cfg.d_model:
            return out(tpif(core[0]))
        if leaf == "w_out":
            return out(tpif(core[0]), None)
        # --- norms & everything else: replicated ---------------------------
        return out(*(None,) * len(core))

    # -- public ------------------------------------------------------------
    def params_spec(self, params_shapes):
        return _tree_map_with_path(
            lambda path, leaf: self._leaf_spec(_path_str(path),
                                               tuple(leaf.shape)),
            params_shapes)

    def params_sharding(self, params_shapes):
        return self.to_sharding(self.params_spec(params_shapes))

    # -- activations ---------------------------------------------------------
    def batch_spec(self, batch_shapes):
        def spec(path, leaf):
            shape = tuple(leaf.shape)
            lead = self._dp_entry() if _divides(shape[0], self.dp_size) \
                else None
            return P(lead, *(None,) * (len(shape) - 1))
        return _tree_map_with_path(spec, batch_shapes)

    def cache_spec(self, cache_shapes):
        """Decode cache: batch over data if divisible, else sequence (SP);
        head-like dims over model when divisible."""
        dp = self._dp_entry()

        def spec(path, leaf):
            shape = tuple(leaf.shape)  # leading dim = n_cycles
            p = path[-1]
            s = [None] * len(shape)
            kv = p in ("k", "v", "ck", "cv") and len(shape) == 5
            if len(shape) >= 2:
                if _divides(shape[1], self.dp_size):
                    s[1] = dp            # batch over data axes
                elif kv and _divides(shape[2], self.dp_size):
                    s[2] = dp            # SP: sequence over data axes
            if kv and _divides(shape[3], self.tp_size):
                s[3] = self.tp           # kv heads over model
            if p == "ssm" and len(shape) == 5 and \
                    _divides(shape[2], self.tp_size):
                s[2] = self.tp           # ssm heads over model
            if p == "conv_x" and len(shape) == 4 and \
                    _divides(shape[3], self.tp_size):
                s[3] = self.tp           # inner channels over model
            return P(*s)
        return _tree_map_with_path(spec, cache_shapes)

    def opt_spec(self, opt_shapes, params_spec):
        """Optimizer-state specs: fp32 moments mirror the param specs;
        int8 block codecs shard the block dim over the data axes (ZeRO-1)."""
        flat_pspec = {_path_str(p): s
                      for p, s in leaves_with_paths(params_spec)}

        def leaf(path, x):
            ps = _path_str(path)
            if ps == "step":
                return P()
            rest = ps.split("/", 1)[1]
            shape = tuple(x.shape)
            if rest.endswith("/codes") or rest.endswith("/scale"):
                lead = self._dp_entry() \
                    if _divides(shape[0], self.dp_size) else None
                return P(lead, *(None,) * (len(shape) - 1))
            if rest in flat_pspec:
                return flat_pspec[rest]
            return P(*(None,) * len(shape))
        return _tree_map_with_path(leaf, opt_shapes)

    def to_sharding(self, spec_tree):
        """Each spec of ``spec_tree`` as DTensor placements on the mesh."""
        return _map_specs(lambda s: to_placements(s, self.mesh), spec_tree)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def choose_mode(cfg: ModelConfig, mesh) -> str:
    """Default policy: fsdp when TP-only weights would blow past ~8GB/chip."""
    tp_size = axis_sizes(mesh)["model"]
    bytes_per_chip = cfg.param_count() * 2 / tp_size
    return "fsdp" if bytes_per_chip > 8e9 else "tp"


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where the spec names that mesh axis at tensor dim ``d``
    (a tuple entry shards one dim over several axes, the first axis
    outermost, as the reference's ``("pod", "data")`` does), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """The shape one device holds of a tensor of ``shape`` placed by
    ``spec`` (every sharded dim divides its axes, as the rules ensure)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        for name in (e if isinstance(e, tuple) else (e,)):
            if name is not None:
                out[d] //= sizes[name]
    return tuple(out)


def place(t: torch.Tensor, mesh, spec: Sequence):
    """``t`` (the whole tensor, on every rank) as a DTensor placed by
    ``spec``: each rank keeps its own slice and nothing is communicated;
    on a one-device mesh ``t`` is wrapped without a copy.  A tensor on
    ``meta`` gives meta local shards (the dry run)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(spec, mesh)
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, placements, run_check=False)
    if t.device.type == "meta":
        local = torch.empty(local_shape(t.shape, spec, mesh),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def place_tree(tree, spec_tree, mesh):
    """``place`` over matching trees of tensors and specs (a spec is a
    leaf where ``tree`` may hold an int8 state's ``{"codes", "scale"}``:
    both follow the same spec)."""
    if isinstance(tree, dict):
        if isinstance(spec_tree, dict):
            return {k: place_tree(v, spec_tree[k], mesh)
                    for k, v in tree.items()}
        return {k: place_tree(v, spec_tree, mesh) for k, v in tree.items()}
    return place(tree, mesh, spec_tree)


def gather_data_axes(t):
    """A DTensor weight with its shards over the data axes gathered (an
    explicit all-gather; its backward reduce-scatters the gradient): the
    per-cycle gather of an ``fsdp`` placement before the weight is used,
    which the reference's compiler inserts.  Other placements, and plain
    tensors, are left as they are."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    names = t.device_mesh.mesh_dim_names
    pl = [Replicate() if names[i] in ("pod", "data") and isinstance(p, Shard)
          else p for i, p in enumerate(t.placements)]
    if pl == list(t.placements):
        return t
    return t.redistribute(placements=pl)


def resolve_partial(t):
    """A DTensor's pending partial sums reduced (an explicit all-reduce
    over each axis it is partial on: a row-parallel product's output,
    which Megatron all-reduces into the residual stream); anything else
    as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(placements=[
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_of(*tensors):
    """The mesh of the first DTensor among ``tensors``, or None: the
    port's counterpart of the reference's ambient mesh context (a
    module takes its multi-device path when its inputs live on one)."""
    for t in tensors:
        if is_dtensor(t):
            return t.device_mesh
    return None


# ---------------------------------------------------------------------------
# CNN image batches (data-parallel multi-image serving)
#
# The CNN hot path has no tensor-parallel dimension worth sharding (whole
# layers fit one card by construction — that is the deployment planner's
# job), so serving parallelism is pure DP: the (N, H, W, C) batch
# dimension over the data axis.  Used by ``core.cnn.cnn_forward(mesh=)``
# and the bucketed runtime (``runtime.CompiledCNN``, which the serve
# engine executes through): each bucket's launch splits its batch with
# ``cnn_batch_sharding`` and joins the slices on the first device.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CNNDataMesh:
    """A 1-D all-``data`` mesh over local devices, driven by one process."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.devices),)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def token(self) -> tuple:
        """What a cache key holds of the mesh."""
        return ("data",) + tuple(str(d) for d in self.devices)


def cnn_data_mesh(devices: Optional[Sequence] = None) -> CNNDataMesh:
    """1-D all-``data`` mesh over ``devices``, by default every CUDA card
    of the host; without a card that raises, as ``device="cuda"`` does
    (pass devices explicitly — the tests pass CPU devices)."""
    from repro_torch.device import resolve_device
    if devices is None:
        resolve_device("cuda")            # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("cnn_data_mesh: no devices")
    return CNNDataMesh(devices)


@dataclass(frozen=True)
class BatchSharding:
    """How an (N, H, W, C) batch lies on a mesh: ``spec`` is
    P(data, None, None, None) when N divides the data axes, else
    P(None, None, None, None) (replicated).  On a ``CNNDataMesh`` it
    splits and joins batches."""

    mesh: object
    spec: P

    @property
    def sharded(self) -> bool:
        return self.spec[0] is not None

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One slice per device (the whole batch on each where
        replicated)."""
        devs = self.mesh.devices
        if not self.sharded:
            return [x.to(d) for d in devs]
        parts = torch.chunk(x, len(devs))
        return [p.to(d).contiguous() for p, d in zip(parts, devs)]

    def join(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The batch on the first device: the slices in order, or the
        first device's copy where replicated."""
        first = self.mesh.devices[0]
        if not self.sharded:
            return parts[0]
        return torch.cat([p.to(first) for p in parts])


def cnn_batch_sharding(mesh, batch: int):
    """Sharding for an (N, H, W, C) image batch: N over the mesh's data
    axes when it divides their product, else replicated (the same
    divisibility rule every other spec here follows)."""
    sizes = axis_sizes(mesh)
    if "data" in sizes:
        axes = tuple(a for a in ("pod", "data") if a in sizes)
    else:                          # bespoke mesh: first axis is the batch axis
        axes = (next(iter(sizes)),)
    size = 1
    for a in axes:
        size *= sizes[a]
    lead = None
    if _divides(batch, size):
        lead = axes if len(axes) > 1 else axes[0]
    return BatchSharding(mesh, P(lead, None, None, None))


# ---------------------------------------------------------------------------
# kernels under a mesh
# ---------------------------------------------------------------------------

class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(fn):
    """``fn`` for ``local_map``, its tensor arguments' gradients made
    contiguous: DTensor wraps a local gradient as it comes, and the
    views of the backward outside (a reshape's) cannot take a strided
    one."""
    def wrapped(*args):
        return fn(*(_ContiguousGrad.apply(a)
                    if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))
    return wrapped


def grad_placements(in_pls, out_pls) -> tuple:
    """The placements of the inputs' local gradients in a ``local_map``
    region: an input replicated over an axis that an output is sharded
    (or partial) over gets a partial gradient there — each device used
    it for its own part of the output, so the devices' gradients add
    up, as the reference's ``shard_map`` transpose sums them."""
    from torch.distributed.tensor import Partial, Replicate
    outs = [o for o in out_pls if o is not None]
    grads = []
    for pl in in_pls:
        if pl is None:
            grads.append(None)
            continue
        grads.append([Partial() if isinstance(p, Replicate) and any(
            not isinstance(o[a], Replicate) for o in outs) else p
            for a, p in enumerate(pl)])
    return tuple(grads)


def shard_map(fn, mesh, in_pls, out_pls):
    """``fn`` under ``local_map`` on ``mesh`` — the reference's
    ``shard_map``: its DTensor inputs redistributed to ``in_pls``, its
    outputs placed by ``out_pls`` (one placement list, or a tuple of
    them for several outputs), the inputs' gradients placed by
    ``grad_placements`` and made contiguous (``_contiguous_grads``)."""
    from torch.distributed.tensor.experimental import local_map
    outs = out_pls if isinstance(out_pls, tuple) else (out_pls,)
    return local_map(_contiguous_grads(fn), out_placements=out_pls,
                     in_placements=tuple(in_pls),
                     in_grad_placements=grad_placements(in_pls, outs),
                     device_mesh=mesh, redistribute_inputs=True)


def kernel_placements(t, ok) -> list:
    """Placements a kernel can run ``t`` under with ``local_map``: each
    of ``t``'s ``Shard(d)`` placements that ``ok(d, axis size)`` accepts,
    and ``Replicate()`` in place of every other (a partial sum is
    reduced, an unsupported shard gathered)."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and ok(p.dim, n) else Replicate()
            for p, n in zip(t.placements, t.device_mesh.shape)]



def placed_zeros(shape: Sequence[int], dtype: torch.dtype, mesh,
                 spec: Sequence, device: torch.device):
    """A zero DTensor of global ``shape`` placed by ``spec``: each device
    allocates only its own shard (on ``meta``, nothing)."""
    from torch.distributed.tensor import DTensor
    local = torch.zeros(local_shape(shape, spec, mesh), dtype=dtype,
                        device=device)
    full = torch.empty(tuple(shape), device="meta")
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=full.shape,
                              stride=full.stride())
