"""Production mesh construction.

Port of ``repro.launch.mesh``.  Functions, not module-level constants,
so importing this module never touches a process group.  The caller sets
the group up first (torchrun's environment, a ``FileStore`` in tests, the
``fake`` group of the dry run); the meshes here are laid over its world.
The production shapes are the reference's: 16×16 = 256 devices, and two
of those with a leading ``pod`` axis = 512.
"""

from __future__ import annotations

import torch.distributed as dist


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under NCCL, else ``cpu`` (gloo,
    and the ``fake`` group, whose tensors live on ``meta`` or the CPU)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """A (16, 16) ``data × model`` mesh, or (2, 16, 16) ``pod × data ×
    model``, over the current group (its world must be 256 or 512)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1):
    """A (world / model, model) ``data × model`` mesh over the world that
    exists (tests / examples)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"of {n}")
    return init_device_mesh(_device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))
