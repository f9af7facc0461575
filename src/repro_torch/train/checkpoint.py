"""Atomic, device-agnostic checkpoints in the reference's format.

Port of ``repro.train.checkpoint``, byte-compatible with it: a checkpoint
written by either package restores in the other.

  * one ``.npy`` file per leaf under ``step_<step:010d>/``, named by the
    first 16 hex digits of the sha1 of the leaf's key, which is its path
    of dict keys joined by "/" (``params/stack/s0/attn/wq``, as the
    reference spells ``tree_flatten_with_path``);
  * ``manifest.json``: ``{"step", "leaves": {key: {"file", "shape",
    "dtype"}}, "metadata"}``; a bfloat16 leaf (and any dtype numpy has
    no type for) is stored losslessly as float32 with its own dtype
    recorded;
  * writes go to ``step_<step>.tmp`` and are committed by ``os.rename``,
    so a crash mid-write never leaves a half checkpoint that restore
    would see; ``keep`` bounds how many committed steps stay;
  * leaves are saved from the host, whole, so restore works on any
    device: the template's leaves give each restored leaf its dtype and
    device.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, leaves_with_paths

# the dtypes numpy stores as they are (the reference's list)
_NUMPY_DTYPES = ("float32", "float64", "int32", "int64", "int8", "uint8",
                 "int16", "uint16", "uint32", "uint64", "bool")


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to store, the leaf's own dtype name)."""
    dtype = str(leaf.dtype).removeprefix("torch.")
    t = leaf.detach().cpu()
    if dtype not in _NUMPY_DTYPES:
        t = t.float()
    return t.numpy(), dtype


def _unflatten_like(template, flat: Dict[str, np.ndarray]):
    """``template``'s tree with each leaf replaced by the array stored
    under its key, as a tensor of the template leaf's dtype on its
    device.  Raises on a missing leaf or another shape."""
    out: Dict = {}
    for path, leaf in leaves_with_paths(template):
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"model {tuple(leaf.shape)}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(arr).to(
            device=leaf.device, dtype=leaf.dtype)
    return out


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save -------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict] = None):
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}, "metadata": metadata or {}}
        for key, leaf in flatten(state).items():
            arr, orig_dtype = _to_numpy(leaf)
            fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": orig_dtype}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[int, Any]:
        """(step, ``template``'s tree restored from the checkpoint at
        ``step``, the newest committed one by default)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {}
        for key, info in manifest["leaves"].items():
            flat[key] = np.load(d / info["file"])
        return step, _unflatten_like(template, flat)
