"""Plan artifacts on disk: save/load helpers for ``DeploymentPlan``.

Port of ``repro.runtime.plan_io``.  Writes are crash-safe:
``atomic_write_text`` stages the payload in a temp file in the
destination directory, fsyncs it, and ``os.replace``s it into place, so
a reader never observes a torn or partially-written plan.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Union

from repro_torch.core.deploy import DeploymentPlan


def _fsync_dir(path: Path) -> None:
    """Flush a directory entry so a rename survives a crash.  Best
    effort: some filesystems/platforms refuse O_RDONLY dir fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: Union[str, Path], text: str, *,
                      fsync: bool = True) -> Path:
    """Write ``text`` to ``path`` atomically (tmp + fsync + rename).

    The temp file lives in the destination directory (``os.replace`` is
    only atomic within a filesystem) and its name is unique per
    (pid, thread), so concurrent writers of the same path race only at
    the rename — last writer wins, readers never see a torn file.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / (
        f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
    if fsync:
        _fsync_dir(path.parent)
    return path


def save_plan(plan: DeploymentPlan, path: Union[str, Path]) -> Path:
    """Write the versioned JSON artifact atomically; returns the path."""
    return atomic_write_text(path, plan.to_json())


def load_plan(path: Union[str, Path]) -> DeploymentPlan:
    """Load a plan artifact (raises ValueError on schema mismatch)."""
    return DeploymentPlan.load(path)
