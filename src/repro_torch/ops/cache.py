"""``PersistentExecutableCache``: a disk tier under ``ExecutableCache``.

Port of ``repro.ops.cache``.  The reference serializes each AOT XLA
executable to disk the first time it is compiled, so a restarted
gateway loads instead of compiling.  The port's compile storm is
``nvcc`` plus preparing each (layer, bucket) launch, so its disk entry
is a ``runtime.LayerLaunch`` record — the launch's identity (block,
``ConvLayerSpec`` fields, input shape, container dtype, device) and the
kernel libraries it launches — and the libraries themselves live in
``<cache_dir>/kernels/``, built there on a cold cache:

    cache = PersistentExecutableCache("state/exec-cache")
    model = runtime.compile_plan(plan, exec_cache=cache)
    # first process: prepares, stores .exe files, builds the libraries
    # after restart: zero preparations and zero nvcc runs — every
    # bucket's launch made from its record, every library loaded

Keying and safety (the reference's contract):

* Entries are keyed by ``sha256(repr((fingerprint, stable key)))`` in
  ``<digest>.exe`` files: the content-addressed layer keys backends
  already use, plus a fingerprint of the environment (``cache_fingerprint``:
  format, torch, CUDA and ``nvcc`` versions, driver, the card's name,
  compute capability and count; on the CPU the device type and torch's
  version).  An entry made for another environment is a miss.
* A corrupt entry is renamed to ``*.corrupt`` and an entry whose
  embedded fingerprint drifted under an unchanged path is renamed to
  ``*.stale``; both are re-prepared, never loaded.
* A kernel library whose bytes do not match the hash written beside it
  at build time, or that fails to load, is quarantined as
  ``*.corrupt`` and rebuilt (``kernels.build.prepare``) — never loaded,
  and never skipped in favour of the plain version.
* Writes are atomic (tmp + fsync + ``os.replace`` + directory fsync),
  and write failures are swallowed and counted: the disk tier is an
  accelerator, never a point of failure.

Values that are not ``LayerLaunch``es are kept in memory only.  An
entry is JSON, so loading one runs no code.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.kernels import build as kernel_build
from repro_torch.runtime.compiled import ExecutableCache, LayerLaunch
from repro_torch.runtime.plan_io import _fsync_dir

__all__ = ["PersistentExecutableCache", "cache_fingerprint",
           "CACHE_FORMAT_VERSION"]

CACHE_FORMAT_VERSION = 1


def _driver_version() -> str:
    """The CUDA driver's version (``cuDriverGetVersion``)."""
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        if libcuda.cuDriverGetVersion(ctypes.byref(v)) != 0:
            return "unknown"
        return str(v.value)
    except OSError:
        return "unknown"


def cache_fingerprint() -> tuple:
    """Identity of the environment a stored launch is only valid for:
    format, torch, CUDA and ``nvcc`` versions, driver, the card's name
    and compute capability, and the device count; on a host with no
    card, the device type and torch's version.  A flat tuple of strings
    and ints, so it survives JSON unchanged."""
    if not torch.cuda.is_available():
        return (CACHE_FORMAT_VERSION, "cpu", torch.__version__)
    major, minor = torch.cuda.get_device_capability(0)
    return (CACHE_FORMAT_VERSION, "cuda", torch.__version__,
            str(torch.version.cuda), kernel_build.toolkit_version(),
            _driver_version(), torch.cuda.get_device_name(0),
            f"sm_{major}{minor}", torch.cuda.device_count())


def _stable_token(obj) -> object:
    """Reduce a cache-key element to something ``repr``-stable across
    processes.  Primitives pass through; tuples recurse; a
    ``torch.device`` becomes its string; anything else falls back to
    repr."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, tuple):
        return tuple(_stable_token(o) for o in obj)
    if isinstance(obj, torch.device):
        return ("device", str(obj))
    return ("repr", repr(obj))


class PersistentExecutableCache(ExecutableCache):
    """Disk-backed ``ExecutableCache`` (see module docstring).

    Inherits single-flight semantics: a key being loaded or prepared by
    one thread is waited on by the others.  ``stats()`` gains
    ``disk_hits`` / ``disk_stores`` / ``disk_errors`` / ``disk_stale``.
    ``kernel_dir`` (``<cache_dir>/kernels``) is where every preparation
    through this cache builds and loads its kernel libraries.
    """

    def __init__(self, cache_dir: Union[str, Path], *,
                 on_event: Optional[Callable[[str, dict], None]] = None):
        super().__init__(on_event=on_event)
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.kernel_dir = self.cache_dir / "kernels"
        self.fingerprint = cache_fingerprint()
        self.disk_hits = 0     # launches made from a record, not prepared
        self.disk_stores = 0   # records written to disk
        self.disk_errors = 0   # corrupt/unwritable entries fallen back from
        self.disk_stale = 0    # fingerprint-drift entries quarantined

    # -- key → file --------------------------------------------------

    def _entry_path(self, key: tuple) -> Path:
        token = repr((self.fingerprint, _stable_token(key)))
        digest = hashlib.sha256(token.encode("utf-8")).hexdigest()
        return self.cache_dir / f"{digest[:32]}.exe"

    @staticmethod
    def _quarantine(path: Path, suffix: str) -> None:
        try:
            os.replace(path, path.with_suffix(suffix))
        except OSError:
            pass

    def _corrupt(self, path: Path) -> None:
        """Count a corrupt entry and move it aside as ``*.corrupt``."""
        with self._lock:
            self.disk_errors += 1
        self._quarantine(path, ".corrupt")
        self._emit("cache_disk_fallback", path=str(path))

    # -- disk read ---------------------------------------------------

    def _read_record(self, key: tuple) -> Optional[dict]:
        """The stored launch record for ``key``; None on any miss
        (absent, wrong fingerprint, corrupt — a corrupt file is
        quarantined as ``*.corrupt``, a drifted one as ``*.stale``)."""
        path = self._entry_path(key)
        try:
            blob = path.read_bytes()
        except FileNotFoundError:
            return None
        except OSError:
            with self._lock:
                self.disk_errors += 1
            return None
        try:
            entry = json.loads(blob.decode("utf-8"))
            if entry["fingerprint"] != list(self.fingerprint):
                # drifted environment under an unchanged path:
                # quarantine, never load, prepare fresh
                with self._lock:
                    self.disk_stale += 1
                self._quarantine(path, ".stale")
                self._emit("cache_disk_stale", path=str(path))
                return None
            if entry["format"] != CACHE_FORMAT_VERSION \
                    or entry["key"] != repr(_stable_token(key)):
                raise ValueError("entry is not this key's")
            record = entry["launch"]
            if not isinstance(record, dict):
                raise ValueError("no launch record")
            return record
        except Exception:              # noqa: BLE001 — any bad entry
            self._corrupt(path)
            return None

    def _load_entry(self, key: tuple) -> Optional[LayerLaunch]:
        """The launch of ``key`` made from its stored record, its
        libraries checked (and rebuilt if corrupt) in ``kernel_dir``;
        None on a miss.  A record that names no valid launch counts as
        a corrupt entry."""
        record = self._read_record(key)
        if record is None:
            return None
        try:
            return LayerLaunch.from_record(record, kernel_dir=self.kernel_dir)
        except (KeyError, TypeError, ValueError, AttributeError):
            self._corrupt(self._entry_path(key))
            return None

    # -- disk write --------------------------------------------------

    def _store_entry(self, key: tuple, exe: LayerLaunch) -> None:
        """Best-effort atomic persist; failures never surface."""
        try:
            blob = json.dumps({
                "format": CACHE_FORMAT_VERSION,
                "fingerprint": list(self.fingerprint),
                "key": repr(_stable_token(key)),
                "launch": exe.record(),
            }, sort_keys=True).encode("utf-8")
            path = self._entry_path(key)
            tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
            with open(tmp, "wb") as fh:
                fh.write(blob)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            _fsync_dir(path.parent)
        except Exception:              # noqa: BLE001 — accelerator only
            with self._lock:
                self.disk_errors += 1
            self._emit("cache_disk_store_failed", key=repr(key)[:160])
            return
        with self._lock:
            self.disk_stores += 1
        self._emit("cache_disk_store", path=str(path), bytes=len(blob))

    # -- the ExecutableCache production seam -------------------------

    def _produce(self, key: tuple, build: Callable[[], object]
                 ) -> Tuple[object, bool]:
        exe = self._load_entry(key)
        if exe is not None:
            with self._lock:
                self.disk_hits += 1
            self._emit("cache_disk_hit", key=repr(key)[:160])
            return exe, False
        exe, compiled = super()._produce(key, build)
        if isinstance(exe, LayerLaunch):
            self._store_entry(key, exe)
        return exe, compiled

    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            out.update({"disk_hits": self.disk_hits,
                        "disk_stores": self.disk_stores,
                        "disk_errors": self.disk_errors,
                        "disk_stale": self.disk_stale})
        return out
