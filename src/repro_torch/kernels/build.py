"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in a build
directory, ``build/repro_torch/`` at the root of the checkout unless a
caller names another (the persistent executable cache keeps its own
under ``<cache_dir>/kernels/``).  A library is named by a hash of the
kernel's sources, the flags and the CUDA toolkit (the last line of
``nvcc --version``), so an edited source or a new toolkit rebuilds and
an unchanged one is reused.  A build writes to a temporary name and
``os.replace``s it into place, so parallel processes never see a torn
library, and writes the library's sha256 beside it (``<lib>.sha256``):
``prepare`` loads a library only when its bytes match that hash, and
quarantines one that does not (or that fails to load) as
``<lib>.corrupt`` and builds it again.

A process binds each kernel's library once: the first ``prepare`` (or
the first ``kernel`` call, from ``BUILD_DIR``) loads it, and every
later call, whatever directory it names, launches that binding;
``bound_paths`` says where each came from.  ``nvcc_runs`` counts the
compiler runs this process started.

Every C entry ``repro_<name>`` launches on the stream it is given and
returns ``cudaGetLastError()``; ``check`` raises on anything but 0.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("conv1_layer", "fused_dot_layer", "packed_dot_layer",
           "conv2_planes", "conv3_planes", "conv4_planes", "causal_conv1d",
           "flash_attention")
# C entries beyond ``repro_<library>``, by the library that holds them
ENTRIES = {"fused_dot_layer_requant": "fused_dot_layer",
           "packed_dot_layer_requant": "packed_dot_layer"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PathLike = Union[str, Path]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound_paths: Dict[str, Path] = {}
_entries: Dict[str, Callable[..., int]] = {}
nvcc_runs = 0                  # compiler processes this process started


def nvcc() -> str:
    """Path of the CUDA compiler (``PATH`` first, then the toolkit's
    default location)."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


@functools.lru_cache(maxsize=1)
def toolkit_version() -> str:
    """The last line of ``nvcc --version`` (read once per process), or
    ``"no nvcc"`` where the toolkit is not installed."""
    try:
        exe = nvcc()
    except RuntimeError:
        return "no nvcc"
    out = subprocess.run([exe, "--version"], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    return out.strip().splitlines()[-1]


def library_path(name: str, directory: Optional[PathLike] = None) -> Path:
    """Where the library of kernel ``name`` lives in ``directory``
    (``BUILD_DIR`` by default) for the current sources, flags and
    toolkit."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(toolkit_version().encode())
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return Path(directory or BUILD_DIR) / f"{name}-{h.hexdigest()[:16]}.so"


def _digest_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".sha256")


def _file_digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def build(names: Iterable[str] = KERNELS,
          directory: Optional[PathLike] = None) -> Dict[str, str]:
    """Build every missing library of ``names`` into ``directory``
    (``BUILD_DIR`` by default), one ``nvcc`` each, all started together,
    each with its sha256 beside it.  Returns each kernel's ``-Xptxas
    -v`` report (read back from the build log when the library already
    existed).  Raises with the compiler's output if a build fails."""
    global nvcc_runs
    names = tuple(names)
    directory = Path(directory or BUILD_DIR)
    directory.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n, directory).exists()]
    procs = []
    try:
        for n in todo:
            out = library_path(n, directory)
            tmp = out.with_name(f".{out.name}.{os.getpid()}."
                                f"{threading.get_ident()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            nvcc_runs += 1
        failures = []
        for n, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            digest = _digest_path(out)
            digest_tmp = digest.with_name(f".{digest.name}.{os.getpid()}."
                                          f"{threading.get_ident()}.tmp")
            digest_tmp.write_text(_file_digest(tmp))
            os.replace(digest_tmp, digest)
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failures))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    reports = {}
    for n in names:
        log = library_path(n, directory).with_suffix(".log")
        reports[n] = log.read_text() if log.exists() else ""
    return reports


def verified(name: str, directory: Optional[PathLike] = None) -> bool:
    """Whether the library of ``name`` in ``directory`` exists and its
    bytes match the sha256 written beside it at build time."""
    path = library_path(name, directory)
    try:
        return _file_digest(path) == _digest_path(path).read_text().strip()
    except OSError:
        return False


def quarantine(name: str, directory: Optional[PathLike] = None) -> None:
    """Move the library of ``name`` in ``directory`` (and its hash)
    aside as ``*.corrupt``, so the next ``build`` makes it anew."""
    path = library_path(name, directory)
    for p in (path, _digest_path(path)):
        try:
            os.replace(p, p.with_name(p.name + ".corrupt"))
        except OSError:
            pass


def _bind(name: str, path: Path) -> None:
    """Load ``path`` as the process's library of ``name`` (under
    ``_lock``)."""
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    _bound_paths[name] = path


def prepare(names: Iterable[str], directory: Optional[PathLike] = None
            ) -> Dict[str, Path]:
    """Make every library of ``names`` present and intact in
    ``directory`` and bind the ones this process has not bound yet.
    A missing library is built there; one whose bytes do not match its
    hash, or that fails to load, is quarantined and built again — never
    skipped.  Returns the library paths in ``directory``."""
    names = tuple(names)
    paths = {n: library_path(n, directory) for n in names}
    with _lock:
        bad = [n for n in names
               if paths[n].exists() and not verified(n, directory)]
        for n in bad:
            quarantine(n, directory)
        build(names, directory)
        for n in names:
            if n in _libs:
                continue
            try:
                _bind(n, paths[n])
            except OSError:
                quarantine(n, directory)
                build((n,), directory)
                _bind(n, paths[n])
    return paths


def bound_paths() -> Dict[str, Path]:
    """The file each kernel library this process has bound was loaded
    from."""
    with _lock:
        return dict(_bound_paths)


def library_of(entry: str) -> str:
    """The kernel library that holds the C entry ``repro_<entry>``."""
    return ENTRIES.get(entry, entry)


def kernel(entry: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry ``repro_<entry>`` of the library this process bound,
    building and binding it from ``BUILD_DIR`` at first use if nothing
    bound it yet.  A loaded entry is returned without taking the lock
    (a dict read is atomic, and an entry is stored only once bound)."""
    fn = _entries.get(entry)
    if fn is not None:
        return fn
    name = library_of(entry)
    if name not in _libs:
        prepare((name,))
    with _lock:
        fn = _entries.get(entry)
        if fn is None:
            fn = getattr(_libs[name], f"repro_{entry}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entries[entry] = fn
        return fn


def check(entry: str, err: int) -> None:
    """Raise if a launch of ``repro_<entry>`` returned a CUDA error
    code."""
    if err:
        msg = _libs[library_of(entry)].repro_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err} "
                           f"({msg})")
