"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in
``build/repro_torch/`` at the root of the checkout, named by a hash of
the kernel's sources and the flags, so an edited source rebuilds and an
unchanged one is reused.  A build writes to a temporary name and
``os.replace``s it into place, so parallel processes never see a torn
library.

Every C entry ``repro_<name>`` launches on the stream it is given and
returns ``cudaGetLastError()``; ``check`` raises on anything but 0.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence

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

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Callable[..., int]] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``PATH`` first, then the toolkit's
    default location)."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives for the current
    sources and flags."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Build every missing library of ``names``, one ``nvcc`` each, all
    started together.  Returns each kernel's ``-Xptxas -v`` report
    (read back from the build log when the library already existed).
    Raises with the compiler's output if a build fails."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    procs = []
    try:
        for n in todo:
            out = library_path(n)
            tmp = out.with_name(f".{out.name}.{os.getpid()}."
                                f"{threading.get_ident()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for n, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
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
        log = library_path(n).with_suffix(".log")
        reports[n] = log.read_text() if log.exists() else ""
    return reports


def library_of(entry: str) -> str:
    """The kernel library that holds the C entry ``repro_<entry>``."""
    return ENTRIES.get(entry, entry)


def kernel(entry: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry ``repro_<entry>``, building and loading its library
    at first use.  A loaded entry is returned without taking the lock
    (a dict read is atomic, and an entry is stored only once bound)."""
    fn = _entries.get(entry)
    if fn is not None:
        return fn
    with _lock:
        fn = _entries.get(entry)
        if fn is None:
            name = library_of(entry)
            lib = _libs.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build((name,))
                lib = ctypes.CDLL(str(path))
                lib.repro_error_string.argtypes = [ctypes.c_int]
                lib.repro_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
            fn = getattr(lib, f"repro_{entry}")
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
