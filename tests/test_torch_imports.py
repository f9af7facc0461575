"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX, ``ml_dtypes`` or anything of the
reference package, and importing the port leaves them out of
``sys.modules``.  Importing builds
no kernel (the CPU tests import every module; nvcc runs only at first
use on the card)."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax_and_no_reference():
    """Every module, imported in a fresh process without nvcc on PATH:
    none loads JAX or the reference, and none builds a kernel."""
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env_path = str(ROOT / "src")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})


# the modules of each slice, which the import checks above must cover
SLICE_MODULES = (
    "repro_torch.kernels.conv2d", "repro_torch.blocks.base",
    "repro_torch.core.cnn", "repro_torch.core.deploy",
    "repro_torch.launch.serve",
    # slice 2: the per-plane path and the planner
    "repro_torch.configs.paper_conv", "repro_torch.core.census",
    "repro_torch.core.synth", "repro_torch.core.correlate",
    "repro_torch.core.polyfit", "repro_torch.core.allocate",
    # slice 3: the LM serving path
    "repro_torch.configs.base", "repro_torch.configs.llama3_2_3b",
    "repro_torch.configs.mamba2_1_3b", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.ssm",
    "repro_torch.models.transformer", "repro_torch.models.registry",
    "repro_torch.kernels.conv1d", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.serve.engine", "repro_torch.convert",
    # slice 8: the async gateway and the ops modules it reports into
    "repro_torch.serve.async_engine", "repro_torch.ops.tracker",
    "repro_torch.ops.store",
    # slice 9: the fleet, fault injection and durable state
    "repro_torch.ops.cache", "repro_torch.ops.root",
    "repro_torch.chaos.plan", "repro_torch.chaos.inject",
    "repro_torch.chaos.recovery", "repro_torch.fleet.health",
    "repro_torch.fleet.router", "repro_torch.fleet.worker",
    "repro_torch.fleet.fleet", "repro_torch.fleet.sim",
)


def test_import_checks_cover_every_slice_module():
    from repro_torch.kernels import build
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    files = {str(p.relative_to(ROOT / "src"))[:-3].replace("/", ".")
             for p in _sources()[:-1]}
    for m in SLICE_MODULES:
        assert m in mods and m in files, m
    assert {"conv2_planes", "conv3_planes", "conv4_planes",
            "causal_conv1d", "flash_attention"} <= set(build.KERNELS)


def test_build_names_a_library_per_source_hash():
    from repro_torch.kernels import build
    paths = {k: build.library_path(k) for k in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    for k, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(k + "-")
        assert (build.CSRC / f"{k}.cu").exists()
    assert build.BUILD_DIR == ROOT / "build" / "repro_torch"
    with pytest.raises(KeyError, match="unknown kernel"):
        build.library_path("conv9_layer")


def test_bound_entry_is_returned_without_the_build_lock(monkeypatch):
    """A loaded entry comes back while another thread holds the build
    lock (the per-plane path looks its entry up once per plane)."""
    import threading
    from repro_torch.kernels import build
    bound = object()
    monkeypatch.setitem(build._entries, "conv4_planes", bound)
    got = []
    with build._lock:
        t = threading.Thread(
            target=lambda: got.append(build.kernel("conv4_planes", ())))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert got == [bound]
