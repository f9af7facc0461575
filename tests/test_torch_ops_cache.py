"""The port's ``ops.PersistentExecutableCache`` and the kernel library
directory under it, on the CPU: the single-flight ``ExecutableCache``
and its ``_produce`` seam, a warm restart that prepares nothing, a
fingerprint mismatch as a miss, drift at the same path quarantined as
``*.stale``, a corrupt entry as ``*.corrupt``, two caches sharing one
directory, the entry format, the counts of the reference's cache on the
same plan, ``LayerLaunch`` records, the block's own kernel libraries,
and ``kernels.build``'s toolkit hash, hashed library files and one
binding per kernel per process (with the compiler and the loader
replaced: there is no ``nvcc`` here)."""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro.core import cnn as ref_cnn
from repro.core import deploy as ref_deploy
from repro.runtime import CompiledCNN as RefCompiledCNN
from repro_torch import convert
from repro_torch.blocks import get_block
from repro_torch.core import deploy
from repro_torch.core.cnn import ConvLayerSpec
from repro_torch.kernels import build
from repro_torch.ops import (CACHE_FORMAT_VERSION, PersistentExecutableCache,
                             cache_fingerprint)
from repro_torch.runtime import CompiledCNN, ExecutableCache
from repro_torch.runtime.compiled import LayerLaunch

ROOT = Path(__file__).resolve().parents[1]


def _ref_cfg():
    return ref_cnn.CNNConfig(layers=(
        ref_cnn.ConvLayerSpec(1, 4, data_bits=8, coeff_bits=6,
                              block="conv4"),
        ref_cnn.ConvLayerSpec(4, 3, data_bits=6, coeff_bits=4,
                              block="conv3"),
    ), img_h=16, img_w=64)


@pytest.fixture(scope="module")
def ref_plan():
    return ref_deploy.plan_deployment(_ref_cfg(),
                                      ref_cnn.fitted_block_models(),
                                      target=0.8, on_infeasible="fallback")


@pytest.fixture(scope="module")
def plan(ref_plan):
    return deploy.DeploymentPlan.from_json(ref_plan.to_json())


def _compiled(plan, cache, max_batch=2):
    return CompiledCNN.from_plan(plan, max_batch=max_batch, device="cpu",
                                 exec_cache=cache)


# ---------------------------------------------------------------------------
# single flight (in-memory tier) and the _produce seam
# ---------------------------------------------------------------------------

def test_single_flight_counting_build():
    """Threads racing one missing key call the build once; the losers
    wait and reuse it (``coalesced`` counts them)."""
    cache = ExecutableCache()
    calls = []
    building = threading.Event()
    release = threading.Event()

    def make():
        calls.append(1)
        building.set()
        release.wait(timeout=10)
        return "launch"

    results = []

    def racer():
        results.append(cache.get_or_build(("k",), make))

    winner = threading.Thread(target=racer)
    winner.start()
    assert building.wait(timeout=10)
    losers = [threading.Thread(target=racer) for _ in range(4)]
    for t in losers:
        t.start()
    deadline = time.monotonic() + 10
    while cache.stats()["coalesced"] < 4:
        assert time.monotonic() < deadline, "losers never coalesced"
        time.sleep(0.005)
    release.set()
    for t in [winner] + losers:
        t.join(timeout=10)
    assert results == ["launch"] * 5 and len(calls) == 1
    assert cache.stats()["compiles"] == 1


def test_failed_build_releases_waiters():
    cache = ExecutableCache()
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("first build dies")
        return "ok"

    with pytest.raises(RuntimeError, match="first build dies"):
        cache.get_or_build(("k",), flaky)
    assert cache.get_or_build(("k",), flaky) == "ok"
    assert len(attempts) == 2 and ("k",) in cache


def test_produce_seam_counts_only_live_productions():
    """A subclass's ``_produce`` that loads instead of building
    (``compiled`` False) adds an entry without a compile."""
    class Loading(ExecutableCache):
        def _produce(self, key, make):
            if key[0] == "disk":
                return "loaded", False
            return super()._produce(key, make)

    cache = Loading()
    seen = []
    cache.on_event = lambda ev, fields: seen.append(ev)
    assert cache.get_or_build(("disk",), lambda: 1 / 0) == "loaded"
    assert cache.get_or_build(("live",), lambda: "built") == "built"
    assert cache.stats() == {"executables": 2, "compiles": 1, "hits": 0,
                             "coalesced": 0}
    assert seen == ["cache_compile"]
    # observer exceptions never reach the caller
    cache.on_event = lambda ev, fields: 1 / 0
    assert cache.get_or_build(("live2",), lambda: "y") == "y"


# ---------------------------------------------------------------------------
# the persistent tier
# ---------------------------------------------------------------------------

def test_warm_restart_prepares_nothing(tmp_path, plan):
    cold_cache = PersistentExecutableCache(tmp_path)
    cold = _compiled(plan, cold_cache)
    layers = len(cold.buckets) * cold.num_layers
    assert cold.compiles == layers
    assert cold_cache.stats()["disk_stores"] == layers
    assert cold_cache.stats()["disk_hits"] == 0

    warm_cache = PersistentExecutableCache(tmp_path)   # a new process
    warm = _compiled(plan, warm_cache)
    s = warm_cache.stats()
    assert warm.compiles == 0 and s["compiles"] == 0
    assert s["disk_hits"] == layers and warm.warmed_up
    x = np.stack(cold.sample_inputs(2, seed=3))
    assert torch.equal(cold(x), warm(x))


def test_warm_restart_counts_equal_the_reference(tmp_path, plan, ref_plan):
    """The same plan through both packages' persistent caches, cold
    then warm: the same compiles, stores and disk hits; and the port's
    launches made from disk, under the reference's weights, give the
    reference's outputs."""
    keys = ("compiles", "disk_stores", "disk_hits")

    def cold_then_warm(make_cache, compile_, d):
        cold = make_cache(d)
        compile_(cold)
        warm = make_cache(d)
        model = compile_(warm)
        return model, [{k: c.stats()[k] for k in keys} for c in (cold, warm)]

    ref_model, ref_counts = cold_then_warm(
        ref_ops.PersistentExecutableCache,
        lambda c: RefCompiledCNN.from_plan(ref_plan, max_batch=2,
                                           exec_cache=c), tmp_path / "ref")
    _, port_counts = cold_then_warm(
        PersistentExecutableCache, lambda c: _compiled(plan, c),
        tmp_path / "port")
    assert port_counts == ref_counts
    assert port_counts[1]["compiles"] == 0
    weights = [np.asarray(w) for w in ref_model.params]
    warm = PersistentExecutableCache(tmp_path / "port")
    port = CompiledCNN.from_plan(
        plan, max_batch=2, device="cpu", exec_cache=warm,
        params=convert.params_from_numpy(weights, deploy.plan_config(plan),
                                         "cpu"))
    assert warm.stats()["compiles"] == 0
    x = np.stack(port.sample_inputs(2, seed=5))
    assert np.array_equal(port(x).numpy(), np.asarray(ref_model(x)))


def test_fingerprint_mismatch_is_a_miss(tmp_path, plan):
    cold = PersistentExecutableCache(tmp_path)
    _compiled(plan, cold, max_batch=1)
    assert cold.stats()["disk_stores"] > 0
    alien = PersistentExecutableCache(tmp_path)
    alien.fingerprint = (CACHE_FORMAT_VERSION, "cuda", "other torch")
    model = _compiled(plan, alien, max_batch=1)
    s = alien.stats()
    assert s["disk_hits"] == 0 and model.compiles > 0
    assert s["disk_stale"] == 0 and s["disk_errors"] == 0


def test_fingerprint_drift_at_the_same_path_is_stale(tmp_path, plan):
    """The embedded fingerprint is the authority: an entry whose
    fingerprint drifted under an unchanged path is moved aside as
    ``*.stale`` and re-prepared — its record is never made into a
    launch (it is poisoned here, so any attempt would raise)."""
    cold = PersistentExecutableCache(tmp_path)
    _compiled(plan, cold, max_batch=1)
    entries = sorted(tmp_path.glob("*.exe"))
    assert entries
    for p in entries:
        entry = json.loads(p.read_text())
        entry["fingerprint"] = [CACHE_FORMAT_VERSION, "cuda", "drifted"]
        entry["launch"] = {"block": "no such block"}
        p.write_text(json.dumps(entry))
    events = []
    warm = PersistentExecutableCache(tmp_path)
    warm.on_event = lambda ev, fields: events.append(ev)
    model = _compiled(plan, warm, max_batch=1)
    s = warm.stats()
    assert model.compiles == len(entries) and s["disk_hits"] == 0
    assert s["disk_stale"] == len(entries) and s["disk_errors"] == 0
    assert "cache_disk_stale" in events
    stale = sorted(tmp_path.glob("*.stale"))
    assert len(stale) == len(entries)
    assert json.loads(stale[0].read_text())["fingerprint"][2] == "drifted"
    assert s["disk_stores"] == model.compiles    # fresh entries stored


@pytest.mark.parametrize("garbage", [
    b"garbage that is not JSON",
    b'{"format": 1}',
    "bad record", "bad device"])
def test_corrupt_entry_is_quarantined_and_re_prepared(tmp_path, plan,
                                                      garbage):
    cold = PersistentExecutableCache(tmp_path)
    _compiled(plan, cold, max_batch=1)
    entries = sorted(tmp_path.glob("*.exe"))
    for p in entries:
        if garbage in ("bad record", "bad device"):   # names no launch
            entry = json.loads(p.read_text())
            if garbage == "bad record":
                entry["launch"]["block"] = "conv9"
            else:
                entry["launch"]["device"] = "tpu:0"
            p.write_text(json.dumps(entry))
        else:
            p.write_bytes(garbage)
    events = []
    warm = PersistentExecutableCache(tmp_path)
    warm.on_event = lambda ev, fields: events.append(ev)
    model = _compiled(plan, warm, max_batch=1)
    s = warm.stats()
    assert model.compiles == len(entries) and s["disk_hits"] == 0
    assert s["disk_errors"] == len(entries)
    assert "cache_disk_fallback" in events
    assert len(list(tmp_path.glob("*.corrupt"))) == len(entries)
    assert s["disk_stores"] == model.compiles
    assert len(list(tmp_path.glob("*.exe"))) == len(entries)


def test_two_caches_share_one_directory(tmp_path, plan):
    """Content addressing: a second cache over the same directory (a
    second worker, or a second plan whose layers coincide) makes every
    launch from the first one's records."""
    a = PersistentExecutableCache(tmp_path)
    model_a = _compiled(plan, a)
    b = PersistentExecutableCache(tmp_path)
    model_b = _compiled(plan, b)
    assert model_b.compiles == 0
    assert b.stats()["disk_hits"] == a.stats()["disk_stores"] > 0
    assert b.kernel_dir == a.kernel_dir == tmp_path / "kernels"
    x = np.stack(model_a.sample_inputs(2, seed=1))
    assert torch.equal(model_a(x), model_b(x))


def test_entry_format(tmp_path, plan):
    cache = PersistentExecutableCache(tmp_path)
    model = _compiled(plan, cache, max_batch=1)
    entry = json.loads(sorted(tmp_path.glob("*.exe"))[0].read_text())
    assert set(entry) == {"format", "fingerprint", "key", "launch"}
    assert entry["format"] == CACHE_FORMAT_VERSION
    assert entry["fingerprint"] == list(cache_fingerprint())
    assert cache_fingerprint() == (CACHE_FORMAT_VERSION, "cpu",
                                   torch.__version__)
    launch = entry["launch"]
    assert set(launch) == {"block", "spec", "in_shape", "in_dtype",
                           "device", "libraries"}
    assert launch["device"] == "cpu" and launch["libraries"] == []
    keys = {repr(tuple(("device", "cpu") if isinstance(k, torch.device)
                       else k for k in model._layer_key(i, 1)))
            for i in range(model.num_layers)}
    assert entry["key"] in keys


def test_other_values_stay_in_memory(tmp_path):
    cache = PersistentExecutableCache(tmp_path)
    assert cache.get_or_build(("plain",), lambda: 42) == 42
    assert cache.stats()["disk_stores"] == 0
    assert not list(tmp_path.glob("*.exe"))


def test_unwritable_directory_is_counted_not_raised(tmp_path, plan,
                                                   monkeypatch):
    cache = PersistentExecutableCache(tmp_path)

    def refuse(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr("repro_torch.ops.cache.os.replace", refuse)
    model = _compiled(plan, cache, max_batch=1)
    s = cache.stats()
    assert s["disk_stores"] == 0 and s["disk_errors"] == model.compiles > 0


# ---------------------------------------------------------------------------
# LayerLaunch records and the block's own libraries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,d,c,libs", [
    ("conv1", 8, 6, ("conv1_layer",)),
    ("conv2", 8, 6, ("fused_dot_layer",)),
    ("conv4", 6, 4, ("fused_dot_layer",)),
    ("conv3", 6, 4, ("packed_dot_layer",)),      # d + c = 10: packed
    ("conv3", 8, 4, ("packed_dot_layer",)),      # 12: the boundary
    ("conv3", 8, 6, ("fused_dot_layer",)),       # 14: two dots
])
def test_a_card_launch_prepares_only_its_block_kernels(monkeypatch, block,
                                                       d, c, libs):
    """Preparing a launch for the card builds and binds the libraries
    its block's layer launches — K1 for conv2, conv4 and unpacked
    conv3, K2 for packed conv3, K3 for conv1 — in the cache's kernel
    directory, and nothing else; on the CPU it prepares none."""
    prepared = []
    monkeypatch.setattr(build, "prepare",
                        lambda names, directory=None:
                        prepared.append((tuple(names), directory)))
    spec = ConvLayerSpec(4, 2, data_bits=d, coeff_bits=c, block=block)
    assert get_block(block).serving_kernels(d, c) == libs
    kdir = Path("/cache/kernels")
    launch = LayerLaunch(get_block(block), spec, (2, 8, 8, 4), torch.int8,
                         torch.device("cuda", 0), kernel_dir=kdir)
    assert prepared == [(libs, kdir)] and launch.libraries == libs
    rec = json.loads(json.dumps(launch.record()))
    assert rec["libraries"] == list(libs) and rec["device"] == "cuda:0"
    again = LayerLaunch.from_record(rec, kernel_dir=kdir)
    assert prepared[-1] == (libs, kdir)
    assert again.record() == launch.record()
    cpu = LayerLaunch(get_block(block), spec, (2, 8, 8, 4), torch.int8,
                      torch.device("cpu"))
    assert cpu.libraries == () and len(prepared) == 2


def test_record_round_trip_on_the_cpu(plan):
    model = _compiled(plan, ExecutableCache(), max_batch=2)
    x = torch.from_numpy(np.stack(model.sample_inputs(2, seed=4)))
    for i in range(model.num_layers):
        launch = model._compile_layer(i, 2)
        again = LayerLaunch.from_record(json.loads(json.dumps(
            launch.record())))
        assert again.record() == launch.record()
        assert torch.equal(again(model.params[i], x),
                           launch(model.params[i], x))
        x = launch(model.params[i], x)
    with pytest.raises(ValueError, match="libraries"):
        rec = launch.record()
        rec["libraries"] = ["conv1_layer"]
        LayerLaunch.from_record(rec)


# ---------------------------------------------------------------------------
# kernels.build: toolkit hash, hashed files, one binding per kernel
# ---------------------------------------------------------------------------

def test_library_name_hashes_the_toolkit(monkeypatch):
    """A new CUDA toolkit gets a new library name for every kernel, so
    a library an older ``nvcc`` built is never loaded."""
    monkeypatch.setattr(build, "toolkit_version",
                        lambda: "Build cuda_12.4.r12.4/compiler.0")
    old = {k: build.library_path(k) for k in build.KERNELS}
    monkeypatch.setattr(build, "toolkit_version",
                        lambda: "Build cuda_12.8.r12.8/compiler.0")
    new = {k: build.library_path(k) for k in build.KERNELS}
    for k in build.KERNELS:
        assert old[k] != new[k] and old[k].parent == new[k].parent
        assert new[k].name.startswith(k + "-")
    assert build.library_path("conv1_layer", "/x") \
        == Path("/x") / new["conv1_layer"].name


def test_the_toolkit_is_not_read_at_import():
    """Importing every module of the port runs no ``nvcc``: the
    toolkit's version is read at the first library name, once."""
    code = ("import pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from repro_torch.kernels import build\n"
            "print(build.toolkit_version.cache_info().currsize, "
            "build.nvcc_runs)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["0", "0"]


@pytest.fixture
def fake_toolchain(monkeypatch):
    """``build.build`` writes a fake library and its hash, counting
    compiler runs; ``_bind`` records the path instead of loading it;
    the process's bindings start empty."""
    runs = []

    def fake_build(names, directory=None):
        for n in names:
            path = build.library_path(n, directory)
            if path.exists():
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            runs.append(n)
            build.nvcc_runs += 1
            path.write_bytes(f"library {n} #{len(runs)}".encode())
            build._digest_path(path).write_text(build._file_digest(path))
        return {n: "" for n in names}

    def fake_bind(name, path):
        if path.read_bytes().startswith(b"\x00"):
            raise OSError(f"{path}: invalid ELF header")
        build._libs[name] = object()
        build._bound_paths[name] = path

    monkeypatch.setattr(build, "toolkit_version", lambda: "fake toolkit")
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "_bind", fake_bind)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_bound_paths", {})
    monkeypatch.setattr(build, "nvcc_runs", 0)
    return runs


def test_prepare_builds_binds_once_and_records_the_path(tmp_path,
                                                        fake_toolchain):
    kdir = tmp_path / "kernels"
    paths = build.prepare(("fused_dot_layer", "conv1_layer"), kdir)
    assert fake_toolchain == ["fused_dot_layer", "conv1_layer"]
    assert build.bound_paths() == paths
    assert all(build.verified(n, kdir) for n in paths)
    # another directory: built there too, but the binding stays
    other = tmp_path / "other"
    build.prepare(("fused_dot_layer",), other)
    assert build.library_path("fused_dot_layer", other).exists()
    assert build.bound_paths()["fused_dot_layer"] == paths["fused_dot_layer"]
    # a warm directory: nothing built, nothing new bound
    runs = build.nvcc_runs
    build.prepare(("fused_dot_layer", "conv1_layer"), kdir)
    assert build.nvcc_runs == runs == 3


@pytest.mark.parametrize("damage", ["bytes", "hash", "unloadable"])
def test_a_corrupt_library_is_quarantined_and_rebuilt(tmp_path,
                                                      fake_toolchain,
                                                      damage):
    """A library whose bytes do not match the hash beside it, or that
    fails to load, is moved aside as ``*.corrupt`` and built again —
    never loaded, never skipped."""
    kdir = tmp_path / "kernels"
    build.build(("packed_dot_layer",), kdir)
    lib = build.library_path("packed_dot_layer", kdir)
    if damage == "bytes":
        lib.write_bytes(b"garbage")
    elif damage == "hash":
        build._digest_path(lib).write_text("0" * 64)
    else:                              # the hash matches, the loader fails
        lib.write_bytes(b"\x00not ELF")
        build._digest_path(lib).write_text(build._file_digest(lib))
    before = lib.read_bytes()
    build.prepare(("packed_dot_layer",), kdir)
    assert fake_toolchain == ["packed_dot_layer"] * 2
    assert lib.with_name(lib.name + ".corrupt").read_bytes() == before
    assert build.verified("packed_dot_layer", kdir)
    assert build.bound_paths()["packed_dot_layer"] == lib
    assert lib.read_bytes() != before
