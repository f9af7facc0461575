"""Whole runs of the harness on the CPU at test sizes (``tiny.py``): every
cell proves correct, a broken timed path does not, a cell and a metric
added as files alone are found by name, and nothing loads JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import catalog, harness
from portbench.tests.tiny import make_root

harness.import_port()

SEED = 2 ** 31 + 977
#: every cell file, the CNN's, which BENCHMARK.json does not list, among
#: them
CELLS = sorted(p.stem for p in (catalog.ROOT / "portbench" / "cells")
               .glob("*.json"))
#: the metrics of the unlisted CNN cell, whose readers are kept with it
UNLISTED = {"cnn-closed64": ["images_per_s", "gateway_overhead_ms.cnn",
                             "forward_ms.cnn", "k1_roofline", "mfu.cnn",
                             "idle_share.cnn"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench"))


def _run(root, cell, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, device="cpu", root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(root, cell):
    out = _run(root, cell)
    assert out.correct, out.checks
    assert out.checks["compared"] > 0 and out.failed == 0
    bench = catalog.benchmark(root)
    names = UNLISTED.get(cell, []) + [
        n for trace in (False, True)
        for n in catalog.metrics_for(bench, cell, trace)]
    assert "setup_s" in names and len(names) > 1
    for name in names:
        value = catalog.module("metrics", name, root).read(out.data)
        if name.startswith(("k1_", "expert_", "idle_")):
            assert value is None            # no device trace on the CPU
        else:
            assert value is not None and np.isfinite(value) \
                and value > 0, name


def _alter_answers(monkeypatch):
    """The timed path's answers each altered where they are produced:
    one value of every answer moved by one step."""
    from repro_torch.runtime.compiled import CompiledModel
    orig = CompiledModel.__call__

    def broken(self, x, **kw):
        y = orig(self, x, **kw).clone()
        y[..., 0, 0] += 1
        return y
    monkeypatch.setattr(CompiledModel, "__call__", broken)


def _skip_layers(monkeypatch):
    """Every MoE layer returns its input unchanged."""
    from repro_torch.runtime.workloads import CompiledMoE
    monkeypatch.setattr(CompiledMoE, "_prepare_layer",
                        lambda self, i, bucket: (lambda p, x: x))


def _drop_half(monkeypatch):
    """Half of every batch left out: its second half answered with
    copies of the first half's answers."""
    from repro_torch.runtime.compiled import CompiledModel
    orig = CompiledModel.__call__

    def broken(self, x, **kw):
        y = orig(self, x, **kw).clone()
        half = (y.shape[0] + 1) // 2
        if y.shape[0] > 1:
            y[half:] = y[:y.shape[0] - half]
        return y
    monkeypatch.setattr(CompiledModel, "__call__", broken)


@pytest.mark.parametrize("cell, fault", [
    ("cnn-closed64", _alter_answers), ("moe-closed64", _alter_answers),
    ("moe-closed64", _skip_layers), ("moe-closed64", _drop_half),
    ("cnn-closed64", _drop_half)])
def test_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(root, cell)
    assert not out.correct, out.checks


@pytest.fixture(scope="module")
def own_root(tmp_path_factory):
    """The tiny sizes under every cell's own traffic and check."""
    return make_root(tmp_path_factory.mktemp("own"), shrink_cells=False)


def _served_checks(bench, lead: int) -> dict:
    """The cell's own check over requests served in admission order, a
    first dispatch of ``lead`` and full ones after it (as the gateway
    serves a closed loop), each dispatch that holds a kept answer run
    through the program's compiled entry."""
    cell, seed = bench.cell, bench.seed
    chk, full = cell["check"], cell["gateway"]["max_batch"]
    n = 4 * chk["keep_run"] * chk["keep_every"]
    order = bench.traffic.plan(cell["traffic"], seed, 1.0,
                               len(bench.system.pool))["order"]
    payload = [int(order[i % len(order)]) for i in range(n)]
    starts = [0] + list(range(lead, n, full))
    dispatches = [list(range(a, min(a + full if a else lead, n)))
                  for a in starts]
    keep = harness._keep_fn(chk, seed)
    compiled = bench.gw.plans[bench.plan_id].compiled
    answers = {}
    for d in dispatches:
        if any(keep(i) for i in d):
            y = compiled(bench.system.pool[[payload[i] for i in d]])
            answers.update((i, y[k].cpu().numpy())
                           for k, i in enumerate(d) if keep(i))
    with torch.no_grad():
        return bench.system.check(answers, payload, dispatches,
                                  np.random.default_rng([seed, 3]),
                                  chk["compare"])


@pytest.mark.parametrize("seed", [SEED, 5, 2 ** 31 + 60_013])
@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_left_out_fails_the_cells_own_check(own_root, monkeypatch,
                                                       cell, seed):
    """Half of every batch left out, under the cell's own sample of kept
    answers (its check as committed, not the tiny runs' denser one) and
    full dispatches at two alignments: whichever slots the seed's sample
    lands on, the check that passes the sound program fails the
    broken one."""
    bench = harness.Bench(cell, seed, device="cpu", root=own_root)
    limits = bench.config["limits"]

    def correct(checks):
        return harness.Outcome(None, checks, limits, 0, 0, 0, "").correct
    for lead in (bench.cell["gateway"]["max_batch"], 5):
        with monkeypatch.context() as m:
            assert correct(_served_checks(bench, lead))
            _drop_half(m)
            checks = _served_checks(bench, lead)
            assert checks["compared"] > 0 and not correct(checks), checks


def test_cell_and_metric_added_as_files_are_found(root, tmp_path):
    """A cell, a traffic mix and a metric that exist only as new files and
    new BENCHMARK.json entries, in a root of their own; the CNN
    configuration and its throughput metric are listed by entries
    alone."""
    new = make_root(tmp_path)
    pb = new / "portbench"
    cell = json.loads((pb / "cells" / "cnn-closed64.json").read_text())
    cell.update(name="cnn-closed8-test", traffic={"kind": "closed-pairs",
                                                  "clients": 4})
    (pb / "cells" / "cnn-closed8-test.json").write_text(json.dumps(cell))
    (pb / "traffic" / "closed-pairs.py").write_text(
        (pb / "traffic" / "closed.py").read_text())
    (pb / "metrics" / "answered.test.py").write_text(
        "def read(run):\n    return float((run.status == 'done').sum())\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "quickstart-cnn", "source": "https://arxiv.org/abs/2510.15930",
        "file": "portbench/configs/quickstart-cnn.json", "reduced": [],
        "why": "the paper's CNN"})
    bench["end_to_end"].append({
        "name": "images_per_s", "unit": "images/s", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["cnn-closed8-test"]})
    bench["workloads"].append({"name": "cnn-closed8-test",
                               "config": "quickstart-cnn",
                               "traffic": "closed-pairs-4", "chips": 1,
                               "why": "a test-only cell"})
    bench["per_layer"].append({
        "name": "answered.test", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "load generator on the event loop",
        "moves": "images_per_s", "workloads": ["cnn-closed8-test"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(new, "cnn-closed8-test")
    assert out.correct
    listed = catalog.benchmark(new)
    assert catalog.metrics_for(listed, "cnn-closed8-test", False) == [
        "setup_s", "images_per_s"]
    assert catalog.metrics_for(listed, "cnn-closed8-test", True) == [
        "answered.test"]
    assert catalog.module("metrics", "answered.test", new).read(out.data) > 0


def test_no_jax_is_imported():
    """The runner, every configuration's kind, traffic kind, metric
    reader and reference, imported in a fresh process, load neither JAX
    nor the JAX package (top-level names compared whole: ``repro_torch``
    is the port)."""
    code = (
        "import sys; sys.path.insert(0, 'portbench')\n"
        "import run\n"
        "from portbench import catalog, harness\n"
        "harness.import_port()\n"
        "import portbench.reference.cnn, portbench.reference.moe\n"
        "import portbench.tools.calibrate\n"
        "b = catalog.benchmark()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    catalog.module('metrics', m['name'])\n"
        "for w in b['workloads']:\n"
        "    c = catalog.cell(w['name'])\n"
        "    catalog.module('traffic', c['traffic']['kind'])\n"
        "    catalog.module('kinds', catalog.config(c['config'])['kind'])\n"
        "import repro_torch.serve.async_engine, repro_torch.models.moe\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in run.FORBIDDEN))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(catalog.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _runner(cell):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=catalog.ROOT, capture_output=True, text=True, timeout=300)


def test_runner_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cell = catalog.benchmark()["workloads"][0]["name"]
    out = _runner(cell)
    assert out.returncode == 2 and out.stdout == ""
    assert f"{cell} needs 1 CUDA card" in out.stderr


def test_runner_refuses_an_unlisted_cell():
    out = _runner("no-such-cell")
    assert out.returncode == 2 and out.stdout == ""
    assert "lists no cell 'no-such-cell'" in out.stderr
