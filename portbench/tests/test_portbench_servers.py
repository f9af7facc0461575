"""Servers beside the gateway, on the CPU at test sizes: a cell whose
kind names a server, and whose traffic kind and metric exist only as new
files, runs correct through ``run_cell``; the engine server counts
tokens when they are emitted, keeps the program's own logits rows for
the checked requests, and a noisy ``decode_step`` fails the check."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import catalog, harness
from portbench.tests.tiny import make_root
from portbench.yardstick import readings

harness.import_port()

from repro_torch.models.registry import Model  # noqa: E402

SEED = 2 ** 31 + 977
ADDED = Path(__file__).resolve().parent / "added"
LM_CELL = "tiny-moe-lm-closed2"
#: short enough that no request of 300 tokens finishes inside it
LM_WINDOW_S = 0.2
TINY_LM = {"name": "tiny-moe-lm", "kind": "tiny-moe-lm", "n_layers": 2,
           "d_model": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 8,
           "vocab_size": 97, "num_experts": 8, "top_k": 2, "d_ff_expert": 16,
           "dtype": "float32", "prompt_lengths": [5, 8], "pool": 8,
           "limits": {"logit_gap": 1e-4}}


def _add(root: Path, *names: str) -> None:
    """Files of ``added/`` copied to the same place under portbench/."""
    for name in names:
        shutil.copy(ADDED / name, root / "portbench" / name)


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def test_cell_with_a_server_added_as_files_runs_correct(tmp_path):
    """A server, a kind, a configuration, a traffic kind, a cell and a
    metric that exist only as new files and new BENCHMARK.json entries,
    in a root of their own: the CNN's plan called directly, without the
    gateway."""
    root = make_root(tmp_path)
    pb = root / "portbench"
    _add(root, "servers/direct-test.py", "kinds/cnn-direct-test.py")
    config = catalog.config("quickstart-cnn", root)
    config.update(name="quickstart-cnn-direct-test", kind="cnn-direct-test")
    _write(pb / "configs" / "quickstart-cnn-direct-test.json", config)
    (pb / "traffic" / "closed-one.py").write_text(
        (pb / "traffic" / "closed.py").read_text())
    (pb / "metrics" / "answered.direct-test.py").write_text(
        "def read(run):\n    return float((run.status == 'done').sum())\n")
    _write(pb / "cells" / "cnn-direct-test.json", {
        "name": "cnn-direct-test", "config": "quickstart-cnn-direct-test",
        "traffic": {"kind": "closed-one", "clients": 1},
        "check": {"keep_run": 1, "keep_every": 2, "compare": 8},
        "why": "a test-only cell"})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "quickstart-cnn-direct-test",
        "source": "https://arxiv.org/abs/2510.15930",
        "file": "portbench/configs/quickstart-cnn-direct-test.json",
        "reduced": [], "why": "the paper's CNN"})
    bench["workloads"].append({"name": "cnn-direct-test",
                               "config": "quickstart-cnn-direct-test",
                               "traffic": "closed-one-1", "chips": 1,
                               "why": "a test-only cell"})
    bench["end_to_end"].append({
        "name": "images_per_s", "unit": "images/s", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["cnn-direct-test"]})
    bench["per_layer"].append({
        "name": "answered.direct-test", "unit": "requests",
        "better": "higher", "source": "host_clock",
        "layer": "load generator on the event loop", "moves": "images_per_s",
        "workloads": ["cnn-direct-test"]})
    _write(root / "BENCHMARK.json", bench)
    out = harness.run_cell("cnn-direct-test", SEED, 1.0, device="cpu",
                           root=root)
    assert out.correct, out.checks
    assert out.checks["compared"] > 0 and out.failed == 0
    assert type(out.data) is harness.RunData
    listed = catalog.benchmark(root)
    names = [n for trace in (False, True)
             for n in catalog.metrics_for(listed, "cnn-direct-test", trace)]
    assert names == ["setup_s", "images_per_s", "answered.direct-test"]
    for name in names:
        assert catalog.module("metrics", name, root).read(out.data) > 0


@pytest.fixture(scope="module")
def lm_root(tmp_path_factory):
    """The tiny MoE LM's kind, configuration and cell added as files:
    two closed clients, prompts of 5 and 8 tokens, 300 new tokens each,
    every answer kept."""
    root = make_root(tmp_path_factory.mktemp("lm"))
    _add(root, "kinds/tiny-moe-lm.py")
    pb = root / "portbench"
    _write(pb / "configs" / "tiny-moe-lm.json", TINY_LM)
    _write(pb / "cells" / f"{LM_CELL}.json", {
        "name": LM_CELL, "config": "tiny-moe-lm",
        "traffic": {"kind": "closed", "clients": 2},
        "engine": {"max_batch": 2, "max_len": 320, "max_new_tokens": 300},
        "check": {"keep_run": 1, "keep_every": 1, "compare": 6},
        "why": "a test-only cell"})
    return root


@pytest.fixture(scope="module")
def lm_run(lm_root):
    """One sound run of the tiny LM cell: its outcome, the recorder the
    check was handed, and every logits tensor the program's
    ``decode_step`` returned."""
    returned, handed = [], {}
    decode_step, check = Model.decode_step, harness.Bench.check

    def spy_decode(self, params, cache, token, pos):
        logits, cache = decode_step(self, params, cache, token, pos)
        returned.append(logits.detach().clone())
        return logits, cache

    def spy_check(self, rec, data, **kw):
        handed["rec"] = rec
        return check(self, rec, data, **kw)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(Model, "decode_step", spy_decode)
        m.setattr(harness.Bench, "check", spy_check)
        out = harness.run_cell(LM_CELL, SEED, LM_WINDOW_S, device="cpu",
                               root=lm_root)
    return out, handed["rec"], returned


def test_engine_counts_tokens_when_they_are_emitted(lm_run):
    """No request finishes inside the window, and ``tokens_per_s`` is
    the tokens emitted in it over its seconds; over the whole run every
    token is emitted once: a prefill's one and each decode step's one a
    live slot."""
    out, _, _ = lm_run
    data = out.data
    assert out.correct, out.checks
    assert not data.completed(data.seconds).any()
    inside = int(data.emitted_units[data.emitted_t < data.seconds].sum())
    assert inside > 0
    tokens_per_s = catalog.module("metrics", "tokens_per_s").read(data)
    assert tokens_per_s == readings.rate_per_s(data) == inside / data.seconds
    done = int(np.sum(data.status == "done"))
    assert done == len(data.status) and done >= 2
    assert data.emitted_units.sum() == 300 * done \
        == len(data.prefills) + data.steps[:, 2].sum()
    assert len(data.prefills) == done
    assert readings.mfu_pct(data, 1e12) == pytest.approx(
        100.0 * inside / data.seconds * data.ops_per_unit / 1e12)


def test_engine_keeps_the_programs_own_logits(lm_run):
    """Each kept answer holds, for every served token, the logits row it
    was sampled from (greedy: its argmax), and each decoded token's row
    is one the program's ``decode_step`` returned, bit for bit."""
    out, rec, returned = lm_run
    assert sorted(rec.answers) == sorted(
        i for i, s in enumerate(out.data.status) if s == "done")
    rows = torch.cat(returned)
    for a in rec.answers.values():
        assert a.logits.shape == (300, TINY_LM["vocab_size"])
        assert a.logits.argmax(-1).tolist() == a.tokens
        for k in (1, 150, 299):
            assert (rows == a.logits[k]).all(-1).any(), k


def test_engine_noisy_decode_fails_the_check(lm_root, monkeypatch):
    """Noise added to the logits of every ``decode_step`` of the timed
    path: the kept rows carry it, and the check fails."""
    decode_step = Model.decode_step

    def noisy(self, params, cache, token, pos):
        logits, cache = decode_step(self, params, cache, token, pos)
        return logits + 1e-2 * logits.abs().max() \
            * torch.randn_like(logits), cache
    monkeypatch.setattr(Model, "decode_step", noisy)
    out = harness.run_cell(LM_CELL, SEED, LM_WINDOW_S, device="cpu",
                           root=lm_root)
    assert out.checks["compared"] > 0 and not out.correct, out.checks
