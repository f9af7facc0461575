"""The LM cell, ``qwen3moe-decode``, on the CPU at test sizes
(``sizes/lm.py``): its configuration builds the port's registered
Qwen3-30B-A3B exactly, its prompts and its operation count, a timed path
broken four ways and the float8 control each failing the cell's own
check, the engine readers' arithmetic, and the engine's spans on the
device trace's clock over synthetic events."""

import asyncio
import filecmp
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import catalog, harness
from portbench.tests.tiny import make_root
from portbench.yardstick import decode, engine_spans, spans
from portbench.yardstick import lm as work
from portbench.yardstick.trace import DeviceEvent

harness.import_port()

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models.registry import Model  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

CELL, CONFIG = "qwen3moe-decode", "qwen3-30b-a3b"
SEED = 2 ** 31 + 977
KIND = catalog.module("kinds", "lm")


def _system(config=None, seed=SEED):
    config = config or catalog.config(CONFIG)
    return KIND.System(config, seed, torch.device("cpu"),
                       catalog.config_dir())


def test_configuration_builds_the_registered_architecture():
    """The published values build exactly the port's registered
    ``qwen3-30b-a3b`` (nothing cut, ``reduced`` empty), and a
    configuration whose architecture lacks what it states is refused."""
    config = catalog.config(CONFIG)
    assert config["reduced"] == [] and config["arch"] == CONFIG
    entry = {c["name"]: c for c in catalog.benchmark()["configs"]}[CONFIG]
    assert entry["reduced"] == []
    assert _system(config).model_config() == get_config(CONFIG)
    with pytest.raises(ValueError, match="qk_norm"):
        _system(dict(config, arch="qwen3-moe-30b-a3b")).model_config()
    with pytest.raises(ValueError, match="tie_word_embeddings"):
        _system(dict(config, tie_word_embeddings=True))


def test_prompts_are_seeded_and_log_uniform_over_their_range():
    a, b, c = _system(), _system(), _system(seed=7)
    assert a.pool == b.pool and a.pool != c.pool
    lengths = [len(p) for p in a.pool]
    assert len(lengths) == 32 and 512 <= min(lengths) \
        and max(lengths) <= 2048
    assert all(0 <= t < 151936 for p in a.pool for t in p)
    # log-uniform: as many below the range's geometric middle as above
    many = KIND.prompt_lengths(dict(catalog.config(CONFIG), pool=4000),
                               np.random.default_rng(0))
    assert abs(np.mean(many < 1024) - 0.5) < 0.03


def test_ops_per_unit_is_pinned_at_full_width():
    """A decoded token of Qwen3-30B-A3B: 113,788,928 FLOPs a layer
    without attention over the context (projections 37,748,736, QK-norm
    18,432, router 524,288, experts 75,497,472) and 16,384 a context
    position, 48 layers, and the LM head's 622,329,856; the kind counts
    it at the pool's mean prompt length."""
    config = catalog.config(CONFIG)
    assert work.decode_flops_per_layer(config, 0) == 113_788_928
    assert work.decode_flops_per_token(config, 0) == 6_084_198_400
    assert work.decode_flops_per_token(config, 1000) == 6_870_630_400
    s = _system(config)
    assert s.ops_per_unit == work.decode_flops_per_token(
        config, float(np.mean([len(p) for p in s.pool])))


def test_benchmark_reference_is_the_ports_plain_reference():
    """``reference/lm.py`` is the copy of ``repro_torch/plain/qwen3_moe.py``
    that the benchmark carries."""
    assert filecmp.cmp(catalog.ROOT / "portbench" / "reference" / "lm.py",
                       harness.SRC / "repro_torch" / "plain" / "qwen3_moe.py",
                       shallow=False)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("lm"))


def _pos_off_by_one(m):
    """One live slot decodes one position past its own."""
    inputs = Engine._inputs

    def broken(self, live):
        toks, pos = inputs(self, live)
        pos = pos.clone()
        pos[live[0][0]] += 1
        return toks, pos
    m.setattr(Engine, "_inputs", broken)


def _qk_norm_skipped_in_one_layer(m):
    """The first layer's attention runs without its QK-norm."""
    block, calls = attention.attention_block, [0]

    def broken(p, x, cfg, **kw):
        calls[0] += 1
        if calls[0] % cfg.n_layers == 1:
            p = {k: v for k, v in p.items() if k not in ("q_norm", "k_norm")}
        return block(p, x, cfg, **kw)
    m.setattr(attention, "attention_block", broken)


def _capacity_1_25(m):
    """The zoo's capacity factor 1.25 in place of the dropless 16:
    tokens beyond an expert's capacity are dropped."""
    m.setattr(moe, "_capacity",
              lambda cf, n, k, e: int(max(k, round(1.25 * n * k / e))))


def _decode_logits_float8(m):
    """Every decode step's logits rounded to float8 (e4m3)."""
    step = Model.decode_step

    def broken(self, *args):
        logits, cache = step(self, *args)
        return logits.to(torch.float8_e4m3fn).float(), cache
    m.setattr(Model, "decode_step", broken)


def test_sound_timed_path_passes_the_cells_own_check(root):
    out = harness.run_cell(CELL, SEED, 1.0, device="cpu", root=root)
    assert out.correct and out.checks["requests"] >= 2, out.checks


@pytest.mark.parametrize("fault", [_pos_off_by_one,
                                   _qk_norm_skipped_in_one_layer,
                                   _capacity_1_25, _decode_logits_float8])
def test_broken_timed_path_fails_the_cells_own_check(root, monkeypatch,
                                                     fault):
    """Each fault on the timed path alone (the check's reference is the
    plain one, which none of them touches) fails the check."""
    fault(monkeypatch)
    out = harness.run_cell(CELL, SEED, 1.0, device="cpu", root=root)
    assert out.checks["compared"] > 0 and not out.correct, out.checks


def test_float8_control_fails_the_limits(root):
    """The reference with every matmul input rounded to float8 in the
    program's place, on the answers of a sound run, fails the limits the
    program's own answers pass."""
    bench = harness.Bench(CELL, SEED, device="cpu", root=root)

    async def main():
        await bench.server.warm()
        rec, _ = await bench.window(1.0)
        return rec
    rec = asyncio.run(main())
    data = bench.data(rec, 1.0, 0.0, None)
    bench.release()
    limits = dict(bench.config["limits"], lost=0)

    def correct(checks):
        return harness.Outcome(data, checks, limits, 0, 0, 0, "").correct
    assert correct(bench.check(rec, data))
    assert not correct(bench.check(rec, data, control=True))


def _engine_run(steps, prefills, host_end=10.0):
    return SimpleNamespace(
        steps=np.asarray(steps, dtype=np.float64).reshape(-1, 3),
        prefills=np.asarray(prefills, dtype=np.float64).reshape(-1, 3),
        host_end=host_end, cell={"engine": {"max_batch": 8}})


def test_engine_readers_arithmetic():
    """Steps and prefills that end before the traced slice, and none
    after it: the median step, live slots over ``max_batch`` and prefill
    time per 1,000 prompt tokens."""
    run = _engine_run([(1.0, 1.1, 8), (1.1, 1.3, 8), (1.3, 1.4, 4),
                       (9.9, 10.5, 1)],
                      [(0.0, 0.5, 1000), (0.5, 0.6, 500), (9.95, 10.2, 9)])
    assert decode.step_ms(run) == pytest.approx(100.0)
    assert decode.slot_occupancy_pct(run) == pytest.approx(100 * 20 / 24)
    assert decode.prefill_ms_per_ktok(run) == pytest.approx(400.0)
    empty = _engine_run([], [])
    assert decode.step_ms(empty) is None
    assert decode.slot_occupancy_pct(empty) is None
    assert decode.prefill_ms_per_ktok(empty) is None


#: where each of the three decode steps starts (µs, on the spans' clock)
STEPS = (0.0, 1000.0, 2000.0)


def _step_spans(shift=0.0):
    out = []
    for k, b in enumerate(STEPS):
        sid = 10 + k
        out += [spans.Span("engine.step", b, b + 900, 1, sid),
                spans.Span("engine.decode", b + 10, b + 600, 1, 20 + k,
                           sid),
                spans.Span("engine.sample", b + 600, b + 890, 1, 30 + k,
                           sid)]
    return [spans.Span(s.name, s.ts + shift, s.end + shift, s.thread, s.id,
                       s.parent) for s in out]


def _ev(cat, name, ts, end, **args):
    return DeviceEvent(cat, name, ts, end - ts, args)


def _step_events(readback=True, upload=True):
    """Per step: an upload of another size (the server's index of its
    kept rows) 4 µs before the step, the upload of (2, 8) int64 values
    ending 5 µs after the step starts, a kernel from 100 to 700 µs, the
    (8,) int64 read-back ending 10 µs before ``engine.sample`` does, and
    the server's copy of its kept rows after the step."""
    evs = [_ev("kernel", "prev", -100, -50)]
    htod, dtoh = ("Memcpy HtoD (Pageable -> Device)",
                  "Memcpy DtoH (Device -> Pageable)")
    for b in STEPS:
        evs += [_ev("gpu_memcpy", htod, b - 4, b - 2, bytes=32),
                _ev("kernel", "decode", b + 100, b + 700),
                _ev("gpu_memcpy", dtoh, b + 905, b + 950, bytes=2430976)]
        if upload:
            evs.append(_ev("gpu_memcpy", htod, b + 2, b + 5, bytes=128))
        if readback:
            evs.append(_ev("gpu_memcpy", dtoh, b + 870, b + 880, bytes=64))
    evs.append(_ev("kernel", "next", 3000, 3010))
    return SimpleNamespace(events=sorted(evs, key=lambda e: e.ts),
                           cell={"engine": {"max_batch": 8}})


#: idle in the slice [-100, 3010]: a step's 4 + 95 + 170 + 25 + 46 µs
#: between its copies and kernel, 46 more before the first, 4 more after
#: the last; the step spans, moved 10 µs back to [-10, 890] + 1000 k,
#: cover 6 + 4 + 95 + 170 + 10 of each step's
IDLE, NAMED = 1070.0, 855.0


@pytest.mark.parametrize("shift", [0.0, 300.0, -400.0, 600.0, -700.0])
def test_engine_spans_on_the_trace_clock(shift):
    """Spans recorded on a clock ``shift`` µs off the trace's (more than
    half a step, too: the first anchor is the read-back under which the
    most steps' read-backs line up, not the nearest) are moved back by
    the steps' read-backs, the uploads then lie before the decode spans,
    and the idle share the spans name is read there."""
    run, items = _step_events(), _step_spans(shift)
    anchors = engine_spans.clock_anchors(run, items)
    assert [a for a, _ in anchors] == [b + 890 + shift for b in STEPS]
    assert all(d == pytest.approx(-10.0 - shift) for _, d in anchors)
    moved = engine_spans.on_device_clock(run, items)
    assert engine_spans.upload_share(run, moved, (0.0, 3000.0)) == 1.0
    idle = sum(b - a for a, b in spans.idle_intervals(run, (-100, 3010)))
    assert idle == pytest.approx(IDLE)
    assert engine_spans.idle_named_share_pct(run, items) == pytest.approx(
        100 * NAMED / IDLE)


def test_engine_spans_give_no_reading_without_their_guard():
    """Without read-backs to anchor at, without the uploads the guard
    checks, without device events, or without engine spans: no
    reading."""
    items = _step_spans()
    assert engine_spans.idle_named_share_pct(
        _step_events(readback=False), items) is None
    assert engine_spans.idle_named_share_pct(
        _step_events(upload=False), items) is None
    assert engine_spans.idle_named_share_pct(
        SimpleNamespace(events=[], cell={"engine": {"max_batch": 8}}),
        items) is None
    assert engine_spans.idle_named_share_pct(_step_events(), []) is None
    assert engine_spans.idle_named_share_pct(_step_events(), None) is None
    gateway = [spans.Span("gateway.stack", 0, 10, 1, 1)]
    assert engine_spans.idle_named_share_pct(_step_events(),
                                             gateway) is None


#: where each of three prefills' ``engine.submit`` starts (µs, on the
#: spans' clock): a slice that holds a wave's prefills and no step
PREFILLS = (0.0, 5000.0, 10000.0)


def _prefill_spans(shift=0.0):
    out = []
    for k, b in enumerate(PREFILLS):
        sid = 40 + k
        out += [spans.Span("engine.submit", b, b + 4000, 1, sid),
                spans.Span("engine.prefill", b + 10, b + 3000, 1, 50 + k,
                           sid),
                spans.Span("engine.sample", b + 3000, b + 3200, 1, 60 + k,
                           sid),
                spans.Span("engine.cache_write", b + 3200, b + 3900, 1,
                           70 + k, sid)]
    return [spans.Span(s.name, s.ts + shift, s.end + shift, s.thread, s.id,
                       s.parent) for s in out]


def _prefill_events(upload=True):
    """Per prefill: the prompt's upload (512 int64 values) ending 100 µs
    after ``engine.prefill`` starts, the model's kernels, the first
    token's read-back (one int64 value) ending 10 µs before
    ``engine.sample`` does, and the server's copy of the kept row."""
    htod, dtoh = ("Memcpy HtoD (Pageable -> Device)",
                  "Memcpy DtoH (Device -> Pageable)")
    evs = []
    for b in PREFILLS:
        evs += [_ev("kernel", "prefill", b + 200, b + 2900),
                _ev("gpu_memcpy", dtoh, b + 3180, b + 3190, bytes=8),
                _ev("kernel", "cache_write", b + 3300, b + 3800),
                _ev("gpu_memcpy", dtoh, b + 4100, b + 4150, bytes=607744)]
        if upload:
            evs.append(_ev("gpu_memcpy", htod, b + 100, b + 110,
                           bytes=4096))
    return SimpleNamespace(events=sorted(evs, key=lambda e: e.ts),
                           cell={"engine": {"max_batch": 8}})


@pytest.mark.parametrize("shift", [0.0, 1500.0, -1500.0])
def test_engine_spans_anchor_a_slice_of_prefills_alone(shift):
    """A slice of prefills and no decode step: the spans are moved back
    by the prefills' read-backs of their first tokens, the prompts'
    uploads then lie at the ``engine.prefill`` spans' starts, and the
    idle share is read; without the uploads, no reading."""
    run, items = _prefill_events(), _prefill_spans(shift)
    anchors = engine_spans.clock_anchors(run, items)
    assert [a for a, _ in anchors] == [b + 3200 + shift for b in PREFILLS]
    assert all(d == pytest.approx(-10.0 - shift) for _, d in anchors)
    moved = engine_spans.on_device_clock(run, items)
    assert engine_spans.upload_share(run, moved, (0.0, 13200.0)) == 1.0
    named = engine_spans.idle_named_share_pct(run, items)
    assert named is not None and 0.0 < named <= 100.0
    assert engine_spans.idle_named_share_pct(_prefill_events(upload=False),
                                             items) is None


def test_catalog_lists_the_lm_metrics_for_its_cell_only():
    bench = catalog.benchmark()
    lm = ["decode_step_ms.lm", "slot_occupancy.lm",
          "prefill_ms_per_ktok.lm", "mfu.lm", "idle_share.lm",
          "idle_named_share.lm"]
    assert catalog.metrics_for(bench, CELL, True) == lm
    assert catalog.metrics_for(bench, CELL, False) == ["tokens_per_s",
                                                       "setup_s"]
    assert not set(lm) & set(catalog.metrics_for(bench, "moe-closed64",
                                                 True))
