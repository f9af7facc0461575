"""``repro_torch.ops``: the JSONL tracker's never-block contract (bounded
queue, drop counting, flush-on-close), torn-line tolerance and the
periodic stats sampler; the plan store's round-trips, retire/revive
lifecycle, corrupt-file quarantine, id validation, crash-mid-write and
concurrency invariants — the tests of ``tests/test_ops_tracker.py`` and
``tests/test_ops_store.py`` held against the port — and one store shared
by both packages."""

import dataclasses
import json
import os
import threading
import time
from pathlib import Path

import pytest

from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

from repro import ops as ref_ops
from repro import runtime as ref_runtime
from repro_torch.core import allocate
from repro_torch.ops import (JsonlTracker, NullTracker, PlanCorrupt,
                             PlanNotFound, PlanRetired, PlanStore,
                             PlanStoreError, PlanUnsupported,
                             StatsSampler, Tracker, read_events, read_log)
from repro_torch.runtime import load_plan

PLANS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
QUICKSTART = PLANS / "quickstart_v5e.json"


def _plan(device=None):
    """The committed, reference-planned quickstart plan, or the same
    plan recorded for another catalog part (a plan that differs)."""
    plan = load_plan(QUICKSTART)
    if device is None:
        return plan
    return dataclasses.replace(plan, device=allocate.get_device(device))


@pytest.fixture(scope="module")
def plan():
    return _plan()


def tear_plan_write(store, plan_id, text, *, cut):
    """What a crash mid-``atomic_write_text`` leaves behind: the temp
    file of its naming protocol (dot-prefixed, ``.tmp``, in the
    destination directory) holding the first ``cut`` bytes of ``text``,
    without the rename."""
    dest = store.path_for(plan_id)
    tmp = dest.parent / (f".{dest.name}.{os.getpid()}"
                         f".{threading.get_ident()}.tmp")
    tmp.write_bytes(text.encode("utf-8")[:cut])
    return tmp


def _wedge(tr, gate):
    """Hold the tracker's writer thread inside a write until ``gate``."""
    tr._write = lambda entry, _w=tr._write: (gate.wait(5), _w(entry))[1]


# ---------------------------------------------------------------------------
# tracker
# ---------------------------------------------------------------------------

def test_events_written_with_t_and_event(tmp_path):
    path = tmp_path / "m.jsonl"
    tr = JsonlTracker(path)
    tr.log_event("alpha", plan_id="p1")
    tr.log_metrics("gateway", {"served": 3})
    tr.close()
    events = read_events(path)
    assert [e["event"] for e in events] == ["alpha", "stats",
                                            "tracker_closed"]
    assert all("t" in e for e in events)
    assert events[0]["plan_id"] == "p1"
    assert events[1]["source"] == "gateway"
    assert events[1]["metrics"] == {"served": 3}


def test_close_is_idempotent_and_seals_totals(tmp_path):
    tr = JsonlTracker(tmp_path / "m.jsonl")
    for i in range(10):
        tr.log_event("e", i=i)
    tr.close()
    tr.close()                         # second close is a no-op
    events = read_events(tr.path)
    closed = events[-1]
    assert closed["event"] == "tracker_closed"
    assert closed["recorded"] == 10 and closed["dropped"] == 0
    assert len(events) == 11


def test_bounded_queue_drops_instead_of_blocking(tmp_path):
    """With the writer wedged, overflow must drop-and-count — record()
    never waits on the disk."""
    tr = JsonlTracker(tmp_path / "m.jsonl", max_queue=8,
                      flush_interval_s=30)
    gate = threading.Event()
    _wedge(tr, gate)
    t0 = time.monotonic()
    for i in range(100):
        tr.log_event("burst", i=i)
    assert time.monotonic() - t0 < 2.0      # never blocked on the queue
    assert tr.dropped > 0
    assert tr.recorded + tr.dropped == 100
    gate.set()
    tr.close()
    events = read_events(tr.path)
    assert events[-1]["dropped"] == tr.dropped


def test_record_after_close_counts_dropped(tmp_path):
    tr = JsonlTracker(tmp_path / "m.jsonl")
    tr.log_event("before")
    tr.close()
    tr.log_event("after")              # silently dropped, counted
    assert tr.dropped == 1
    assert [e["event"] for e in read_events(tr.path)] \
        == ["before", "tracker_closed"]


def test_read_events_skips_torn_trailing_line(tmp_path):
    path = tmp_path / "m.jsonl"
    tr = JsonlTracker(path)
    tr.log_event("whole")
    tr.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"event": "torn-by-cra')   # crash mid-write
    events = read_events(path)
    assert [e["event"] for e in events] == ["whole", "tracker_closed"]


def test_unserializable_fields_fall_back_to_repr(tmp_path):
    tr = JsonlTracker(tmp_path / "m.jsonl")
    tr.log_event("odd", payload=object())
    tr.close()
    (entry,) = [e for e in read_events(tr.path) if e["event"] == "odd"]
    assert "object at 0x" in entry["payload"]


def test_tracker_context_manager(tmp_path):
    with JsonlTracker(tmp_path / "m.jsonl") as tr:
        tr.log_event("inside")
    assert [e["event"] for e in read_events(tr.path)] \
        == ["inside", "tracker_closed"]


def test_null_tracker_accepts_everything():
    tr = NullTracker()
    tr.log_event("x", a=1)
    tr.log_metrics("src", {"b": 2})
    tr.close()
    assert isinstance(tr, Tracker)


def test_read_log_surfaces_seal_drop_count(tmp_path):
    """``read_log`` exposes recorded/dropped/write_errors from the seal
    record, so a harness can bound telemetry loss."""
    tr = JsonlTracker(tmp_path / "m.jsonl", max_queue=8,
                      flush_interval_s=30)
    gate = threading.Event()
    _wedge(tr, gate)
    for i in range(100):
        tr.log_event("burst", i=i)
    gate.set()
    tr.close()
    log = read_log(tr.path)
    assert log.sealed
    assert log.dropped == tr.dropped > 0
    assert log.recorded == tr.recorded
    assert log.write_errors == 0
    assert log.recorded + log.dropped == 100
    assert len(log.events) == log.recorded + 1      # + the seal itself
    assert list(log.events) == read_events(tr.path)


def test_read_log_unsealed_and_torn_lines(tmp_path):
    # a tracker that died mid-flight left no seal: no loss bound exists
    path = tmp_path / "died.jsonl"
    path.write_text('{"event": "a", "t": 1.0}\n'
                    '{"event": "b", "t": 2.0}\n'
                    '{"event": "torn-by-cra')       # crash mid-write
    log = read_log(path)
    assert not log.sealed
    assert log.recorded is None and log.dropped is None
    assert log.torn_lines == 1
    assert [e["event"] for e in log.events] == ["a", "b"]
    # a torn append after a clean close does not unseal the file
    tr = JsonlTracker(tmp_path / "closed.jsonl")
    tr.log_event("whole")
    tr.close()
    with open(tr.path, "a", encoding="utf-8") as fh:
        fh.write('{"event": "torn-by-cra')
    log = read_log(tr.path)
    assert log.sealed and log.recorded == 1 and log.torn_lines == 1


def test_io_fault_counts_write_errors_never_raises(tmp_path):
    """Failed disk writes (the ``io_fault=`` seam) are counted, never
    raised to the caller, and the seal reports them."""
    def io_fault(entry):
        if entry.get("event") == "doomed":
            raise OSError("disk full (injected)")

    tr = JsonlTracker(tmp_path / "m.jsonl", io_fault=io_fault)
    tr.log_event("ok-1")
    tr.log_event("doomed")
    tr.log_event("ok-2")
    tr.close()
    assert tr.write_errors == 1
    log = read_log(tr.path)
    assert [e["event"] for e in log.events] \
        == ["ok-1", "ok-2", "tracker_closed"]
    assert log.sealed and log.write_errors == 1
    assert log.recorded == 3 and log.dropped == 0
    assert len(log.events) - 1 == log.recorded - log.write_errors


def test_tracker_file_reads_the_same_in_both_packages(tmp_path):
    """The port writes the reference's format: each package's
    ``read_log`` reads the other's file to the same events and seal."""
    for writer in (JsonlTracker, ref_ops.JsonlTracker):
        path = tmp_path / f"{writer.__module__}.jsonl"
        tr = writer(path)
        tr.log_event("plan_registered", plan_id="p", kind="cnn")
        tr.log_metrics("gateway", {"served": 2})
        tr.close()
        ours, theirs = read_log(path), ref_ops.read_log(path)
        assert ours.events == theirs.events
        assert (ours.sealed, ours.recorded, ours.dropped) \
            == (theirs.sealed, theirs.recorded, theirs.dropped) \
            == (True, 2, 0)


def test_sampler_samples_periodically_and_on_close(tmp_path):
    calls = []

    def source():
        calls.append(1)
        return {"n": len(calls)}

    tr = JsonlTracker(tmp_path / "m.jsonl")
    sampler = StatsSampler(tr, {"fake": source}, interval_s=0.02)
    deadline = time.monotonic() + 5
    while sampler.samples < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    sampler.close()                    # + one final sample
    sampler.close()                    # idempotent
    tr.close()
    stats = [e for e in read_events(tr.path) if e["event"] == "stats"]
    assert len(stats) == len(calls) >= 4
    assert stats[-1]["metrics"]["n"] == len(calls)
    assert all(e["source"] == "fake" for e in stats)


def test_sampler_survives_raising_source(tmp_path):
    tr = JsonlTracker(tmp_path / "m.jsonl")

    def bad():
        raise RuntimeError("stats exploded")

    sampler = StatsSampler(tr, {"bad": bad, "good": lambda: {"ok": 1}},
                           interval_s=0.01)
    deadline = time.monotonic() + 5
    while sampler.samples < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    sampler.close()
    tr.close()
    events = read_events(tr.path)
    errors = [e for e in events if e["event"] == "sample_error"]
    good = [e for e in events if e["event"] == "stats"]
    assert errors and "stats exploded" in errors[0]["error"]
    assert good and all(e["source"] == "good" for e in good)


# ---------------------------------------------------------------------------
# plan store: round-trip + listing
# ---------------------------------------------------------------------------

def test_save_load_round_trip(tmp_path, plan):
    store = PlanStore(tmp_path)
    path = store.save(plan, "cnn-v1")
    assert path.exists() and path == store.path_for("cnn-v1")
    loaded = store.load("cnn-v1")
    assert [(l.block, l.data_bits, l.coeff_bits) for l in loaded.layers] \
        == [(l.block, l.data_bits, l.coeff_bits) for l in plan.layers]
    assert loaded.device == plan.device
    assert loaded.to_json() == plan.to_json()


def test_listing_sorted_and_membership(tmp_path, plan):
    store = PlanStore(tmp_path)
    for pid in ("b", "a", "c"):
        store.save(plan, pid)
    assert store.list_plans() == ["a", "b", "c"]
    assert len(store) == 3 and "b" in store and "zz" not in store
    # stray files are not plans
    (tmp_path / "plans" / "notes.txt").write_text("hi")
    (tmp_path / "plans" / ".hidden.json").write_text("{}")
    assert store.list_plans() == ["a", "b", "c"]


def test_overwrite_is_allowed(tmp_path, plan):
    store = PlanStore(tmp_path)
    store.save(plan, "p")
    store.save(plan, "p")                       # idempotent re-publish
    assert store.list_plans() == ["p"]


def test_two_instances_share_the_directory(tmp_path, plan):
    PlanStore(tmp_path).save(plan, "shared")
    again = PlanStore(tmp_path)                 # "another process"
    assert again.list_plans() == ["shared"]
    assert again.load("shared").device == plan.device


# ---------------------------------------------------------------------------
# plan store: retire lifecycle
# ---------------------------------------------------------------------------

def test_retire_moves_and_load_raises_retired(tmp_path, plan):
    store = PlanStore(tmp_path)
    store.save(plan, "old")
    store.retire("old")
    assert store.list_plans() == [] and store.list_retired() == ["old"]
    with pytest.raises(PlanRetired, match="retired"):
        store.load("old")
    assert store.load_retired("old").device == plan.device


def test_revive_after_retire(tmp_path, plan):
    store = PlanStore(tmp_path)
    store.save(plan, "p")
    store.retire("p")
    store.save(plan, "p")                       # re-publish revives
    assert store.list_plans() == ["p"]
    assert store.load("p").device == plan.device


def test_retire_missing_raises_not_found(tmp_path):
    store = PlanStore(tmp_path)
    with pytest.raises(PlanNotFound, match="to retire"):
        store.retire("ghost")
    with pytest.raises(PlanNotFound):
        store.load("ghost")
    with pytest.raises(PlanNotFound):
        store.load_retired("ghost")


def test_not_found_is_also_keyerror(tmp_path):
    store = PlanStore(tmp_path)
    with pytest.raises(KeyError):
        store.load("ghost")
    err = PlanNotFound("no plan 'ghost'")
    assert str(err) == "no plan 'ghost'"


# ---------------------------------------------------------------------------
# plan store: corruption + validation
# ---------------------------------------------------------------------------

def test_corrupt_file_is_quarantined(tmp_path, plan):
    store = PlanStore(tmp_path)
    store.save(plan, "ok")
    store.path_for("bad").write_text("{ not json")
    with pytest.raises(PlanCorrupt, match="quarantine"):
        store.load("bad")
    assert not store.path_for("bad").exists()
    q = list((tmp_path / "quarantine").iterdir())
    assert len(q) == 1 and q[0].read_text() == "{ not json"
    assert store.list_plans() == ["ok"]
    assert store.load("ok").device == plan.device


def test_schema_violation_is_corrupt_not_crash(tmp_path):
    store = PlanStore(tmp_path)
    store.path_for("vX").write_text(json.dumps({"schema": 999}))
    with pytest.raises(PlanCorrupt):
        store.load("vX")


def test_unported_workload_kind_is_corrupt_not_crash(tmp_path, monkeypatch):
    """A ``moe`` plan the reference wrote into a shared store now loads
    in the port, equal to the reference's JSON.  A plan of a kind the
    reference serves and the port does not yet is still not corrupt:
    the port raises ``PlanUnsupported`` and leaves it live, and nothing
    is quarantined."""
    from repro_torch.runtime import workloads
    layer = ref_runtime.MoELayerSpec(d_ff_expert=16, num_experts=4, top_k=2)
    spec = ref_runtime.MoEWorkloadSpec(layers=(layer,) * 2, d_model=8,
                                       seq_len=8)
    moe = ref_runtime.plan_moe_deployment(spec, "v5e")
    ref_ops.PlanStore(tmp_path).save(moe, "moe-v5e")
    store = PlanStore(tmp_path)
    loaded = store.load("moe-v5e")
    assert loaded.to_json() == moe.to_json()
    assert loaded.workload.kind == "moe"
    monkeypatch.setitem(workloads._NOT_YET_PORTED, "rnn",
                        "a recurrent workload")
    store.path_for("rnn-v5e").write_text(
        moe.to_json().replace('"kind": "moe"', '"kind": "rnn"'))
    with pytest.raises(PlanUnsupported, match="not yet"):
        store.load("rnn-v5e")
    assert store.path_for("rnn-v5e").exists()
    assert store.list_plans() == ["moe-v5e", "rnn-v5e"]
    assert list((tmp_path / "quarantine").iterdir()) == []
    assert ref_ops.PlanStore(tmp_path).load("moe-v5e").to_json() \
        == moe.to_json()


@pytest.mark.parametrize("bad_id", [
    "", ".hidden", "../escape", "a/b", "a\\b", "x" * 101, "sp ace",
    ".", "..",
])
def test_invalid_plan_ids_rejected(tmp_path, plan, bad_id):
    store = PlanStore(tmp_path)
    with pytest.raises(ValueError, match="plan_id"):
        store.save(plan, bad_id)
    with pytest.raises(ValueError):
        store.load(bad_id)
    assert bad_id not in store                  # no traversal probe


def test_save_requires_a_plan(tmp_path):
    with pytest.raises(PlanStoreError, match="DeploymentPlan"):
        PlanStore(tmp_path).save({"not": "a plan"}, "p")


# ---------------------------------------------------------------------------
# plan store: crash mid-write never corrupts a read
# ---------------------------------------------------------------------------

def test_torn_tmp_at_every_byte_offset_never_corrupts_reads(tmp_path, plan):
    """A crash at any byte offset of ``atomic_write_text``'s temp file —
    before the rename — leaves the store serving the complete old plan."""
    store = PlanStore(tmp_path)
    store.save(plan, "p")
    new_plan = _plan("v5p")
    assert new_plan.device.name != plan.device.name
    text = new_plan.to_json()
    for cut in range(len(text.encode("utf-8")) + 1):
        tmp = tear_plan_write(store, "p", text, cut=cut)
        assert store.list_plans() == ["p"]       # torn temp not listed
        got = store.load("p")                    # never PlanCorrupt
        assert got.device.name == plan.device.name
        tmp.unlink()
    store.save(new_plan, "p")
    assert store.load("p").device.name == new_plan.device.name


if HAVE_HYPOTHESIS:
    _cut_strategy = st.floats(min_value=0.0, max_value=1.0)
else:                                           # pragma: no cover
    _cut_strategy = None


@settings(max_examples=50, deadline=None)
@given(frac=_cut_strategy)
def test_property_crash_mid_save_yields_old_or_new(tmp_path_factory, plan,
                                                   frac):
    """Load-after-crash yields the complete old plan (crash before the
    rename) or the complete new one (after it) — never a corrupt read."""
    root = tmp_path_factory.mktemp("torn")
    store = PlanStore(root)
    store.save(plan, "p")
    new_plan = _plan("v5p")
    text = new_plan.to_json()
    data = text.encode("utf-8")
    cut = int(round(frac * len(data)))
    tmp = tear_plan_write(store, "p", text, cut=cut)
    assert store.load("p").device.name == plan.device.name
    if cut == len(data):
        os.replace(tmp, store.path_for("p"))
        assert store.load("p").device.name == new_plan.device.name
    else:
        tmp.unlink()
        assert store.load("p").device.name == plan.device.name


# ---------------------------------------------------------------------------
# plan store: interleaved save/load/retire never corrupts the store
# ---------------------------------------------------------------------------

def test_threaded_save_load_retire_stress(tmp_path, plan):
    store = PlanStore(tmp_path)
    store.save(plan, "a")
    errors = []

    def worker(k):
        for i in range(25):
            pid = ("a", "b")[(k + i) % 2]
            try:
                op = (k + i) % 3
                if op == 0:
                    store.save(plan, pid)
                elif op == 1:
                    got = store.load(pid)
                    assert len(got.layers) == len(plan.layers)
                else:
                    store.retire(pid)
            except (PlanNotFound, PlanRetired):
                pass                            # legal interleavings
            except Exception as e:              # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errors == []
    for pid in store.list_plans():
        assert len(store.load(pid).layers) == len(plan.layers)
    for pid in store.list_retired():
        assert len(store.load_retired(pid).layers) == len(plan.layers)


if HAVE_HYPOTHESIS:
    _ops_strategy = st.lists(
        st.tuples(st.sampled_from(["save", "load", "retire"]),
                  st.sampled_from(["a", "b"]),
                  st.integers(min_value=0, max_value=3)),
        min_size=1, max_size=24)
else:                                           # pragma: no cover
    _ops_strategy = None


@settings(max_examples=25, deadline=None)
@given(ops=_ops_strategy)
def test_property_interleaved_ops_keep_store_consistent(tmp_path_factory,
                                                        plan, ops):
    root = tmp_path_factory.mktemp("store")
    store = PlanStore(root)
    errors = []

    def apply(op, pid):
        try:
            if op == "save":
                store.save(plan, pid)
            elif op == "load":
                store.load(pid)
            else:
                store.retire(pid)
        except (PlanNotFound, PlanRetired):
            pass
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    lanes = [[], [], []]
    for i, (op, pid, _salt) in enumerate(ops):
        lanes[i % 3].append((op, pid))
    threads = [threading.Thread(
        target=lambda lane=lane: [apply(op, pid) for op, pid in lane])
        for lane in lanes if lane]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()

    assert errors == []
    for pid in store.list_plans():
        assert len(store.load(pid).layers) == len(plan.layers)
    for pid in store.list_retired():
        assert len(store.load_retired(pid).layers) == len(plan.layers)


# ---------------------------------------------------------------------------
# one store, both packages
# ---------------------------------------------------------------------------

def test_store_is_shared_with_the_reference(tmp_path):
    """A plan the port's store saves loads in the reference's store, and
    the reverse, to the same artifact, for the planned quickstart plan."""
    ours, theirs = PlanStore(tmp_path), ref_ops.PlanStore(tmp_path)
    ref_plan = ref_runtime.load_plan(QUICKSTART)
    ours.save(_plan(), "cnn-port")
    theirs.save(ref_plan, "cnn-ref")
    assert ours.list_plans() == theirs.list_plans() \
        == ["cnn-port", "cnn-ref"]
    assert theirs.load("cnn-port").to_json() == ref_plan.to_json()
    assert ours.load("cnn-ref").to_json() == _plan().to_json()
    # a retire by one package is seen by the other
    theirs.retire("cnn-port")
    with pytest.raises(PlanRetired):
        ours.load("cnn-port")
    assert ours.load_retired("cnn-port").to_json() == _plan().to_json()
