"""The port-only Qwen3-30B-A3B (``configs/qwen3_30b_a3b.py``) on the CPU:
QK-norm, dropless routing and decode at per-row positions, held to the
plain float32 reference of the published forward
(``repro_torch.plain.qwen3_moe``), and the ``Engine``'s per-slot
admission, its spans and its counters.

The model is the published block at a small size: 2 layers, 8 experts,
top 2, QK-norm, capacity factor E / k (so no token is dropped), in
float32, every weight drawn from a seeded generator and every norm
weight moved off its init so that a norm applied wrongly shows.

Tolerances (each test's docstring gives its own):
``REF_TOL`` 1e-4 of the largest logit: the port and the reference
compute the same float32 function in other orders (fused projections,
chunked attention, a batched gather-and-combine against a per-expert
loop), a difference near float32's 1.2e-7 per operation summed over two
layers; a wrong position, norm or dropped token moves logits by 1e-2 and
more.  Equalities that run the same arithmetic on both sides are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import list_archs as ref_list_archs
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.launch import serve as launch
from repro_torch.models import build_model
from repro_torch.ops import spans
from repro_torch.plain import qwen3_moe as plain
from repro_torch.serve import Engine, Request, ServeConfig

ARCH = "qwen3-30b-a3b"
REF_TOL = 1e-4
PROMPTS = (5, 9, 13)


def _cfg():
    base = smoke_config(ARCH)
    return base.with_overrides(
        dtype="float32", moe=dataclasses.replace(
            base.moe, num_experts=8, top_k=2, capacity_factor=8 / 2))


@pytest.fixture(scope="module")
def qwen():
    """The small model, its seeded weights (norm weights drawn too) and
    the reference's spec."""
    cfg = _cfg()
    model = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen)
    stack = params["stack"]["s0"]
    for leaf in (stack["ln1"], stack["ln2"], stack["attn"]["q_norm"],
                 stack["attn"]["k_norm"], params["final_norm"]):
        leaf.copy_(0.3 * torch.randn(leaf.shape, generator=gen))
    spec = {"n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "top_k": cfg.moe.top_k, "rope_theta": cfg.rope_theta,
            "norm_eps": cfg.norm_eps}
    return cfg, model, params, spec


def _prompts(cfg, lengths=PROMPTS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lengths]


def _close(got, want):
    got, want = got.float(), want.float()
    assert float((got - want).abs().max() / want.abs().max()) < REF_TOL


def test_registered_port_only_beside_the_reference_zoo():
    """``list_archs`` still mirrors the reference's zoo; the published
    Qwen3-30B-A3B is found by name, carries QK-norm, is dropless at
    capacity factor E / k and keeps its published widths."""
    assert list_archs() == ref_list_archs()
    assert ARCH not in list_archs()
    cfg = get_config(ARCH)
    assert cfg.qk_norm and cfg.dtype == "bfloat16"
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (48, 2048, 32, 4, 128, 151936)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.moe.n_shared_experts) == (128, 8, 768, 0)
    assert cfg.moe.capacity_factor == 16 and cfg.rope_theta == 1e6
    assert cfg.moe.router_aux_weight == 0.001 and not cfg.tie_embeddings
    assert smoke_config(ARCH).qk_norm
    # 30.5 B parameters (61 GB in bf16), q_norm and k_norm counted
    assert cfg.param_count() == 30_532_120_576


def test_qk_norm_leaves_only_where_the_config_carries_them(qwen):
    """``init`` adds (head_dim,) ``q_norm`` and ``k_norm`` per layer for
    this configuration and for no architecture of the reference's zoo."""
    cfg, _, params, _ = qwen
    attn = params["stack"]["s0"]["attn"]
    assert attn["q_norm"].shape == attn["k_norm"].shape \
        == (cfg.n_layers, cfg.head_dim)
    other = build_model(smoke_config("qwen3-moe-30b-a3b"), "meta")
    assert "q_norm" not in other.init_abstract()["stack"]["s0"]["attn"]


def test_prefill_matches_the_plain_reference(qwen):
    """The port's prefill logits (the last position of each prompt)
    against the reference's teacher-forced forward, within ``REF_TOL``
    (float32 on both sides, other summation orders)."""
    cfg, model, params, spec = qwen
    for p in _prompts(cfg):
        got, _ = model.prefill(params, {"tokens": [p]})
        want = plain.forward(params, [p], [[len(p) - 1]], spec)[0]
        _close(got, want)


def test_ragged_per_row_decode_matches_the_plain_reference(qwen):
    """Prompts of 5, 9 and 13 tokens prefilled alone into one pool
    cache, then decoded together, each row at its own position (a (B,)
    tensor ``pos``), four steps: every row's logits against the
    reference's at that position of its sequence, within ``REF_TOL``."""
    cfg, model, params, spec = qwen
    prompts = _prompts(cfg)
    max_len = max(PROMPTS) + 8
    cache = model.init_cache(len(prompts), max_len)
    seqs, toks = [], []
    for b, p in enumerate(prompts):
        logits, one = model.prefill(params, {"tokens": [p]})
        for name in ("k", "v"):
            cache["s0"][name][:, b, :len(p)] = one["s0"][name][:, 0]
        seqs.append(list(p))
        toks.append(int(logits.argmax(-1)))
    pos = torch.tensor(PROMPTS)
    rows = [[] for _ in prompts]
    for _ in range(4):
        for b, t in enumerate(toks):
            seqs[b].append(t)
        logits, cache = model.decode_step(
            params, cache, torch.tensor(toks)[:, None], pos)
        for b in range(len(prompts)):
            rows[b].append(logits[b])
        toks = logits.argmax(-1).tolist()
        pos = pos + 1
    want = plain.forward(params, seqs,
                         [list(range(n, n + 4)) for n in PROMPTS], spec)
    for b in range(len(prompts)):
        _close(torch.stack(rows[b]), want[b])


def test_int_and_all_equal_tensor_positions_decode_alike(qwen):
    """A decode step at an int position and at a tensor of that position
    for every row: the same logits, bit for bit (the same arithmetic,
    masks built per row), and the same cache written."""
    cfg, model, params, _ = qwen
    toks = torch.tensor([p[:9] for p in _prompts(cfg, (9, 9, 9))])
    _, base = model.prefill(params, {"tokens": toks})
    caches = [{k: {n: torch.cat([t, torch.zeros_like(t[:, :, :3])], 2)
                   for n, t in e.items()} for k, e in base.items()}
              for _ in range(2)]
    step = toks[:, -1:]
    a, ca = model.decode_step(params, caches[0], step, 9)
    b, cb = model.decode_step(params, caches[1], step, torch.full((3,), 9))
    assert torch.equal(a, b)
    for name in ("k", "v"):
        assert torch.equal(ca["s0"][name], cb["s0"][name])


class _Tap:
    """The model as an engine sees it, keeping every call's logits."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, batch):
        out = self.model.prefill(params, batch)
        self.calls.append(out[0].clone())
        return out

    def decode_step(self, params, cache, token, pos):
        out = self.model.decode_step(params, cache, token, pos)
        self.calls.append(out[0].clone())
        return out


def _served_logits(model, params, prompts, max_batch, n_new):
    """Each request's tokens and the logits row each was sampled from,
    served per slot in one pool of ``max_batch``."""
    tap = _Tap(model)
    eng = Engine(tap, params, ServeConfig(max_batch=max_batch, max_len=32,
                                          max_new_tokens=n_new))
    reqs = [Request(prompt=list(p), request_id=i)
            for i, p in enumerate(prompts)]
    rows = {i: [] for i in range(len(reqs))}
    queue = list(reqs)
    while queue or eng.live():
        while queue and eng.submit(queue[0]):
            rows[queue.pop(0).request_id].append(tap.calls[-1][0])
        live = eng.live()
        eng.step()
        for slot, r in live:
            rows[r.request_id].append(tap.calls[-1][slot])
    return [(r.out_tokens, torch.stack(rows[r.request_id])) for r in reqs]


def test_per_slot_engine_serves_each_request_as_alone(qwen):
    """Five prompts of three lengths through a pool of three slots, per
    slot (slots freed and refilled at other positions): each request's
    tokens and logits rows equal those it gets served alone, within
    ``REF_TOL`` (the same float32 arithmetic over a batch of other rows:
    the products may take other summation orders; dropless routing
    keeps every row's experts its own)."""
    cfg, model, params, _ = qwen
    prompts = _prompts(cfg, (5, 9, 13, 7, 11), seed=1)
    pooled = _served_logits(model, params, prompts, 3, 6)
    for p, (tokens, rows) in zip(prompts, pooled):
        alone_tokens, alone_rows = _served_logits(model, params, [p], 1,
                                                  6)[0]
        assert tokens == alone_tokens and rows.shape[0] == 6
        _close(rows, alone_rows)


#: every architecture of the zoo the engine serves (text in, no frontend)
TEXT_ARCHS = [a for a in list_archs() if not smoke_config(a).frontend]


@pytest.mark.parametrize("arch", TEXT_ARCHS)
def test_per_slot_engine_serves_every_text_arch_as_alone(arch):
    """Each text architecture of the zoo at smoke size, in float32 and
    dropless (an MoE MLP at capacity factor E / k): prompts of 5, 9 and
    13 tokens decoding together per slot (attention, sliding windows,
    Mamba state and MoE layers at per-row positions) give each request
    the tokens it gets alone, and logits rows within ``REF_TOL`` (the
    same float32 arithmetic over a batch of other rows)."""
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(4))
    prompts = _prompts(cfg, seed=4)
    pooled = _served_logits(model, params, prompts, 3, 5)
    for p, (tokens, rows) in zip(prompts, pooled):
        alone_tokens, alone_rows = _served_logits(model, params, [p], 1,
                                                  5)[0]
        assert tokens == alone_tokens
        _close(rows, alone_rows)


def test_per_slot_engine_matches_the_plain_reference(qwen):
    """Every logits row the per-slot engine served, for prompts of 5, 9
    and 13 tokens decoding together, against the reference's
    teacher-forced row at that position, within ``REF_TOL``."""
    cfg, model, params, spec = qwen
    prompts = _prompts(cfg, seed=2)
    served = _served_logits(model, params, prompts, 3, 5)
    want = plain.forward(
        params, [p + t[:-1] for p, (t, _) in zip(prompts, served)],
        [list(range(len(p) - 1, len(p) + 4)) for p in prompts], spec)
    for (_, rows), w in zip(served, want):
        _close(rows, w)


def test_lockstep_admission_keeps_the_references_rule(qwen):
    """``admission="lockstep"``: a prompt whose length differs from the
    pool's shared position waits; per slot it is admitted.  An unknown
    rule is refused, and per slot a prompt that leaves no position below
    ``max_len`` raises."""
    cfg, model, params, _ = qwen
    a, b = _prompts(cfg, (5, 9))
    for admission, joins in (("lockstep", False), ("per_slot", True)):
        eng = Engine(model, params, ServeConfig(
            max_batch=2, max_len=32, max_new_tokens=4, admission=admission))
        assert eng.submit(Request(prompt=a))
        assert eng.submit(Request(prompt=b)) is joins
    with pytest.raises(ValueError, match="admission"):
        Engine(model, params, ServeConfig(admission="wave"))
    eng = Engine(model, params, ServeConfig(max_batch=1, max_len=8))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(prompt=list(range(1, 9))))


def test_engine_counters_follow_the_schedule(qwen):
    """Three prompts into two slots, two new tokens each: two admitted
    at once, the third refused for want of a slot until the first two
    finish after one step (2 live slots), then admitted and stepped once
    alone: admitted 3, refused_no_slot 1, slot_steps 2 + 1, two decode
    steps."""
    cfg, model, params, _ = qwen
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=32,
                                            max_new_tokens=2))
    reqs = [Request(prompt=p) for p in _prompts(cfg)]
    assert eng.submit(reqs[0]) and eng.submit(reqs[1])
    assert not eng.submit(reqs[2])
    eng.step()
    assert reqs[0].done and reqs[1].done
    assert eng.submit(reqs[2])
    eng.step()
    t = eng.timings()
    assert (t["admitted"], t["refused_no_slot"], t["slot_steps"],
            t["decode_steps"], t["prefills"]) == (3, 1, 3, 2, 3)


def _engine_spans(model, params, prompts):
    from torch.profiler import ProfilerActivity, profile
    spans.RECORDER.clear()
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=32,
                                            max_new_tokens=3))
    with profile(activities=[ProfilerActivity.CPU]):
        assert eng.submit(Request(prompt=prompts[0]))
        assert eng.submit(Request(prompt=prompts[1]))
        eng.step()
    return [s for s in spans.RECORDER.snapshot()
            if s.name.startswith("engine.")]


def test_engine_spans_nest_as_stated_and_only_under_a_profiler(qwen):
    """Under a CPU profiler two admissions and one step record
    ``engine.submit`` (each) holding ``engine.prefill``, ``engine.sample`` and
    ``engine.cache_write`` in that order, and ``engine.step`` holding
    ``engine.decode`` then ``engine.sample``; with no profiler nothing
    is recorded."""
    cfg, model, params, _ = qwen
    prompts = _prompts(cfg)
    got = _engine_spans(model, params, prompts)
    by_id = {s.id: s for s in got}
    tops = [s for s in got if s.parent not in by_id]
    assert sorted(s.name for s in tops) == ["engine.step", "engine.submit",
                                            "engine.submit"]
    kids = {}
    for s in got:
        if s.parent in by_id:
            kids.setdefault(s.parent, []).append(s)
    for top in tops:
        names = [s.name for s in sorted(kids.get(top.id, []),
                                        key=lambda s: s.start)]
        want = {"engine.submit": ["engine.prefill", "engine.sample",
                                  "engine.cache_write"],
                "engine.step": ["engine.decode", "engine.sample"]}
        assert names == want[top.name], (top.name, names)
        for k in kids.get(top.id, []):
            assert top.start <= k.start <= k.end <= top.end
    spans.RECORDER.clear()
    eng = Engine(model, params, ServeConfig(max_batch=1, max_len=32,
                                            max_new_tokens=2))
    eng.run([Request(prompt=prompts[0])])
    assert not [s for s in spans.RECORDER.snapshot()
                if s.name.startswith("engine.")]


def test_launcher_serves_the_published_qwen3_smoke_size():
    """``launch/serve.py --workload lm --arch qwen3-30b-a3b`` serves the
    configuration's smoke size (bf16, QK-norm, dropless) per slot."""
    args = launch.parse_args(["--workload", "lm", "--arch", ARCH,
                              "--requests", "3", "--prompt-len", "8",
                              "--new-tokens", "4", "--torch-device", "cpu"])
    engine, reqs, dt = launch.run_lm(args)
    assert engine.model.cfg == smoke_config(ARCH) and dt > 0
    assert engine.cfg.admission == "per_slot"
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
