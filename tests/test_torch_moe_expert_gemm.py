"""The MoE expert products over each expert's filled rows
(``repro_torch.kernels.moe_expert_gemm``) on the CPU: the plain version
against ``torch.bmm`` on every filled row, the layer's output with the
rows past the fill poisoned, and the rule by which ``_expert_ffn``
takes the ragged products or ``torch.bmm``.  The rule sends every CPU
call to ``torch.bmm``; the tests of the rest of it set the kernels'
device to the CPU (``kernels_on_cpu``), where ``moe_expert_ffn`` runs
its plain version.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 11).
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import smoke_config
from repro_torch.kernels import moe_expert_gemm as meg
from repro_torch.kernels.build import LAUNCHES
from repro_torch.models import moe

E, CAP, D, FF = 6, 16, 12, 20


def _weights(gen):
    return {"w_gate": torch.randn(E, D, FF, generator=gen) / D ** 0.5,
            "w_up": torch.randn(E, D, FF, generator=gen) / D ** 0.5,
            "w_down": torch.randn(E, FF, D, generator=gen) / FF ** 0.5}


@pytest.fixture
def kernels_on_cpu(monkeypatch):
    """``takes`` as on the card, for CPU tensors."""
    monkeypatch.setattr(meg, "DEVICE", "cpu")


def _filled(fill, cap):
    """(E, C, 1): whether each row of each expert's buffer holds a
    token."""
    return (torch.arange(cap)[None, :] < fill[:, None])[..., None]


def _bmm_ffn(x, p):
    """``_expert_ffn``'s batched products over every row."""
    h = torch.bmm(x, p["w_up"])
    h = F.silu(torch.bmm(x, p["w_gate"])) * h
    return h, torch.bmm(h, p["w_down"])


def _seeded_fill(seed):
    """Fills from routing 24 tokens top-2 over E experts at capacity CAP
    // 2: some experts' counts pass the capacity (drops)."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.randperm(E, generator=gen)[:2]
                       for _ in range(24)]).reshape(-1)
    counts = moe._expert_counts(ids, E)
    return torch.clamp(counts, max=CAP // 2), counts


FILLS = [[0] * E, [1] * E, [7] * E, [8] * E, [9] * E, [CAP] * E,
         [0, 1, 7, 8, 9, CAP], "seed:0", "seed:1", "seed:2"]


@pytest.mark.parametrize("fill", FILLS, ids=[str(f) for f in FILLS])
def test_plain_equals_bmm_on_filled_rows(fill):
    """The plain version (``moe_expert_ffn`` on the CPU, and its
    hidden activation) equals ``torch.bmm``'s products on every filled
    row, bit for bit (the same products on the same rows), whatever the
    rows past the fill hold: a NaN there reaches only rows past the
    fill."""
    gen = torch.Generator().manual_seed(7)
    p = _weights(gen)
    x = torch.randn(E, CAP, D, generator=gen)
    if isinstance(fill, str):
        fill, _ = _seeded_fill(int(fill.split(":")[1]))
        cap = CAP // 2
        x = x[:, :cap].contiguous()
    else:
        fill, cap = torch.tensor(fill), CAP
    filled = _filled(fill, cap)
    h_want, y_want = _bmm_ffn(x, p)
    poisoned = x.masked_fill(~filled, float("nan"))
    hs = []
    y = meg.expert_ffn_bmm(poisoned, p["w_up"], p["w_down"], p["w_gate"],
                           mid=lambda h: hs.append(h) or h)
    y2 = meg.moe_expert_ffn(poisoned, p["w_gate"], p["w_up"], p["w_down"],
                            fill)
    for got, want in ((hs[0], h_want), (y, y_want), (y2, y_want)):
        rows = filled.expand_as(got)
        assert torch.equal(got[rows], want[rows])
        assert got[~rows].isnan().all()


def test_seeded_fills_drop_tokens():
    """The seeded fills of the test above hold experts whose count passes
    the capacity, so the clamp is exercised."""
    dropped = [bool(_seeded_fill(s)[1].gt(CAP // 2).any()) for s in range(3)]
    assert any(dropped)


def _cfg(**kw):
    cfg = smoke_config("qwen3-moe-30b-a3b").with_overrides(dtype="float32")
    return cfg.with_overrides(moe=dataclasses.replace(
        cfg.moe, num_experts=8, top_k=2, capacity_factor=1.0), **kw)


def _layer_inputs(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    return p, x


def test_layer_reads_no_row_past_the_fill(monkeypatch, kernels_on_cpu):
    """With every row past the fill set to NaN in the products' output,
    ``_moe_layer_flat`` is finite and equal to today's ``torch.bmm``
    path (tolerance 0: the combine gathers only filled rows, and those
    are the same products)."""
    _layer_with_poisoned_rows(monkeypatch, _cfg(), torch.float32)


def test_bf16_layer_reads_no_row_past_the_fill(monkeypatch, kernels_on_cpu):
    """The same for an LM's bf16 MoE MLP, which now takes the ragged
    products too."""
    _layer_with_poisoned_rows(monkeypatch, _cfg(dtype="bfloat16"),
                              torch.bfloat16)


def test_bf16_grid_bound():
    """The bound a bf16 launch sizes its grid by: the caller's, at most
    every row of the buffer, every row without one."""
    assert meg._rows(None, 4, 8) == 32
    assert meg._rows(100, 4, 8) == 32
    assert meg._rows(10, 4, 8) == 10
    assert meg._rows(0, 4, 8) == 0


def _layer_with_poisoned_rows(monkeypatch, cfg, dtype):
    p, x = _layer_inputs(cfg)
    p = {k: v.to(dtype) if k != "router" else v for k, v in p.items()}
    x = x.to(dtype)
    plain = meg.moe_expert_ffn
    seen = []

    def poisoned(xb, wg, wu, wd, fill, rows=None):
        seen.append(fill)
        y = plain(xb, wg, wu, wd, fill, rows)
        return y.masked_fill(~_filled(fill, y.shape[1]), float("nan"))
    monkeypatch.setattr(meg, "moe_expert_ffn", poisoned)
    out, aux = moe.moe_layer(p, x, cfg)
    cap = moe._capacity(cfg.moe.capacity_factor, 32, 2, 8)
    assert len(seen) == 1 and int(seen[0].sum()) < seen[0].numel() * cap
    monkeypatch.setattr(meg, "takes", lambda *a: False)
    want, want_aux = moe.moe_layer(p, x, cfg)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert float(aux) == float(want_aux)


def _fallbacks(fn):
    before = LAUNCHES[meg.BMM_FALLBACK]
    fn()
    return LAUNCHES[meg.BMM_FALLBACK] - before


def test_float32_inference_takes_the_ragged_products(monkeypatch,
                                                    kernels_on_cpu):
    """The MoE serving case (float32, no gradient, gated SiLU, flat, no
    mesh) on the kernels' device takes the ragged products and counts no
    fallback; on the CPU ``moe_expert_ffn`` runs its plain version and
    launches nothing."""
    cfg = _cfg()
    p, x = _layer_inputs(cfg)
    calls = []
    real = meg.expert_ffn_bmm
    monkeypatch.setattr(meg, "expert_ffn_bmm",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    launches = meg.launches()
    with torch.no_grad():
        assert _fallbacks(lambda: moe.moe_layer(p, x, cfg)) == 0
    assert calls == [1] and meg.launches() == launches


#: the LM's MoE MLP in inference: bf16, capacity-bounded or dropless
#: (capacity factor experts / top-k, as the published Qwen3-30B-A3B)
INFERENCE = {
    "bf16": lambda: _cfg(dtype="bfloat16"),
    "bf16-dropless": lambda: _cfg(dtype="bfloat16").with_overrides(
        moe=dataclasses.replace(_cfg().moe, capacity_factor=4.0)),
}


@pytest.mark.parametrize("case", sorted(INFERENCE))
def test_inference_takes_the_ragged_products(case, monkeypatch,
                                             kernels_on_cpu):
    """An LM's bf16 MoE MLP in inference (no gradient, gated SiLU, flat,
    no mesh) on the kernels' device takes the ragged products, given the
    fills and their bound n · k, and counts no fallback; on the CPU
    ``moe_expert_ffn`` runs its plain version and launches nothing (the
    card's two launches a call are counted in ``tests/test_torch_cuda.py``
    and ``chip_smoke.py``)."""
    cfg = INFERENCE[case]()
    p, x = _layer_inputs(cfg)
    p = {k: v.bfloat16() if k != "router" else v for k, v in p.items()}
    x = x.bfloat16()
    seen = []
    real = meg.moe_expert_ffn

    def ffn(xb, wg, wu, wd, fill, rows=None):
        seen.append((xb.dtype, tuple(xb.shape), int(fill.sum()), rows))
        return real(xb, wg, wu, wd, fill, rows)
    monkeypatch.setattr(meg, "moe_expert_ffn", ffn)
    launches = meg.launches()
    with torch.no_grad():
        before = LAUNCHES[meg.BMM_FALLBACK]
        out, _ = moe.moe_layer(p, x, cfg)
        assert LAUNCHES[meg.BMM_FALLBACK] == before
    n, k, e = 32, cfg.moe.top_k, cfg.moe.num_experts
    cap = moe._capacity(cfg.moe.capacity_factor, n, k, e)
    assert seen == [(torch.bfloat16, (e, cap, cfg.d_model),
                     seen[0][2], n * k)]
    assert seen[0][2] <= n * k <= e * cap
    assert meg.launches() == launches and out.dtype == torch.bfloat16


def _grad_call(cfg, p, x):
    leaves = {k: v.requires_grad_() for k, v in p.items()}
    out, aux = moe.moe_layer(leaves, x, cfg)
    (out.sum() + aux).backward()


CASES = {
    # bf16 training: inference in bf16 takes the kernels (above)
    "bf16": lambda: (_cfg(dtype="bfloat16"), torch.bfloat16, _grad_call),
    "grad": lambda: (_cfg(), torch.float32, _grad_call),
    "grouped": lambda: (_cfg(moe_groups=2), torch.float32, None),
    "ungated": lambda: (_cfg(mlp_gated=False), torch.float32, None),
    "gelu": lambda: (_cfg(act="gelu"), torch.float32, None),
}


def test_cpu_calls_keep_bmm_and_count():
    """On the CPU the serving case too keeps the one ``torch.bmm`` path,
    counted."""
    cfg = _cfg()
    p, x = _layer_inputs(cfg)

    def call():
        with torch.no_grad():
            moe.moe_layer(p, x, cfg)
    assert _fallbacks(call) == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_other_calls_keep_bmm_and_count(case, kernels_on_cpu):
    """A gradient (training, in float32 or bf16), the grouped path, an
    ungated or non-SiLU FFN: ``torch.bmm``, counted in
    ``BMM_FALLBACK`` (once a call; the grouped path calls the products
    once)."""
    cfg, dtype, call = CASES[case]()
    p, x = _layer_inputs(cfg)
    p = {k: v.to(dtype) if k != "router" else v for k, v in p.items()}
    x = x.to(dtype)
    if call is None:
        def call(cfg, p, x):
            with torch.no_grad():
                moe.moe_layer(p, x, cfg)
    assert _fallbacks(lambda: call(cfg, p, x)) == 1


def test_mesh_calls_keep_bmm_and_count(monkeypatch, kernels_on_cpu):
    """Under a mesh the flat path passes no fill (its replicated routing
    keeps five outputs), so the products take ``torch.bmm``, counted."""
    cfg = _cfg()
    p, x = _layer_inputs(cfg)
    meshes = []

    def replicated(fn, mesh, n_in, n_out):
        meshes.append((mesh, n_in, n_out))
        return fn
    monkeypatch.setattr(moe, "mesh_of", lambda t: "mesh")
    monkeypatch.setattr(moe, "_replicated", replicated)
    monkeypatch.setattr(moe, "_hint", lambda t, *a: t)
    with torch.no_grad():
        assert _fallbacks(lambda: moe._moe_layer_flat(p, x, cfg)) == 1
    assert meshes == [("mesh", 2, 5), ("mesh", 4, 1)]


def test_takes_only_plain_float32_inference(monkeypatch):
    """The rule: plain float32, or plain bf16 (every tensor the same), on
    the kernels' device, no gradient, gated SiLU, widths whole 16-byte
    vectors (4 float32, 8 bf16)."""
    gen = torch.Generator().manual_seed(0)
    p = _weights(gen)
    x = torch.randn(E, CAP, D, generator=gen)
    bf = {k: v.bfloat16() for k, v in p.items()}
    assert not meg.takes(x, p, "silu")          # the CPU
    assert not meg.takes(x.bfloat16(), bf, "silu")
    monkeypatch.setattr(meg, "DEVICE", "cpu")
    assert meg.takes(x, p, "silu")
    assert not meg.takes(x, p, "gelu")
    assert not meg.takes(x, {k: v for k, v in p.items() if k != "w_gate"},
                         "silu")
    assert not meg.takes(x.bfloat16(), p, "silu")
    assert not meg.takes(x, bf, "silu")
    assert not meg.takes(x.half(), {k: v.half() for k, v in p.items()},
                         "silu")
    assert not meg.takes(x.to("meta"), {k: v.to("meta") for k, v in
                                        p.items()}, "silu")
    w = dict(p, w_up=p["w_up"].clone().requires_grad_())
    assert not meg.takes(x, w, "silu")
    with torch.no_grad():
        assert meg.takes(x, w, "silu")
    # bf16: D = 12 and FF = 20 are whole float4s but not whole 8s
    assert not meg.takes(x.bfloat16(), bf, "silu")
    x16 = torch.randn(E, CAP, 16, generator=gen).bfloat16()
    w16 = {"w_gate": torch.randn(E, 16, 24).bfloat16(),
           "w_up": torch.randn(E, 16, 24).bfloat16(),
           "w_down": torch.randn(E, 24, 16).bfloat16()}
    assert meg.takes(x16, w16, "silu")
    assert not meg.takes(x16, dict(w16, w_up=w16["w_up"][..., :20]),
                         "silu")
    assert not meg.takes(x16, dict(w16, w_down=w16["w_down"].float()),
                         "silu")
    g16 = dict(w16, w_gate=w16["w_gate"].clone().requires_grad_())
    assert not meg.takes(x16, g16, "silu")
    with torch.no_grad():
        assert meg.takes(x16, g16, "silu")


@pytest.mark.parametrize("bad", ["shape", "fill", "dtype", "device",
                                 "mixed", "half"])
def test_wrapper_refuses_what_the_kernels_do_not_take(bad):
    gen = torch.Generator().manual_seed(0)
    p = _weights(gen)
    x = torch.randn(E, CAP, D, generator=gen)
    fill = torch.full((E,), 3)
    if bad == "shape":
        p["w_down"] = p["w_down"][:, :-1]
    elif bad == "fill":
        fill = fill.int()
    elif bad == "dtype":
        x = x.double()
    elif bad == "mixed":
        x = x.bfloat16()
    elif bad == "half":
        x = x.half()
        p = {k: v.half() for k, v in p.items()}
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        meg.moe_expert_ffn(x, p["w_gate"], p["w_up"], p["w_down"], fill)
    # float32 weights: a dtype the kernels do not take is refused before
    # the launch path looks at the device
    with pytest.raises(ValueError, match="no kernel"):
        meg.moe_expert_gemm_down(torch.empty(E, CAP, FF, device="meta"),
                                 p["w_down"].float().to("meta"),
                                 fill.to("meta"))
