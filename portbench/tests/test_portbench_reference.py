"""The plain references against goldens computed here by other code
(Python loops over numpy arrays), and the controls against the limits."""

import numpy as np
import torch

from portbench import catalog
from portbench.reference import cnn as cnn_ref
from portbench.reference import moe as moe_ref

NET = {"img_h": 4, "img_w": 5, "layers": [
    {"in_channels": 2, "out_channels": 3, "data_bits": 8, "coeff_bits": 6,
     "shift": 3},
    {"in_channels": 3, "out_channels": 2, "data_bits": 6, "coeff_bits": 4,
     "shift": 2}]}


def _cnn_golden(x, ws):
    """Pixel by pixel, tap by tap, with Python integers."""
    act = x.astype(np.int64)
    for w, spec in zip(ws, NET["layers"]):
        n, h, wd, cin = act.shape
        out = np.zeros((n, h, wd, w.shape[0]), np.int64)
        hi = 2 ** (spec["data_bits"] - 1) - 1
        for b in range(n):
            for i in range(h):
                for j in range(wd):
                    for o in range(w.shape[0]):
                        acc = 0
                        for c in range(cin):
                            for di in range(3):
                                for dj in range(3):
                                    ii, jj = i + di - 1, j + dj - 1
                                    if 0 <= ii < h and 0 <= jj < wd:
                                        acc += int(act[b, ii, jj, c]) \
                                            * int(w[o, c, di, dj])
                        out[b, i, j, o] = min(max(acc >> spec["shift"], 0),
                                              hi)
        act = out
    return act


def test_cnn_reference_matches_loop_golden():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 128, (2, 4, 5, 2))
    ws = [rng.integers(-32, 32, (3, 2, 3, 3)),
          rng.integers(-8, 8, (2, 3, 3, 3))]
    got = cnn_ref.forward(torch.from_numpy(x), [torch.from_numpy(w)
                                                for w in ws], NET)
    want = _cnn_golden(x, ws)
    assert (want != 0).mean() > 0.2        # not a comparison of zeros
    np.testing.assert_array_equal(got.numpy(), want)


def test_cnn_int4_control_differs():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 128, (2, 4, 5, 2)))
    ws = [torch.from_numpy(rng.integers(-32, 32, (3, 2, 3, 3))),
          torch.from_numpy(rng.integers(-8, 8, (2, 3, 3, 3)))]
    full = cnn_ref.forward(x, ws, NET)
    low = cnn_ref.forward(x, ws, NET, operand_bits=4)
    assert int((full != low).sum()) > 0


SPEC = {"num_experts": 4, "num_experts_per_tok": 2, "capacity_factor": 0.5,
        "data_bits": 4, "coeff_bits": 4}


def _fq(v, bits, floor):
    v = np.asarray(v, np.float32)
    s = np.float32(2 ** (bits - 1) - 1) / np.maximum(
        np.float32(np.abs(v).max()), np.float32(floor))
    return np.round(v * s) / s


def _moe_golden(x, p):
    """Token by token, expert by expert: quantize, route, count each
    expert's assignments in (token, choice) order, drop past capacity,
    run the kept experts in float64, add to the input."""
    e, k = SPEC["num_experts"], SPEC["num_experts_per_tok"]
    t = x.shape[0]
    cap = int(max(k, round(SPEC["capacity_factor"] * t * k / e)))
    w = {n: (v if n == "router" else _fq(v, SPEC["coeff_bits"], 1e-9))
         for n, v in p.items()}
    seen = [0] * e
    out = x.astype(np.float64).copy()
    for i in range(t):
        xq = _fq(x[i], SPEC["data_bits"], 1e-6)
        logits = xq.astype(np.float64) @ w["router"]
        prob = np.exp(logits - logits.max())
        prob /= prob.sum()
        order = sorted(range(e), key=lambda j: (-prob[j], j))[:k]
        gates = prob[order] / prob[order].sum()
        for g, ex in zip(gates, order):
            seen[ex] += 1
            if seen[ex] > cap:
                continue
            gate = xq @ w["w_gate"][ex].astype(np.float64)
            h = gate / (1 + np.exp(-gate)) * (xq @ w["w_up"][ex])
            out[i] += g * (h @ w["w_down"][ex])
    return out


def test_moe_reference_matches_loop_golden():
    """Six tokens over 4 experts, top-2, capacity 2: some assignments are
    dropped."""
    rng = np.random.default_rng(2)
    d, f, t = 8, 5, 6
    p = {"router": rng.standard_normal((d, 4)).astype(np.float32),
         "w_up": rng.standard_normal((4, d, f)).astype(np.float32),
         "w_gate": rng.standard_normal((4, d, f)).astype(np.float32),
         "w_down": rng.standard_normal((4, f, d)).astype(np.float32)}
    x = rng.standard_normal((t, d)).astype(np.float32)
    want = _moe_golden(x, p)
    layer = moe_ref.quantize_weights(
        {n: torch.from_numpy(v) for n, v in p.items()}, SPEC["coeff_bits"])
    got = moe_ref.layer(torch.from_numpy(x), layer, SPEC).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(want, x)


def test_to_tf32_rounds_to_ten_mantissa_bits():
    one = 1.0
    vals = torch.tensor([one + 2 ** -11, one + 3 * 2 ** -11,
                         one + 2 ** -10 + 2 ** -12, -(one + 3 * 2 ** -11)],
                        dtype=torch.float32)
    want = torch.tensor([one, one + 2 ** -9, one + 2 ** -10,
                         -(one + 2 ** -9)])
    assert torch.equal(moe_ref.to_tf32(vals), want)


def test_moe_tf32_control_fails_the_limits():
    """At a small width and the configuration's depth, with its weight
    scales, the TF32 control's token errors lie above the
    configuration's limit on their median."""
    config = catalog.config("qwen3-moe-30b-a3b-experts")
    limits, n = config["limits"], config["num_hidden_layers"]
    g = torch.Generator().manual_seed(3)
    d, f, e = 256, 64, 16
    spec = dict(num_experts=e, num_experts_per_tok=4, capacity_factor=2.0,
                data_bits=4, coeff_bits=4)
    layers = [moe_ref.quantize_weights(
        {"router": torch.randn(d, e, generator=g) / d ** 0.5,
         "w_up": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "w_gate": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "w_down": torch.randn(e, f, d, generator=g) / (2 * n * f) ** 0.5},
        4) for _ in range(n)]
    x = torch.randn(8, 32, d, generator=g)
    want = moe_ref.forward(x, layers, [spec] * n, 8)
    got = moe_ref.forward(x, layers, [spec] * n, 8, tf32=True)
    err = moe_ref.contribution_errors(got, want, x)
    assert float(err.median()) > limits["token_err_median"]
    same = moe_ref.contribution_errors(want, want, x)
    assert float(same.max()) == 0.0
