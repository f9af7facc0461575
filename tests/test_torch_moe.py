"""The port's MoE layer (``repro_torch.models.moe``) held against the
reference's (``repro.models.moe``): twins of ``tests/test_moe.py``'s
single-device tests, each also comparing the port's ``moe_layer``
(flat and grouped), ``moe_layer_dense_ref`` and ``aux`` with the
reference's on the reference's parameters (carried as numpy) and
inputs, at ``rtol=1e-5, atol=1e-5``, and the experts both pick."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.configs import smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro_torch.configs import smoke_config
from repro_torch.models import moe

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(top_k=2, experts=4, cf=8.0, arch="qwen3-moe-30b-a3b", **kw):
    """The reference's and the port's float32 config of ``arch`` with
    the given routing (``tests/test_moe.py``'s ``_cfg``)."""
    out = []
    for smoke in (ref_smoke_config, smoke_config):
        cfg = smoke(arch).with_overrides(dtype="float32")
        out.append(cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, num_experts=experts, top_k=top_k,
            capacity_factor=cf), **kw))
    return out


def _carry(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _ref_top_ids(p, x, k):
    """The experts the reference's layers route each token to."""
    probs = jax.nn.softmax(
        jnp.asarray(x).reshape(-1, x.shape[-1]) @ p["router"], axis=-1)
    return np.asarray(ref_moe._top_k(probs, k)[1])


def _against_reference(p, x, rcfg, tcfg):
    """Run both packages' ``moe_layer`` and ``moe_layer_dense_ref`` on
    the reference's parameters ``p`` and numpy ``x``: equal top_ids,
    outputs and aux within TOL.  Returns the port's (out, aux, dense)."""
    tp, tx = _carry(p), torch.from_numpy(np.array(x))
    out, aux = moe.moe_layer(tp, tx, tcfg)
    dense = moe.moe_layer_dense_ref(tp, tx, tcfg)
    rout, raux = ref_moe.moe_layer(p, jnp.asarray(x), rcfg)
    rdense = ref_moe.moe_layer_dense_ref(p, jnp.asarray(x), rcfg)
    _, _, ids = moe._route(tx.reshape(-1, x.shape[-1]), tp["router"],
                           tcfg.moe.top_k)
    np.testing.assert_array_equal(ids.numpy(),
                                  _ref_top_ids(p, x, rcfg.moe.top_k))
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(rdense), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)
    return out, aux, dense


def _x(seed, shape):
    return np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(seed),
                                              shape))


def test_dispatch_matches_dense_oracle():
    rcfg, tcfg = _cfgs()
    p = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg)
    x = _x(1, (2, 16, rcfg.d_model))
    out, aux, dense = _against_reference(p, x, rcfg, tcfg)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert float(aux) >= 0


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       top_k=st.integers(1, 3),
       experts=st.sampled_from([4, 8]))
def test_dispatch_property(seed, top_k, experts):
    """With generous capacity the sorted dispatch equals the dense path
    for random routers and tokens, in the port as in the reference."""
    rcfg, tcfg = _cfgs(top_k=top_k, experts=experts, cf=float(experts))
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg)
    x = _x(seed + 1, (1, 12, rcfg.d_model))
    out, _, dense = _against_reference(p, x, rcfg, tcfg)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_capacity_drops_tokens():
    """At capacity_factor → 0 the layer drops most tokens and stays
    finite, dropping exactly the reference's."""
    rcfg, tcfg = _cfgs(cf=0.25)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg)
    x = _x(1, (2, 32, rcfg.d_model))
    out, _, dense = _against_reference(p, x, rcfg, tcfg)
    assert bool(torch.all(torch.isfinite(out)))
    assert float(torch.max(torch.abs(out - dense))) > 1e-3


def test_shared_expert_path():
    rcfg, tcfg = _cfgs(arch="llama4-maverick-400b-a17b", top_k=1,
                       experts=4, cf=8.0)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg)
    assert "shared_up" in p
    assert set(moe.init_moe(None, tcfg)) == set(p)
    x = _x(1, (1, 8, rcfg.d_model))
    out, _, dense = _against_reference(p, x, rcfg, tcfg)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_aux_loss_prefers_balance():
    """Uniform routing yields a lower aux loss than collapsed routing,
    through the port's routing and loss, equal to the reference's."""
    n, e = 64, 4
    balanced = np.tile(np.eye(e, dtype=np.float32), (n // e, 1)) * 10.0
    collapsed = np.zeros((n, e), np.float32)
    collapsed[:, 0] = 10.0

    def aux_of(logits):
        probs = torch.softmax(torch.from_numpy(logits), dim=-1)
        _, ids = moe._top_k(probs, 1)
        counts = moe._expert_counts(ids.reshape(-1), e)
        return float(moe._aux_loss(probs, counts, n, e, 1.0))

    def ref_aux_of(logits):
        probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
        _, ids = jax.lax.top_k(probs, 1)
        me = jnp.mean(probs, axis=0)
        ce = jnp.mean(jnp.sum(jax.nn.one_hot(ids, e), axis=1), axis=0)
        return float(e * jnp.sum(me * ce))

    assert aux_of(balanced) < aux_of(collapsed)
    for logits in (balanced, collapsed):
        assert aux_of(logits) == pytest.approx(ref_aux_of(logits),
                                               rel=1e-6)


def test_grouped_routing_matches_dense_oracle():
    """Group-local routing equals the dense oracle at high capacity, and
    the reference's grouped layer on its parameters."""
    rcfg, tcfg = _cfgs(cf=8.0, moe_groups=4)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg)
    x = _x(1, (2, 16, rcfg.d_model))
    out, _, dense = _against_reference(p, x, rcfg, tcfg)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0])
def test_grouped_capacity_drops_equal_reference(cf):
    """Group-local capacity drops (a per-group capacity of
    cf·n_loc·k/E) drop what the reference's grouped layer drops."""
    rcfg, tcfg = _cfgs(cf=cf, moe_groups=4)
    p = ref_moe.init_moe(jax.random.PRNGKey(3), rcfg)
    _against_reference(p, _x(4, (2, 16, rcfg.d_model)), rcfg, tcfg)


def test_top_k_puts_the_lower_index_first_on_ties():
    """A row of equal probabilities — every zero padding row's router
    output — picks experts 0..k-1 in order, as ``lax.top_k`` does."""
    probs = torch.full((3, 8), 0.125)
    probs[1, 5] = 0.5                 # one clear winner, then ties
    vals, ids = moe._top_k(probs, 3)
    rvals, rids = ref_moe._top_k(jnp.asarray(probs.numpy()), 3)
    assert ids.tolist() == [[0, 1, 2], [5, 0, 1], [0, 1, 2]]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


@pytest.mark.parametrize("bits", [2, 4, 8, 10, 16])
def test_quantize_moe_params_equals_reference(bits):
    """Per-tensor fake quantization is bit-exact with the reference's,
    the router untouched, the 1e-9 floor kept for a zero tensor."""
    rcfg, tcfg = _cfgs(arch="llama4-maverick-400b-a17b", top_k=1)
    p = ref_moe.init_moe(jax.random.PRNGKey(bits), rcfg)
    p["shared_down"] = jnp.zeros_like(p["shared_down"])
    want = ref_moe.quantize_moe_params(p, bits)
    got = moe.quantize_moe_params(_carry(p), bits)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert torch.equal(got["router"], _carry(p)["router"])
    assert not torch.any(got["shared_down"])


def test_init_moe_shapes_and_scale():
    """The port's draw has the reference's keys, shapes and dtypes, its
    scale 1/sqrt(fan_in), and lands on the generator's device; without
    a generator the tensors are on ``meta``."""
    rcfg, tcfg = _cfgs(arch="llama4-maverick-400b-a17b", top_k=1,
                       experts=8)
    want = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg)
    got = moe.init_moe(torch.Generator().manual_seed(0), tcfg)
    meta = moe.init_moe(None, tcfg)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape == tuple(meta[k].shape), k
        assert got[k].dtype == torch.float32 and meta[k].is_meta
        fan_in = {"w_down": tcfg.moe.d_ff_expert,
                  "shared_down": tcfg.moe.d_ff_expert}.get(k, tcfg.d_model)
        assert float(got[k].std()) == pytest.approx(fan_in ** -0.5,
                                                    rel=0.1), k
