"""The port's sharding rules and dry-run helpers, held against the JAX
reference with no process group: ``parallel.sharding.ShardingRules``
over a ``MeshShape`` with the reference's tests' patched axis sizes
(16 x 16), spec for spec against ``repro.parallel.sharding`` for every
arch of the zoo in both modes; ``cnn_batch_sharding``'s rule; and
``init_abstract``, ``cache_abstract`` and ``input_specs`` shape for shape
and dtype for dtype against the reference's ``ShapeDtypeStruct``s; and
CNN data parallelism (``--shard``) over four CPU devices in one process,
bit-exact against the reference's ``cnn_forward_ref``.  Everything is
exact."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P, MeshShape, ShardingRules

ARCHS = [a for a in list_archs() if a != "paper-conv-sweep"]


def _ref_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


def _rules(arch, mode):
    """Both packages' rules for ``arch``, axis sizes patched to 16 x 16
    as the reference's tests patch them."""
    ref = ref_sharding.ShardingRules(
        ref_get_config(arch), jax.make_mesh((1, 1), ("data", "model")),
        mode=mode)
    port = ShardingRules(get_config(arch),
                         MeshShape((1, 1), ("data", "model")), mode=mode)
    for r in (ref, port):
        r.tp_size = r.dp_size = 16
    return ref, port


def _same_specs(port_tree, ref_tree):
    got, want = _flat(port_tree), _ref_flat(ref_tree)
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want
           if tuple(got[k]) != tuple(want[k])}
    assert not bad, bad


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, mode):
    """params_spec, batch_spec (train_4k), cache_spec (decode_32k) and
    opt_spec (float32 and int8 states), leaf by leaf."""
    ref, port = _rules(arch, mode)
    rmodel = ref_build_model(ref_get_config(arch))
    pmodel = build_model(get_config(arch), "meta")
    r_params, p_params = rmodel.init_abstract(), pmodel.init_abstract()
    r_pspec, p_pspec = ref.params_spec(r_params), port.params_spec(p_params)
    _same_specs(p_pspec, r_pspec)
    _same_specs(port.batch_spec(pmodel.input_specs(SHAPES["train_4k"])
                                ["batch"]),
                ref.batch_spec(rmodel.input_specs(REF_SHAPES["train_4k"])
                               ["batch"]))
    _same_specs(port.cache_spec(pmodel.input_specs(SHAPES["decode_32k"])
                                ["cache"]),
                ref.cache_spec(rmodel.input_specs(REF_SHAPES["decode_32k"])
                               ["cache"]))
    for state in ("float32", "int8"):
        r_opt = jax.eval_shape(
            lambda p: ref_adamw_init(p, RefAdamWConfig(state_dtype=state)),
            r_params)
        p_opt = adamw_init(p_params, AdamWConfig(state_dtype=state))
        _same_specs(port.opt_spec(p_opt, p_pspec),
                    ref.opt_spec(r_opt, r_pspec))


def _spec(tree, *path):
    for p in path:
        tree = tree[p]
    return tree


def _params_spec(arch, mode="tp", dp=None):
    _, port = _rules(arch, mode)
    if dp is not None:
        port.dp_size = dp
    return port.params_spec(build_model(get_config(arch),
                                        "meta").init_abstract())


def test_granite_mqa_head_not_sharded():
    spec = _params_spec("granite-20b")
    assert _spec(spec, "stack", "s0", "attn", "wq") == \
        P(None, None, "model", None)          # 48 heads ÷ 16 OK
    assert _spec(spec, "stack", "s0", "attn", "wk") == \
        P(None, None, None, None)             # 1 kv head: replicated


def test_gemma2_2b_heads_replicated():
    spec = _params_spec("gemma2-2b")           # 8 q heads < 16
    assert _spec(spec, "stack", "s0", "attn", "wq") == \
        P(None, None, None, None)
    assert _spec(spec, "stack", "s0", "mlp", "w_up") == \
        P(None, None, "model")


def test_moe_expert_parallel_spec():
    spec = _params_spec("qwen3-moe-30b-a3b")
    assert _spec(spec, "stack", "s0", "moe", "w_up") == \
        P(None, "model", None, None)          # experts over model


def test_fsdp_adds_data_axis():
    spec = _params_spec("llama4-maverick-400b-a17b", "fsdp", dp=16)
    assert "data" in _spec(spec, "stack", "s0", "attn", "wq")


def test_choose_mode_policy():
    mesh = MeshShape((1, 1), ("data", "model"))
    assert sharding.choose_mode(get_config("jamba-1.5-large-398b"),
                                mesh) == "fsdp"
    assert sharding.choose_mode(get_config("jamba-1.5-large-398b"), mesh) \
        == ref_sharding.choose_mode(
            ref_get_config("jamba-1.5-large-398b"),
            jax.make_mesh((1, 1), ("data", "model")))


@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_cnn_batch_sharding_rule(devices):
    """Batches 1-16 split over the devices where they divide their
    count, else replicated: the reference's rule, and the split."""
    mesh = sharding.cnn_data_mesh(["cpu"] * devices)
    ref_mesh = AbstractMesh((devices,), ("data",))
    for b in range(1, 17):
        got = sharding.cnn_batch_sharding(mesh, b)
        assert tuple(got.spec) == tuple(
            ref_sharding.cnn_batch_sharding(ref_mesh, b).spec)
        x = torch.arange(b * 2).reshape(b, 1, 2, 1)
        parts = got.split(x)
        assert len(parts) == devices
        assert all(p.shape[0] == (b // devices if b % devices == 0 else b)
                   for p in parts)
        assert torch.equal(got.join(parts), x)
    two_d = MeshShape((1, 1), ("data", "model"))
    assert sharding.cnn_batch_sharding(two_d, 8).spec == \
        P("data", None, None, None)


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in _flat(tree).items()}


def _ref_shapes(tree):
    return {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _ref_flat(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_helpers_equal_reference(arch):
    """init_abstract, cache_abstract and input_specs of every shape: the
    reference's shapes and dtypes leaf by leaf, on ``meta``."""
    rmodel = ref_build_model(ref_get_config(arch))
    pmodel = build_model(get_config(arch), "meta")
    params = pmodel.init_abstract()
    assert all(t.device.type == "meta" for t in _flat(params).values())
    assert _shapes(params) == _ref_shapes(rmodel.init_abstract())
    assert _shapes(pmodel.cache_abstract(4, 64)) == \
        _ref_shapes(rmodel.cache_abstract(4, 64))
    for name in SHAPES:
        got = pmodel.input_specs(SHAPES[name])
        want = rmodel.input_specs(REF_SHAPES[name])
        assert _shapes(got) == _ref_shapes(want), name


# ---------------------------------------------------------------------------
# CNN data parallelism (--shard), one process over four CPU devices
# ---------------------------------------------------------------------------

def test_shard_cnn_bit_exact_every_bucket():
    """``CompiledCNN``, ``CNNEngine`` and ``cnn_forward`` over a 4-device
    ``cnn_data_mesh``: a batch in every bucket (1, 2, 4, 8, 16; split
    where it divides 4, else replicated) and padded ones (3, 13), equal
    to the reference's ``cnn_forward_ref`` on the reference's
    weights."""
    import jax.numpy as jnp
    from repro.core import cnn as ref_cnn
    from repro_torch import convert
    from repro_torch.core import cnn
    from repro_torch.parallel.sharding import cnn_data_mesh
    from repro_torch.runtime import CompiledCNN
    from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest
    from tests.torch_parity import narrow_config
    ref_cfg, cfg = narrow_config(ref_cnn), narrow_config(cnn)
    arrays = [np.asarray(w) for w in
              ref_cnn.init_cnn(jax.random.PRNGKey(0), ref_cfg)]
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    blocks = [s.block for s in cfg.layers]
    mesh = cnn_data_mesh(["cpu"] * 4)
    compiled = CompiledCNN(cfg, params, blocks, max_batch=16, mesh=mesh)
    assert compiled.mesh is mesh and compiled.device.type == "cpu"
    for n in (1, 2, 3, 4, 8, 13, 16):
        xb = np.stack(compiled.sample_inputs(n, seed=n))
        want = np.asarray(ref_cnn.cnn_forward_ref(
            [jnp.asarray(a) for a in arrays], jnp.asarray(xb), ref_cfg))
        assert np.array_equal(compiled(xb).numpy(), want), n
        got = cnn.cnn_forward(params, torch.from_numpy(xb), cfg, blocks,
                              mesh=mesh)
        assert np.array_equal(got.numpy(), want), n
    assert all(k[-2] == mesh.token for k in compiled.cache._execs)
    engine = CNNEngine(cfg, params, blocks, CNNServeConfig(max_batch=8),
                       mesh, device="cpu")
    reqs = [ImageRequest(image=im, request_id=i)
            for i, im in enumerate(compiled.sample_inputs(11, seed=5))]
    engine.run(reqs)
    want = np.asarray(ref_cnn.cnn_forward_ref(
        [jnp.asarray(a) for a in arrays],
        jnp.asarray(np.stack([r.image for r in reqs])), ref_cfg))
    assert np.array_equal(np.stack([r.output for r in reqs]), want)


def test_shard_flag_needs_cuda_cards():
    """``--shard`` shards over the CUDA cards: without one the mesh
    raises, and the launcher refuses it on the CPU path and beside
    other workloads."""
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import cnn_data_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cnn_data_mesh()
    for extra in (["--torch-device", "cpu"], ["--workload", "moe"],
                  ["--fleet"]):
        with pytest.raises(SystemExit):
            serve.parse_args(["--shard"] + extra)
    assert serve.parse_args(["--shard", "--async"]).shard
