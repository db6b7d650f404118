"""The port's layer surface (``geot_tpu_torch.models.layers``: its
``__all__``, ``helpers``, ``weight_init``, ``drop``, ``factories`` and
``mlp``) against ``geot_tpu.models.layers``, module by module; the
neighbourhood layers (``knn``, ``subsample``, ``ASSA``, ``kmeans``,
``graph_conv``, ``attention``) are in ``test_torch_layers_graph.py``,
with the helpers of this file.

Inputs from a numpy seed at a small size (2 clouds of at most 256
points, widths at most 64, depth 2); weights drawn by numpy into
``geot_tpu``'s flax tree and carried across by ``params_from_jax``. The
draws of the stochastic layers (DropPath, DropBlock, the dilated kNN's
gate and permutation, k-means' first centres, the initialisers' base
samples) are ``geot_tpu``'s, drawn from its ``jax.random`` key and
passed to the port. Tolerances: indices bit-equal; float32 outputs within
``RTOL`` of the output's largest magnitude; float64 forwards and
gradients (ASSA, ``ResDynBlock``, ``TransformerEncoder``, k-means)
within ``RTOL64``.
"""
import math

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from geot_tpu.models import layers as J
from geot_tpu.models.layers import factories as jfactories

from geot_tpu_torch.engine.convert import params_from_jax
from geot_tpu_torch.models import layers as L
from geot_tpu_torch.models.layers import factories as tfactories
from geot_tpu_torch.models.layers.common import Dense

RTOL = 1e-5
RTOL64 = 1e-10
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    both_inf = np.isinf(got) & np.isinf(want) & (got == want)
    with np.errstate(invalid="ignore"):        # inf - inf where both agree
        diff = np.where(both_inf, 0.0, np.abs(got - want))
    scale = np.abs(np.where(np.isinf(want), 0.0, want)).max()
    return float(diff.max() / max(scale, 1e-30))


def _close(got, want, rtol=RTOL):
    assert _rel(got, want) <= rtol, _rel(got, want)


def draw_variables(jmodel, *args, seed=3, dtype=np.float32, **kwargs):
    """Variables of ``jmodel``'s tree drawn by numpy: kernels N(0, 1 /
    fan_in), biases, shifts and raw parameters N(0, 0.1^2), scales 1 +
    U(-0.1, 0.1), running means U(-0.05, 0.05), variances U(0.8, 1.2)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, *args, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1.0 + rng.uniform(-0.1, 0.1, shape)
        elif name == "mean":
            a = rng.uniform(-0.05, 0.05, shape)
        elif name == "var":
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port(module, variables, dtype=torch.float32):
    module = module.to(dtype)
    module.load_state_dict(params_from_jax(
        {"params": variables.get("params", {}),
         "batch_stats": variables.get("batch_stats", {})}), strict=True)
    return module.eval()


def _japply(jmodel, variables, *args, training=False, **kwargs):
    """``jmodel``'s forward, compiled (one compile costs less than the
    eager dispatch of its operations); training mode updates no state."""
    def run(v, *xs):
        if not training:
            return jmodel.apply(v, *xs, **kwargs)
        return jmodel.apply(v, *xs, training=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(5)},
                            **kwargs)[0]

    return jax.jit(run)(variables, *args)


def _cloud(seed, n=128, c=3, dtype=np.float32):
    return np.random.default_rng(seed).uniform(-1, 1, (B, n, c)).astype(
        dtype)


def _grads64(jmodel, variables, jinputs, tmodel, tinputs, wseed=0,
             **kwargs):
    """Float64 train-mode forward and gradient of ``sum(out * r)`` (r a
    fixed draw) in both packages: (rel forward, rel input grads, rel
    weight grads by port name)."""
    def forward(params, *xs):
        v = dict(variables, params=params)
        return _japply(jmodel, v, *xs, training=True, **kwargs)

    shape = jax.eval_shape(forward, variables["params"], *jinputs).shape
    r = np.random.default_rng(wseed).standard_normal(shape).astype(
        np.float64)

    def loss(params, *xs):
        o = forward(params, *xs)
        return jnp.sum(o * r), o

    argnums = tuple(range(len(jinputs) + 1))
    gj, out_j = jax.jit(jax.grad(loss, argnums=argnums, has_aux=True))(
        variables["params"], *jinputs)
    tmodel.train()
    xs = [t.clone().requires_grad_() for t in tinputs]
    out_t = tmodel(*xs)
    (out_t * _t(r)).sum().backward()
    res = {"forward": _rel(out_t, out_j)}
    for i, (x, g) in enumerate(zip(xs, gj[1:])):
        res[f"input{i}"] = _rel(x.grad, g)
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                              gj[0]),
                            "batch_stats": {}})
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got), set(want) ^ set(got)
    res["weights"] = max(_rel(got[k].grad, v) for k, v in want.items())
    return res


# --- the surface ------------------------------------------------------------

def test_layers_all_holds_every_geot_tpu_name():
    missing = sorted(set(J.__all__) - set(L.__all__))
    assert not missing, missing
    for name in L.__all__:
        assert hasattr(L, name), name
    assert L.get_aggregation_feautres is L.get_aggregation_features


# --- helpers ----------------------------------------------------------------

def test_tuple_helpers_and_make_divisible_match():
    for fn in ("to_1tuple", "to_2tuple", "to_3tuple", "to_4tuple"):
        for v in (3, (1, 2), [4, 5, 6]):
            assert getattr(L, fn)(v) == getattr(J, fn)(v)
    assert L.to_ntuple(5)(2) == J.to_ntuple(5)(2)
    for v in (3, 7, 24, 37.5, 100):
        assert L.make_divisible(v) == J.make_divisible(v)
    assert L.drop_path_rates(0.3, 4) == J.drop_path_rates(0.3, 4)


def test_multiple_sequential_matches_flax():
    x = _cloud(1, 16, 8)
    split = lambda a: (a[..., :2], a[..., 2:])      # noqa: E731
    join = lambda a, b: a * b.sum(-1, keepdims=True)  # noqa: E731
    jm = J.MultipleSequential([fnn.Dense(6), split, join, fnn.Dense(3)])
    v = draw_variables(jm, jnp.asarray(x))
    tm = port(L.MultipleSequential([
        Dense(8, 6), split, lambda a, b: a * b.sum(-1, keepdim=True),
        Dense(2, 3)]), v)
    _close(tm(_t(x)), _japply(jm, v, jnp.asarray(x)))


# --- weight_init ------------------------------------------------------------

def test_trunc_normal_on_geot_tpus_draw():
    key = jax.random.PRNGKey(7)
    shape = (64, 48)
    u = _t(jax.random.uniform(key, shape, jnp.float32))
    for kw in ({}, {"mean": 0.5, "std": 0.2, "a": 0.1, "b": 0.8},
               {"std": 0.02}):
        want = J.trunc_normal_(key, shape, **kw)
        got = L.trunc_normal_(shape, draw=u, **kw)
        _close(got, want)
        assert float(got.min()) >= kw.get("a", -2.0)
    # in place, from a generator: the torch reference's call
    w = torch.empty(4000)
    assert L.trunc_normal_(w, std=0.5, a=-1.0, b=1.0,
                           generator=torch.Generator().manual_seed(0)) is w
    assert float(w.abs().max()) <= 1.0 and 0.3 < float(w.std()) < 0.5


@pytest.mark.parametrize("fan_axes", ["torch", "flax"])
@pytest.mark.parametrize("distribution",
                         ["normal", "truncated_normal", "uniform"])
@pytest.mark.parametrize("mode", ["fan_in", "fan_out", "fan_avg"])
def test_variance_scaling_on_geot_tpus_draw(mode, distribution, fan_axes):
    key = jax.random.PRNGKey(11)
    shape = (24, 16, 3)
    draw = (jax.random.normal(key, shape, jnp.float32)
            if distribution == "normal"
            else jax.random.uniform(key, shape, jnp.float32))
    want = J.variance_scaling_(key, shape, scale=2.0, mode=mode,
                               distribution=distribution, fan_axes=fan_axes)
    got = L.variance_scaling_(shape, scale=2.0, mode=mode,
                              distribution=distribution, fan_axes=fan_axes,
                              draw=_t(draw))
    _close(got, want)


def test_lecun_normal_and_dtype():
    key = jax.random.PRNGKey(12)
    u = _t(jax.random.uniform(key, (32, 20), jnp.float32))
    for axes in ("torch", "flax"):
        _close(L.lecun_normal_((32, 20), fan_axes=axes, draw=u),
               J.lecun_normal_(key, (32, 20), fan_axes=axes))
    assert L.lecun_normal_((3, 4), dtype=torch.float64).dtype == \
        torch.float64


# --- drop -------------------------------------------------------------------

def test_drop_path_on_geot_tpus_draw():
    x = _cloud(2, 16, 8)
    key = jax.random.PRNGKey(3)
    draw = _t(jax.random.uniform(key, (B, 1, 1), jnp.float32))
    for scale in (True, False):
        want = J.drop_path(jnp.asarray(x), key, 0.5, True, scale)
        _close(L.drop_path(_t(x), 0.5, True, scale, draw=draw), want)
    assert L.drop_path(_t(x), 0.5, False) is not None
    torch.testing.assert_close(L.drop_path(_t(x), 0.5, False), _t(x))


@pytest.mark.parametrize("variant,block_size",
                         [("block", 3), ("block", 4), ("block_noise", 3),
                          ("batchwise", 4), ("fast", 3), ("fast_noise", 4)])
def test_drop_block_on_geot_tpus_draws(variant, block_size):
    x = np.random.default_rng(4).standard_normal((2, 9, 9, 5)).astype(
        np.float32)
    key = jax.random.PRNGKey(21)
    k_seed, k_noise = jax.random.split(key)
    noise = "noise" in variant
    shape = (1, 9, 9, 5) if variant == "batchwise" else x.shape
    u = _t(jax.random.uniform(k_seed, shape, jnp.float32))
    z = _t(jax.random.normal(k_noise, shape, jnp.float32))
    if variant.startswith("fast"):
        want = J.drop_block_fast_2d(jnp.asarray(x), key, 0.2, block_size,
                                    1.0, noise)
        got = L.drop_block_fast_2d(_t(x), 0.2, block_size, 1.0, noise,
                                   uniform=u, normal=z)
    else:
        want = J.drop_block_2d(jnp.asarray(x), key, 0.2, block_size, 1.0,
                               noise, variant == "batchwise")
        got = L.drop_block_2d(_t(x), 0.2, block_size, 1.0, noise,
                              variant == "batchwise", uniform=u, normal=z)
    _close(got, want)
    assert not np.allclose(np.asarray(want), x)      # something was dropped


def test_drop_block_module_is_the_function():
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(3))
    for fast, fn in ((True, L.drop_block_fast_2d), (False, L.drop_block_2d)):
        tm = L.DropBlock2d(0.3, 3, fast=fast)
        torch.testing.assert_close(tm.train()(_t(x), uniform=u),
                                   fn(_t(x), 0.3, 3, uniform=u),
                                   rtol=0, atol=0)
        torch.testing.assert_close(tm.eval()(_t(x)), _t(x))
        # geot_tpu's module is the same function on its own draw
        jm = J.DropBlock2d(0.3, 3, fast=fast)
        assert np.allclose(jm.apply({}, jnp.asarray(x)), x)


# --- factories --------------------------------------------------------------

ACTS = sorted(jfactories._ACT_FNS) + [{"act": "leakyrelu",
                                       "negative_slope": 0.2},
                                      {"act": "elu", "alpha": 0.5}]


@pytest.mark.parametrize("act", ACTS, ids=str)
def test_create_act_matches_jax(act):
    x = np.linspace(-4, 4, 97).astype(np.float32)
    _close(L.create_act(act)(_t(x)), J.create_act(act)(jnp.asarray(x)))
    assert L.create_act(None) is None and L.create_act({"act": None}) is None


NORMS = (sorted(jfactories._BN_NAMES) + sorted(jfactories._LN_NAMES)
         + sorted(jfactories._IN_NAMES)
         + [{"norm": "gn", "num_groups": 4}, {"norm": "bn", "eps": 1e-3,
                                             "momentum": 0.3}])


@pytest.mark.parametrize("norm", NORMS, ids=str)
def test_create_norm_matches_flax_in_eval_and_training(norm):
    x = _cloud(6, 32, 16)
    jm = J.create_norm(norm, 16)
    v = draw_variables(jm, jnp.asarray(x))
    tm = port(L.create_norm(norm, 16), v)
    _close(tm(_t(x)), _japply(jm, v, jnp.asarray(x)))
    if isinstance(jm, J.PointBatchNorm):
        want, stats = jm.apply(v, jnp.asarray(x), training=True,
                               mutable=["batch_stats"])
        tm.train()
        _close(tm(_t(x)), want)
        _close(tm.bn.running_var, stats["batch_stats"]["bn"]["var"])
        _close(tm.bn.running_mean, stats["batch_stats"]["bn"]["mean"])


def test_create_norm_refusals_match():
    for bad in ("bogus", {"norm": "gn"}):
        with pytest.raises(ValueError):
            J.create_norm(bad, 8, dimension="1d")
        with pytest.raises(ValueError):
            L.create_norm(bad, 8, dimension="1d")
    assert L.create_norm(None, 8) is None
    with pytest.raises(NotImplementedError):
        L.create_convblock1d(8, 16, 3)


BLOCKS = [("1d", "bn", "relu", "conv-norm-act"),
          ("1d", "ln", "gelu", "norm-act-conv"),
          ("2d", "in2d", "prelu", "conv-act-norm"),
          ("2d", "bn2d", "prelu", "norm-act-conv"),
          ("linear", None, "leakyrelu", "conv-norm-act"),
          ("linear", "fastbn", None, "conv-norm-act")]


@pytest.mark.parametrize("kind,norm,act,order", BLOCKS, ids=str)
def test_conv_blocks_match_flax(kind, norm, act, order):
    make = {"1d": "create_convblock1d", "2d": "create_convblock2d",
            "linear": "create_linearblock"}[kind]
    x = _cloud(7, 32, 12) if kind != "2d" else \
        np.random.default_rng(7).standard_normal((2, 8, 4, 12)).astype(
            np.float32)
    jm = getattr(J, make)(12, 20, norm_args=norm, act_args=act, order=order)
    v = draw_variables(jm, jnp.asarray(x))
    tm = port(getattr(L, make)(12, 20, norm_args=norm, act_args=act,
                               order=order), v)
    _close(tm(_t(x)), _japply(jm, v, jnp.asarray(x)))
    _close(tm.train()(_t(x)), _japply(jm, v, jnp.asarray(x), training=True))


@pytest.mark.parametrize("act", ["relu", "prelu"])
def test_res_conv_block_and_pointwise_convs_match_flax(act):
    x = np.random.default_rng(8).standard_normal((2, 6, 5, 16)).astype(
        np.float32)
    res = np.random.default_rng(9).standard_normal((2, 6, 5, 16)).astype(
        np.float32)
    jm = J.CreateResConvBlock2D([16, 24, 32, 16], norm_args="bn",
                                act_args=act)
    v = draw_variables(jm, jnp.asarray(x))
    tm = port(L.CreateResConvBlock2D([16, 24, 32, 16], norm_args="bn",
                                     act_args=act), v)
    _close(tm(_t(x)), _japply(jm, v, jnp.asarray(x)))
    _close(tm(_t(x), _t(res)), _japply(jm, v, jnp.asarray(x),
                                       jnp.asarray(res)))
    _close(tm.train()(_t(x)), _japply(jm, v, jnp.asarray(x), training=True))
    for make in ("Conv1d", "Conv2d"):
        jc = getattr(J, make)(16, 8)
        vc = draw_variables(jc, jnp.asarray(x))
        _close(port(getattr(L, make)(16, 8), vc)(_t(x)),
               _japply(jc, vc, jnp.asarray(x)))
    assert tfactories.Conv1d(16).conv.out_features == 16


# --- mlp --------------------------------------------------------------------

MLPS = [("Mlp", {}), ("Mlp", {"act_args": "relu", "out_features": 10}),
        ("GluMlp", {}), ("GatedMlp", {"gate": True}), ("GatedMlp", {}),
        ("ConvMlp", {"norm_args": "bn"}), ("ConvMlp", {"norm_args": "ln"}),
        ("ConvMlp", {"act_args": "prelu"})]


@pytest.mark.parametrize("name,kw", MLPS, ids=str)
def test_mlp_family_matches_flax(name, kw):
    jkw, tkw = dict(kw), dict(kw)
    if jkw.pop("gate", False):
        tkw.pop("gate")
        jkw["gate_layer"] = fnn.Dense(12)
        tkw["gate_layer"] = Dense(24, 12)
    x = _cloud(10, 24, 16)
    jm = getattr(J, name)(hidden_features=24, **jkw)
    v = draw_variables(jm, jnp.asarray(x))
    tm = port(getattr(L, name)(16, hidden_features=24, **tkw), v)
    _close(tm(_t(x)), _japply(jm, v, jnp.asarray(x)))
    _close(tm.train()(_t(x)), _japply(jm, v, jnp.asarray(x), training=True))
