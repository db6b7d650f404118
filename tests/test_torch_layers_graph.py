"""The port's neighbourhood layers (``geot_tpu_torch.models.layers``:
``knn``, ``subsample``, ``ASSA``, ``kmeans``, ``graph_conv``,
``attention``) against ``geot_tpu.models.layers``, module by module, with
the helpers and tolerances of ``test_torch_layers_surface.py``.

Inputs from a numpy seed at a small size (2 clouds of at most 256
points, widths at most 64, depth 2); weights drawn by numpy into
``geot_tpu``'s flax tree and carried across by ``params_from_jax``. The
draws (the dilated kNN's gate and permutation, k-means' first centres)
are ``geot_tpu``'s, passed to the port. Tolerances: indices bit-equal;
float32 outputs within ``RTOL`` of the output's largest magnitude; float64
forwards and gradients (ASSA, ``ResDynBlock``, ``TransformerEncoder``,
k-means) within ``RTOL64``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.models import layers as J

from geot_tpu_torch.models import layers as L

from test_torch_layers_surface import (  # noqa: F401 (the fixtures)
    B, RTOL64, _close, _cloud, _grads64, _japply, _t, draw_variables,
    port, x64)
from torch_helpers import one_torch_thread  # noqa: F401


# --- knn and subsample ------------------------------------------------------

def test_knn_layers_match_jax():
    xyz = _cloud(11, 200)
    q = np.ascontiguousarray(xyz[:, :150])
    for k, support in ((3, xyz), (12, None)):
        dj, ij = J.knn_point(k, jnp.asarray(q),
                             None if support is None else jnp.asarray(
                                 support))
        dt, it = L.knn_point(k, _t(q), None if support is None
                             else _t(support))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        _close(dt, dj)
        dk, ik = L.KNN(k)(_t(q), None if support is None else _t(support))
        assert torch.equal(ik, it)
    dj, ij = J.DilatedKNN(4, 2)(jnp.asarray(xyz))
    dt, it = L.DilatedKNN(4, 2)(_t(xyz))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(dt, dj)


@pytest.mark.parametrize("epsilon", [0.0, 1.0])
def test_dense_dilated_stochastic_on_geot_tpus_draws(epsilon):
    edges = np.random.default_rng(12).integers(0, 99, (2, 30, 12)).astype(
        np.int32)
    rng = jax.random.PRNGKey(4)
    r_gate, r_perm = jax.random.split(rng)
    draws = (float(jax.random.uniform(r_gate)),
             _t(jax.random.permutation(r_perm, 12)))
    want = J.DenseDilated(4, 3, True, epsilon)(jnp.asarray(edges), rng,
                                               training=True)
    got = L.DenseDilated(4, 3, True, epsilon)(_t(edges), training=True,
                                              draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # eval, or no draws: every d-th column
    np.testing.assert_array_equal(
        L.DenseDilated(4, 3, True, epsilon)(_t(edges)).numpy(),
        edges[..., ::3])
    g = torch.Generator().manual_seed(0)
    assert L.DenseDilated(4, 3, True, epsilon)(
        _t(edges), g, training=True).shape == (2, 30, 4)


def test_subsample_layers_match_jax():
    xyz = _cloud(13, 256)
    np.testing.assert_array_equal(
        L.furthest_point_sample(_t(xyz), 40).numpy(),
        np.asarray(J.furthest_point_sample(jnp.asarray(xyz), 40)))
    rng = jax.random.PRNGKey(6)
    perms = np.stack([np.asarray(jax.random.permutation(k, 256))
                      for k in jax.random.split(rng, B)])
    np.testing.assert_array_equal(
        L.random_sample(_t(xyz), 32, perms=_t(perms)).numpy(),
        np.asarray(J.random_sample(jnp.asarray(xyz), 32, rng)))
    got = L.random_sample(_t(xyz), 32,
                          generator=torch.Generator().manual_seed(1))
    assert got.shape == (B, 32) and all(len(set(r.tolist())) == 32
                                        for r in got)


# --- ASSA -------------------------------------------------------------------

GROUP = {"NAME": "ballquery", "radius": 0.5, "nsample": 12}


def _assa_inputs(dtype=np.float32):
    xyz = _cloud(14, 128, dtype=dtype)
    feats = np.random.default_rng(15).standard_normal((B, 128, 16)).astype(
        dtype)
    return np.ascontiguousarray(xyz[:, :32]), xyz, feats


@pytest.mark.parametrize("chans,reduction,use_res",
                         [([16, 24, 32], "mean", True),
                          ([24, 24], "max", True),
                          ([16, 24, 32, 32], "sum", False),
                          ([30], "mean", True)], ids=str)
def test_assa_matches_flax(chans, reduction, use_res):
    q, xyz, f = _assa_inputs()
    args = [jnp.asarray(a) for a in (q, xyz, f)]
    jm = J.ASSA(chans, GROUP, reduction, use_res)
    v = draw_variables(jm, *args)
    tm = port(L.ASSA(16, chans, GROUP, reduction, use_res), v)
    _close(tm(*map(_t, (q, xyz, f))), _japply(jm, v, *args))
    _close(tm.train()(*map(_t, (q, xyz, f))),
           _japply(jm, v, *args, training=True))
    jl = J.LocalAggregation(chans, GROUP, reduction=reduction,
                            aggr_type="assa", use_res=use_res)
    vl = draw_variables(jl, *args)
    tl = port(L.LocalAggregation(16, chans, GROUP, reduction=reduction,
                                 aggr_type="assa", use_res=use_res), vl)
    _close(tl(*map(_t, (q, xyz, f))), _japply(jl, vl, *args))


def test_assa_float64_forward_and_gradient(x64):
    q, xyz, f = _assa_inputs(np.float64)
    args = [jnp.asarray(a) for a in (q, xyz, f)]
    jm = J.ASSA([16, 24, 32], GROUP)
    v = draw_variables(jm, *args, dtype=np.float64)
    tm = port(L.ASSA(16, [16, 24, 32], GROUP), v, torch.float64)
    res = _grads64(jm, v, args, tm, [_t(a) for a in (q, xyz, f)])
    assert max(res.values()) <= RTOL64, res


# --- k-means ----------------------------------------------------------------

def test_kmeans_float64_on_geot_tpus_first_centres(x64):
    # 3-d points and 20-d features, near-ties in float32 and all: float64
    for c in (3, 20):
        x = np.random.default_rng(16 + c).standard_normal((200, c))
        rng = jax.random.PRNGKey(c)
        init = np.asarray(jax.random.choice(rng, 200, (16,), replace=False))
        aj, cj = J.kmeans(jnp.asarray(x), 16, iters=6, rng=rng)
        at, ct = L.kmeans(_t(x), 16, iters=6, init_idx=_t(init))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        _close(ct, cj, RTOL64)
        aj, cj = J.kmeans(jnp.asarray(x), 16, iters=6)
        at, ct = L.kmeans(_t(x), 16, iters=6)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        _close(ct, cj, RTOL64)


@pytest.mark.parametrize("feature_type", ["dp", "pj_dp", "pi_dp"])
def test_kmeans_embed_float64_matches_flax(x64, feature_type):
    xyz = _cloud(18, 96, dtype=np.float64)
    jm = J.KMeansEmbed(num_groups=8, encoder_dim=32,
                       feature_type=feature_type, kmeans_iters=4)
    v = draw_variables(jm, jnp.asarray(xyz), dtype=np.float64)
    tm = port(L.KMeansEmbed(8, 32, feature_type, 4), v, torch.float64)
    got = tm(_t(xyz))
    want = _japply(jm, v, jnp.asarray(xyz))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, RTOL64)


def test_kmeans_embed_empty_cluster_is_minus_inf():
    # 6 distinct points repeated, 8 clusters: 2 stay empty in both
    base = _cloud(19, 6)
    xyz = np.concatenate([base] * 4, axis=1)
    jm = J.KMeansEmbed(num_groups=8, encoder_dim=16, kmeans_iters=2)
    v = draw_variables(jm, jnp.asarray(xyz))
    tm = port(L.KMeansEmbed(8, 16, "dp", 2), v)
    got, want = tm(_t(xyz)), _japply(jm, v, jnp.asarray(xyz))
    assert np.isneginf(np.asarray(want[1])).any()
    _close(got[1], want[1])


# --- graph convs ------------------------------------------------------------

def test_gather_features_matches_jax():
    rng = np.random.default_rng(20)
    f = rng.standard_normal((2, 8, 30, 1)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 30, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        L.gather_features(_t(f), _t(idx)).numpy(),
        np.asarray(J.gather_features(jnp.asarray(f), jnp.asarray(idx))))


@pytest.mark.parametrize("conv", ["edge", "mrconv"])
def test_graph_convs_match_flax(conv):
    x = np.random.default_rng(21).standard_normal((2, 96, 16)).astype(
        np.float32)
    idx = np.random.default_rng(22).integers(0, 96, (2, 96, 6)).astype(
        np.int32)
    jm = J.GraphConv(24, conv)
    v = draw_variables(jm, jnp.asarray(x), jnp.asarray(idx))
    tm = port(L.GraphConv(16, 24, conv), v)
    _close(tm(_t(x), _t(idx)), _japply(jm, v, jnp.asarray(x),
                                       jnp.asarray(idx)))
    for jm, tm in ((J.DynConv(24, conv, k=6, dilation=2),
                    L.DynConv(16, 24, conv, k=6, dilation=2)),
                   (J.DenseDynBlock(16, 40, conv, k=5),
                    L.DenseDynBlock(16, 40, conv, k=5))):
        v = draw_variables(jm, jnp.asarray(x))
        tm = port(tm, v)
        _close(tm(_t(x)), _japply(jm, v, jnp.asarray(x)))
        _close(tm.train()(_t(x)), _japply(jm, v, jnp.asarray(x),
                                          training=True))


def test_res_dyn_block_float64_forward_and_gradient(x64):
    x = np.random.default_rng(23).standard_normal((2, 128, 24))
    jm = J.ResDynBlock(24, "edge", k=8, dilation=2)
    v = draw_variables(jm, jnp.asarray(x), dtype=np.float64)
    tm = port(L.ResDynBlock(24, "edge", k=8, dilation=2), v, torch.float64)
    res = _grads64(jm, v, [jnp.asarray(x)], tm, [_t(x)])
    assert max(res.values()) <= RTOL64, res


# --- attention --------------------------------------------------------------

def test_transformer_encoder_float64_forward_and_gradient(x64):
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 32, 48))
    pos = rng.standard_normal((2, 32, 48))
    jm = J.TransformerEncoder(embed_dim=48, depth=2, num_heads=4,
                              qkv_bias=True, mlp_ratio=2.0)
    v = draw_variables(jm, jnp.asarray(x), jnp.asarray(pos),
                       dtype=np.float64)
    tm = port(L.TransformerEncoder(48, 2, 4, mlp_ratio=2.0, qkv_bias=True),
              v, torch.float64)
    res = _grads64(jm, v, [jnp.asarray(x), jnp.asarray(pos)], tm,
                   [_t(x), _t(pos)])
    assert max(res.values()) <= RTOL64, res


def test_transformer_encoder_taps_match_flax():
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    pos = rng.standard_normal((2, 16, 32)).astype(np.float32)
    jm = J.TransformerEncoder(embed_dim=32, depth=4, num_heads=4)
    v = draw_variables(jm, jnp.asarray(x), jnp.asarray(pos))
    tm = port(L.TransformerEncoder(32, 4, 4), v)
    want = _japply(jm, v, jnp.asarray(x), jnp.asarray(pos), num_outs=2)
    got = tm.forward_features(_t(x), _t(pos), 2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w)
    _close(tm(_t(x), _t(pos)), _japply(jm, v, jnp.asarray(x),
                                       jnp.asarray(pos)))
    with torch.no_grad():
        assert math.isclose(float(tm(_t(x), _t(pos)).abs().sum()),
                            float(got[-1].abs().sum()))
