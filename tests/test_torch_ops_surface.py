"""The port's reference op API (``geot_tpu_torch.ops``: ``scatter``,
``vector_attn``, ``fps_weighted``, ``subsample``, ``index_points`` /
``torch_grouping_operation`` / ``knn_point`` and ``compat``) against
``geot_tpu.ops``.

Inputs from a numpy seed at a small size (2 clouds of at most 256 points:
every JAX search here is exact, ``lax.top_k``), run through both
packages on the CPU, where the port's kernel wrappers take their plain
versions. Indices (FPS, kNN, ball query, grid voxels and labels) are
bit-equal; float32 outputs within ``RTOL`` of the output's largest
magnitude. The CUDA routes of ``compat`` are held in
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geot_tpu import ops as jops
from geot_tpu.native import get_lib, grid_subsample_native as j_native
from geot_tpu.ops import compat as jcompat
from geot_tpu.ops.group import torch_grouping_operation as j_tgo

from geot_tpu_torch import ops
from geot_tpu_torch.ops import _build, compat

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, \
        np.abs(got - want).max() / scale


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _cloud(seed, B=2, N=256):
    return np.random.default_rng(seed).standard_normal(
        (B, N, 3)).astype(np.float32)


def test_ops_all_holds_every_geot_tpu_name():
    missing = sorted(set(jops.__all__) - set(ops.__all__))
    assert not missing, missing
    for name in ops.__all__:
        assert hasattr(ops, name), name


# --- scatter ----------------------------------------------------------------

@pytest.mark.parametrize("width", [None, 5])
def test_segment_ops_match_jax_with_empty_and_dropped_segments(width):
    rng = np.random.default_rng(1)
    n, K = 40, 9
    shape = (n,) if width is None else (n, width)
    data = rng.standard_normal(shape).astype(np.float32)
    # segments 2 and 7 are empty; K itself is past the end and dropped
    ids = rng.choice([0, 1, 3, 4, 5, 6, 8, K], n).astype(np.int32)
    for name in ("segment_sum", "segment_mean", "segment_max"):
        want = np.asarray(getattr(jops, name)(jnp.asarray(data),
                                              jnp.asarray(ids), K))
        got = getattr(ops, name)(_t(data), _t(ids), K).numpy()
        if name == "segment_max":
            # an empty segment is -inf, max's identity, in both
            assert np.isneginf(got[[2, 7]]).all()
            _equal(got, want)
        else:
            _close(got, want)


def test_segment_max_of_integers_and_its_gradient():
    rng = np.random.default_rng(2)
    data = rng.integers(-50, 50, (30, 3)).astype(np.int32)
    ids = rng.integers(0, 4, 30).astype(np.int32)
    ids[ids == 2] = 3
    want = np.asarray(jops.segment_max(jnp.asarray(data), jnp.asarray(ids),
                                       5))
    _equal(ops.segment_max(_t(data), _t(ids), 5), want)
    assert want[2, 0] == np.iinfo(np.int32).min
    x = _t(rng.standard_normal((30, 3)).astype(np.float32)).requires_grad_()
    ops.segment_sum(x, _t(ids), 5).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


# --- vector attention -------------------------------------------------------

def test_subtraction_and_aggregation_match_jax():
    rng = np.random.default_rng(3)
    B, N, K, C, Cp = 2, 64, 16, 32, 8
    f1 = rng.standard_normal((B, N, C)).astype(np.float32)
    f2 = rng.standard_normal((B, 80, C)).astype(np.float32)
    idx = rng.integers(0, 80, (B, N, K)).astype(np.int32)
    w = rng.standard_normal((B, N, K, Cp)).astype(np.float32)
    _close(ops.subtraction(_t(f1), _t(f2), _t(idx)),
           jops.subtraction(jnp.asarray(f1), jnp.asarray(f2),
                            jnp.asarray(idx)))
    _close(ops.aggregation(_t(f2), _t(w), _t(idx)),
           jops.aggregation(jnp.asarray(f2), jnp.asarray(w),
                            jnp.asarray(idx)))


# --- weighted FPS -----------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "duplicates_and_zero_weights"])
def test_fps_weighted_matches_jax(case):
    rng = np.random.default_rng(4)
    xyz = _cloud(4, N=300)
    w = rng.uniform(0.2, 2.0, (2, 300)).astype(np.float32)
    if case != "random":
        xyz[:, 200:] = xyz[:, :100]            # exact duplicates: ties
        w[:, ::7] = 0.0                         # max(w, 1e-12) takes these
    want = np.asarray(jops.fps_weighted(jnp.asarray(xyz), jnp.asarray(w),
                                        64))
    got = ops.fps_weighted(_t(xyz), _t(w), 64)
    assert got.dtype == torch.int32
    _equal(got, want)


# --- subsampling ------------------------------------------------------------

def _grid_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.6).astype(np.float32)
    feats = rng.standard_normal((n, 4)).astype(np.float32)
    labels = rng.integers(0, 17, n).astype(np.int32)
    return pts, feats, labels


@pytest.mark.parametrize("args", ["points", "features", "labels", "all"])
def test_grid_subsample_numpy_matches_geot_tpu(args):
    pts, feats, labels = _grid_inputs(5)
    kw = {"features": feats if args in ("features", "all") else None,
          "labels": labels if args in ("labels", "all") else None,
          "sample_dl": 0.15}
    want = jops.grid_subsample(pts, **kw)
    got = ops.grid_subsample(pts, **kw)
    for g, w in zip(*(((x,) if isinstance(x, np.ndarray) else x)
                      for x in (got, want))):
        assert g.dtype == w.dtype
        _equal(g, w)


def test_grid_subsample_native_matches_geot_tpu_native():
    if get_lib() is None:
        pytest.skip("geot_tpu's native library does not build here")
    pts, feats, labels = _grid_inputs(6, 20000)
    labels[::50] = 40                           # past num_classes: uncounted
    for kw in ({}, {"features": feats}, {"labels": labels},
               {"features": feats, "labels": labels}):
        want = j_native(pts, sample_dl=0.1, **kw)
        got = ops.grid_subsample_native(pts, sample_dl=0.1, **kw)
        for g, w in zip(*(((x,) if isinstance(x, np.ndarray) else x)
                          for x in (got, want))):
            _equal(g, w)
    # the same voxels as the numpy path, in another order
    sub = ops.grid_subsample_native(pts, sample_dl=0.1)
    ref = ops.grid_subsample(pts, sample_dl=0.1)
    assert sub.shape == ref.shape
    _close(np.sort(sub, axis=0), np.sort(ref, axis=0), 1e-6)


def test_grid_subsample_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "CXX", "no-such-compiler-geot")
    monkeypatch.setattr(_build, "_native_lib", None)
    with pytest.raises(RuntimeError, match="host compiler"):
        ops.grid_subsample_native(_grid_inputs(7, 10)[0])


def test_random_sample_matches_geot_tpu():
    for n, m in ((100, 40), (10, 25)):
        want = jops.random_sample(n, m, np.random.default_rng(8))
        _equal(ops.random_sample(n, m, np.random.default_rng(8)), want)


# --- grouping and knn_point -------------------------------------------------

def test_index_points_grouping_and_knn_point_match_jax():
    rng = np.random.default_rng(9)
    pts = rng.standard_normal((2, 50, 6)).astype(np.float32)
    idx2 = rng.integers(0, 50, (2, 12)).astype(np.int32)
    idx3 = rng.integers(0, 50, (2, 12, 5)).astype(np.int32)
    for idx in (idx2, idx3):
        _equal(ops.index_points(_t(pts), _t(idx)),
               jops.index_points(jnp.asarray(pts), jnp.asarray(idx)))
    cf = np.ascontiguousarray(pts.transpose(0, 2, 1))
    _equal(ops.torch_grouping_operation(_t(cf), _t(idx3)),
           j_tgo(jnp.asarray(cf), jnp.asarray(idx3)))
    xyz = _cloud(9, N=200)
    for k, support in ((16, None), (3, xyz[:, :150])):
        want = jops.knn_point(k, jnp.asarray(xyz), None if support is None
                              else jnp.asarray(support))
        got = ops.knn_point(k, _t(xyz), None if support is None
                            else _t(support))
        _equal(got[1], want[1])
        _close(got[0], want[0])


# --- compat -----------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(10)
    xyz = rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    new = np.ascontiguousarray(xyz[:, :160])
    feat = rng.standard_normal((2, 256, 8)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (2, 256)).astype(np.float32)
    return xyz, new, feat, w


def _both(fn_j, fn_t, *args, **kw):
    """(port, geot_tpu) results of one call on the same inputs: numpy
    arguments become each package's arrays, the rest pass as they are."""
    def conv(f):
        return lambda a: f(a) if isinstance(a, np.ndarray) else a

    j = fn_j(*map(conv(jnp.asarray), args),
             **{k: conv(jnp.asarray)(v) for k, v in kw.items()})
    t = fn_t(*map(conv(_t), args), **{k: conv(_t)(v) for k, v in kw.items()})
    return t, j


def test_compat_pointops_matches_jax(scene):
    xyz, new, feat, w = scene
    for k in (3, 16):            # k = 3: the small-k route; 16: tiled
        (i, d), (ij, dj) = _both(jcompat.pointops.knn, compat.pointops.knn,
                                 new, xyz, k)
        _equal(i, ij)
        _close(d, dj)
    cf_new = np.ascontiguousarray(new.transpose(0, 2, 1))
    cf_xyz = np.ascontiguousarray(xyz.transpose(0, 2, 1))
    (i, d), (ij, dj) = _both(jcompat.pointops.knn, compat.pointops.knn,
                             cf_new, cf_xyz, 4, transpose=True)
    _equal(i, ij)
    _equal(*_both(jcompat.pointops.fps, compat.pointops.fps, xyz, 40))
    _equal(*_both(jcompat.pointops.fps_weight, compat.pointops.fps_weight,
                  xyz, 40, weight=w))
    with pytest.raises(AssertionError):
        compat.pointops.fps_weight(_t(xyz), 4)
    idx = np.random.default_rng(11).integers(0, 256, (2, 30, 4)).astype(
        np.int32)
    _equal(*_both(jcompat.pointops.index_points,
                  compat.pointops.index_points, feat, idx))


@pytest.mark.parametrize("batched", [True, False], ids=["3d", "2d"])
def test_compat_openpoints_group_and_interpolate_match_jax(scene, batched):
    xyz, new, feat, _ = scene
    sel = (lambda a: a) if batched else (lambda a: np.ascontiguousarray(
        a[0]))
    x, n, f = sel(xyz), sel(new), sel(feat)
    op_j, op_t = jcompat.openpoints_pointops, compat.openpoints_pointops
    for use_xyz in (True, False):
        got, want = _both(op_j.queryandgroup, op_t.queryandgroup, 12, x, n, f,
                          use_xyz=use_xyz)
        _close(got, want)
    # a given idx: (B, m, k), or (m, k) for a single cloud
    idx = sel(np.random.default_rng(12).integers(0, 256, (2, 160, 6))
              .astype(np.int32))
    got, want = _both(op_j.queryandgroup, op_t.queryandgroup, 6, x, n, None,
                      idx=idx)
    _close(got, want)
    for method, radius in (("knn", None), ("ballquery", 0.4)):
        for norm in (False, True):
            (gx, gf), (jx, jf) = _both(op_j.querygroup, op_t.querygroup,
                                       10, x, n, f, radius=radius,
                                       query_method=method,
                                       normalize_dp=norm)
            _close(gx, jx)
            _close(gf, jf)
    for k in (3, 6):
        got, want = _both(op_j.interpolation, op_t.interpolation, x, n, f,
                          k=k)
        assert got.shape == (want.shape)
        _close(got, want)


def test_compat_vector_attention_matches_jax(scene):
    xyz, new, feat, _ = scene
    rng = np.random.default_rng(13)
    idx = rng.integers(0, 256, (2, 256, 16)).astype(np.int32)
    w = rng.standard_normal((2, 256, 16, 4)).astype(np.float32)
    op_j, op_t = jcompat.openpoints_pointops, compat.openpoints_pointops
    _close(*_both(op_j.subtraction, op_t.subtraction, feat, feat, idx))
    _close(*_both(op_j.aggregation, op_t.aggregation, feat, w, idx))


def test_compat_pointnet2_utils_matches_jax(scene):
    xyz, new, feat, _ = scene
    p_j, p_t = jcompat.pointnet2_utils, compat.pointnet2_utils
    inds, inds_j = _both(p_j.furthest_point_sample, p_t.furthest_point_sample,
                         xyz, 48)
    _equal(inds, inds_j)
    cf = np.ascontiguousarray(feat.transpose(0, 2, 1))
    _equal(*_both(p_j.gather_operation, p_t.gather_operation, cf,
                  inds_j.__array__()))
    (d, i), (dj, ij) = _both(p_j.three_nn, p_t.three_nn, new, xyz)
    _equal(i, ij)
    _close(d, dj)
    wt = np.random.default_rng(14).uniform(0, 1, (2, 160, 3)).astype(
        np.float32)
    _close(*_both(p_j.three_interpolate, p_t.three_interpolate, cf,
                  i.numpy(), wt))
    gidx, gidx_j = _both(p_j.ball_query, p_t.ball_query, 0.3, 8, xyz,
                         new)
    _equal(gidx, gidx_j)
    _equal(*_both(p_j.grouping_operation, p_t.grouping_operation, cf,
                  gidx.numpy()))


def test_compat_on_cpu_tensors_launches_no_kernel(scene):
    xyz, new, feat, _ = scene
    _build.reset_launches()
    compat.pointops.knn(_t(new), _t(xyz), 3)
    compat.pointnet2_utils.furthest_point_sample(_t(xyz), 8)
    compat.openpoints_pointops.interpolation(_t(xyz), _t(new), _t(feat))
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
