"""The port's point ops (``geot_tpu_torch.ops``) against ``geot_tpu.ops``.

Inputs are made from a seed with numpy and fed to both packages. The JAX
side runs the pure-JAX ops and, for the two kernels, the Pallas kernels in
interpret mode, as ``tests/test_ops.py`` does. The CUDA kernels are held
against their plain versions in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu import ops as jops
from geot_tpu.ops.fps import _fps_impl
from geot_tpu.ops.pallas_fps import fps_pallas
from geot_tpu.ops.pallas_knn import knn_small_k_pallas
from geot_tpu_torch import ops
from geot_tpu_torch.ops import _build


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dup_cloud(rng, n_base, B=1):
    """A cloud with exact duplicate points: tie candidates everywhere."""
    base = rng.standard_normal((B, n_base, 3)).astype(np.float32)
    return np.concatenate([base, base[:, :60], base[:, :40]], axis=1)


# --- FPS -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_fps_matches_jax(rng, case):
    if case == "random":
        xyz = rng.standard_normal((2, 1030, 3)).astype(np.float32)
        npoint = 40
    else:
        xyz = _dup_cloud(rng, 100)                           # (1, 200, 3)
        npoint = 32
    got = ops.fps(_t(xyz), npoint).numpy()
    assert got.dtype == np.int32 and got.shape == (xyz.shape[0], npoint)
    np.testing.assert_array_equal(got, np.asarray(
        _fps_impl(jnp.asarray(xyz), None, npoint)))
    np.testing.assert_array_equal(got, np.asarray(
        fps_pallas(jnp.asarray(xyz), npoint, interpret=True)))


def test_fps_gather_matches_jax(rng):
    xyz = rng.standard_normal((2, 300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ops.fps_gather(_t(xyz), 24).numpy(),
        np.asarray(jops.fps_gather(jnp.asarray(xyz), 24)))


# --- kNN -------------------------------------------------------------------

def _knn_inputs(rng, case):
    if case == "random_k3":
        return (rng.standard_normal((2, 300, 3)).astype(np.float32),
                rng.standard_normal((2, 450, 3)).astype(np.float32), 3)
    if case in ("k1", "k4"):
        return (rng.standard_normal((1, 130, 3)).astype(np.float32),
                rng.standard_normal((1, 200, 3)).astype(np.float32),
                int(case[1]))
    # duplicated supports, queries drawn from the supports: exact-zero
    # self distances and ties at equal distance
    s = rng.standard_normal((1, 64, 3)).astype(np.float32)
    s = np.concatenate([s, s[:, :32]], axis=1)               # (1, 96, 3)
    return s[:, :48].copy(), s, 3


@pytest.mark.parametrize("case", ["random_k3", "k1", "k4", "ties"])
def test_knn_small_k_matches_jax(rng, case):
    q, s, k = _knn_inputs(rng, case)
    d_ref, i_ref = ops.knn_small_k_ref(_t(q), _t(s), k)
    d_w, i_w = ops.knn_small_k(_t(q), _t(s), k)     # CPU tensor -> plain
    d_k, i_k = ops.knn(_t(q), _t(s), k, squared=True)
    d_e, i_e = jops.knn(jnp.asarray(q), jnp.asarray(s), k, exact=True,
                        squared=True)
    d_p, i_p = knn_small_k_pallas(jnp.asarray(q), jnp.asarray(s), k,
                                  interpret=True)
    for d, i in ((d_ref, i_ref), (d_w, i_w), (d_k, i_k)):
        assert i.dtype == torch.int32
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_e))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_p))
        np.testing.assert_allclose(d.numpy(), np.asarray(d_e), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(d_p), rtol=0,
                                   atol=1e-6)
    if case == "ties":
        assert np.all(d_ref.numpy()[..., 0] == 0.0)


def test_knn_large_k_tiled_matches_jax(rng):
    """The k=32 tokenizer search: exact, tiled over queries (a tile smaller
    than Q here, so the tiling itself is exercised)."""
    q = rng.standard_normal((2, 40, 3)).astype(np.float32)
    s = rng.standard_normal((2, 250, 3)).astype(np.float32)
    d, i = ops.knn(_t(q), _t(s), 32, tile=16)
    d_e, i_e = jops.knn(jnp.asarray(q), jnp.asarray(s), 32, exact=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_e))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_e), rtol=0, atol=1e-6)


def test_pairwise_dist2_both_regimes(rng):
    for C, atol in ((3, 0.0), (16, 1e-4)):
        q = rng.standard_normal((2, 20, C)).astype(np.float32)
        s = rng.standard_normal((2, 30, C)).astype(np.float32)
        np.testing.assert_allclose(
            ops.pairwise_dist2(_t(q), _t(s)).numpy(),
            np.asarray(jops.pairwise_dist2(jnp.asarray(q), jnp.asarray(s))),
            rtol=1e-5 if C > 4 else 0, atol=atol)
    x = _t(rng.standard_normal((1, 10, 3)).astype(np.float32))
    assert torch.all(torch.diagonal(ops.pairwise_dist2(x, x)[0]) == 0)


# --- gather, grouping, interpolation ---------------------------------------

def test_gather_and_grouping_match_jax(rng):
    pts = rng.standard_normal((2, 50, 5)).astype(np.float32)
    idx2 = rng.integers(0, 50, (2, 7)).astype(np.int32)
    idx3 = rng.integers(0, 50, (2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_points(_t(pts), _t(idx2)).numpy(),
        np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx2))))
    np.testing.assert_array_equal(
        ops.grouping_operation(_t(pts), _t(idx3)).numpy(),
        np.asarray(jops.grouping_operation(jnp.asarray(pts),
                                           jnp.asarray(idx3))))


def test_three_interpolation_matches_jax(rng):
    unknown = rng.standard_normal((2, 200, 3)).astype(np.float32)
    known = rng.standard_normal((2, 64, 3)).astype(np.float32)
    known[:, :10] = unknown[:, :10]            # coincident points: d = 0
    feats = rng.standard_normal((2, 64, 24)).astype(np.float32)
    got = ops.three_interpolation(_t(unknown), _t(known), _t(feats)).numpy()
    want = np.asarray(jops.three_interpolation(
        jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    d, i = ops.three_nn(_t(unknown), _t(known))
    d_e, i_e = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_e))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_e), rtol=0, atol=1e-6)


def test_three_interpolation_float64_matches_compiled_geot_tpu(rng):
    """The 3-NN weights are float32 in a float64 step, bit-equal to those
    of ``geot_tpu``'s compiled ``three_interpolation`` (its squared
    distances FMA-contracted, its square root correctly rounded, its two
    divisions folded into one). Weights in float64, or from the search's
    own distances, differ from them in the last bit, and at a max over
    neighbours whose top two are closer than that they route the gradient
    to another neighbour (``tests/test_torch_registry_rest_engine.py``'s
    ``ntm-T`` case)."""
    unknown = rng.uniform(-1, 1, (4, 128, 3)).astype(np.float32)
    known = rng.uniform(-1, 1, (4, 64, 3)).astype(np.float32)
    known[:, :10] = unknown[:, :10]            # coincident points: d = 0
    feats = rng.standard_normal((4, 64, 48))
    got = ops.three_interpolation(_t(unknown), _t(known),
                                  torch.from_numpy(feats)).numpy()
    _, i = ops.three_nn(_t(unknown), _t(known))
    w = ops.three_nn_weights(_t(unknown), _t(known), i)

    def weights(u, k):
        dist, _ = jops.three_nn(u, k)
        dist_recip = 1.0 / (dist + 1e-8)
        return dist_recip / jnp.sum(dist_recip, axis=2, keepdims=True)

    jax.config.update("jax_enable_x64", True)
    try:
        _, i_j = jax.jit(jops.three_nn)(jnp.asarray(unknown),
                                        jnp.asarray(known))
        w_j = jax.jit(weights)(jnp.asarray(unknown), jnp.asarray(known))
        want = jax.jit(jops.three_interpolation)(
            jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats))
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert w.dtype == torch.float32 and want.dtype == jnp.float64
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    # float64 sums of float32-weighted terms (XLA fuses them into FMAs)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-14)


# --- the build and the wrappers' CPU behaviour -----------------------------

def test_library_name_tracks_sources_and_flags(monkeypatch):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libgeot_kernels_") and path.suffix == ".so"
    assert path == _build.library_path()            # deterministic
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path() != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build").exists()


def test_cpu_tensors_take_the_plain_version(rng):
    """On the CPU the wrappers run the plain versions and count no
    launch."""
    before = dict(ops.LAUNCHES)
    xyz = _t(rng.standard_normal((1, 300, 3)).astype(np.float32))
    ops.fps(xyz, 16)
    ops.knn(xyz, xyz, 3)
    ops.knn_small_k(xyz, xyz, 4)
    assert ops.LAUNCHES == before


def test_wrappers_reject_other_devices():
    meta = torch.zeros((1, 300, 3), device="meta")
    with pytest.raises(ValueError):
        ops.fps(meta, 8)
    with pytest.raises(ValueError):
        ops.knn_small_k(meta, meta, 3)
