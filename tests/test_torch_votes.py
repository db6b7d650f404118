"""VoteNet's set-abstraction modules (``geot_tpu_torch.models.backbone.
pointnet2_votes``) and the reference aliases of ``pointnetv2`` against
``geot_tpu.models.backbone``: ``unique_fill`` bit-equal, each module's
eval and train forward in float32 within ``RTOL`` of the output's largest
magnitude (indices bit-equal), and one SA module's float64 forward and
gradient within ``RTOL64``. Weights are drawn by numpy into the flax tree
and carried by ``params_from_jax``; 2 clouds of 256 points."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import geot_tpu.models.backbone as JB
from geot_tpu.models.backbone.pointnet2_votes import (
    _pool as j_pool, unique_fill as j_unique_fill)

import geot_tpu_torch.models.backbone as TB
from geot_tpu_torch.models.backbone.pointnet2_votes import (
    _pool as t_pool, unique_fill as t_unique_fill)

from test_torch_layers_surface import (_close, _grads64, _japply, _rel, _t,
                                       draw_variables, port)

RTOL = 1e-5
RTOL64 = 1e-10
NAMES = ["PointnetSAModule", "PointnetSAModuleMSG", "PointnetFPModule",
         "PointNetFeaturePropagation", "PointnetSAModuleVotes",
         "PointnetSAModuleVotes_nofps", "PointnetSAModuleVotes_nogrouping",
         "PointnetSAModuleMSGVotes", "PointnetLFPModuleMSG"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(31)
    xyz = rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 256, 8)).astype(np.float32)
    return xyz, feats


def test_backbone_exports_match():
    for name in NAMES:
        assert hasattr(JB, name) and hasattr(TB, name), name
    assert set(TB.__all__) == set(NAMES)
    assert TB.PointNetFeaturePropagation is TB.PointnetFPModule


def test_unique_fill_matches_jax():
    rng = np.random.default_rng(32)
    idx = rng.integers(0, 9, (3, 40, 16)).astype(np.int32)
    idx[0, 0] = 5                               # one unique index
    idx[1, 1] = np.arange(16)                   # all unique
    fj, cj = j_unique_fill(jnp.asarray(idx))
    ft, ct = t_unique_fill(_t(idx))
    assert ft.dtype == torch.int32 and ct.dtype == torch.int32
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(ct[0, 0]) == 1 and int(ct[1, 1]) == 16


@pytest.mark.parametrize("pooling", ["max", "avg", "rbf"])
def test_pool_matches_jax(pooling):
    rng = np.random.default_rng(33)
    f = rng.standard_normal((2, 10, 6, 5)).astype(np.float32)
    g = rng.standard_normal((2, 10, 6, 3)).astype(np.float32)
    _close(t_pool(_t(f), _t(g), pooling, 0.3, 6),
           j_pool(jnp.asarray(f), jnp.asarray(g), pooling, 0.3, 6))
    with pytest.raises(ValueError):
        t_pool(_t(f), _t(g), "median", 0.3, 6)


VOTES = [
    {"pooling": "max"},
    {"pooling": "avg", "normalize_xyz": True},
    {"pooling": "rbf", "normalize_xyz": True, "sigma": 0.2},
    {"sample_uniformly": True, "ret_unique_cnt": True},
    {"use_xyz": False},
    {"features": False},
    {"npoint": None},
]


@pytest.mark.parametrize("case", VOTES, ids=str)
def test_sa_module_votes_matches_flax(cloud, case):
    xyz, feats = cloud
    case = dict(case)
    with_feats = case.pop("features", True)
    kw = {"npoint": 32, "radius": 0.4, "nsample": 12, **case}
    mlp = [8 if with_feats else 0, 16, 24]
    f = feats if with_feats else None
    jargs = [jnp.asarray(xyz), None if f is None else jnp.asarray(f)]
    jm = JB.PointnetSAModuleVotes(mlp=mlp, **kw)
    v = draw_variables(jm, *jargs)
    tm = port(TB.PointnetSAModuleVotes(mlp, **kw), v)
    targs = [_t(xyz), None if f is None else _t(f)]
    for training in (False, True):
        want = _japply(jm, v, *jargs, training=training)
        got = tm.train(training)(*targs)
        assert len(got) == len(want)
        if kw["npoint"] is None:
            assert got[0] is None and want[0] is None
        else:
            _close(got[0], want[0])
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        _close(got[1], want[1])
        if kw.get("ret_unique_cnt"):
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        if kw["npoint"] is not None and not training:   # given inds
            inds = np.asarray(want[2])[:, ::-1].copy()
            _close(tm(*targs, _t(inds))[1],
                   _japply(jm, v, *jargs, jnp.asarray(inds))[1])


def test_sa_module_votes_float64_forward_and_gradient(cloud):
    xyz, feats = (a.astype(np.float64) for a in cloud)
    jax.config.update("jax_enable_x64", True)
    try:
        kw = {"npoint": 32, "radius": 0.4, "nsample": 12,
              "normalize_xyz": True}
        jm = JB.PointnetSAModuleVotes(mlp=[8, 16, 24], **kw)

        class TFeatures(TB.PointnetSAModuleVotes):   # the features
            def forward(self, x, f):
                return super().forward(x, f)[1]

        class JFeatures(JB.PointnetSAModuleVotes):
            def __call__(self, x, f, training=False):
                return super().__call__(x, f, training=training)[1]

        jf = JFeatures(mlp=[8, 16, 24], **kw)
        v = draw_variables(jm, jnp.asarray(xyz), jnp.asarray(feats),
                           dtype=np.float64)
        tm = port(TFeatures([8, 16, 24], **kw), v, torch.float64)
        res = _grads64(jf, v, [jnp.asarray(xyz), jnp.asarray(feats)], tm,
                       [_t(xyz), _t(feats)])
    finally:
        jax.config.update("jax_enable_x64", False)
    assert max(res.values()) <= RTOL64, res


def test_nofps_and_nogrouping_match_flax(cloud):
    xyz, feats = cloud
    rng = np.random.default_rng(34)
    grouped = rng.standard_normal((2, 32, 12, 11)).astype(np.float32)
    jm = JB.PointnetSAModuleVotes_nofps(mlp=[8, 16], nsample=12,
                                        radius=0.4, pooling="rbf")
    v = draw_variables(jm, jnp.asarray(grouped))
    tm = port(TB.PointnetSAModuleVotes_nofps([8, 16], nsample=12,
                                             radius=0.4, pooling="rbf"), v)
    got, want = tm(_t(grouped)), _japply(jm, v, jnp.asarray(grouped))
    _close(got[1], want[1])
    assert got[0] is not None and torch.equal(got[0], _t(grouped))
    f32 = np.ascontiguousarray(feats[:, :32])
    jm = JB.PointnetSAModuleVotes_nogrouping(mlp=[8, 16, 24], npoint=32)
    v = draw_variables(jm, jnp.asarray(xyz), jnp.asarray(f32))
    tm = port(TB.PointnetSAModuleVotes_nogrouping([8, 16, 24], npoint=32), v)
    got = tm(_t(xyz), _t(f32))
    want = _japply(jm, v, jnp.asarray(xyz), jnp.asarray(f32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[1], want[1])


@pytest.mark.parametrize("sample_uniformly", [False, True])
def test_msg_votes_and_lfp_match_flax(cloud, sample_uniformly):
    xyz, feats = cloud
    jargs = [jnp.asarray(xyz), jnp.asarray(feats)]
    kw = {"radii": [0.3, 0.6], "nsamples": [8, 16],
          "sample_uniformly": sample_uniformly}
    jm = JB.PointnetSAModuleMSGVotes(mlps=[[8, 16], [8, 12, 20]], npoint=40,
                                     **kw)
    v = draw_variables(jm, *jargs)
    tm = port(TB.PointnetSAModuleMSGVotes([[8, 16], [8, 12, 20]], 40, **kw),
              v)
    for training in (False, True):
        got = tm.train(training)(*map(_t, (xyz, feats)))
        want = _japply(jm, v, *jargs, training=training)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        _close(got[1], want[1])
    new_xyz = np.asarray(want[0])
    f2 = np.random.default_rng(35).standard_normal((2, 40, 6)).astype(
        np.float32)
    largs = [jnp.asarray(new_xyz), jnp.asarray(xyz), jnp.asarray(f2),
             jnp.asarray(feats)]
    jl = JB.PointnetLFPModuleMSG(mlps=[[8, 16], [8, 16]], post_mlp=[22, 12],
                                 **kw)
    vl = draw_variables(jl, *largs)
    tl = port(TB.PointnetLFPModuleMSG([[8, 16], [8, 16]], post_mlp=[22, 12],
                                      **kw), vl)
    for training in (False, True):
        _close(tl.train(training)(*map(_t, (new_xyz, xyz, f2, feats))),
               _japply(jl, vl, *largs, training=training))


def test_pointnet_sa_module_alias_matches_flax(cloud):
    xyz, feats = cloud
    jm = JB.PointnetSAModule([8, 16, 24], radius=0.4, nsample=12, stride=4)
    v = draw_variables(jm, jnp.asarray(xyz), jnp.asarray(feats))
    tm = port(TB.PointnetSAModule([8, 16, 24], radius=0.4, nsample=12,
                                  stride=4), v)
    got = tm(_t(xyz), _t(feats))
    want = _japply(jm, v, jnp.asarray(xyz), jnp.asarray(feats))
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert _rel(got[1], want[1]) <= RTOL
    for mod in (JB, TB):
        with pytest.raises(ValueError, match="stride"):
            mod.PointnetSAModule([8, 16], npoint=64, radius=0.4, nsample=8)
