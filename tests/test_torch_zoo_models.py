"""The supervised tooth zoo's modules against ``geot_tpu``: ``ball_query``,
the grouping layers and local aggregation, and the forward of each model
of ``cfgs/tooth_sup/`` (``BaseSeg`` with PointNet++ or DGCNN,
``PointMLPPartSegmentor``, ``WholePartSeg`` with ``PointTransformer_seg``)
at the small widths of ``tests/test_supervised_zoo.py``, weights carried
across by ``params_from_jax``, in eval and in train mode (logits and the
updated BatchNorm statistics), in float32 and float64.

Inputs are synthetic tooth scans sampled to 256 points by the port's
loader (bit-equal to ``geot_tpu``'s) or seeded numpy clouds. At 256 points
every JAX neighbour search is exact ``lax.top_k``, as the port's always is.
Dropout is off where the config can turn it off; PointMLP's head dropout
(a fixed 0.5) takes in the port the mask that ``geot_tpu`` drew.
"""
import copy
import functools
import hashlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.core.config import EasyConfig as JEasyConfig
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.models.layers import group as jgroup
from geot_tpu.models.layers.local_aggregation import \
    LocalAggregation as JLocalAggregation
from geot_tpu.ops import ball_query as jball_query

from geot_tpu_torch.core.config import EasyConfig, build_model_from_cfg
from geot_tpu_torch.data import build as tdata_build
from geot_tpu_torch.engine.convert import params_from_jax
from geot_tpu_torch.models.layers import (LocalAggregation,
                                          get_aggregation_features,
                                          group as tgroup)
from geot_tpu_torch.ops import ball_query

from test_supervised_zoo import TINY
from torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS = 256
CONFIGS = sorted(TINY)
# dropout and stochastic depth off where the config has a switch
NO_DROPOUT = {
    "pointnet2.yaml": ["model.cls_args.dropout_ratio=0.0"],
    "dgcnn.yaml": ["model.cls_args.dropout_ratio=0.0"],
    "pointmlp.yaml": [],
    "transformer.yaml": ["model.segmentor_args.drop_path_rate=0.0",
                         "model.segmentor_args.head_dropout=0.0"],
}
FEATURE_TYPES = ("dp_fj", "dp_fj_df", "pi_dp_fj_df", "dp_df")



def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cast(tree, dt):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, dt) if np.asarray(a).dtype
                              == np.float32 else a), tree)


def zoo_cfg(pkg, name, *extra):
    """``cfgs/tooth_sup/<name>`` at the small widths, in ``pkg``'s
    config class, with the dropout switches off."""
    cfg = (JEasyConfig if pkg == "jax" else EasyConfig)()
    cfg.load(os.path.join(ROOT, "cfgs", "tooth_sup", name), recursive=True)
    cfg.update(TINY[name] + NO_DROPOUT[name] + list(extra))
    return cfg


def zoo_batches(cfg, n=2, epoch=1):
    """``n`` labelled train batches of ``cfg``'s loader, 256 points a scan
    (numpy dicts)."""
    ds = dict(cfg.dataset_l)
    ds["common"] = dict(ds["common"], num_points=N_PTS)
    loader = tdata_build.build_dataloader_from_cfg(
        int(cfg.batch_size_l), ds, None, cfg.datatransforms, split="train",
        seed=int(cfg.seed))
    loader.set_epoch(epoch)
    out = []
    for batch in loader:
        out.append({k: batch[k] for k in tdata_build.MODEL_KEYS})
        if len(out) == n:
            return out


def as_dtype(batch, dt):
    return {k: (v.astype(dt) if v.dtype == np.float32 else v)
            for k, v in batch.items()}


# jax_model's variables by (config, seed, batch): computed once a process
_VARIABLES = {}


def jax_model(name, batch, seed=0):
    """The JAX model of the config at the small widths and its variables
    (numpy, float32) with jittered BatchNorm statistics: a copy of what one
    ``jax.jit`` of ``init`` gives, computed once a process for the config,
    seed and batch (eager ``init`` compiles each operation on its own)."""
    jmodel = jbuild(zoo_cfg("jax", name).model)
    key = (name, seed, tuple((k, v.shape, v.dtype.str,
                              hashlib.sha1(v.tobytes()).hexdigest())
                             for k, v in sorted(batch.items())))
    if key not in _VARIABLES:
        _VARIABLES[key] = _init_variables(jmodel, batch, seed)
    return jmodel, copy.deepcopy(_VARIABLES[key])


def _init_variables(jmodel, batch, seed):
    key = jax.random.PRNGKey(seed)
    variables = _np(jax.jit(jmodel.init)(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        {k: jnp.asarray(v) for k, v in batch.items()}))
    rng = np.random.default_rng(seed)

    def jitter(path, a):
        name = path[-1].key
        if name == "mean":
            return rng.uniform(-0.05, 0.05, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return a

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        jitter, variables["batch_stats"])
    return variables


def port_model(name, variables, dt=np.float32):
    model = build_model_from_cfg(zoo_cfg("torch", name).model)
    if dt == np.float64:
        model.double()
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


class GivenMask(torch.nn.Module):
    """A dropout that applies a given keep mask (``geot_tpu``'s draw)."""

    def __init__(self, mask: np.ndarray, rate: float):
        super().__init__()
        self.mask = torch.from_numpy(mask)
        self.keep = 1.0 - rate

    def forward(self, x, generator=None):
        return torch.where(self.mask, x / self.keep, torch.zeros_like(x))


def jax_dropout_mask(jmodel, variables, jbatch, rng):
    """The keep mask of PointMLP's head dropout in ``geot_tpu``'s train
    forward under dropout key ``rng``. A ReLU output that is 0 reads as
    dropped: either way the product and the gradient through it are 0."""
    _, out = jax.jit(functools.partial(
        jmodel.apply, training=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True))(variables, jbatch,
                                     rngs={"dropout": rng})
    (drop,) = out["intermediates"]["Dropout_0"]["__call__"]
    return np.asarray(drop) != 0


def use_jax_dropout(name, tmodel, jmodel, variables, jbatch, rng):
    if name == "pointmlp.yaml":
        tmodel.dropout = GivenMask(
            jax_dropout_mask(jmodel, variables, jbatch, rng), 0.5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- ball query --------------------------------------------------------------

@pytest.fixture(scope="module")
def clouds():
    """Supports with exact duplicates (a scan sampled with replacement)
    and queries among them and off them; 250 supports, so that
    ``geot_tpu``'s kNN is exact ``lax.top_k``."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-0.5, 0.5, (2, 150, 3)).astype(np.float32)
    support = np.concatenate([base, base[:, :75], base[:, 40:65]], axis=1)
    query = np.concatenate([support[:, :48],
                            rng.uniform(-0.6, 0.6, (2, 80, 3))
                            .astype(np.float32)], axis=1)
    return np.ascontiguousarray(support), np.ascontiguousarray(query)


@pytest.mark.parametrize("radius,nsample", [(0.02, 8), (0.1, 16),
                                            (0.25, 32), (2.0, 8)])
def test_ball_query_matches_jax(clouds, radius, nsample):
    """Indices equal to ``geot_tpu``'s, chunked over the support (chunk
    64 < N) and not; radius 0.02 leaves balls empty (index 0), 2.0 takes
    the first nsample indices of the cloud."""
    support, query = clouds
    want = np.asarray(jball_query(radius, nsample, jnp.asarray(support),
                                  jnp.asarray(query)))
    for chunk in (2048, 64):
        got = ball_query(radius, nsample, torch.from_numpy(support),
                         torch.from_numpy(query), chunk_size=chunk)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    empty = (want == want[..., :1]).all(-1) & (want[..., 0] == 0)
    print(f"radius {radius}: {int(empty.sum())} of {empty.size} balls "
          f"empty or holding index 0 alone")
    if radius == 2.0:
        np.testing.assert_array_equal(want, np.broadcast_to(
            np.arange(nsample), want.shape))


def test_ball_query_contract(clouds):
    """Ascending hits inside the radius, then the first hit repeated; 0 for
    an empty ball."""
    support, query = clouds
    r, ns = 0.1, 16
    idx = ball_query(r, ns, torch.from_numpy(support),
                     torch.from_numpy(query)).numpy()
    for b in range(2):
        d2 = ((query[b][:, None] - support[b][None]) ** 2).sum(-1)
        for m in range(query.shape[1]):
            hits = np.flatnonzero(d2[m] < np.float32(r * r))[:ns]
            want = np.full(ns, hits[0] if len(hits) else 0)
            want[:len(hits)] = hits
            np.testing.assert_array_equal(idx[b, m], want)


# --- grouping and local aggregation ------------------------------------------

@pytest.mark.parametrize("grouper", ["ballquery", "knn"])
def test_groupers_match_jax(clouds, grouper):
    support, query = clouds
    feats = np.random.default_rng(4).standard_normal(
        support.shape[:2] + (5,)).astype(np.float32)
    args = {"NAME": grouper, "radius": 0.1, "nsample": 8,
            "normalize_dp": True}
    jdp, jfj = jgroup.create_grouper(args)(
        jnp.asarray(query), jnp.asarray(support), jnp.asarray(feats))
    tdp, tfj = tgroup.create_grouper(args)(
        torch.from_numpy(query), torch.from_numpy(support),
        torch.from_numpy(feats))
    np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(tfj.numpy(), np.asarray(jfj))
    gp, gf = tgroup.create_grouper({"nsample": None})(
        None, torch.from_numpy(support), torch.from_numpy(feats))
    assert gp.shape == (2, 1) + support.shape[1:] and gf.shape[1] == 1


@pytest.mark.parametrize("feature_type", FEATURE_TYPES)
def test_local_aggregation_matches_jax(clouds, feature_type):
    """Assembled features, then ``LocalAggregation`` (ball query, shared
    MLP, max) with ``geot_tpu``'s weights, eval and train mode."""
    support, query = clouds
    rng = np.random.default_rng(5)
    feats = rng.standard_normal(support.shape[:2] + (6,)).astype(np.float32)
    M = query.shape[1]
    p, f = query, feats[:, :M]
    dp = rng.standard_normal((2, M, 8, 3)).astype(np.float32)
    fj = rng.standard_normal((2, M, 8, 6)).astype(np.float32)
    want = jgroup.get_aggregation_features(*map(jnp.asarray, (p, dp, f, fj)),
                                           feature_type)
    got = get_aggregation_features(*map(torch.from_numpy, (p, dp, f, fj)),
                                   feature_type)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    group_args = {"NAME": "ballquery", "radius": 0.15, "nsample": 8}
    jla = JLocalAggregation([16, 24], group_args, feature_type, "max")
    jin = tuple(map(jnp.asarray, (query, support, feats)))
    variables = _np(jla.init(jax.random.PRNGKey(0), *jin))
    tla = LocalAggregation(6, [16, 24], group_args, feature_type, "max")
    tla.load_state_dict(params_from_jax(variables), strict=True)
    tin = tuple(map(torch.from_numpy, (query, support, feats)))
    with torch.no_grad():
        np.testing.assert_allclose(tla.eval()(*tin).numpy(),
                                   np.asarray(jla.apply(variables, *jin)),
                                   rtol=1e-5, atol=1e-5)
        out, upd = jla.apply(variables, *jin, training=True,
                             mutable=["batch_stats"])
        np.testing.assert_allclose(tla.train()(*tin).numpy(),
                                   np.asarray(out), rtol=1e-4, atol=1e-4)
    new = params_from_jax({"params": variables["params"],
                           "batch_stats": _np(upd["batch_stats"])})
    for k, v in tla.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), new[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# --- the models --------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_params_from_jax_covers_every_port_tensor(name):
    batch = zoo_batches(zoo_cfg("torch", name), 1)[0]
    _, variables = jax_model(name, batch)
    sd = params_from_jax(variables)
    tmodel = build_model_from_cfg(zoo_cfg("torch", name).model)
    assert set(sd) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert sd[k].shape == v.shape, k
    n_j = sum(np.asarray(a).size for a in
              jax.tree_util.tree_leaves(variables["params"]))
    assert n_j == sum(p.numel() for p in tmodel.parameters())


def _forward_both(name, dt, train):
    """The config's forward in both packages from the same weights and
    batch: (port logits, JAX logits, port state_dict, JAX's updated
    state_dict or None). ``geot_tpu``'s forward is compiled, as its steps
    are (eager, each operation compiles on its own)."""
    batch = as_dtype(zoo_batches(zoo_cfg("torch", name), 1)[0], dt)
    jmodel, variables = jax_model(name, zoo_batches(zoo_cfg("torch", name),
                                                    1)[0])
    jvars = _cast(variables, dt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tmodel = port_model(name, variables, dt)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    new = None
    if train:
        rng = jax.random.PRNGKey(7)
        use_jax_dropout(name, tmodel, jmodel, jvars, jbatch, rng)
        out, upd = jax.jit(functools.partial(
            jmodel.apply, training=True, mutable=["batch_stats"]))(
            jvars, jbatch, rngs={"dropout": rng})
        new = params_from_jax({"params": variables["params"],
                               "batch_stats": _np(upd["batch_stats"])})
        tmodel.train()
    else:
        out = jax.jit(jmodel.apply)(jvars, jbatch)
        tmodel.eval()
    with torch.no_grad():
        got = tmodel(tbatch, generator=torch.Generator().manual_seed(0))
    logits = lambda o: o[0] if isinstance(o, tuple) else o  # noqa: E731
    return (logits(got).numpy(), np.asarray(logits(out)),
            tmodel.state_dict(), new)


# max |dlogit| relative to the largest |logit|. Measured: float32 3.5e-7
# (eval) to 7.4e-6 (train, where batch statistics amplify rounding);
# float64 5e-16 for DGCNN and 4.7e-8 to 3.8e-7 for the models with 3-NN
# interpolation, whose weights geot_tpu rounds to float32 (its kNN returns
# float32 distances) and the port computes in the features' dtype
FWD_RTOL = {np.float32: 1e-4, np.float64: 1e-6}


@pytest.mark.parametrize("dt", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jax(name, mode, dt):
    x64 = dt == np.float64
    if x64:
        jax.config.update("jax_enable_x64", True)
    try:
        got, want, sd, new = _forward_both(name, dt, mode == "train")
    finally:
        if x64:
            jax.config.update("jax_enable_x64", False)
    rel = _rel(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"{name} {mode} {dt.__name__}: max |dlogit| / max |logit| "
          f"{rel:.3e}, argmax agreement {agree:.6f}")
    assert got.shape == want.shape == (want.shape[0], N_PTS, 17)
    assert rel <= FWD_RTOL[dt]
    if new is not None:
        worst = 0.0
        for k, v in new.items():
            if k.endswith(("running_mean", "running_var")):
                err = float((sd[k].double() - v.double()).abs().max())
                worst = max(worst, err)
                assert err <= 1e-4 * max(1.0, float(v.abs().max())), k
        print(f"  running statistics: max |diff| {worst:.3e}")
