"""The heritage tasks' models against ``geot_tpu``: ``BaseCls`` over
``PointNet2Encoder``, ``DGCNN``, ``PointMLPEncoder``, ``PointMLPEncoderV2``
and ``PointMLP``, ``DistillCls`` (both outputs), ``BasePartSeg`` with
``PointNet2PartDecoder`` and ``SegHead``, and ``PointMLPPartSegmentor`` at
``shape_classes: 16``, at the small widths of ``geot_tpu``'s own cls and
partseg tests (``tests/test_cls_*.py``, ``tests/test_partseg_*.py``),
weights carried across by
``params_from_jax``: the eval logits in float32, and one supervised step
(``geot_tpu``'s ``make_supervised_step`` and the port's) in float64: the
loss, the running statistics and every tensor's clipped gradient (AdamW's
first moment is 0.1 x it in both).

Batches: 4 clouds of 256 points of the synthetic ScanObjectNN and
ShapeNetPart sets from the port's loader (bit-equal to ``geot_tpu``'s). At
256 points every JAX neighbour search is exact ``lax.top_k``. Dropout is
off where the config can turn it off; PointMLP's head dropout (a fixed
0.5) takes in the port the mask that ``geot_tpu`` drew.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.core.config import EasyConfig as JEasyConfig
from geot_tpu.engine.state import TrainState as JTrainState
from geot_tpu.engine.steps import make_supervised_step as jmake_step
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer

from geot_tpu_torch.core.config import EasyConfig, build_model_from_cfg
from geot_tpu_torch.data import build as tbuild
from geot_tpu_torch.engine.convert import params_from_jax, state_from_jax
from geot_tpu_torch.engine.state import TrainState
from geot_tpu_torch.engine.steps import make_supervised_step
from geot_tpu_torch.models.backbone.pointmlp import (PointMLPEncoder,
                                                     pointMLP, pointMLPElite)
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_torch_zoo_models import GivenMask, _np, _rel, jax_dropout_mask
from test_torch_zoo_train import _adam_mu
from torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS = 256
B = 4

POINTNET2 = ["model.encoder_args.width=8", "model.encoder_args.num_samples=8",
             "model.encoder_args.strides=[4,4]",
             "model.encoder_args.blocks=[1,1]"]
POINTMLP_CLS = ["model.encoder_args.embed_dim=8",
                "model.encoder_args.dim_expansion=[2,2]",
                "model.encoder_args.pre_blocks=[1,1]",
                "model.encoder_args.pos_blocks=[1,1]",
                "model.encoder_args.k_neighbors=[8,8]",
                "model.encoder_args.reducers=[4,4]"]
NO_DROP = ["model.cls_args.dropout_ratio=0.0"]
# name -> (config file, overrides): the small widths of geot_tpu's own cls
# and partseg tests (tests/test_cls_*.py, tests/test_partseg_*.py)
MODELS = {
    "cls_pointnet2": ("scanobjectnn/pointnet2cls.yaml",
                      POINTNET2 + ["model.cls_args.mlps=[32]"] + NO_DROP),
    "cls_dgcnn": ("scanobjectnn/dgcnncls.yaml", [
        "model.encoder_args.channels=8", "model.encoder_args.embed_dim=32",
        "model.encoder_args.n_blocks=3", "model.encoder_args.k=8",
        "model.cls_args.mlps=[32]"] + NO_DROP),
    "cls_pointmlp": ("scanobjectnn/pointmlpcls.yaml",
                     POINTMLP_CLS + ["model.cls_args.mlps=[32]"] + NO_DROP),
    "cls_pointmlp_v2": ("scanobjectnn/pointmlpcls.yaml", POINTMLP_CLS + [
        "model.encoder_args.NAME=PointMLPEncoderV2",
        "model.encoder_args.feat_channels=24",
        "model.cls_args.mlps=[32]"] + NO_DROP),
    "cls_pointmlp_alias": ("scanobjectnn/pointmlpcls.yaml", POINTMLP_CLS + [
        "model.encoder_args.NAME=PointMLP", "model.encoder_args.num_classes=15",
        "model.cls_args.mlps=[32]"] + NO_DROP),
    "distill_pointnet2": ("scanobjectnn/pointnet2cls.yaml", POINTNET2 + [
        "model.NAME=DistillCls", "model.cls_args.mlps=[32,16]"] + NO_DROP),
    "part_pointnet2": ("shapenetpart/pointnet2part.yaml",
                       POINTNET2 + ["model.cls_args.mlps=[16]"] + NO_DROP),
    "part_pointmlp": ("shapenetpart/pointmlppart.yaml", [
        "model.embed_dim=8", "model.dim_expansion=[2,2]",
        "model.pre_blocks=[1,1]", "model.pos_blocks=[1,1]",
        "model.k_neighbors=[8,8]", "model.reducers=[4,4]",
        "model.de_dims=[16,16]", "model.de_blocks=[1,1]", "model.gmp_dim=8",
        "model.cls_dim=8"]),
}
NAMES = sorted(MODELS)
# max |dlogit| / max |logit| of the float32 eval forward, and the float64
# step's loss (relative) and per-tensor gradient (of the tensor's largest)
# bounds: those of tests/test_torch_zoo_models.py and
# tests/test_torch_zoo_train.py
EVAL_RTOL = 1e-4
STEP_LOSS_RTOL = 1e-6
STEP_GRAD_TOL = 1e-6



def heritage_cfg(pkg, name, *extra):
    path, opts = MODELS[name]
    cfg = (JEasyConfig if pkg == "jax" else EasyConfig)()
    cfg.load(os.path.join(ROOT, "cfgs", path), recursive=True)
    cfg.update(list(opts) + [f"dataset.common.num_points={N_PTS}", "seed=0"]
               + list(extra))
    return cfg


def heritage_batch(cfg):
    """The first training batch of the config's dataset (numpy)."""
    split = cfg.dataset.get("train_split", "train")
    loader = tbuild.build_dataloader_from_cfg(B, cfg.dataset, split=split,
                                              seed=0)
    loader.set_epoch(1)
    batch = next(iter(loader))
    return {k: batch[k] for k in ("pos", "x", "cls", "y") if k in batch}


def _logits(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def seeded_variables(jmodel, jbatch, seed):
    """Variables of ``jmodel``'s tree (``jax.eval_shape`` of its init: no
    compile) drawn from numpy: kernels N(0, 1 / fan_in), biases and
    BatchNorm shifts N(0, 0.1^2), scales 1 + U(-0.1, 0.1), running means
    U(-0.05, 0.05) and variances U(0.8, 1.2), PointMLP's affine
    ``alpha`` 1 + U(-0.1, 0.1) and ``beta`` N(0, 0.1^2)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jmodel.init, {"params": key, "dropout": key},
                            jbatch)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "affine_alpha"):
            a = 1.0 + rng.uniform(-0.1, 0.1, shape)
        elif name == "mean":
            a = rng.uniform(-0.05, 0.05, shape)
        elif name == "var":
            a = rng.uniform(0.8, 1.2, shape)
        else:                          # bias, affine_beta
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _cast64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)
                              if np.asarray(a).dtype == np.float32 else a),
        tree)


@pytest.fixture(scope="module")
def both():
    """Per model: the batch, ``geot_tpu``'s variables
    (``seeded_variables``), its float32 eval output, and its float64 step (the state
    after it, the loss, the dropout mask PointMLP's head drew)."""
    out = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for name in NAMES:
            if name == "cls_pointmlp_alias":
                # geot_tpu's PointMLP is its PointMLPEncoder: the same
                # module, weights and batch as cls_pointmlp
                out[name] = out["cls_pointmlp"]
                continue
            jcfg = heritage_cfg("jax", name)
            batch = heritage_batch(heritage_cfg("torch", name))
            jb32 = {k: jnp.asarray(v) for k, v in batch.items()}
            jmodel = jbuild(jcfg.model)
            variables = seeded_variables(jmodel, jb32, 3)
            eval_out = _np(jax.jit(jmodel.apply)(
                jax.tree_util.tree_map(jnp.asarray, variables), jb32))
            b64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
                   for k, v in batch.items()}
            jb64 = {k: jnp.asarray(v) for k, v in b64.items()}
            v64 = _cast64(variables)
            tx = joptimizer(None, lr=jcfg.lr, **jcfg.optimizer)
            jstate = JTrainState.create(v64, tx)
            lr = build_scheduler_from_cfg(heritage_cfg("torch", name))(1)
            mask = None
            if name == "part_pointmlp":
                # geot_tpu's dropout key of step 0 at seed 0 (steps.py:96)
                mask = jax_dropout_mask(jmodel, v64, jb64, jax.random.fold_in(
                    jax.random.PRNGKey(0), 0))
            new, m = jmake_step(jmodel, tx, jcfg)(jstate, jb64,
                                                  jnp.asarray(lr))
            out[name] = {"batch": batch, "variables": variables,
                         "eval": eval_out, "new": _np(new),
                         "loss": float(m["loss"]), "mask": mask, "lr": lr}
    finally:
        jax.config.update("jax_enable_x64", False)
    return out


def port_model(name, variables):
    model = build_model_from_cfg(heritage_cfg("torch", name).model)
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_covers_every_port_tensor(both, name):
    variables = both[name]["variables"]
    sd = params_from_jax(variables)
    model = build_model_from_cfg(heritage_cfg("torch", name).model)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    assert sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(
        variables["params"])) == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", NAMES)
def test_eval_logits_match_geot_tpu(both, name):
    """float32 eval forward from the same weights: max |dlogit| within
    ``EVAL_RTOL`` of the largest logit; ``DistillCls``'s global feature
    too; arrays in give what the batch dict gives."""
    rec = both[name]
    model = port_model(name, rec["variables"]).eval()
    tb = {k: torch.from_numpy(v) for k, v in rec["batch"].items()}
    with torch.no_grad():
        got = model(tb)
        args = (tb["pos"], tb["x"]) + ((tb["cls"],) if "cls" in tb
                                       and name.startswith("part") else ())
        again = model(*args)
    want = rec["eval"]
    rel = _rel(_logits(got).numpy(), _logits(want))
    print(f"{name}: eval max |dlogit| / max |logit| {rel:.3e}")
    assert _logits(got).shape == _logits(want).shape
    assert _logits(got).shape[-1] == (15 if name.startswith(("cls", "distill"))
                                      else 50)
    assert rel <= EVAL_RTOL
    torch.testing.assert_close(_logits(again), _logits(got), rtol=0, atol=0)
    if name.startswith("distill"):
        assert isinstance(got, tuple) and len(got) == 2
        assert _rel(got[1].numpy(), want[1]) <= EVAL_RTOL


@pytest.mark.parametrize("name", NAMES)
def test_supervised_step_matches_geot_tpu(both, name):
    """float64, one ``make_supervised_step`` from the same state and batch:
    the loss within ``STEP_LOSS_RTOL``, the running statistics within
    1e-8 (``geot_tpu`` rounds the 3-NN weights to float32: its kNN returns
    float32 distances; measured 7.9e-10), and AdamW's first moment (0.1 x the clipped gradient) per
    tensor within ``STEP_GRAD_TOL`` of the tensor's largest entry (the
    scale floored at 1e-6 of the largest gradient: a bias before a
    batch-statistics BatchNorm has a zero gradient)."""
    rec = both[name]
    cfg = heritage_cfg("torch", name)
    state = TrainState.create(cfg, cfg.model, seed=0, device="cpu")
    state.model.double()
    state.load(state_from_jax({"params": rec["variables"]["params"],
                               "batch_stats":
                               rec["variables"]["batch_stats"]}))
    if rec["mask"] is not None:
        state.model.dropout = GivenMask(rec["mask"], 0.5)
    b64 = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32
                               else v) for k, v in rec["batch"].items()}
    m = make_supervised_step(cfg)(state, b64, rec["lr"])
    rel = _rel(float(m["loss"]), rec["loss"])
    new = rec["new"]
    want_sd = params_from_jax({"params": new.params,
                               "batch_stats": new.batch_stats})
    sd = state.model.state_dict()
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-8, err_msg=k)
    want = params_from_jax({"params": _adam_mu(new.opt_state),
                            "batch_stats": {}})
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    gmax = max(float(v.abs().max()) for v in want.values())
    worst = 0.0
    for k, p in named.items():
        got = state.opt.state[p]["exp_avg"].numpy()
        ref = want[k].double().numpy()
        scale = max(np.abs(ref).max(), 1e-6 * gmax)
        err = float(np.abs(got - ref).max() / scale)
        worst = max(worst, err)
        assert err <= STEP_GRAD_TOL, (k, err)
    print(f"{name} float64 step: loss {float(m['loss']):.10f} (relative "
          f"{rel:.2e}), worst per-tensor gradient error {worst:.2e}")
    assert rel <= STEP_LOSS_RTOL
    assert state.step == 1


def test_pointmlp_constructors():
    """``pointMLP`` / ``pointMLPElite`` build the published encoders
    (``num_classes`` dropped), and the registry's ``PointMLP`` drops the
    arguments ``PointMLPEncoder`` does not take."""
    full, elite = pointMLP(in_channels=4, num_classes=15), pointMLPElite()
    assert isinstance(full, PointMLPEncoder) and full.out_channels == 1024
    assert elite.out_channels == 256 and elite.in_channels == 3
    alias = build_model_from_cfg({"NAME": "PointMLP", "in_channels": 4,
                                  "embed_dim": 8, "dim_expansion": [2],
                                  "pre_blocks": [1], "pos_blocks": [1],
                                  "k_neighbors": [4], "reducers": [2],
                                  "num_classes": 15, "groups": 1})
    assert type(alias) is PointMLPEncoder and alias.out_channels == 16
    feat = alias.forward_cls_feat(torch.randn(2, 32, 3), torch.randn(2, 32, 4))
    assert feat.shape == (2, 16)
