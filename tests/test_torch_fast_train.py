"""The ``_fast.yaml`` recipe in the port against ``geot_tpu``: one semi step
with a student in the serving topology (``fast_pyramid``, ``fast_graph``)
and an exact teacher (``model_t``), from the same converted state; and the
recipe through the port's trainer, with test-time votes.

The config is the small one of ``tests/test_torch_model.py`` (D = 48,
depth 3, 256 points) with stochastic depth and dropout off, as in
``tests/test_torch_train.py``.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.engine.state import SemiTrainState as JSemiTrainState
from geot_tpu.engine.steps import make_semi_step as jmake_semi_step
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer

from geot_tpu_torch.data import build as tdata_build
from geot_tpu_torch.engine import eval as teval
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.convert import (params_from_jax,
                                           semi_state_from_jax,
                                           t_params_from_jax)
from geot_tpu_torch.engine.state import SemiTrainState
from geot_tpu_torch.engine.steps import make_semi_step
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_torch_model import ROOT, jax_small_model
from test_torch_train import CFG, TRAIN_ARGS, _adam_mu, _np_tree, _rel
from torch_helpers import one_torch_thread  # noqa: F401



C = 17
FAST_TRAIN_ARGS = dict(TRAIN_ARGS, fast_pyramid=64, fast_graph=True)
FAST_YAML = os.path.join(ROOT, "cfgs", "tooth_semi",
                         "transformer_finetune_fixmatch_ntm_fast.yaml")


@pytest.fixture(scope="module")
def batch():
    """The first (labelled, unlabelled) numpy batch pair of epoch 1."""
    l, u = tdata_build.build_semi_loaders(CFG)
    l.set_epoch(1)
    u.set_epoch(1)
    return next(tdata_build.semi_pairs(l, u, limit=1))


def _run_both(batch, x64):
    """One semi step, teacher on, fast student and exact teacher, from the
    same state in both packages: (JAX state after, JAX metrics, port state,
    port metrics)."""
    student = jbuild({"NAME": "WholePartSeg",
                      "segmentor_args": FAST_TRAIN_ARGS})
    teacher = jbuild({"NAME": "WholePartSeg", "segmentor_args": TRAIN_ARGS})
    variables = _np_tree(jax_small_model(0)[1])
    jt = jbuild(CFG["t_predictor"])
    t_vars = _np_tree(jt.init(jax.random.PRNGKey(2),
                              jnp.ones((1, 8, C)) / C, jnp.eye(C)))
    rng = np.random.default_rng(11)
    cm = rng.uniform(0, 1, (C, C)).astype(np.float32)
    cm /= cm.sum(1, keepdims=True)
    ema = np.eye(C, dtype=np.float32) * 0.7 + 0.3 / C
    dt = np.float64 if x64 else np.float32

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, dt) if np.asarray(a).dtype
                                  == np.float32 else a), tree)

    def arrays(b, keys):
        return {k: (b[k].astype(dt) if b[k].dtype == np.float32 else b[k])
                for k in keys}

    bl = arrays(batch[0], tdata_build.MODEL_KEYS)
    bu = arrays(batch[1], tdata_build.SEMI_KEYS)
    lr = build_scheduler_from_cfg(CFG)(1)
    tx = joptimizer(None, lr=CFG["lr"], **CFG["optimizer"])
    t_tx = joptimizer(None, lr=CFG["lr"], **CFG["optimizer"])
    jstate = JSemiTrainState.create(
        cast(variables), tx, cast(t_vars), t_tx, C, jax.random.PRNGKey(3),
        teacher_variables=cast(variables),
        contrast_dim=TRAIN_ARGS["trans_dim"])
    jstate = jstate.replace(cm=jnp.asarray(cm.astype(dt)),
                            ema_t=jnp.asarray(ema.astype(dt)))
    before = {f: _np_tree(getattr(jstate, f)) for f in (
        "params", "batch_stats", "t_params", "teacher_params",
        "teacher_batch_stats", "ema_t", "cm")}
    jstep = jmake_semi_step(student, teacher, jt, tx, t_tx, dict(CFG))
    jnew, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in bl.items()},
                           {k: jnp.asarray(v) for k, v in bu.items()},
                           jnp.asarray(lr, dt), True)

    state = SemiTrainState.create(CFG, seg_args=FAST_TRAIN_ARGS,
                                  teacher_args=TRAIN_ARGS, device="cpu")
    if x64:
        for m in (state.model, state.teacher, state.t_predictor):
            m.double()
        state.ema_t, state.cm = state.ema_t.double(), state.cm.double()
    state.load(semi_state_from_jax(before))
    metrics = make_semi_step(CFG)(
        state, tdata_build.to_device(bl, bl, "cpu"),
        tdata_build.to_device(bu, bu, "cpu"), lr, True)
    return _np_tree(jnew), _np_tree(jmetrics), state, metrics


@pytest.fixture(scope="module")
def one_step(batch):
    return _run_both(batch, x64=False)


@pytest.fixture(scope="module")
def one_step_x64(batch):
    jax.config.update("jax_enable_x64", True)
    try:
        return _run_both(batch, x64=True)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_teacher_has_its_own_topology():
    state = SemiTrainState.create(CFG, seg_args=FAST_TRAIN_ARGS,
                                  teacher_args=TRAIN_ARGS, device="cpu")
    assert state.model.segmentor.fast_pyramid == 64
    assert state.model.segmentor.fast_graph
    assert not state.teacher.segmentor.fast_pyramid
    assert not any(p.requires_grad for p in state.teacher.parameters())
    want = state.model.state_dict()
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_fast_semi_step_losses_match_jax(one_step):
    """float32: loss terms within 1e-5 relative, as the flagship step's."""
    _, jm, _, tm = one_step
    for k in ("loss", "sup_loss", "unsup_loss", "threed_loss"):
        print(f"{k}: port {float(tm[k]):.8f} jax {float(jm[k]):.8f}")
        assert np.isfinite(float(tm[k]))
        assert _rel(tm[k], jm[k]) <= 1e-5, k
    for k in ("over_th", "pseudo_acc", "teacher_acc", "student_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)


def test_fast_semi_step_gradients_match_jax(one_step_x64):
    """float64: every parameter's first AdamW moment (0.1 x its clipped
    gradient) within 1e-5 of the tensor's largest entry, the bar of
    ``tests/test_torch_train.py::test_semi_step_gradients_match_jax``."""
    jnew, jm, state, tm = one_step_x64
    for k in ("loss", "sup_loss", "unsup_loss", "threed_loss"):
        assert _rel(tm[k], jm[k]) <= 1e-6, k
    want = params_from_jax({"params": _adam_mu(jnew.opt_state),
                            "batch_stats": {}})
    want.update(t_params_from_jax(_adam_mu(jnew.t_opt_state)))
    named = dict(state.model.named_parameters())
    named.update(state.t_predictor.named_parameters())
    assert set(want) == set(named)
    gmax = max(float(v.abs().max()) for v in want.values())
    worst = 0.0
    for k, p in named.items():
        opt = state.t_opt if k.startswith("T_predictor.") else state.opt
        got = opt.state[p]["exp_avg"].double().numpy()
        ref = want[k].double().numpy()
        scale = max(np.abs(ref).max(), 1e-6 * gmax)
        err = np.abs(got - ref).max() / scale
        worst = max(worst, err)
        assert err <= 1e-5, (k, err)
    print(f"float64: worst per-tensor gradient error / max|g|: {worst:.3e}")


# --- the trainer --------------------------------------------------------------

_SMALL = {"trans_dim": 48, "depth": 3, "group_size": 8, "num_group": 32,
          "encoder_dims": 32, "downsample_targets": [128, 64, 32],
          "extract_layers": [1, 2, 3]}


def _fast_opts(root):
    """``_fast.yaml`` cut to the small width, one epoch, 256 points."""
    opts = [f"root_dir={root}", "device=cpu", "epochs=1", "val_freq=1",
            "test_freq=1", "num_points=256", "threed_k=8",
            "dataset_l.common.num_points=256",
            "dataset_u.common.num_points=256",
            "model.segmentor_args.fast_pyramid=64"]
    for model in ("model", "model_t"):
        opts += [f"{model}.segmentor_args.{k}={v!r}".replace(" ", "")
                 for k, v in _SMALL.items()]
    return opts


def test_fast_recipe_trains_and_votes_through_parse_and_run(tmp_path,
                                                          monkeypatch):
    """One epoch of the small ``_fast.yaml`` (fast student, exact teacher)
    with 2 votes: validation, the test pass and its ``test_voting`` pass,
    whose voted logits differ from the single pass's, and whose metrics
    differ from the test pass's and are those of the voted logits (the
    single pass's logits give the ``test`` metrics); then ``mode=test``
    with 2 votes on the best checkpoint gives the ``test_voting`` metrics
    again. The learning rate is small: an epoch at the recipe's labels
    every point of this data as gum, and no vote can change that."""
    voted, vote_loader, loaders = [], [], []
    real_vote, real_cache = teval.tta_vote_logits, teval._eval_cache

    def recording_cache(loader, *args, **kwargs):
        loaders.append(loader)
        return real_cache(loader, *args, **kwargs)

    def recording_vote(logits, *args, **kwargs):
        out = real_vote(logits, *args, **kwargs)
        if not voted:
            vote_loader.append(loaders[-1])
        voted.append((logits.clone(), out.clone()))
        return out

    monkeypatch.setattr(teval, "_eval_cache", recording_cache)
    monkeypatch.setattr(teval, "tta_vote_logits", recording_vote)
    opts = [*_fast_opts(tmp_path), "lr=1e-6"]
    res = ttrain.parse_and_run(["--cfg", FAST_YAML, "num_votes=2", *opts])
    for split in ("val", "test", "test_voting"):
        assert set(res[split]) >= {"whole_miou", "sampled_acc"}
        assert all(np.isfinite(v) and 0 <= v <= 1
                   for v in res[split].values()), (split, res[split])
    assert res["test_voting"] != res["test"]
    assert voted and all(float((b - a).abs().max()) > 0 for a, b in voted)
    # the metrics of the test pass's loader scored from the recorded
    # logits by validate without votes: the voted ones give test_voting's
    probe = torch.nn.Linear(1, 1)
    recorded = {"single": [a for a, _ in voted],
                "voted": [b for _, b in voted]}
    scored = {}
    for kind, logits in recorded.items():
        it = iter(logits)
        scored[kind] = teval.validate(
            lambda model, batch: next(it), probe, vote_loader[0],
            {"num_classes": logits[0].shape[-1]})
    assert scored["voted"] == res["test_voting"], (scored, res)
    assert scored["single"] == res["test"], (scored, res)
    (run_dir,) = glob.glob(os.path.join(tmp_path, "tooth_semi", "*"))
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"test_whole_miou_voting", "train_loss",
            "insT_threed_loss"} <= tags
    best = glob.glob(os.path.join(run_dir, "checkpoint", "*_ckpt_best.pth"))
    sd = torch.load(best[0], weights_only=True)["state"]
    assert set(sd["teacher"]) == set(sd["model"])
    test = ttrain.parse_and_run(["--cfg", FAST_YAML, "mode=test",
                                 "num_votes=2", f"pretrained_path={best[0]}",
                                 *opts])
    assert test["test"] == res["test_voting"]
