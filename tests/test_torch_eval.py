"""The port's validation and its eval-side steps against ``geot_tpu``'s:
``_upsample_cm``, ``_metrics_from_cm``, ``validate`` over the whole
synthetic val split, ``make_eval_step``, ``make_confusion_step`` and
``make_supervised_step``; and the model's mode around them.

The config is the small one of ``tests/test_torch_model.py`` (D = 48,
depth 3, 256 points) with stochastic depth and dropout off, weights carried
across by ``params_from_jax``.
"""
import copy
import os

os.environ.setdefault("GEOT_EXACT_KNN", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geot_tpu.data import build as jdata_build  # noqa: E402
from geot_tpu.engine import eval as jeval  # noqa: E402
from geot_tpu.engine.state import TrainState as JTrainState  # noqa: E402
from geot_tpu.engine.steps import make_confusion_step as jmake_confusion_step  # noqa: E402,E501
from geot_tpu.engine.steps import make_eval_step as jmake_eval_step  # noqa: E402
from geot_tpu.engine.steps import make_supervised_step as jmake_sup_step  # noqa: E402,E501
from geot_tpu.engine.train import cal_confusion as jcal_confusion  # noqa: E402
from geot_tpu.models import build_model_from_cfg as jbuild  # noqa: E402
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer  # noqa: E402

from geot_tpu_torch import FLAGSHIP_SEMI_CFG  # noqa: E402
from geot_tpu_torch.core.config import build_model_from_cfg  # noqa: E402
from geot_tpu_torch.data import build as tdata_build  # noqa: E402
from geot_tpu_torch.engine import eval as teval  # noqa: E402
from geot_tpu_torch.engine.convert import (params_from_jax,  # noqa: E402
                                           semi_state_from_jax)
from geot_tpu_torch.engine.state import SemiTrainState  # noqa: E402
from geot_tpu_torch.engine.steps import (make_confusion_step,  # noqa: E402
                                         make_eval_step, make_semi_step,
                                         make_supervised_step)
from geot_tpu_torch.engine.train import cal_confusion  # noqa: E402

from test_torch_model import N_POINTS, SMALL_ARGS, jax_small_model  # noqa: E402,E501
from torch_helpers import one_torch_thread  # noqa: E402,F401

TRAIN_ARGS = dict(SMALL_ARGS, drop_path_rate=0.0, head_dropout=0.0)
CFG = dict(FLAGSHIP_SEMI_CFG, num_points=N_POINTS)
C = 17
DS = {"common": {"NAME": "TeethSegSemiLDataset", "data_root": "",
                 "num_points": N_POINTS}}



def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The JAX model and weights, and the port model with the same
    weights, dropout off."""
    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": TRAIN_ARGS})
    _, variables = jax_small_model(3)
    tmodel = build_model_from_cfg({"NAME": "WholePartSeg",
                                   "segmentor_args": TRAIN_ARGS})
    tmodel.load_state_dict(params_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


def _val_loaders(split="val"):
    tf = CFG["datatransforms"]
    return (tdata_build.build_dataloader_from_cfg(2, DS, None, tf,
                                                  split=split,
                                                  seed=CFG["seed"]),
            jdata_build.build_dataloader_from_cfg(2, DS, None, tf,
                                                  split=split,
                                                  seed=CFG["seed"]))


# --- the upsample's confusion matrix and its metrics -----------------------

@pytest.mark.parametrize("n_valid", [5000, 5300, 8192])
def test_upsample_cm_equals_geot_tpu(n_valid):
    rng = np.random.default_rng(n_valid)
    N, P = 300, 8192
    logits = rng.standard_normal((N, C)).astype(np.float32) * 3
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    pos = rng.standard_normal((N, 3)).astype(np.float32) * 0.5
    center = rng.standard_normal(3).astype(np.float32)
    scale = np.float32(1.7)
    full = np.zeros((P, 3), np.float32)
    full[:n_valid] = rng.standard_normal((n_valid, 3)) * 0.85 + center
    labels = rng.integers(0, C, P).astype(np.int32)   # padding labelled too
    want = np.asarray(jeval._upsample_cm(
        jnp.asarray(probs), jnp.asarray(pos), jnp.asarray(full),
        jnp.asarray(center), jnp.asarray(scale), jnp.asarray(labels),
        jnp.int32(n_valid), C))
    got = teval._upsample_cm(
        torch.from_numpy(probs), torch.from_numpy(pos),
        torch.from_numpy(full), torch.from_numpy(center),
        torch.tensor(scale), torch.from_numpy(labels).long(), n_valid, C)
    assert got.dtype == torch.int32 and got.shape == (C, C)
    assert int(got.sum()) == n_valid
    np.testing.assert_array_equal(got.numpy(), want)


def _cms():
    rng = np.random.default_rng(7)
    full = rng.integers(0, 500, (C, C))
    absent = full.copy()
    absent[[3, 9, 16]] = 0                       # classes not in the labels
    never = full.copy()
    never[:, 5] = 0
    never[5] = 0
    never[5, 0] = 7                              # class 5 never predicted
    gum_only = np.zeros((C, C), np.int64)
    gum_only[0, 0] = 10                          # nothing to average: NaN
    return [full, absent, never, gum_only, np.zeros((C, C), np.int64)]


@pytest.mark.parametrize("case", range(5))
def test_metrics_from_cm_equal_geot_tpu(case):
    cm = _cms()[case]
    got = teval._metrics_from_cm(cm)
    want = jeval._metrics_from_cm(cm)
    for a, b in zip(got, want):
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12, (a, b)


# --- validate --------------------------------------------------------------

def _recording(monkeypatch, module):
    seen = []
    real = module._metrics_from_cm

    def record(cm):
        seen.append(np.asarray(cm))
        return real(cm)

    monkeypatch.setattr(module, "_metrics_from_cm", record)
    return seen


def test_validate_equals_geot_tpu(models, monkeypatch):
    """Both in float64 (JAX with x64 on for this test): in float32 the two
    forwards differ by ~1e-6 of the logit scale, enough to flip a point
    where two classes tie.

    Even in float64 one point of the 960,000 (scan 14) gets another
    label: the 3-NN search reads float32 coordinates in both packages, and
    XLA on the CPU contracts ``dx*dx + dy*dy + dz*dz`` into fused
    multiply-adds (21 % of such float32 sums differ in the last bit from
    the separately rounded sum), while the port rounds each product, as
    its CUDA kernel built with ``--fmad=false`` does. So the last bit of a
    distance, and with it an inverse-distance weight, can differ. Bounds:
    at most 2 points of the split labelled differently, every output key
    within 5e-6 (measured: 1 point; 2.1e-6, ``mandible_acc``)."""
    jmodel, variables, tmodel = models
    t_loader, j_loader = _val_loaders()
    assert len(t_loader) == 12 and not t_loader.shuffle
    t_cms = _recording(monkeypatch, teval)
    j_cms = _recording(monkeypatch, jeval)
    cfg = {"num_classes": C, "seed": CFG["seed"]}
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        want = jeval.validate(jmake_eval_step(jmodel), v64, j_loader, cfg)
    finally:
        jax.config.update("jax_enable_x64", False)
    model64 = copy.deepcopy(tmodel).double()
    got = teval.validate(make_eval_step(), model64, t_loader, cfg)
    assert len(t_cms) == len(j_cms) == 24
    flips = [int(np.abs(a.astype(np.int64) - b).sum()) // 2
             for a, b in zip(t_cms, j_cms)]
    print(f"points labelled differently, per scan: {flips}")
    for a, b in zip(t_cms, j_cms):
        assert a.sum() == b.sum() == 40000
        np.testing.assert_array_equal(a.sum(1), b.sum(1))  # same labels
    assert sum(flips) <= 2
    assert set(got) == set(want) and len(got) == 10
    diffs = {k: abs(got[k] - want[k]) for k in want}
    print(f"validate {got}; |port - geot_tpu| {diffs}")
    assert max(diffs.values()) <= 5e-6, diffs
    # the second pass reads the loader's cache and gives the same answer;
    # so does the float32 model, to well inside the tolerance above
    assert t_loader._geot_eval_cache[0] == torch.device("cpu")
    assert teval.validate(make_eval_step(), model64, t_loader, cfg) == got
    got32 = teval.validate(make_eval_step(), tmodel, t_loader, cfg)
    for k in want:
        assert abs(got32[k] - want[k]) <= 1e-4, (k, got32[k], want[k])


def test_validate_refuses_votes(models):
    """Votes need a vote pipeline: without one ``validate`` refuses them
    (``geot_tpu`` would quietly not vote). Voting itself is held against
    ``geot_tpu`` in ``tests/test_torch_fast.py``."""
    with pytest.raises(ValueError, match="num_votes"):
        teval.validate(make_eval_step(), models[2], [], {}, num_votes=2)


# --- eval and confusion steps ----------------------------------------------

@pytest.fixture(scope="module")
def val_batch():
    t_loader, _ = _val_loaders()
    return next(iter(t_loader))


def test_eval_step_equals_geot_tpu(models, val_batch):
    jmodel, variables, tmodel = models
    keys = ("pos", "x", "cls")
    want = np.asarray(jmake_eval_step(jmodel)(
        variables, {k: jnp.asarray(val_batch[k]) for k in keys}))
    tmodel.train()
    got = make_eval_step()(tmodel, tdata_build.to_device(val_batch, keys,
                                                         "cpu"))
    assert not tmodel.training and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_confusion_step_equals_geot_tpu(models, val_batch):
    jmodel, variables, tmodel = models
    keys = ("pos", "x", "cls", "y")
    want = np.asarray(jmake_confusion_step(jmodel, C)(
        variables, {k: jnp.asarray(val_batch[k]) for k in keys}))
    got = make_confusion_step(C)(tmodel, tdata_build.to_device(
        val_batch, keys, "cpu"))
    assert got.shape == (C, C) and float(got.sum()) == 2 * N_POINTS
    np.testing.assert_array_equal(got.numpy(), want)


def test_cal_confusion_equals_geot_tpu(models):
    jmodel, variables, tmodel = models
    loaders = _val_loaders()
    for loader in loaders:
        loader.dataset.file_list = loader.dataset.file_list[:4]
    want = jcal_confusion(jmake_confusion_step(jmodel, C), variables,
                          loaders[1], C,
                          lambda d: jax.tree_util.tree_map(jnp.asarray, d))
    got = cal_confusion(make_confusion_step(C), tmodel, loaders[0], C, "cpu")
    assert got.dtype == torch.float32 and got.shape == (C, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the supervised step, in float64 ---------------------------------------

def test_supervised_step_equals_geot_tpu(models):
    """One supervised step from the same weights in float64 in both
    packages: the loss within 1e-6 relative (``geot_tpu``'s loss comes
    back in float32), and AdamW's first moment
    (0.1 x the clipped gradient) tensor by tensor within 1e-5 of the
    tensor's largest entry, as for the semi step (measured: 8.6e-7) (floored at 1e-6 of the largest gradient: a
    bias before a batch-statistics BatchNorm has a zero gradient)."""
    jmodel, variables, _ = models
    loader = tdata_build.build_semi_loaders(CFG)[0]
    loader.set_epoch(1)
    batch = next(iter(loader))
    b64 = {k: (batch[k].astype(np.float64) if batch[k].dtype == np.float32
               else batch[k]) for k in tdata_build.MODEL_KEYS}
    lr = 1e-3
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        tx = joptimizer(None, lr=lr, **CFG["optimizer"])
        jstate = JTrainState.create(v64, tx)
        jnew, jm = jmake_sup_step(jmodel, tx, CFG)(
            jstate, {k: jnp.asarray(v) for k, v in b64.items()},
            jnp.asarray(lr))
        jnew, jm = _np_tree(jnew), _np_tree(jm)
    finally:
        jax.config.update("jax_enable_x64", False)

    state = SemiTrainState.create(CFG, seg_args=TRAIN_ARGS, device="cpu")
    state.model.double()
    state.model.load_state_dict(params_from_jax(variables), strict=True)
    state.model.eval()                     # the step must switch to train
    t_before = {k: v.clone() for k, v in state.t_predictor.state_dict()
                .items()}
    tm = make_supervised_step(CFG)(state, tdata_build.to_device(
        b64, tdata_build.MODEL_KEYS, "cpu"), lr)
    assert state.model.training and state.step == 1
    for k in ("loss", "sup_loss"):
        assert abs(float(tm[k]) / float(jm[k]) - 1) <= 1e-6, k
    assert float(tm["unsup_loss"]) == 0.0
    # the training forward's running statistics are flax's (the converter
    # rounds the reference to float32)
    got_sd = state.model.state_dict()
    want_sd = params_from_jax({"params": jnew.params,
                               "batch_stats": jnew.batch_stats})
    for k, v in want_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    adam = [s for s in jax.tree_util.tree_leaves(
        jnew.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    want = params_from_jax({"params": adam.mu, "batch_stats": {}})
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    gmax = max(float(np.abs(v.numpy()).max()) for v in want.values())
    worst = 0.0
    for k, p in named.items():
        got = state.opt.state[p]["exp_avg"].numpy()
        ref = want[k].double().numpy()
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6 * gmax)
        worst = max(worst, err)
        assert err <= 1e-5, (k, err)
    print(f"supervised step, float64: worst per-tensor gradient error "
          f"{worst:.3e}")
    # the T-predictor and its optimizer are not touched
    for k, v in state.t_predictor.state_dict().items():
        assert torch.equal(v, t_before[k]), k
    assert not state.t_opt.state


# --- modes around validation -----------------------------------------------

def test_semi_step_after_validate_trains_in_train_mode(models):
    """``validate`` leaves the model in eval mode with its weights and
    running statistics unchanged; the next semi step runs it in train
    mode, so the running statistics move."""
    jmodel, variables, _ = models
    state = SemiTrainState.create(CFG, seg_args=TRAIN_ARGS, device="cpu")
    state.load(semi_state_from_jax({
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "teacher_params": variables["params"],
        "teacher_batch_stats": variables["batch_stats"],
        "t_params": {"T_predictor": {"fc": state.t_predictor.state_dict()[
            "T_predictor.fc"].numpy()}},
        "ema_t": np.eye(C), "cm": np.eye(C)}))
    t_loader, _ = _val_loaders()
    t_loader.dataset.file_list = t_loader.dataset.file_list[:4]
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    teval.validate(make_eval_step(), state.model, t_loader, {})
    assert not state.model.training
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    l, u = tdata_build.build_semi_loaders(CFG)
    bl, bu = next(tdata_build.semi_pairs(l, u))
    make_semi_step(CFG)(state, tdata_build.to_device(
        bl, tdata_build.MODEL_KEYS, "cpu"), tdata_build.to_device(
        bu, tdata_build.SEMI_KEYS, "cpu"), 1e-3, True)
    assert state.model.training and not state.teacher.training
    moved = [k for k, v in state.model.state_dict().items()
             if k.endswith("running_mean") and not torch.equal(v, before[k])]
    assert moved
