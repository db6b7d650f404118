"""The semi-supervised recipe with ``model.NAME: WholePartSeg_ntm`` (the
student and the teacher) against ``geot_tpu``: one flagship semi step in
float64 at the small config of ``tests/test_torch_train.py``, teacher on,
with the default criterion (``Poly1FocalLoss_U_corr``) and with
``Poly1FocalLoss_U_T_v1``, whose missing T-revision output is zeros in
both packages (``geot_tpu/engine/steps.py:275-279``): the losses within
``STEP_LOSS_RTOL`` and AdamW's first moments (student and T-predictor)
per tensor within ``STEP_GRAD_TOL`` of the tensor's largest entry.

``WholePartSeg_ntm``'s tree is ``WholePartSeg``'s, so the weights are
``geot_tpu``'s own init of the small model (under ``jit``) with jittered
BatchNorm statistics and ``T_linear``, as ``tests/test_torch_model.py``'s
``jax_small_model``; the T thread never reaches the segmentor, so
``T_linear`` gets no gradient.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from geot_tpu.engine.state import SemiTrainState as JSemiTrainState
from geot_tpu.engine.steps import make_semi_step as jmake_semi_step
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer

from geot_tpu_torch.data import build as tdata_build
from geot_tpu_torch.engine.convert import (params_from_jax,
                                           semi_state_from_jax,
                                           t_params_from_jax)
from geot_tpu_torch.engine.state import SemiTrainState
from geot_tpu_torch.engine.steps import make_semi_step
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_torch_train import (CFG, TRAIN_ARGS, C, _adam_mu, _jbatch, _np_tree,
                              _rel, _tbatch, batches)  # noqa: F401
from torch_helpers import one_torch_thread  # noqa: F401

STEP_LOSS_RTOL = 1e-6
STEP_GRAD_TOL = 1e-6
NTM = "WholePartSeg_ntm"



@pytest.fixture(scope="module")
def init():
    """``geot_tpu``'s ``WholePartSeg_ntm`` and T-predictor of the small
    config with their float32 initial weights as numpy trees."""
    jmodel = jbuild({"NAME": NTM, "segmentor_args": TRAIN_ARGS})
    pos = jnp.zeros((1, 256, 3))
    key = jax.random.PRNGKey(0)
    variables = _np_tree(jax.jit(lambda b: jmodel.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1)}, b))(
            {"pos": pos, "x": pos, "cls": jnp.zeros((1, 1), jnp.int32)}))
    rng = np.random.default_rng(0)

    def jitter(path, a):
        name = path[-1].key
        if name == "mean":
            return rng.uniform(-0.05, 0.05, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return a

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        jitter, variables["batch_stats"])
    seg = variables["params"]["segmentor"]
    seg["T_linear"] = (rng.standard_normal(seg["T_linear"].shape)
                       * 0.1).astype(np.float32)
    jt = jbuild(CFG["t_predictor"])
    t_vars = _np_tree(jt.init(jax.random.PRNGKey(2), jnp.ones((1, 8, C)) / C,
                              jnp.eye(C)))
    return jmodel, variables, jt, t_vars


@pytest.mark.parametrize("criterion_u", ["Poly1FocalLoss_U_corr",
                                         "Poly1FocalLoss_U_T_v1"])
def test_ntm_semi_step_matches_geot_tpu(init, batches, criterion_u):
    jmodel, variables, jt, t_vars = init
    cfg = dict(CFG, criterion_u_args=dict(CFG["criterion_u_args"],
                                          NAME=criterion_u))
    bl, bu = batches[0]

    def f64(b, keys):
        return {k: (b[k].astype(np.float64) if b[k].dtype == np.float32
                    else b[k]) for k in keys}

    bl, bu = f64(bl, tdata_build.MODEL_KEYS), f64(bu, tdata_build.SEMI_KEYS)
    rng = np.random.default_rng(11)
    cm = rng.uniform(0, 1, (C, C))
    cm /= cm.sum(1, keepdims=True)
    ema = np.eye(C) * 0.7 + 0.3 / C
    lr = build_scheduler_from_cfg(cfg)(1)
    jax.config.update("jax_enable_x64", True)
    try:
        def cast(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a, np.float64)
                                      if np.asarray(a).dtype == np.float32
                                      else a), tree)

        tx = joptimizer(None, lr=cfg["lr"], **cfg["optimizer"])
        t_tx = joptimizer(None, lr=cfg["lr"], **cfg["optimizer"])
        jstate = JSemiTrainState.create(
            cast(variables), tx, cast(t_vars), t_tx, C, jax.random.PRNGKey(3),
            teacher_variables=cast(variables),
            contrast_dim=TRAIN_ARGS["trans_dim"])
        jstate = jstate.replace(cm=jnp.asarray(cm), ema_t=jnp.asarray(ema))
        before = {f: _np_tree(getattr(jstate, f)) for f in (
            "params", "batch_stats", "t_params", "teacher_params",
            "teacher_batch_stats", "ema_t", "cm")}
        jstep = jmake_semi_step(jmodel, jmodel, jt, tx, t_tx, cfg)
        jnew, jm = jstep(jstate, _jbatch(bl, bl), _jbatch(bu, bu),
                         jnp.asarray(lr, jnp.float64), True)
        jnew, jm = _np_tree(jnew), _np_tree(jm)
    finally:
        jax.config.update("jax_enable_x64", False)

    state = SemiTrainState.create(cfg, seg_args=TRAIN_ARGS, device="cpu",
                                  model_name=NTM)
    assert type(state.teacher).__name__ == "WholePartSegNTM"
    for m in (state.model, state.teacher, state.t_predictor):
        m.double()
    state.ema_t, state.cm = state.ema_t.double(), state.cm.double()
    state.load(semi_state_from_jax(before))
    tm = make_semi_step(cfg)(state, _tbatch(bl, bl), _tbatch(bu, bu), lr,
                             True)
    for k in ("loss", "sup_loss", "unsup_loss", "threed_loss"):
        assert np.isfinite(float(tm[k])), k
        assert _rel(float(tm[k]), float(jm[k])) <= STEP_LOSS_RTOL, k

    want = params_from_jax({"params": _adam_mu(jnew.opt_state),
                            "batch_stats": {}})
    want.update(t_params_from_jax(_adam_mu(jnew.t_opt_state)))
    named = dict(state.model.named_parameters())
    named.update(state.t_predictor.named_parameters())
    assert set(want) == set(named)
    assert float(want["segmentor.T_linear.weight"].abs().max()) == 0.0
    gmax = max(float(v.abs().max()) for v in want.values())
    worst = 0.0
    for k, p in named.items():
        opt = state.t_opt if k.startswith("T_predictor.") else state.opt
        got = opt.state[p]["exp_avg"].double().numpy()
        ref = want[k].double().numpy()
        err = float(np.abs(got - ref).max()
                    / max(np.abs(ref).max(), 1e-6 * gmax))
        worst = max(worst, err)
        assert err <= STEP_GRAD_TOL, (k, err)
    print(f"{criterion_u}: loss {float(tm['loss']):.10f}, worst per-tensor "
          f"gradient error {worst:.2e}")
    # the NTM's EMA, as tests/test_torch_train.py holds it
    np.testing.assert_allclose(state.ema_t.numpy(), jnew.ema_t, rtol=0,
                               atol=1e-6)
