"""bfloat16 training against ``geot_tpu``: one flagship semi step with
``segmentor_args.dtype: bfloat16`` for the student and the teacher, in both
packages, from the same float32 weights, batch and state, with stochastic
depth and dropout off (the two frameworks draw different masks). The
config is ``tests/test_torch_train.py``'s small one (D = 48, depth 3, 256
points).

Both packages keep the parameters, the optimizer state and BatchNorm's
running statistics in float32, compute each module in bfloat16, reduce
BatchNorm's batch statistics in float32 and hand float32 logits to the
losses; FPS and every neighbour search read float32 coordinates.

Tolerances, and what was measured on this config:

- The port's float32 step is the control each check must tell apart
  from its bfloat16 step: a port that took ``dtype`` and computed in
  float32 fails. Its ``Dense`` layers return bfloat16 in the bfloat16
  step and only float32 in the float32 one.
- Loss terms within 2e-2 of ``geot_tpu``'s (measured: within 2.0e-3,
  ``threed_loss`` the worst), and each nearer to ``geot_tpu``'s
  bfloat16 term than the port's float32 term is (measured: 0.30 to 0.89
  of the float32 term's distance, ``sup_loss`` the nearest call).
- The teacher's logits within 5e-2 of their largest (measured 3.1e-2;
  ``geot_tpu``'s own compiled and eager bfloat16 forwards are 2.7e-2
  apart), and its pseudo labels equal at 95 % of the points at least
  (measured 497 of 512; ``geot_tpu`` compiled and eager agree at 505):
  the flips are near-ties of the bfloat16 logits. The flagship's
  confidence gate is 0, so its mask cannot flip. Two independent
  bfloat16 roundings lie further apart than either from float32, so the
  port's bfloat16 logits are not nearer ``geot_tpu``'s than its float32
  ones (3.1e-2 against 2.5e-2). Instead the port's bfloat16 rounding of
  the logits (its bfloat16 against its float32 logits) must be between
  half and twice ``geot_tpu``'s (``geot_tpu``'s bfloat16 against the
  port's float32 logits; measured 1.20 times).
- Gradients: not a few bfloat16 ulps. Batch-statistics BatchNorm
  subtracts the batch mean of each backward, and on bfloat16 activations
  much of what is left is rounding: either package's bfloat16 gradients
  are a median 28 % and up to 49 % of each tensor's norm from its own
  float32 ones. So each tensor of the port's bfloat16 gradient must be no
  further from ``geot_tpu``'s than twice ``geot_tpu``'s bfloat16 gradient
  is from the float32 one (the port's float32 step stands for that one:
  the two packages' float32 gradients agree to 1.5e-2 of each tensor's
  norm), or than 5e-2 of its norm, and all tensors together nearer than
  the port's float32 gradient is (measured: at most 1.35 times for a
  tensor, 0.91 times for all together); and the port's own rounding, all
  tensors together, between half and twice ``geot_tpu``'s (measured
  0.97 times). The step runs without ``grad_norm_clip``, and the
  biases of the layers that feed a batch-statistics BatchNorm are left
  out: their gradient is 0 in exact arithmetic (float32: at most 5.7e-6
  in norm in both packages), and in bfloat16 ``geot_tpu``'s is noise up
  to 2.77 in norm, larger than any other gradient of the model (the
  port's 0.026), which would set the global norm a clip divides every
  tensor by.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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

from test_torch_model import jax_small_model
from test_torch_train import (CFG, TRAIN_ARGS, C, _adam_mu,
                              _jax_semi_state, _jbatch, _np_tree, _rel,
                              _tbatch)
from torch_helpers import dense_dtypes, one_torch_thread  # noqa: F401

BF16_ARGS = dict(TRAIN_ARGS, dtype="bfloat16")
STEP_CFG = dict(CFG, grad_norm_clip=None)
LOSS_RTOL = 2e-2
LOGIT_RTOL = 5e-2
PSEUDO_AGREE = 0.95
GRAD_RTOL = 5e-2
GRAD_OF_ROUNDING = 2.0
# the port's own bfloat16 rounding (bfloat16 against its float32) within
# this factor of geot_tpu's, either way
OWN_ROUNDING = 2.0
TERMS = ("loss", "sup_loss", "unsup_loss", "threed_loss")
# Dense layers whose output goes straight into a batch-statistics BatchNorm
PRE_BN_BIASES = ("segmentor.encoder.first_conv.0.bias",
                 "segmentor.encoder.first_conv.3.bias",
                 "segmentor.encoder.second_conv.0.bias",
                 "segmentor.seg_head.0.bias")


def _moments(state):
    """AdamW's first moment (0.1 x the gradient) of every parameter."""
    named = dict(state.model.named_parameters())
    named.update(state.t_predictor.named_parameters())
    return {k: (state.t_opt if k.startswith("T_predictor.") else state.opt)
            .state[p]["exp_avg"].double().numpy() for k, p in named.items()}


@pytest.fixture(scope="module")
def bf16_step():
    """One semi step, teacher on, from the same float32 state and batch:
    ``geot_tpu``'s in bfloat16, the port's in bfloat16 and in float32.
    Returns the metrics, first moments and teacher logits of each, and
    for the port's the state and the dtypes its Dense layers returned."""
    loader_l, loader_u = tdata_build.build_semi_loaders(CFG)
    loader_l.set_epoch(1)
    loader_u.set_epoch(1)
    bl, bu = next(tdata_build.semi_pairs(loader_l, loader_u))
    bl = {k: bl[k] for k in tdata_build.MODEL_KEYS}
    bu = {k: bu[k] for k in tdata_build.SEMI_KEYS}
    lr = build_scheduler_from_cfg(CFG)(1)

    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": BF16_ARGS})
    _, variables = jax_small_model(0)
    jt = jbuild(CFG["t_predictor"])
    t_vars = _np_tree(jt.init(jax.random.PRNGKey(2),
                              jnp.ones((1, 8, C)) / C, jnp.eye(C)))
    jstate, before, _ = _jax_semi_state(
        (jmodel, _np_tree(variables), jt, t_vars))
    teacher = {"params": before["teacher_params"],
               "batch_stats": before["teacher_batch_stats"]}
    j_logit = np.asarray(jax.jit(lambda v, b: jmodel.apply(
        v, b, if_teacher=True)[0])(teacher, _jbatch(bu, bu)))
    jnew, jm = _jax_step(jmodel, jt)(jstate, _jbatch(bl, bl),
                                     _jbatch(bu, bu),
                                     jnp.asarray(lr, jnp.float32), True)
    jnew = _np_tree(jnew)
    want = params_from_jax({"params": _adam_mu(jnew.opt_state),
                            "batch_stats": {}})
    want.update(t_params_from_jax(_adam_mu(jnew.t_opt_state)))
    out = {"geot_tpu": (_np_tree(jm), {k: v.double().numpy()
                                       for k, v in want.items()}, j_logit)}

    for dt in ("bfloat16", "float32"):
        state = SemiTrainState.create(STEP_CFG, seg_args=dict(BF16_ARGS,
                                                              dtype=dt),
                                      device="cpu")
        state.load(semi_state_from_jax(before))
        with torch.no_grad(), dense_dtypes(state.teacher) as seen:
            t_logit = state.teacher(_tbatch(bu, bu), if_teacher=True)[0]
        with dense_dtypes(state.model, state.teacher) as step_seen:
            metrics = make_semi_step(STEP_CFG)(state, _tbatch(bl, bl),
                                               _tbatch(bu, bu), lr, True)
        out[dt] = (metrics, _moments(state), t_logit.numpy(), state,
                   seen | step_seen)
    return out


def _jax_step(jmodel, jt):
    """``geot_tpu``'s step of ``STEP_CFG`` (no gradient clip), its
    optimizers those of ``_jax_semi_state``'s state."""
    tx = joptimizer(None, lr=CFG["lr"], **CFG["optimizer"])
    return jmake_semi_step(jmodel, jmodel, jt, tx, tx, dict(STEP_CFG))


def test_bf16_semi_step_computes_in_bfloat16(bf16_step):
    """The control: the bfloat16 step's Dense layers return bfloat16, the
    float32 step's only float32."""
    assert torch.bfloat16 in bf16_step["bfloat16"][4]
    assert bf16_step["float32"][4] == {torch.float32}


def test_bf16_semi_step_losses_match_geot_tpu(bf16_step):
    jm, _, j_logit = bf16_step["geot_tpu"]
    tm, _, t_logit, _, _ = bf16_step["bfloat16"]
    fm, _, f_logit, _, _ = bf16_step["float32"]
    for k in TERMS:
        got, want, f32 = float(tm[k]), float(jm[k]), float(fm[k])
        print(f"{k}: port {got:.8f} geot_tpu {want:.8f} rel "
              f"{_rel(got, want):.2e}; port float32 {f32:.8f}, "
              f"{abs(got - want) / abs(f32 - want):.3f} of its distance")
        assert np.isfinite(got), k
        assert _rel(got, want) <= LOSS_RTOL, k
        assert abs(got - want) < abs(f32 - want), k
    # the teacher: bfloat16 logits, whose argmax flips at near-ties
    assert t_logit.dtype == np.float32
    rel = _rel(t_logit, j_logit)
    agree = float((t_logit.argmax(-1) == j_logit.argmax(-1)).mean())
    own, theirs = _rel(t_logit, f_logit), _rel(j_logit, f_logit)
    print(f"teacher logits {rel:.2e} of their largest apart; pseudo "
          f"labels agree at {agree:.4f} of the points; bfloat16 rounding "
          f"of the logits: port {own:.2e}, geot_tpu {theirs:.2e}")
    assert rel <= LOGIT_RTOL
    assert theirs / OWN_ROUNDING <= own <= OWN_ROUNDING * theirs
    assert agree >= PSEUDO_AGREE
    assert abs(float(tm["teacher_acc"]) - float(jm["teacher_acc"])) \
        <= 1.0 - PSEUDO_AGREE
    np.testing.assert_allclose(float(tm["over_th"]), float(jm["over_th"]))


def test_bf16_semi_step_gradients_match_geot_tpu(bf16_step):
    _, want, _ = bf16_step["geot_tpu"]
    _, got, _, _, _ = bf16_step["bfloat16"]
    _, f32, _, _, _ = bf16_step["float32"]
    assert set(want) == set(got) == set(f32)
    worst, num, den, own = ("", 0.0), 0.0, 0.0, 0.0
    for k in sorted(want):
        if k in PRE_BN_BIASES:
            continue
        r = np.linalg.norm(want[k])
        d = np.linalg.norm(got[k] - want[k])
        rounding = np.linalg.norm(want[k] - f32[k])
        if r == 0.0:
            # a parameter the step does not reach: no gradient in either
            assert d == 0.0, k
            continue
        bound = max(GRAD_RTOL * r, GRAD_OF_ROUNDING * rounding)
        worst = max(worst, (k, d / rounding), key=lambda t: t[1])
        num, den = num + d * d, den + rounding * rounding
        own += np.linalg.norm(got[k] - f32[k]) ** 2
        assert d <= bound, (k, d / r, rounding / r)
    print(f"port vs geot_tpu, in units of geot_tpu's bfloat16 rounding: "
          f"worst {worst[0]} {worst[1]:.3f}, all tensors "
          f"{(num / den) ** 0.5:.3f}; the port's own rounding "
          f"{(own / den) ** 0.5:.3f}")
    # nearer geot_tpu's bfloat16 gradient than the port's float32 one is
    assert num < den
    assert den / OWN_ROUNDING ** 2 <= own <= OWN_ROUNDING ** 2 * den


def test_bf16_semi_step_keeps_float32_state(bf16_step):
    """Parameters, optimizer state, BatchNorm statistics and the NTM state
    stay float32 through a bfloat16 step."""
    state = bf16_step["bfloat16"][3]
    for m in (state.model, state.teacher, state.t_predictor):
        for k, v in m.state_dict().items():
            if v.is_floating_point():
                assert v.dtype == torch.float32, k
    for opt in (state.opt, state.t_opt):
        for st in opt.state.values():
            for k, v in st.items():
                if torch.is_tensor(v) and v.is_floating_point():
                    assert v.dtype == torch.float32, k
    assert state.ema_t.dtype == torch.float32
    assert state.contrast.queue.dtype == torch.float32
