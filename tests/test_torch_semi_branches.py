"""Every branch of the port's semi step against ``geot_tpu``'s: one
``make_semi_step`` call per auxiliary loss, with ``pseudo_refine``,
``threed_anchors``, ``reference_bugs``, all flags together and the
class-weighted supervised criterion, from the same converted state in both
packages (one step per ``criterion_u`` name: ``tests/test_torch_losses_u.py``).

The config is ``tests/test_semi_branches.py``'s small one (D = 48, depth 3,
128 points: every JAX neighbour search is an exact ``lax.top_k``) with
stochastic depth and dropout off, since the two frameworks draw different
masks. The contrast keys and permutation and the 3D-loss anchors are
``geot_tpu``'s own draws, split from its state's ``rng`` here and fed
through the port's ``draws`` seam.

Tolerances: loss terms within 1e-5 relative in float32; in float64 the
loss terms within 1e-6 and AdamW's first moment (0.1 x the clipped
gradient) within 1e-5 of each tensor's largest entry, the bound of
``tests/test_torch_train.py``; ``ema_t`` and the bank within 1e-6
(float32) absolute.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from geot_tpu.engine.state import SemiTrainState as JSemiTrainState
from geot_tpu.engine.steps import make_semi_step as jmake_semi_step
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer

from geot_tpu_torch.engine.convert import (params_from_jax,
                                           semi_state_from_jax,
                                           t_params_from_jax)
from geot_tpu_torch.engine.state import SemiTrainState
from geot_tpu_torch.engine.steps import make_semi_step

from test_semi_branches import SEG as JSEG
from torch_helpers import one_torch_thread  # noqa: F401



SEG = dict(JSEG, drop_path_rate=0.0, head_dropout=0.0)
N = 128
C = 17
CFG = {
    "criterion_args": {"NAME": "Poly1FocalLoss"},
    "criterion_u_args": {"NAME": "Poly1FocalLoss_U_corr"},
    "num_classes": C, "grad_norm_clip": 1.0, "threshold": 0.0,
    "unsupervised_loss_weight": 1.0, "lambma": 0.9, "geo_lambma": 0.999,
    "ema_t_decay": 0.999, "use_3d_loss": True, "threed_k": 4,
    "threed_sigma": 1.0, "threed_loss_weight": 0.1, "batch_size_l": 2,
    "batch_size_u": 2, "seed": 0, "lr": 1e-3,
    "optimizer": {"NAME": "adamw", "weight_decay": 1e-4},
    "t_predictor": {"NAME": "Ins_T_mean",
                    "T_args": {"NAME": "sig_t_mean", "nclasses": C}}}
FEAT = {"use_feat_loss": True, "feat_k": 4, "feat_sigma": 1.0,
        "feat_loss_weight": 10.0}
# a random-init teacher's confidence is 0.07-0.12: this gate passes about
# half of the points, so the loss and the bank update are live
CONTRAST = {"use_contrastive": True, "contrastive_loss_weight": 1.0,
            "contrast_threshold": 0.1}
ALL_FLAGS = {**FEAT, **CONTRAST, "use_identity_loss": True,
             "identity_loss_weight": 1.0, "pseudo_refine": True,
             "filter_outlier": True, "threshold": 0.1}
AUX = ("feat_loss", "identity_loss", "threed_loss", "contrast_loss")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def batches(seed=0, cur=False):
    """A labelled and an unlabelled batch of 2 clouds of N points, numpy;
    the strong view a scaled copy of the weak one."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((2, N, 3)).astype(np.float32)
    y = rng.integers(0, C, (2, N)).astype(np.int32)
    cw = rng.uniform(0.5, 1.5, (2, C)).astype(np.float32)
    bl = {"pos": pos, "x": pos, "cls": np.zeros((2, 1), np.int32), "y": y,
          "class_weights": cw}
    pw = rng.standard_normal((2, N, 3)).astype(np.float32)
    ps = pw * np.float32(1.1)
    bu = {"pos_w": pw, "x_w": pw, "cls_w": np.zeros((2, 1), np.int32),
          "pos_s": ps, "x_s": ps, "cls_s": np.zeros((2, 1), np.int32),
          "raw_pos": pw, "y": rng.integers(0, C, (2, N)).astype(np.int32)}
    if cur:
        bu["cur"] = rng.uniform(-1, 1, (2, N)).astype(np.float32)
    return bl, bu


def _cast(tree, x64):
    dt = np.float64 if x64 else np.float32
    return {k: (v.astype(dt) if v.dtype == np.float32 else v)
            for k, v in tree.items()}


def jax_init(seed=0):
    """The JAX model and T-predictor with float32 initial weights (numpy)."""
    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": SEG})
    key = jax.random.PRNGKey(seed)
    bl, _ = batches()
    variables = _np(jax.jit(jmodel.init)(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        {k: jnp.asarray(bl[k]) for k in ("pos", "x", "cls")}))
    jt = jbuild(CFG["t_predictor"])
    t_vars = _np(jt.init(jax.random.fold_in(key, 2),
                         jnp.full((1, 8, C), 1 / C), jnp.eye(C)))
    return jmodel, variables, jt, t_vars


def jax_draws(jstate, cfg):
    """The contrast keys and permutation and the 3D-loss anchors that
    ``geot_tpu``'s step draws from ``jstate`` (``steps.py:201``,
    ``contrast.py:67,93``, ``inst_loss.py:133``)."""
    b_u = cfg["batch_size_u"]
    _, drop_rng, contrast_rng = jax.random.split(
        jax.random.fold_in(jstate.rng, jstate.step), 3)
    sel_rng, q_rng = jax.random.split(contrast_rng)
    draws = {"contrast": (
        torch.from_numpy(np.array(jax.random.uniform(sel_rng, (b_u, N)))),
        torch.from_numpy(np.array(
            jax.random.permutation(q_rng, b_u * min(1024, N)))))}
    if cfg.get("threed_anchors"):
        draws["anchors"] = torch.from_numpy(np.array(jax.random.randint(
            jax.random.fold_in(drop_rng, 0x3D),
            (b_u, int(cfg["threed_anchors"])), 0, N)))
    return draws


def port_state(cfg, before, x64=False):
    """The port's state loaded from ``geot_tpu``'s (numpy tree), float64
    when ``x64``."""
    state = SemiTrainState.create(cfg, seg_args=SEG, device="cpu")
    if x64:
        for m in (state.model, state.teacher, state.t_predictor):
            m.double()
        state.ema_t, state.cm = state.ema_t.double(), state.cm.double()
        state.contrast.queue = state.contrast.queue.double()
        if state.ema_params:
            state.seed_ema()
    return state.load(semi_state_from_jax(before))


def run_both(cfg, init, x64=False, cur=False, steps=1):
    """``steps`` semi steps, teacher on, from the same state in both
    packages: (JAX state after, its metrics, port state, its metrics), the
    metrics of the last step."""
    jmodel, variables, jt, t_vars = init
    cfg = dict(CFG, **cfg)
    bl, bu = (_cast(b, x64) for b in batches(cur=cur))
    rng = np.random.default_rng(11)
    cm = rng.uniform(0, 1, (C, C)).astype(np.float32)
    cm /= cm.sum(1, keepdims=True)
    ema_t = np.eye(C, dtype=np.float32) * 0.7 + 0.3 / C
    dt = np.float64 if x64 else np.float32

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a.astype(dt) if a.dtype == np.float32
                                  else a), tree)

    tx = joptimizer(None, lr=cfg["lr"], **cfg["optimizer"])
    t_tx = joptimizer(None, lr=cfg["lr"], **cfg["optimizer"])
    jstate = JSemiTrainState.create(
        cast(variables), tx, cast(t_vars), t_tx, C, jax.random.PRNGKey(3),
        contrast_dim=SEG["trans_dim"], ema=bool(cfg.get("ema_eval")))
    jstate = jstate.replace(cm=jnp.asarray(cm.astype(dt)),
                            ema_t=jnp.asarray(ema_t.astype(dt)))
    before = {f: _np(getattr(jstate, f)) for f in (
        "params", "batch_stats", "t_params", "teacher_params",
        "teacher_batch_stats", "ema_t", "cm", "contrast", "ema_params")}
    state = port_state(cfg, before, x64)
    state.bank_before = state.contrast.queue.clone()
    jstep = jmake_semi_step(jmodel, jmodel, jt, tx, t_tx, cfg)
    step = make_semi_step(cfg)
    jl = {k: jnp.asarray(v) for k, v in bl.items()}
    ju = {k: jnp.asarray(v) for k, v in bu.items()}
    tl = {k: torch.from_numpy(v) for k, v in bl.items()}
    tu = {k: torch.from_numpy(v) for k, v in bu.items()}
    for _ in range(steps):
        draws = jax_draws(jstate, cfg)
        jstate, jm = jstep(jstate, jl, ju, jnp.asarray(cfg["lr"], dt), True)
        tm = step(state, tl, tu, cfg["lr"], True, draws=draws)
    return _np(jstate), _np(jm), state, tm


def _adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return _np(found[0].mu)


def check_f32(jnew, jm, state, tm, aux=()):
    """Loss terms 1e-5 relative; ema_t, the bank and the shadow 1e-6."""
    for k in ("loss", "sup_loss", "unsup_loss", *aux):
        assert np.isfinite(float(tm[k])), k
        assert _rel(tm[k], jm[k]) <= 1e-5, (k, float(tm[k]), float(jm[k]))
    assert set(AUX) & set(tm) == set(AUX) & set(jm)
    np.testing.assert_allclose(state.ema_t.numpy(), jnew.ema_t, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(state.contrast.queue.numpy(),
                               jnew.contrast.queue, rtol=0, atol=1e-6)
    assert int(state.contrast.ptr) == int(jnew.contrast.ptr)
    for k in ("over_th", "pseudo_acc", "teacher_acc", "student_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)


def check_f64(jnew, jm, state, tm, aux=()):
    """Loss terms 1e-6 relative; each tensor's first AdamW moment within
    1e-5 of its largest entry (floored at 1e-6 of the largest gradient)."""
    for k in ("loss", "sup_loss", "unsup_loss", *aux):
        assert _rel(tm[k], jm[k]) <= 1e-6, (k, float(tm[k]), float(jm[k]))
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
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6 * gmax)
        worst = max(worst, err)
        assert err <= 1e-5, (k, err)
    print(f"float64: worst per-tensor first-moment error {worst:.3e}")


@pytest.fixture(scope="module")
def init():
    return jax_init()


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


CASES = {
    "feat": (FEAT, ("feat_loss",)),
    "identity": ({"use_identity_loss": True, "identity_loss_weight": 1.0},
                 ("identity_loss",)),
    "contrast": (CONTRAST, ("contrast_loss",)),
    "pseudo_refine": ({"pseudo_refine": True, "threshold": 0.1}, ()),
    "threed_anchors": ({"threed_anchors": 64}, ("threed_loss",)),
    "reference_bugs": ({"reference_bugs": True, "filter_outlier": True},
                       ("threed_loss",)),
    "all_flags": (ALL_FLAGS, AUX),
    # the supervised dispatch: Weight_CELoss reads the batch's
    # class_weights (steps.py:39-46)
    "weight_ce_supervised": ({"criterion_args": {"NAME": "Weight_CELoss"}},
                             ("threed_loss",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_branch_float32(init, case):
    extra, aux = CASES[case]
    jnew, jm, state, tm = run_both(extra, init)
    check_f32(jnew, jm, state, tm, aux)
    if "use_contrastive" in extra:
        # the gate let part of the points through: the bank moved
        assert 0 < int(state.contrast.ptr) < 4096


@pytest.mark.parametrize("case", list(CASES))
def test_branch_float64(init, x64, case):
    extra, aux = CASES[case]
    check_f64(*run_both(extra, init, x64=True), aux)


def test_random_teacher_leaves_the_bank_frozen(init):
    """At the reference's 0.9 gate a random-init teacher passes no point:
    the contrast loss is exactly 0 and the bank does not move, in both
    packages (``tests/test_semi_branches.py:90-97``)."""
    extra = dict(CONTRAST, contrast_threshold=0.9)
    jnew, jm, state, tm = run_both(extra, init)
    check_f32(jnew, jm, state, tm, ("contrast_loss",))
    assert float(tm["contrast_loss"]) == 0.0 == float(jm["contrast_loss"])
    assert int(state.contrast.ptr) == 0
    np.testing.assert_array_equal(state.contrast.queue.numpy(),
                                  state.bank_before.numpy())
