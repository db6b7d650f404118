"""AdaHessian's Hessian-diagonal pass (``geot_tpu_torch/optim/adahessian.py``
and the steps of ``engine/steps.py``) against ``geot_tpu``.

- ``hutchinson_diag`` (the port's reverse over reverse) against
  ``geot_tpu``'s ``jax.jvp`` through the gradient function, with the same
  ``z``, in float64.
- The supervised and the semi step with ``optimizer.NAME: adahessian`` at
  the small width in float64 (JAX with x64 on), from the same weights and
  batch, with ``z`` reproduced from ``geot_tpu``'s keys (``fold_in(
  fold_in(rng, 0x5EC0), 0)`` split over the leaves in flax order): the
  loss terms within 1e-6 relative; AdaHessian's first moment (0.1 x the
  clipped gradient) and second moment (0.001 x the squared diagonal)
  tensor by tensor within 1e-5 of the tensor's largest entry, floored at
  1e-6 of the largest (the bound ``tests/test_torch_train.py`` holds the
  gradients to).
- Two gloo ranks on the CPU, each on its block of the global batch,
  against one process on the global batch, in float64 with the same
  ``z``: the second moments within ``DP_HESS_TOL``. A control whose
  collectives do not record the all-reduce inside their backward (the
  first backward then is not differentiable across ranks) keeps the
  first moments within the bound and must land past it on the second.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.engine.state import TrainState as JTrainState
from geot_tpu.engine.state import SemiTrainState as JSemiTrainState
from geot_tpu.engine.steps import make_semi_step as jmake_semi_step
from geot_tpu.engine.steps import make_supervised_step as jmake_sup_step
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer
from geot_tpu.optim.adahessian import hutchinson_diag as jhutchinson

from geot_tpu_torch.data import build as tdata_build
from geot_tpu_torch.engine.convert import (params_from_jax,
                                           semi_state_from_jax,
                                           t_params_from_jax)
from geot_tpu_torch.engine.state import SemiTrainState
from geot_tpu_torch.engine.steps import make_semi_step, make_supervised_step
from geot_tpu_torch.optim import build_scheduler_from_cfg, hutchinson_diag

from test_torch_dist import WORLD, _torch_batch, run_workers
from test_torch_train import (C, CFG, TRAIN_ARGS, _jax_init, _jbatch,
                              _np_tree, _rel, _tbatch, batches)  # noqa: F401
from torch_helpers import one_torch_thread  # noqa: F401

HCFG = dict(CFG, optimizer={"NAME": "adahessian", "weight_decay": 0.05})
TOL = 1e-5
FLOOR = 1e-6
DP_HESS_TOL = 1e-6



def _x64(x):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64))
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), x)


def _zs(rng, tree):
    """``geot_tpu``'s Rademacher draws for ``tree`` from the step key
    ``rng`` (``optim/adahessian.py:43-47``, one sample), in one ``jax.jit``
    (integer draws: the same bits as eager, which compiles each leaf's
    shape on its own)."""
    def draw(rng, tree):
        key = jax.random.fold_in(jax.random.fold_in(rng, 0x5EC0), 0)
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        keys = jax.random.split(key, len(leaves))
        return treedef.unflatten([
            (jax.random.randint(k, l.shape, 0, 2) * 2 - 1).astype(l.dtype)
            for k, l in zip(keys, leaves)])

    return _np_tree(jax.jit(draw)(rng, tree))


def _hadam(opt_state):
    """The AdahessianState inside an optax state, as numpy trees."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "exp_hessian_diag_sq"))
        if hasattr(s, "exp_hessian_diag_sq")]
    assert len(found) == 1
    return _np_tree(found[0].exp_avg), _np_tree(found[0].exp_hessian_diag_sq)


def _worst(got: dict, want: dict) -> float:
    """The largest per-tensor error of ``got`` against ``want``, relative
    to each tensor's largest entry floored at ``FLOOR`` of the largest."""
    assert set(got) == set(want)
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    return max(np.abs(np.asarray(got[k], np.float64)
                      - np.asarray(v, np.float64)).max()
               / max(np.abs(np.asarray(v, np.float64)).max(), FLOOR * gmax)
               for k, v in want.items())


def _compare(got: dict, want: dict, what: str, tol=TOL):
    worst = _worst(got, want)
    print(f"{what}: worst per-tensor error {worst:.3e}")
    assert worst <= tol, (what, worst)


def _opt_entries(state, key, t_predictor=True):
    out = {n: state.opt.state[p][key] for n, p in
           state.model.named_parameters()}
    if t_predictor:
        out.update({n: state.t_opt.state[p][key] for n, p in
                    state.t_predictor.named_parameters()})
    return {k: v.detach().numpy() for k, v in out.items()}


def test_hutchinson_diag_matches_geot_tpu():
    """A two-layer tanh network's loss: z * (H z) with the same z."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 4))
    params = {"w1": rng.standard_normal((4, 5)), "b1": rng.standard_normal(5),
              "w2": rng.standard_normal((5, 3))}
    zs = {k: rng.integers(0, 2, v.shape) * 2.0 - 1.0
          for k, v in params.items()}

    def jloss(p):
        h = jnp.tanh(jnp.asarray(x) @ p["w1"] + p["b1"])
        return jnp.sum(jnp.tanh(h @ p["w2"]) ** 2)

    jax.config.update("jax_enable_x64", True)
    try:
        want = _np_tree(jhutchinson(jax.grad(jloss), _x64(params),
                                    jax.random.PRNGKey(0),
                                    zs=[_x64(zs)]))
    finally:
        jax.config.update("jax_enable_x64", False)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    h = torch.tanh(torch.from_numpy(x) @ tp["w1"] + tp["b1"])
    loss = (torch.tanh(h @ tp["w2"]) ** 2).sum()
    names = list(tp)
    grads = torch.autograd.grad(loss, [tp[n] for n in names],
                                create_graph=True)
    got = hutchinson_diag(grads, [tp[n] for n in names],
                          [torch.from_numpy(zs[n]) for n in names])
    for n, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[n], rtol=1e-12,
                                   atol=1e-12, err_msg=n)


@pytest.fixture(scope="module")
def sup_run(batches):  # noqa: F811
    """One supervised AdaHessian step in float64 in both packages."""
    jmodel, variables, _, _ = _jax_init()
    bl = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
          for k, v in batches[0][0].items()
          if k in tdata_build.MODEL_KEYS}
    lr = 1e-3
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = _x64(variables)
        tx = joptimizer(None, lr=lr, **HCFG["optimizer"])
        jstate = JTrainState.create(v64, tx)
        rng = jax.random.fold_in(jax.random.PRNGKey(HCFG.get("seed", 0)),
                                 0)
        zs = _zs(rng, jstate.params)
        jnew, jm = jmake_sup_step(jmodel, tx, HCFG)(
            jstate, _jbatch(bl, bl), jnp.asarray(lr))
        jnew, jm = _np_tree(jnew), _np_tree(jm)
    finally:
        jax.config.update("jax_enable_x64", False)
    state = SemiTrainState.create(HCFG, seg_args=TRAIN_ARGS, device="cpu")
    state.model.double()
    state.model.load_state_dict(params_from_jax(variables), strict=True)
    tm = make_supervised_step(HCFG)(
        state, _tbatch(bl, bl), lr,
        draws={"hessian": params_from_jax({"params": zs,
                                           "batch_stats": {}})})
    return jnew, jm, state, tm


def test_supervised_step_losses_match_geot_tpu(sup_run):
    _, jm, _, tm = sup_run
    assert _rel(tm["loss"], jm["loss"]) <= 1e-6


def test_supervised_step_moments_match_geot_tpu(sup_run):
    jnew, _, state, _ = sup_run
    mu, nu = _hadam(jnew.opt_state)
    conv = lambda t: {k: v.numpy() for k, v in params_from_jax(  # noqa
        {"params": t, "batch_stats": {}}).items()}
    _compare(_opt_entries(state, "exp_avg", False), conv(mu),
             "supervised first moment")
    _compare(_opt_entries(state, "exp_hessian_diag_sq", False), conv(nu),
             "supervised squared diagonal")


@pytest.fixture(scope="module")
def semi_run(batches):  # noqa: F811
    """One semi AdaHessian step (teacher on) in float64 in both packages,
    with a non-trivial ``cm`` and ``ema_t``."""
    jmodel, variables, jt, t_vars = _jax_init()
    bl, bu = batches[0]
    r = np.random.default_rng(11)
    cm = r.uniform(0, 1, (C, C))
    cm /= cm.sum(1, keepdims=True)
    ema = np.eye(C) * 0.7 + 0.3 / C

    def arrays(b, keys):
        return {k: (b[k].astype(np.float64) if b[k].dtype == np.float32
                    else b[k]) for k in keys}

    bl_l = arrays(bl, tdata_build.MODEL_KEYS)
    bu_u = arrays(bu, tdata_build.SEMI_KEYS)
    lr = build_scheduler_from_cfg(HCFG)(1)
    jax.config.update("jax_enable_x64", True)
    try:
        tx = joptimizer(None, lr=lr, **HCFG["optimizer"])
        t_tx = joptimizer(None, lr=lr, **HCFG["optimizer"])
        jstate = JSemiTrainState.create(
            _x64(variables), tx, _x64(t_vars), t_tx, C,
            jax.random.PRNGKey(3), teacher_variables=_x64(variables),
            contrast_dim=TRAIN_ARGS["trans_dim"])
        jstate = jstate.replace(cm=jnp.asarray(cm), ema_t=jnp.asarray(ema))
        before = {f: _np_tree(getattr(jstate, f)) for f in (
            "params", "batch_stats", "t_params", "teacher_params",
            "teacher_batch_stats", "ema_t", "cm")}
        rng = jax.random.split(jax.random.fold_in(jstate.rng, jstate.step),
                               3)[0]
        zp, zt = _zs(rng, (jstate.params, jstate.t_params))
        step = jmake_semi_step(jmodel, jmodel, jt, tx, t_tx, dict(HCFG))
        jnew, jm = step(jstate, _jbatch(bl_l, bl_l), _jbatch(bu_u, bu_u),
                        jnp.asarray(lr), True)
        jnew, jm = _np_tree(jnew), _np_tree(jm)
    finally:
        jax.config.update("jax_enable_x64", False)
    zs = params_from_jax({"params": zp, "batch_stats": {}})
    zs.update(t_params_from_jax(zt))
    state = SemiTrainState.create(HCFG, seg_args=TRAIN_ARGS, device="cpu")
    for m in (state.model, state.teacher, state.t_predictor):
        m.double()
    state.ema_t, state.cm = state.ema_t.double(), state.cm.double()
    state.load(semi_state_from_jax(before))
    tm = make_semi_step(HCFG)(state, _tbatch(bl_l, bl_l),
                              _tbatch(bu_u, bu_u), lr, True,
                              draws={"hessian": zs})
    return {"jax": (jnew, jm), "port": (state, tm), "before": before,
            "zs": zs, "lr": lr, "batch": (bl_l, bu_u)}


def test_semi_step_losses_match_geot_tpu(semi_run):
    _, jm = semi_run["jax"]
    _, tm = semi_run["port"]
    for k in ("loss", "sup_loss", "unsup_loss", "threed_loss"):
        assert _rel(tm[k], jm[k]) <= 1e-6, k


def test_semi_step_moments_match_geot_tpu(semi_run):
    """One joint Hutchinson pass over the student and the T-predictor: both
    optimizers' moments."""
    jnew, _ = semi_run["jax"]
    state, _ = semi_run["port"]
    mu, nu = _hadam(jnew.opt_state)
    tmu, tnu = _hadam(jnew.t_opt_state)

    def conv(t, tt):
        out = {k: v.numpy() for k, v in params_from_jax(
            {"params": t, "batch_stats": {}}).items()}
        out.update({k: v.numpy() for k, v in t_params_from_jax(tt).items()})
        return out

    _compare(_opt_entries(state, "exp_avg"), conv(mu, tmu),
             "semi first moment")
    _compare(_opt_entries(state, "exp_hessian_diag_sq"), conv(nu, tnu),
             "semi squared diagonal")


@pytest.fixture(scope="module")
def dp_runs(semi_run, tmp_path_factory):
    """The semi AdaHessian step on two gloo ranks (and on two ranks with
    the cut collectives), from ``semi_run``'s state, batch and ``z``."""
    tmp = tmp_path_factory.mktemp("hessian_dp")
    bl, bu = semi_run["batch"]
    out = {}
    for mode in ("step", "step_cut"):
        d = tmp / mode
        d.mkdir()
        torch.save({"cfg": dict(HCFG), "seg_args": TRAIN_ARGS,
                    "state": semi_state_from_jax(semi_run["before"]),
                    "lr": semi_run["lr"], "dtype": "float64",
                    "draws": {"hessian": semi_run["zs"]},
                    "batches": [(_torch_batch(bl), _torch_batch(bu))]},
                   d / "in.pt")
        run_workers(mode, d / "in.pt", d)
        out[mode] = [torch.load(d / f"rank{r}_step0.pt")
                     for r in range(WORLD)]
    return out


def _single(semi_run, key):
    return _opt_entries(semi_run["port"][0], key)


def test_two_ranks_match_one_process(dp_runs, semi_run):
    ranks = dp_runs["step"]
    for k, v in ranks[0]["hess"].items():
        assert torch.equal(v, ranks[1]["hess"][k]), k
    _compare({k: v.numpy() for k, v in ranks[0]["exp_avg"].items()},
             {k: v for k, v in _single(semi_run, "exp_avg").items()
              if k in ranks[0]["exp_avg"]}, "two ranks, first moment",
             DP_HESS_TOL)
    _compare({k: v.numpy() for k, v in ranks[0]["hess"].items()},
             _single(semi_run, "exp_hessian_diag_sq"),
             "two ranks, squared diagonal", DP_HESS_TOL)


def test_cut_collectives_fail_the_diagonal_bound(dp_runs, semi_run):
    """The control: the same first moments, a second moment past the
    bound."""
    cut = dp_runs["step_cut"][0]
    _compare({k: v.numpy() for k, v in cut["exp_avg"].items()},
             {k: v for k, v in _single(semi_run, "exp_avg").items()
              if k in cut["exp_avg"]}, "cut, first moment", DP_HESS_TOL)
    worst = _worst({k: v.numpy() for k, v in cut["hess"].items()},
                   _single(semi_run, "exp_hessian_diag_sq"))
    print(f"cut, squared diagonal: worst per-tensor error {worst:.3e}")
    assert worst > DP_HESS_TOL
