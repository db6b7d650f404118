"""The port's optimizer family against ``geot_tpu``'s optax chains: every
name that ``geot_tpu.optim.factory`` registers, with and without weight
decay, the ``lookahead`` prefix, ``layer_decay`` (ids and scales on the
flagship's whole parameter list), ``step_per_update`` against
``optax.MultiSteps`` across a ``state_dict`` round trip, and
``opt_state_from_jax`` on each optax state it converts, and AdamP and SGDP
on the converted weights of the flagship and of ``ViewGenBase``, whose
channel view is ``geot_tpu``'s kernel layout.

The parameters are a 2-D kernel (whose gradients are orthogonal to its
rows, so that AdamP's and SGDP's projection acts on it), a bias and a
160 x 144 matrix (which adafactor factors). Both packages take the same
gradients (and Hessian diagonals) for 5 updates (7 for radam, whose
rectification starts at the sixth), with the learning rate set before
each; the weights must agree within 1e-9 of each tensor's largest entry
in float64 (JAX with x64 on) and 1e-5 in float32.
"""
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer
from geot_tpu.optim.factory import _OPTIMIZERS as JOPTIMIZERS
from geot_tpu.optim.factory import _layer_id_from_path, layer_decay_scale
from geot_tpu.optim.factory import set_learning_rate as jset_lr

from geot_tpu_torch.core.config import build_model_from_cfg
from geot_tpu_torch.engine.convert import opt_state_from_jax, params_from_jax
from geot_tpu_torch.engine.state import _load_opt
from geot_tpu_torch.optim import build_optimizer_from_cfg, set_learning_rate
from geot_tpu_torch.optim.factory import _OPTIMIZERS, layer_id, layer_scales

from test_torch_model import N_POINTS, SMALL_ARGS
from test_torch_pretrain import GEN_CFG, _batch, _j, _jinit

SHAPES = {"kernel": (6, 5), "bias": (5,), "big": (160, 144)}
LRS = (1e-2, 1e-2, 5e-3, 5e-3, 2e-3, 2e-3, 1e-3)
TOL = {np.float64: 1e-9, np.float32: 1e-5}


def _problem(dtype, steps, seed=0):
    """Parameters, and per update the gradients and Hessian diagonals."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(dtype)
              for k, s in SHAPES.items()}
    grads, diags = [], []
    for _ in range(steps):
        g = {k: (0.1 * rng.standard_normal(s)).astype(dtype)
             for k, s in SHAPES.items()}
        w = params["kernel"]
        g["kernel"] = g["kernel"] - (np.sum(g["kernel"] * w, axis=1,
                                            keepdims=True)
                                     / np.sum(w * w, axis=1, keepdims=True)
                                     ) * w
        grads.append(g)
        diags.append({k: rng.standard_normal(s).astype(dtype)
                      for k, s in SHAPES.items()})
    return params, grads, diags


def _module(params):
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(
            torch.from_numpy(v.copy())))
    return module


def _by_name(opt, tree):
    names = [n for g in opt.param_groups for n in g["names"]]
    return [torch.from_numpy(np.asarray(tree[n]).copy()) for n in names]


def _jax_run(cfg, params, grads, diags, every_k=1, lrs=LRS):
    tx = joptimizer(None, lr=lrs[0], every_k=every_k, **dict(cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    hess = "adahessian" in cfg["NAME"]
    for g, h, lr in zip(grads, diags, lrs):
        state = jset_lr(state, lr)
        extra = ({"hessian_diag": {k: jnp.asarray(v) for k, v in h.items()}}
                 if hess else {})
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp, **extra)
        jp = optax.apply_updates(jp, upd)
    return {k: np.asarray(v) for k, v in jp.items()}, state


def _port_step(opt, module, g, h, lr):
    for k, p in module.named_parameters():
        p.grad = torch.from_numpy(g[k].copy())
    set_learning_rate(opt, lr)
    opt.step(hessian=_by_name(opt, h) if opt.needs_hessian else None)


def _assert_close(module, want, tol):
    for k, p in module.named_parameters():
        got = p.detach().numpy()
        err = np.abs(got - want[k]).max() / np.abs(want[k]).max()
        assert err <= tol, (k, err)


def _x64(dtype):
    """A context that turns JAX's x64 on for float64."""
    class Ctx:
        def __enter__(self):
            jax.config.update("jax_enable_x64", dtype == np.float64)

        def __exit__(self, *exc):
            jax.config.update("jax_enable_x64", False)
    return Ctx()


CASES = [pytest.param({"NAME": n, **wd}, id=n + ("-wd" if wd else ""))
         for n in sorted(JOPTIMIZERS) for wd in ({}, {"weight_decay": 0.05})]
CASES += [pytest.param({"NAME": n, "lookahead_k": 2, "weight_decay": 0.05},
                       id=n)
          for n in ("lookahead_adamw", "lookaheadsgd", "lookahead_adahessian")]


def test_every_registered_name_is_ported():
    assert set(_OPTIMIZERS) == set(JOPTIMIZERS)
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer_from_cfg(_module({"w": np.zeros((2, 2))}), 1e-3,
                                 NAME="lookahead")


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("cfg", CASES)
def test_optimizer_matches_geot_tpu(cfg, dtype):
    steps = 7 if cfg["NAME"] == "radam" else 5
    params, grads, diags = _problem(dtype, steps)
    with _x64(dtype):
        want, _ = _jax_run(cfg, params, grads, diags)
    module = _module(params)
    opt = build_optimizer_from_cfg(module, LRS[0], **dict(cfg))
    for g, h, lr in zip(grads, diags, LRS):
        _port_step(opt, module, g, h, lr)
    _assert_close(module, want, TOL[dtype])


@pytest.mark.parametrize("name", ["adamw", "lookahead_sgd"])
def test_layer_decay_matches_geot_tpu(name):
    """``layer_decay=0.75`` after the optimizer (and lookahead) on the small
    problem, whose names carry no layer id: every scale is 1, as in
    ``geot_tpu``; the flagship's ids are the next test's."""
    cfg = {"NAME": name, "layer_decay": 0.75, "lookahead_k": 2}
    params, grads, diags = _problem(np.float32, 5)
    want, _ = _jax_run(cfg, params, grads, diags)
    module = _module(params)
    opt = build_optimizer_from_cfg(module, LRS[0], **cfg)
    for g, h, lr in zip(grads, diags, LRS):
        _port_step(opt, module, g, h, lr)
    _assert_close(module, want, TOL[np.float32])


@pytest.fixture(scope="module")
def flagship_names():
    """The flagship's parameters at depth 12 (a narrow width: the names do
    not depend on it): geot_tpu's layer id of each flax leaf, carried
    through ``params_from_jax`` to the port's name."""
    args = dict(SMALL_ARGS, depth=12, extract_layers=[4, 8, 12])
    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": args})
    pos = np.zeros((1, N_POINTS, 3), np.float32)
    params = _jinit(jmodel, {"pos": pos, "x": pos,
                             "cls": np.zeros((1, 1), np.int32)})["params"]
    ids = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, -1.0 if _layer_id_from_path(
            path) is None else float(_layer_id_from_path(path)),
            np.float32), params)
    scales = layer_decay_scale(0.75).update(
        jax.tree_util.tree_map(jnp.ones_like, params), optax.EmptyState())[0]
    port = build_model_from_cfg({"NAME": "WholePartSeg",
                                 "segmentor_args": args})
    return ({k: float(v.reshape(-1)[0]) for k, v in params_from_jax(
        {"params": ids, "batch_stats": {}}).items()},
        {k: float(v.reshape(-1)[0]) for k, v in params_from_jax(
            {"params": jax.tree_util.tree_map(np.asarray, scales),
             "batch_stats": {}}).items()},
        [n for n, _ in port.named_parameters()])


def test_layer_ids_on_the_flagship_match_geot_tpu(flagship_names):
    want_ids, want_scales, names = flagship_names
    assert set(names) == set(want_ids)
    got = {n: layer_id(n) for n in names}
    assert {n: -1.0 if i is None else float(i) for n, i in got.items()} \
        == want_ids
    assert max(i for i in got.values() if i is not None) == 12
    assert got["segmentor.encoder.first_conv.0.weight"] == 0
    assert got["segmentor.blocks.blocks.0.attn.qkv.weight"] == 1
    assert got["segmentor.seg_head.0.weight"] is None
    scales = layer_scales(names, 0.75)
    for n, s in zip(names, scales):
        np.testing.assert_allclose(1.0 if s is None else s, want_scales[n],
                                   rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("cfg", [
    {"NAME": "adamw"}, {"NAME": "sgd", "weight_decay": 0.05},
    {"NAME": "lookahead_adamw", "lookahead_k": 2}])
def test_step_per_update_matches_multisteps_across_a_round_trip(cfg):
    """``every_k=2`` for 5 gradients: updates after the 2nd and 4th, the
    5th waits in the accumulator; the optimizer is saved after the 3rd
    (mid-group) and a fresh one over a copy of the weights loads it."""
    params, grads, diags = _problem(np.float64, 5)
    with _x64(np.float64):
        want, jstate = _jax_run(cfg, params, grads, diags, every_k=2)
    module = _module(params)
    opt = build_optimizer_from_cfg(module, LRS[0], every_k=2, **cfg)
    before = {k: p.detach().clone() for k, p in module.named_parameters()}
    for i, (g, h, lr) in enumerate(zip(grads, diags, LRS)):
        if i == 3:
            sd = opt.state_dict()
            weights = {k: p.detach().numpy().copy()
                       for k, p in module.named_parameters()}
            module = _module(weights)
            opt = build_optimizer_from_cfg(module, LRS[0], every_k=2, **cfg)
            opt.load_state_dict(sd)
        _port_step(opt, module, g, h, lr)
        if i == 0:
            for k, p in module.named_parameters():
                assert torch.equal(p, before[k]), k
    _assert_close(module, want, TOL[np.float64])
    st = opt.state[module.bias]
    assert st["mini_step"] == 1 and int(st["step"]) == 2
    assert int(jstate.mini_step) == 1


@pytest.mark.parametrize("cfg,every_k", [
    ({"NAME": "adamw"}, 1), ({"NAME": "sgd", "weight_decay": 0.05}, 1),
    ({"NAME": "lookahead_adamw", "lookahead_k": 3}, 1),
    ({"NAME": "adahessian"}, 1), ({"NAME": "adamw"}, 2)],
    ids=["ScaleByAdamState", "TraceState", "LookaheadState",
         "AdahessianState", "MultiStepsState"])
def test_opt_state_from_jax_resumes_geot_tpus_optimizer(cfg, every_k):
    """``geot_tpu``'s state after 3 gradients, written as a checkpoint
    writes it (``flax.serialization.to_state_dict``), converted and loaded:
    the next 2 updates match ``geot_tpu``'s 5."""
    params, grads, diags = _problem(np.float64, 5)
    with _x64(np.float64):
        mid, jstate = _jax_run(cfg, params, grads[:3], diags[:3],
                               every_k=every_k)
        want, _ = _jax_run(cfg, params, grads, diags, every_k=every_k)
    conv = opt_state_from_jax(flax.serialization.to_state_dict(jstate),
                              lambda tree: {k: torch.from_numpy(
                                  np.asarray(v)) for k, v in tree.items()})
    assert conv["step"] == 3 // every_k
    module = _module(mid)
    opt = build_optimizer_from_cfg(module, LRS[0], every_k=every_k, **cfg)
    _load_opt(opt, module, conv)
    for g, h, lr in zip(grads[3:], diags[3:], LRS[3:]):
        _port_step(opt, module, g, h, lr)
    _assert_close(module, want, TOL[np.float64])


@pytest.mark.parametrize("name,state_name", [
    ("adafactor", "FactoredState"), ("rmsprop", "ScaleByRmsState"),
    ("madgrad", "MadgradState")])
def test_opt_state_from_jax_names_what_it_does_not_convert(name, state_name):
    params, grads, diags = _problem(np.float32, 1)
    _, jstate = _jax_run({"NAME": name}, params, grads, diags)
    for form in (jstate, flax.serialization.to_state_dict(jstate)):
        with pytest.raises(ValueError, match=state_name):
            opt_state_from_jax(form, lambda tree: tree)


def test_adahessian_step_needs_the_diagonal():
    opt = build_optimizer_from_cfg(_module({"w": np.ones((2, 2))}), 1e-3,
                                   NAME="adahessian")
    for p in opt.params():
        p.grad = torch.ones_like(p)
    with pytest.raises(ValueError, match="Hessian"):
        opt.step()


# --- AdamP and SGDP on a model's weights ----------------------------------

@pytest.fixture(scope="module")
def model_variables():
    """``geot_tpu``'s initial params of the flagship at the small width and
    of ``ViewGenBase`` at ``tests/test_generation.py``'s size (its decoder's
    4-D convolution kernels), with their configs."""
    flagship = {"NAME": "WholePartSeg", "segmentor_args": SMALL_ARGS}
    pos = np.zeros((1, N_POINTS, 3), np.float32)
    return {
        "flagship": (flagship, _jinit(jbuild(flagship), {
            "pos": pos, "x": pos, "cls": np.zeros((1, 1), np.int32)})),
        "viewgen": (GEN_CFG, _jinit(jbuild(GEN_CFG), _j(_batch(0))))}


def _flax_row_orthogonal(params, rng):
    """Gradients of ``params`` (a flax tree) that are orthogonal to every
    row of each rank >= 2 leaf in ``geot_tpu``'s channel view (its first
    axis): AdamP's projection acts there, and only there."""
    def one(w):
        g = 0.1 * rng.standard_normal(w.shape).astype(w.dtype)
        if w.ndim < 2:
            return g
        wv, gv = w.reshape(w.shape[0], -1), g.reshape(w.shape[0], -1)
        gv = gv - (np.sum(gv * wv, axis=1, keepdims=True)
                   / np.maximum(np.sum(wv * wv, axis=1, keepdims=True),
                                1e-30)) * wv
        return gv.reshape(w.shape)
    return jax.tree_util.tree_map(one, params)


@pytest.mark.parametrize("model", ["flagship", "viewgen"])
@pytest.mark.parametrize("name", ["adamp", "sgdp"])
def test_projection_on_converted_model_weights_matches_geot_tpu(
        model_variables, model, name):
    """3 updates on a model's weights converted by ``params_from_jax``, with
    gradients orthogonal to the rows of each flax kernel: within 1e-5 of
    each tensor's largest entry of ``geot_tpu``'s weights, converted alike.
    The control projects along the port tensor's first axis (no
    ``kernel_axes``) and must miss the bound."""
    cfg, variables = model_variables[model]
    params = {"params": variables["params"]}
    rng = np.random.default_rng(7)
    grads = [_flax_row_orthogonal(params["params"], rng) for _ in range(3)]
    opt_cfg = {"NAME": name, "weight_decay": 0.05}
    tx = joptimizer(None, lr=LRS[0], **opt_cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params["params"])
    state = tx.init(jp)
    update = jax.jit(tx.update)     # one compile, not one an operation
    for g, lr in zip(grads, LRS):
        state = jset_lr(state, lr)
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, g), state,
                            jp)
        jp = optax.apply_updates(jp, upd)
    want = params_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                             jp)})
    port_grads = [params_from_jax({"params": g}) for g in grads]

    def run(kernel_axes):
        module = build_model_from_cfg(cfg)
        module.load_state_dict(params_from_jax(variables), strict=True)
        opt = build_optimizer_from_cfg(module, LRS[0], **opt_cfg)
        if not kernel_axes:
            opt.kernel_axes = [None] * len(opt.params())
        for g, lr in zip(port_grads, LRS):
            for k, p in module.named_parameters():
                p.grad = g[k].clone()
            set_learning_rate(opt, lr)
            opt.step()
        return {k: max(float((p.detach() - want[k]).abs().max())
                       / max(float(want[k].abs().max()), 1e-30), 0.0)
                for k, p in module.named_parameters()}

    errs = run(True)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL[np.float32], (worst, errs[worst])
    ctl = run(False)
    assert max(ctl.values()) > TOL[np.float32], max(ctl.values())
