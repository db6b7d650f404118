"""The port's train slice against ``geot_tpu``: data, transforms, the
fixmatch forward, the T-predictor, the losses, the NTM update, the
class-mean bootstrap, the optimizer and schedule, and one whole
``semi_step`` from the same state.

Inputs come from seeded numpy (or from the port's synthetic datasets,
which are bit-equal to ``geot_tpu``'s) and go through both packages. The
config is the small one of ``tests/test_torch_model.py`` (D = 48, depth 3,
256 points: every JAX neighbour search is exact ``lax.top_k``) with
stochastic depth and dropout off, since the two frameworks draw different
masks.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from geot_tpu.core.config import EasyConfig
from geot_tpu.data import build as jdata_build
from geot_tpu.data.transforms import build_transforms_from_cfg as jtransforms
from geot_tpu.engine import semi as jsemi
from geot_tpu.engine.state import SemiTrainState as JSemiTrainState
from geot_tpu.engine.steps import make_cm_step as jmake_cm_step
from geot_tpu.engine.steps import make_semi_step as jmake_semi_step
from geot_tpu.engine.train import cal_mean_feature as jcal_mean_feature
from geot_tpu.losses import build_criterion_from_cfg as jcriterion
from geot_tpu.losses.inst_loss import threed_space_loss as jthreed
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer
from geot_tpu.optim import build_scheduler_from_cfg as jscheduler
from geot_tpu.optim.factory import set_learning_rate as jset_lr

from geot_tpu_torch import FLAGSHIP_SEMI_CFG
from geot_tpu_torch.core.config import build_model_from_cfg
from geot_tpu_torch.data import build as tdata_build
from geot_tpu_torch.data.transforms import build_transforms_from_cfg
from geot_tpu_torch.engine import semi as tsemi
from geot_tpu_torch.engine.convert import (params_from_jax,
                                           semi_state_from_jax,
                                           t_params_from_jax)
from geot_tpu_torch.engine.state import SemiTrainState
from geot_tpu_torch.engine.steps import make_cm_step, make_semi_step
from geot_tpu_torch.engine.train import cal_mean_feature
from geot_tpu_torch.losses import build_criterion_from_cfg, threed_space_loss
from geot_tpu_torch.optim import (build_optimizer_from_cfg,
                                  build_scheduler_from_cfg,
                                  set_learning_rate)

from test_torch_model import N_POINTS, ROOT, SMALL_ARGS, jax_small_model
from torch_helpers import one_torch_thread  # noqa: F401



# dropout and stochastic depth off: masks cannot match across frameworks
TRAIN_ARGS = dict(SMALL_ARGS, drop_path_rate=0.0, head_dropout=0.0)
CFG = dict(FLAGSHIP_SEMI_CFG, num_points=N_POINTS)
C = 17


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _loaders(pkg):
    """The labelled and unlabelled train loaders of both packages."""
    tf = CFG["datatransforms"]
    if pkg == "torch":
        return tdata_build.build_semi_loaders(CFG)
    common = {"NAME": "TeethSegSemiLDataset", "data_root": "",
              "num_points": N_POINTS}
    l = jdata_build.build_dataloader_from_cfg(
        CFG["batch_size_l"], {"common": common}, None, tf, split="train",
        seed=CFG["seed"])
    u = jdata_build.build_semi_dataloader_from_cfg(
        CFG["batch_size_u"], {"common": dict(common,
                                             NAME="TeethSegSemiUDataset")},
        None, tf, split="train", seed=CFG["seed"])
    return l, u


@pytest.fixture(scope="module")
def batches():
    """Two (labelled, unlabelled) numpy batch pairs of epoch 1."""
    l, u = _loaders("torch")
    l.set_epoch(1)
    u.set_epoch(1)
    return list(tdata_build.semi_pairs(l, u, limit=2))


def _jbatch(batch, keys):
    return {k: jnp.asarray(batch[k]) for k in keys}


def _tbatch(batch, keys):
    return tdata_build.to_device(batch, keys, "cpu")


# --- data ------------------------------------------------------------------

def test_semi_batches_equal_geot_tpu():
    (tl, tu), (jl, ju) = _loaders("torch"), _loaders("jax")
    assert (len(tl.dataset), len(tu.dataset)) == (24, 48)
    assert (len(tl.dataset), len(tu.dataset)) == (len(jl.dataset),
                                                  len(ju.dataset))
    for epoch in (1, 2):
        for loader in (tl, tu, jl, ju):
            loader.set_epoch(epoch)
        for a_l, b_l, (a_u, b_u) in zip(tl, jl, zip(tu, ju)):
            for a, b in ((a_l, b_l), (a_u, b_u)):
                assert set(a) == set(b)
                for k in a:
                    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            break                         # one batch pair per epoch


@pytest.mark.parametrize("split", ["train", "train_w", "train_s"])
def test_transforms_equal_geot_tpu(split):
    tf = CFG["datatransforms"]
    pos = np.random.default_rng(3).standard_normal((500, 3)).astype(
        np.float32)
    got = build_transforms_from_cfg(split, tf)(
        {"pos": pos.copy(), "x": pos}, np.random.default_rng(7))
    want = jtransforms(split, tf)({"pos": pos.copy(), "x": pos},
                                  np.random.default_rng(7))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_semi_cfg_equals_the_yaml():
    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs", "tooth_semi",
                          "transformer_finetune_fixmatch_ntm.yaml"),
             recursive=True)
    for key, val in FLAGSHIP_SEMI_CFG.items():
        want = (cfg.dataset_l.common.num_points if key == "num_points"
                else cfg[key])
        assert json.loads(json.dumps(want)) == val, key


# --- models ----------------------------------------------------------------

def _jax_train_model(seed=0):
    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": TRAIN_ARGS})
    _, variables = jax_small_model(seed)
    return jmodel, variables


def _port_model(variables):
    model = build_model_from_cfg({"NAME": "WholePartSeg",
                                  "segmentor_args": TRAIN_ARGS})
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def test_fixmatch_forward_matches_jax(batches):
    jmodel, variables = _jax_train_model()
    tmodel = _port_model(variables).train()
    bl, bu = batches[0]
    u_keys = ("pos_s", "x_s", "cls_s", "pos_w", "x_w", "cls_w")
    T = np.eye(C, dtype=np.float32) * 0.8 + 0.2 / C
    # geot_tpu's forwards compiled, as its steps are (eager, each operation
    # compiles on its own: ~2 min of this test under the tier-1 load)
    apply = jax.jit(jmodel.apply, static_argnames=(
        "fixmatch", "training", "mutable", "if_teacher"))
    (j_logit, j_corr, _, _), mutated = apply(
        variables, _jbatch(bl, ("pos", "x", "cls")),
        u0={**_jbatch(bu, u_keys), "T": jnp.asarray(T)}, fixmatch=True,
        training=True, mutable=("batch_stats",))
    t_logit, t_corr, _, _ = tmodel(_tbatch(bl, ("pos", "x", "cls")),
                                   u0={**_tbatch(bu, u_keys), "T": _t(T)},
                                   fixmatch=True)
    assert t_logit.shape == (6, N_POINTS, C)
    # batch statistics in every BatchNorm amplify float32 rounding: the
    # logits agree to ~1e-5 of their scale (in float64 the two forwards
    # agree to the final cast, 4e-7 of the scale)
    diff = np.abs(t_logit.detach().numpy() - np.asarray(j_logit)).max()
    scale = np.abs(np.asarray(j_logit)).max()
    print(f"training fixmatch forward: max |dlogit| {diff:.3e}, scale "
          f"{scale:.3f}")
    assert diff <= 2e-5 * scale
    np.testing.assert_allclose(t_corr.detach().numpy(), np.asarray(j_corr),
                               rtol=0, atol=1e-6)
    # the training forward's running statistics are flax's
    want = params_from_jax({"params": variables["params"],
                            "batch_stats": _np_tree(
                                mutated["batch_stats"])})
    got = tmodel.state_dict()
    n = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
            n += 1
    assert n > 0

    # eval mode: the concat itself, and the teacher branch (the weak view)
    with torch.no_grad():
        e_logit = _port_model(variables).eval()(
            _tbatch(bl, ("pos", "x", "cls")), u0=_tbatch(bu, u_keys),
            fixmatch=True)[0]
    j_e = apply(variables, _jbatch(bl, ("pos", "x", "cls")),
                u0=_jbatch(bu, u_keys), fixmatch=True)[0]
    np.testing.assert_allclose(e_logit.numpy(), np.asarray(j_e), rtol=0,
                               atol=1e-5)
    j_t = apply(variables, _jbatch(bu, u_keys), if_teacher=True)[0]
    with torch.no_grad():
        t_t = _port_model(variables).eval()(_tbatch(bu, u_keys),
                                            if_teacher=True)[0]
    np.testing.assert_allclose(t_t.numpy(), np.asarray(j_t), rtol=0,
                               atol=1e-5)


def test_eval_forward_unchanged_by_a_training_forward(batches):
    """Eval mode reads the running statistics only; a training forward
    updates them and then changes what eval computes."""
    _, variables = _jax_train_model()
    model = _port_model(variables).eval()
    batch = _tbatch(batches[0][0], ("pos", "x", "cls"))
    with torch.no_grad():
        a = model(batch)[0]
        b = model(batch)[0]
        assert torch.equal(a, b)
        model.train()(batch)
        c = model.eval()(batch)[0]
    assert not torch.equal(a, c)


def test_batchnorm_eval_is_torchs_and_train_updates_like_flax(rng):
    """Eval mode is ``nn.BatchNorm1d``'s, bit for bit; a training forward
    normalises with the biased batch variance and moves the running
    statistics 0.1 of the way to it, as flax ``BatchNorm(momentum=0.9)``."""
    from geot_tpu_torch.models.layers import BatchNorm

    x = _t(rng.standard_normal((4, 30, 8)).astype(np.float32) * 2 + 1)
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
        bn.weight.uniform_(0.5, 2)
        bn.bias.uniform_(-1, 1)
    ref = torch.nn.BatchNorm1d(8)
    ref.load_state_dict(bn.state_dict())
    bn.eval()
    ref.eval()
    assert torch.equal(bn(x), ref(x.reshape(-1, 8)).reshape(x.shape))
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    y = bn.train()(x)
    flat = x.reshape(-1, 8).double()
    mean, var = flat.mean(0), flat.var(0, unbiased=False)
    torch.testing.assert_close(bn.running_mean.double(), 0.9 * rm + 0.1 * mean,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_var.double(), 0.9 * rv + 0.1 * var,
                               rtol=0, atol=1e-6)
    want = (flat - mean) / torch.sqrt(var + 1e-5) * bn.weight.double() \
        + bn.bias.double()
    torch.testing.assert_close(y.reshape(-1, 8).double(), want, rtol=0,
                               atol=1e-5)


def test_train_modules_import_no_jax_or_geot_tpu():
    """The train slice imports, builds a state and steps on the CPU with
    jax, flax, yaml and geot_tpu blocked."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import sys
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
                   "geot_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        from geot_tpu_torch import FLAGSHIP_SEMI_CFG
        from geot_tpu_torch.data.build import (MODEL_KEYS, SEMI_KEYS,
            build_semi_loaders, semi_pairs, to_device)
        from geot_tpu_torch.engine.state import SemiTrainState
        from geot_tpu_torch.engine.steps import make_cm_step, make_semi_step
        from geot_tpu_torch.engine.train import cal_mean_feature
        cfg = dict(FLAGSHIP_SEMI_CFG, num_points={N_POINTS})
        state = SemiTrainState.create(cfg, seg_args={SMALL_ARGS!r},
                                      device="cpu")
        l, u = build_semi_loaders(cfg)
        bl, bu = next(semi_pairs(l, u))
        state.cm = cal_mean_feature(make_cm_step(), state.model, [bl], 17,
                                    "cpu")
        m = make_semi_step(cfg)(state, to_device(bl, MODEL_KEYS, "cpu"),
                                to_device(bu, SEMI_KEYS, "cpu"), 1e-3, True)
        assert float(m["loss"]) > 0 and state.step == 1
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_state_refuses_a_missing_card_and_unported_branches(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemiTrainState.create(CFG, seg_args=TRAIN_ARGS)
    # the Hessian-diagonal optimizer is ported (tests/test_torch_adahessian
    # .py); the pretraining step, which geot_tpu gives no diagonal, refuses
    # it by name; a loss neither package registers raises
    make_semi_step(dict(CFG, optimizer={"NAME": "adahessian"}))
    from geot_tpu_torch.engine.pretrain import make_pretrain_step
    with pytest.raises(ValueError, match="adahessian"):
        make_pretrain_step(dict(CFG, optimizer={"NAME": "adahessian"}))
    with pytest.raises(KeyError, match="Poly1FocalLoss_X"):
        make_semi_step(dict(CFG, criterion_u_args={"NAME":
                                                   "Poly1FocalLoss_X"}))


def test_dropout_masks_follow_the_generator(batches):
    model = build_model_from_cfg({"NAME": "WholePartSeg",
                                  "segmentor_args": SMALL_ARGS}).train()
    batch = _tbatch(batches[0][0], ("pos", "x", "cls"))
    out = []
    for seed in (5, 5, 6):
        m = copy.deepcopy(model)
        out.append(m(batch, generator=torch.Generator().manual_seed(seed))[0])
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], out[2])


def test_sig_t_mean_matches_jax(rng):
    jt = jbuild(CFG["t_predictor"])
    probs = jax.nn.softmax(jnp.asarray(
        rng.standard_normal((2, 40, C)).astype(np.float32)), -1)
    cm = rng.uniform(0, 1, (C, C)).astype(np.float32)
    t_vars = _np_tree(jt.init(jax.random.PRNGKey(1), probs, jnp.eye(C)))
    want = jt.apply(t_vars, probs, jnp.asarray(cm))
    tt = build_model_from_cfg(CFG["t_predictor"])
    tt.load_state_dict(t_params_from_jax(t_vars["params"]))
    got = tt(_t(np.asarray(probs)), _t(cm))
    assert got.shape == (80, C, C)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


# --- losses and NTM --------------------------------------------------------

def test_losses_match_jax(rng):
    logits = rng.standard_normal((2, 50, C)).astype(np.float32) * 3
    labels = rng.integers(0, C, (2, 50))
    conf = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    sup = build_criterion_from_cfg(CFG["criterion_args"])
    unsup = build_criterion_from_cfg(CFG["criterion_u_args"])
    j_sup = jcriterion(CFG["criterion_args"])
    j_unsup = jcriterion(CFG["criterion_u_args"])
    assert _rel(sup(_t(logits), _t(labels)),
                j_sup(jnp.asarray(logits), jnp.asarray(labels))) <= 1e-5
    for th in (0.0, 0.5):
        assert _rel(unsup(_t(logits), _t(labels), _t(conf), thresh=th),
                    j_unsup(jnp.asarray(logits), jnp.asarray(labels),
                            jnp.asarray(conf), thresh=th)) <= 1e-5


def test_threed_space_loss_matches_jax(rng):
    pos = rng.standard_normal((2, 200, 3)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 200))
    ins = rng.uniform(0, 1, (400, C, C)).astype(np.float32)
    ins /= ins.sum(-1, keepdims=True)
    got = threed_space_loss(32, 1.0)(_t(pos), _t(labels), _t(ins))
    want = jthreed(32, 1.0, C)(jnp.asarray(pos), jnp.asarray(labels),
                               jnp.asarray(ins))
    assert _rel(got, want) <= 1e-5


def test_ntm_update_combine_and_apply_match_jax(rng):
    probs = jax.nn.softmax(jnp.asarray(
        rng.standard_normal((2, 60, C)).astype(np.float32) * 2), -1)
    ema = rng.uniform(0, 1, (C, C)).astype(np.float32)
    ema /= ema.sum(1, keepdims=True)
    sigma = rng.uniform(0.3, 0.6, C).astype(np.float32)
    for fo in (False, True):
        j = jsemi.ntm_update(jnp.asarray(ema), probs, jnp.asarray(sigma),
                             filter_outlier=fo)
        t = tsemi.ntm_update(_t(ema), _t(np.asarray(probs)), _t(sigma),
                             filter_outlier=fo)
        for a, b in zip(t, j):
            assert _rel(a, b) <= 1e-5
    ins = rng.uniform(0, 1, (120, C, C)).astype(np.float32)
    j_new = jsemi.combine_T(j.ema_t_corr, jnp.asarray(ins), 0.9)
    t_new = tsemi.combine_T(t.ema_t_corr, _t(ins), 0.9)
    assert _rel(t_new, j_new) <= 1e-5
    logits = rng.standard_normal((2, 60, C)).astype(np.float32)
    assert _rel(tsemi.apply_T(_t(logits), t_new),
                jsemi.apply_T(jnp.asarray(logits), j_new)) <= 1e-5
    conf = np.asarray(probs).max(-1)
    pseudo = np.asarray(probs).argmax(-1)
    target = rng.integers(0, C, pseudo.shape)
    got = tsemi.pseudo_stats(_t(pseudo), _t(target), _t(conf), 0.3, C)
    want = jsemi.pseudo_stats(jnp.asarray(pseudo), jnp.asarray(target),
                              jnp.asarray(conf), 0.3, C)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)


# --- optimizer and schedule ------------------------------------------------

@pytest.mark.parametrize("epoch", [1, 2, 219, 220, 221, 300])
def test_multistep_lr_matches_jax(epoch):
    assert build_scheduler_from_cfg(CFG)(epoch) == pytest.approx(
        jscheduler(CFG)(epoch), rel=1e-12)


def test_adamw_with_decay_mask_matches_optax(rng):
    """Three updates from the same gradients: rank >= 2 tensors decay,
    vectors do not, the lr is set per step."""
    shapes = {"w": (5, 4), "b": (4,), "k": (3, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = joptimizer(None, lr=1e-3, **CFG["optimizer"])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(_t(v.copy())))
    opt = build_optimizer_from_cfg(module, 1e-3, **CFG["optimizer"])
    for g, lr in zip(grads, (1e-3, 1e-3, 1e-4)):
        opt_state = jset_lr(opt_state, lr)
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.named_parameters():
            p.grad = _t(g[k])
        set_learning_rate(opt, lr)
        opt.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    decay = {id(p) for g in opt.param_groups if g["weight_decay"] > 0
             for p in g["params"]}
    assert decay == {id(module.w), id(module.k)}


# --- the cm bootstrap and the whole step ------------------------------------

def test_cal_mean_feature_matches_jax():
    jmodel, variables = _jax_train_model()
    tmodel = _port_model(variables)
    jl, _ = _loaders("jax")
    tl, _ = _loaders("torch")
    for loader in (jl, tl):
        loader.set_epoch(1)
    jl.dataset.file_list = jl.dataset.file_list[:4]
    tl.dataset.file_list = tl.dataset.file_list[:4]
    want = jcal_mean_feature(jmake_cm_step(jmodel), variables, jl, C,
                             lambda d: jax.tree_util.tree_map(jnp.asarray, d))
    got = cal_mean_feature(make_cm_step(), tmodel, tl, C, "cpu")
    assert got.dtype == torch.float32 and got.shape == (C, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _adam_mu(opt_state):
    """The first moments of an optax adam state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return _np_tree(found[0].mu)


def _jax_init():
    """The JAX model and T-predictor with their float32 initial weights as
    numpy trees."""
    jmodel, variables = _jax_train_model()
    jt = jbuild(CFG["t_predictor"])
    t_vars = _np_tree(jt.init(jax.random.PRNGKey(2), jnp.ones((1, 8, C)) / C,
                              jnp.eye(C)))
    return jmodel, _np_tree(variables), jt, t_vars


def _jax_semi_state(init, x64=False):
    """Optimizers and a SemiTrainState with a non-trivial ``cm`` and
    ``ema_t`` from the float32 weights of ``init``, cast to float64 when
    ``x64``, so both dtypes start from the same numbers."""
    jmodel, variables, jt, t_vars = init
    rng = np.random.default_rng(11)
    cm = rng.uniform(0, 1, (C, C)).astype(np.float32)
    cm /= cm.sum(1, keepdims=True)
    ema = np.eye(C, dtype=np.float32) * 0.7 + 0.3 / C
    dt = np.float64 if x64 else np.float32

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, dt) if np.asarray(a).dtype
                                  == np.float32 else a), tree)

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
    step = jmake_semi_step(jmodel, jmodel, jt, tx, t_tx, dict(CFG))
    return jstate, before, step


def _run_both(init, batch, x64):
    """One flagship semi step, teacher on, from the same state in both
    packages: (JAX state before, JAX state after, JAX metrics, port state
    after, port metrics)."""
    bl, bu = batch
    dt = np.float64 if x64 else np.float32

    def arrays(b, keys):
        return {k: (b[k].astype(dt) if b[k].dtype == np.float32 else b[k])
                for k in keys}

    bl_l, bu_u = (arrays(bl, tdata_build.MODEL_KEYS),
                  arrays(bu, tdata_build.SEMI_KEYS))
    lr = build_scheduler_from_cfg(CFG)(1)
    jstate, before, jstep = _jax_semi_state(init, x64)
    jnew, jmetrics = jstep(jstate, _jbatch(bl_l, bl_l), _jbatch(bu_u, bu_u),
                           jnp.asarray(lr, dt), True)
    jnew, jmetrics = _np_tree(jnew), _np_tree(jmetrics)

    state = SemiTrainState.create(CFG, seg_args=TRAIN_ARGS, device="cpu")
    if x64:
        for m in (state.model, state.teacher, state.t_predictor):
            m.double()
        state.ema_t, state.cm = state.ema_t.double(), state.cm.double()
    state.load(semi_state_from_jax(before))
    metrics = make_semi_step(CFG)(state, _tbatch(bl_l, bl_l),
                                  _tbatch(bu_u, bu_u), lr, True)
    return before, jnew, jmetrics, state, metrics


@pytest.fixture(scope="module")
def one_step(batches):
    return _run_both(_jax_init(), batches[0], x64=False)


@pytest.fixture(scope="module")
def one_step_x64(batches):
    """The same step in float64 in both packages (JAX with x64 switched on
    for this fixture only)."""
    init = _jax_init()
    jax.config.update("jax_enable_x64", True)
    try:
        return _run_both(init, batches[0], x64=True)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_semi_step_losses_match_jax(one_step):
    _, _, jm, _, tm = one_step
    for k in ("loss", "sup_loss", "unsup_loss", "threed_loss"):
        print(f"{k}: port {float(tm[k]):.8f} jax {float(jm[k]):.8f}")
        assert np.isfinite(float(tm[k]))
        assert _rel(tm[k], jm[k]) <= 1e-5, k
    for k in ("over_th", "pseudo_acc", "teacher_acc", "student_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)


def test_semi_step_gradients_match_jax(one_step_x64):
    """AdamW's first moment after one step is 0.1 x the clipped gradient in
    both packages: compare it tensor by tensor, relative to the tensor's
    largest entry. In float64: in float32 the batch-statistics BatchNorms
    leave either package's gradients up to ~2e-2 of a tensor's scale from
    the float64 gradient, while the two float64 steps agree to ~1e-6. A
    bias followed by BatchNorm has a zero gradient; its scale is floored
    at 1e-6 of the largest gradient."""
    _, jnew, jm, state, tm = one_step_x64
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


def test_semi_step_state_matches_jax(one_step):
    before, jnew, _, state, _ = one_step
    np.testing.assert_allclose(state.ema_t.numpy(), jnew.ema_t, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(state.ema_t.sum(1).numpy(), 1.0, atol=1e-6)
    want = params_from_jax({"params": jnew.params,
                            "batch_stats": jnew.batch_stats})
    got = state.model.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
    # the teacher stays the state it was given
    teacher = params_from_jax({"params": before["teacher_params"],
                               "batch_stats": before["teacher_batch_stats"]})
    for k, v in state.teacher.state_dict().items():
        if k in teacher:
            assert torch.equal(v, teacher[k]), k
    assert state.step == 1
