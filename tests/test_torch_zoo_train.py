"""The supervised tooth zoo's training path against ``geot_tpu``: one
``make_supervised_step`` per ``cfgs/tooth_sup/`` config from the same
``TrainState`` (loss in float32, gradients in float64), the AdamW decay
filter name for name, the EMA shadow and the non-finite guard, a resume
from a converted ``geot_tpu`` ``TrainState``, and the port's trainer on
each config (one epoch, validation, the test pass, then ``mode=test``,
checkpoints and a bit-exact resume).

Small widths (``tests/test_supervised_zoo.py``'s ``TINY``), 256 points a
scan, batches from the port's loader (bit-equal to ``geot_tpu``'s);
dropout as in ``tests/test_torch_zoo_models.py``: off where the config
can turn it off, ``geot_tpu``'s mask in PointMLP's head.
"""
import copy
import json
import os

import flax.serialization
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.engine.state import TrainState as JTrainState
from geot_tpu.engine.steps import make_supervised_step as jmake_step
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer
from geot_tpu.optim.factory import _decay_mask

from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.checkpoint import ckpt_path, load_checkpoint
from geot_tpu_torch.engine.convert import params_from_jax, state_from_jax
from geot_tpu_torch.engine.state import TrainState
from geot_tpu_torch.engine.steps import make_supervised_step
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_torch_zoo_models import (CONFIGS, N_PTS, NO_DROPOUT, ROOT, TINY,
                                   _cast, _np, _rel, as_dtype, jax_model,
                                   use_jax_dropout, zoo_batches, zoo_cfg)
from torch_helpers import one_torch_thread  # noqa: F401



def _adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return _np(found[0].mu)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def pre_bn_biases(model, batch):
    """The biases of the Linear layers whose output goes straight into a
    BatchNorm that normalises with batch statistics: their gradient is 0
    in exact arithmetic, so Adam moves them by rounding noise, whose sign
    no two computations share. Found from the hooks of a forward of a
    copy (a train-mode forward moves the running statistics)."""
    model = copy.deepcopy(model)
    out_of, found = {}, set()
    hooks = []
    for n, m in model.named_modules():
        if isinstance(m, torch.nn.Linear) and m.bias is not None:
            hooks.append(m.register_forward_hook(
                lambda _m, _i, o, n=n: out_of.__setitem__(id(o), (n, o))))
        elif isinstance(m, torch.nn.BatchNorm1d):
            hooks.append(m.register_forward_pre_hook(
                lambda _m, i: found.add(out_of.get(id(i[0]), (None,))[0])))
    try:
        with torch.no_grad():
            model.train()(_tbatch(batch))
    finally:
        for h in hooks:
            h.remove()
    return {f"{n}.bias" for n in found if n is not None}


def run_both(name, x64, *extra, steps=1):
    """``steps`` supervised steps of the config from the same weights and
    batches in both packages: (JAX states after each step as numpy trees,
    JAX metrics per step, port state, port metrics per step, the JAX step,
    the batches)."""
    dt = np.float64 if x64 else np.float32
    tcfg, jcfg = zoo_cfg("torch", name, *extra), zoo_cfg("jax", name, *extra)
    raw = zoo_batches(tcfg, steps)
    batches = [as_dtype(b, dt) for b in raw]
    jmodel, variables = jax_model(name, raw[0])
    tx = joptimizer(None, lr=jcfg.lr, **jcfg.optimizer)
    jstate = JTrainState.create(_cast(variables, dt), tx,
                                ema=bool(jcfg.get("ema_eval")))
    jstep = jmake_step(jmodel, tx, jcfg)
    state = TrainState.create(tcfg, tcfg.model, seed=0, device="cpu")
    if x64:
        state.model.double()
    state.load(state_from_jax({"params": variables["params"],
                               "batch_stats": variables["batch_stats"]}))
    if state.ema_params:
        state.seed_ema()
    step = make_supervised_step(tcfg)
    lr = build_scheduler_from_cfg(tcfg)(1)
    jstates, jms, tms = [], [], []
    for i, b in enumerate(batches):
        jb = _jbatch(b)
        # geot_tpu's dropout key for the step (steps.py:96)
        rng = jax.random.fold_in(jax.random.PRNGKey(int(jcfg.seed)), i)
        use_jax_dropout(name, state.model, jmodel,
                        {"params": jstate.params,
                         "batch_stats": jstate.batch_stats}, jb, rng)
        jstate, jm = jstep(jstate, jb, jnp.asarray(lr, dt))
        jstates.append(_np(jstate))
        jms.append(_np(jm))
        tms.append(step(state, _tbatch(b), lr))
    return jstates, jms, state, tms, jstep, batches


@pytest.mark.parametrize("name", CONFIGS)
def test_supervised_step_loss_matches_jax(name):
    """float32: the loss within 1e-5 relative, the step counted, and the
    running statistics the step wrote within 1e-6 (absolute)."""
    (jnew,), jms, state, tms, _, _ = run_both(name, x64=False)
    got, want = float(tms[0]["loss"]), float(jms[0]["loss"])
    print(f"{name}: loss port {got:.8f} geot_tpu {want:.8f}")
    assert np.isfinite(got)
    assert _rel(got, want) <= 1e-5
    assert float(tms[0]["unsup_loss"]) == 0.0
    assert state.step == int(jnew.step) == 1
    new = params_from_jax({"params": jnew.params,
                           "batch_stats": jnew.batch_stats})
    sd = state.model.state_dict()
    for k, v in new.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", CONFIGS)
def test_supervised_step_gradients_match_jax(name):
    """float64: AdamW's first moment after one step is 0.1 x the clipped
    gradient in both packages; per tensor within 1e-6 of the tensor's
    largest entry (a bias before a batch-statistics BatchNorm has a zero
    gradient: its scale is floored at 1e-6 of the largest gradient)."""
    jax.config.update("jax_enable_x64", True)
    try:
        (jnew,), jms, state, tms, _, _ = run_both(name, x64=True)
    finally:
        jax.config.update("jax_enable_x64", False)
    # geot_tpu rounds the seg_T logits to float32 and the 3-NN weights too
    # (float32 distances): measured 1.0e-9 to 1.5e-9 (3-NN), 3.4e-7
    # (seg_T), 5e-16 (DGCNN)
    assert _rel(float(tms[0]["loss"]), float(jms[0]["loss"])) <= 1e-6
    want = params_from_jax({"params": _adam_mu(jnew.opt_state),
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
        assert err <= 1e-6, (k, err)
    print(f"{name} float64: worst per-tensor gradient error / max|g| "
          f"{worst:.3e}")


@pytest.mark.parametrize("name", CONFIGS)
def test_decay_filter_matches_geot_tpu(name):
    """The tensors that AdamW decays, name for name: rank >= 2 in both
    packages, so PointMLP's (1, 1, 1, C) ``affine_alpha``/``affine_beta``
    decay in both."""
    batch = zoo_batches(zoo_cfg("torch", name), 1)[0]
    _, variables = jax_model(name, batch)
    mask = params_from_jax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m, np.float32), _decay_mask(
            variables["params"])), "batch_stats": {}})
    want = {k for k, v in mask.items() if bool(v.reshape(-1)[0])}
    tcfg = zoo_cfg("torch", name)
    state = TrainState.create(tcfg, tcfg.model, seed=0, device="cpu")
    names = {id(p): n for n, p in state.model.named_parameters()}
    got = {names[id(p)] for g in state.opt.param_groups
           if g["weight_decay"] > 0 for p in g["params"]}
    assert got == want
    if name == "pointmlp.yaml":
        assert "grouper_0.affine_alpha" in got
        assert "grouper_0.affine_beta" in got


def test_ema_and_the_guard_on_a_train_state():
    """``ema_eval`` and ``skip_nonfinite_updates`` on a ``TrainState``: the
    shadow after a step equals ``geot_tpu``'s (float32, 1e-6); a batch with
    a NaN skips the step in both packages and leaves every tensor of the
    port's state bit-equal; the next step trains."""
    name = "pointnet2.yaml"
    extra = ("ema_eval=0.9", "skip_nonfinite_updates=True")
    (jnew,), jms, state, tms, jstep, batches = run_both(name, False,
                                                        *extra)
    want = params_from_jax({"params": jnew.ema_params,
                            "batch_stats": {}})
    assert set(want) == set(state.ema_params)
    noisy = pre_bn_biases(state.model, batches[0])
    assert noisy == {"head.mlp_0.bias"}
    for k, v in state.ema_params.items():
        # a noisy bias moved by at most 0.1 x lr (1e-4) in the shadow
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-4 if k in noisy else 1e-6,
                                   err_msg=k)
    assert state.eval_model() is not state.model

    bad = dict(batches[0], pos=batches[0]["pos"].copy())
    bad["pos"][0, 0, 0] = np.nan
    bad["x"] = bad["pos"]
    _, jm = jstep(jax.tree_util.tree_map(jnp.asarray, jnew), _jbatch(bad),
                  jnp.asarray(1e-3, jnp.float32))
    assert float(jm["skipped"]) == 1.0

    def snapshot():
        sd = state.state_dict()
        out = {f"model/{k}": v.clone() for k, v in sd["model"].items()}
        out.update({f"ema/{k}": v.clone()
                    for k, v in sd["ema_params"].items()})
        for i, s in sd["opt"]["state"].items():
            out.update({f"opt/{i}/{k}": v.clone() for k, v in s.items()})
        return out

    before = snapshot()
    m = make_supervised_step(zoo_cfg("torch", name, *extra))(
        state, _tbatch(bad), 1e-3)
    assert float(m["skipped"]) == 1.0 and float(m["loss"]) == 0.0
    after = snapshot()
    assert before.keys() == after.keys()
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    assert state.step == 2
    m = make_supervised_step(zoo_cfg("torch", name, *extra))(
        state, _tbatch(batches[0]), 1e-3)
    assert float(m["skipped"]) == 0.0
    assert not torch.equal(before["model/head.out.weight"],
                           state.model.state_dict()["head.out.weight"])


def test_resume_from_a_converted_geot_tpu_train_state():
    """``geot_tpu`` takes one step; its whole ``TrainState`` (weights,
    BatchNorm statistics, AdamW moments, ``step``) goes through
    ``state_from_jax`` into a fresh port state; the next step in both
    packages gives the same loss and weights (float32)."""
    name = "dgcnn.yaml"
    (j1, j2), jms, _, _, _, batches = run_both(name, False, steps=2)
    tcfg = zoo_cfg("torch", name)
    state = TrainState.create(tcfg, tcfg.model, seed=5, device="cpu")
    state.load(state_from_jax(flax.serialization.to_state_dict(j1)))
    assert state.step == 1
    lr = build_scheduler_from_cfg(tcfg)(1)
    m = make_supervised_step(tcfg)(state, _tbatch(batches[1]), lr)
    assert _rel(float(m["loss"]), float(jms[1]["loss"])) <= 1e-5
    want = params_from_jax({"params": j2.params,
                            "batch_stats": j2.batch_stats})
    sd = state.model.state_dict()
    noisy = pre_bn_biases(state.model, batches[0])
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            # a noisy bias moves by up to lr (1e-3) a step
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=2e-3 if k in noisy else 2e-6,
                                       err_msg=k)
    assert state.step == int(j2.step) == 2


# --- the trainer -------------------------------------------------------------

def _cfg_args(name, root, *extra):
    return ["--cfg", os.path.join(ROOT, "cfgs", "tooth_sup", name),
            "device=cpu", f"root_dir={root}",
            f"dataset_l.common.num_points={N_PTS}", *TINY[name],
            *NO_DROPOUT[name], *extra]


def _run_dir(root):
    (d,) = [os.path.join(root, "tooth_sup", x)
            for x in os.listdir(os.path.join(root, "tooth_sup"))]
    return d


def _scalars(run_dir, step):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return {d["tag"]: d["value"] for d in map(json.loads, f)
                if d["step"] == step}


@pytest.mark.parametrize("name", CONFIGS)
def test_trainer_trains_and_tests_each_config(name, tmp_path):
    """``parse_and_run`` on the config: one epoch with validation, a
    checkpoint and the test pass, then ``mode=test`` on its best
    checkpoint gives the same test metrics."""
    res = ttrain.parse_and_run(_cfg_args(
        name, tmp_path, "epochs=1", "val_freq=1", "test_freq=1",
        "save_freq=1"))
    for split in ("val", "test"):
        for k, v in res[split].items():
            assert np.isfinite(v) and 0.0 <= v <= 1.0, (split, k, v)
    run_dir = _run_dir(tmp_path)
    sc = _scalars(run_dir, 1)
    assert np.isfinite(sc["train_loss"]) and sc["train_loss_u"] == 0.0
    ck = os.path.join(run_dir, "checkpoint")
    best = ckpt_path(ck, os.path.basename(run_dir), "best")
    for tag in ("latest", "best", "E1"):
        assert os.path.exists(ckpt_path(ck, os.path.basename(run_dir), tag))
    res_t = ttrain.parse_and_run(_cfg_args(name, tmp_path, "mode=test",
                                           f"pretrained_path={best}"))
    assert res_t["test"] == pytest.approx(res["test"], abs=1e-12)


def test_checkpoint_round_trip_and_bit_exact_resume(tmp_path):
    """Two epochs of PointMLP; a resume from the epoch-1 checkpoint writes
    epoch-2 scalars bit-equal to the uninterrupted run's; a checkpoint
    loads back into a fresh state bit for bit (dropout's generator
    included)."""
    name = "pointmlp.yaml"
    common = ("epochs=2", "val_freq=1", "test_freq=2", "save_freq=1")
    ttrain.parse_and_run(_cfg_args(name, tmp_path, *common))
    run_dir = _run_dir(tmp_path)
    a2 = _scalars(run_dir, 2)
    ck = os.path.join(run_dir, "checkpoint")
    e1 = ckpt_path(ck, os.path.basename(run_dir), "E1")
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        n_lines = len(f.readlines())
    ttrain.parse_and_run(_cfg_args(name, tmp_path, "mode=resume",
                                   f"pretrained_path={e1}", *common))
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        b2 = {d["tag"]: d["value"] for d in map(json.loads,
                                                f.readlines()[n_lines:])
              if d["step"] == 2}
    timing = ("epoch_seconds", "data_seconds")
    assert {k: v for k, v in b2.items() if k not in timing} == \
        {k: v for k, v in a2.items() if k not in timing}

    tcfg = zoo_cfg("torch", name)
    state = TrainState.create(tcfg, tcfg.model, seed=3, device="cpu")
    epoch, extra = load_checkpoint(e1, state)
    assert epoch == 1 and "miou" in extra
    saved = torch.load(e1, weights_only=True)["state"]
    for k, v in state.state_dict()["model"].items():
        assert torch.equal(v, saved["model"][k]), k
    assert torch.equal(state.generator.get_state(), saved["generator"])
    assert state.step == saved["step"] == 6


def _case(name, opt, key, want):
    """A case under the id its parameters had when every name of it was
    refused as unported."""
    return pytest.param(name, opt, want, id=f"{name}-{opt}-{key}")


@pytest.mark.parametrize("name,opt,want", [
    _case("pointnet2.yaml", "model.NAME=WholePartSeg_ntm", "model.NAME",
          "model.encoder_args"),
    _case("pointnet2.yaml", "model.NAME=VariableSeg", "model.NAME", None),
    _case("pointnet2.yaml", "model.NAME=DistillBaseSeg", "model.NAME", None),
    _case("pointnet2.yaml", "model.decoder_args.NAME=P3Embed",
          "model.decoder_args.NAME", "model.decoder_args.NAME"),
    _case("pointnet2.yaml", "model.cls_args.NAME=VariableSegHead",
          "model.cls_args.NAME", "model.cls_args.mlps"),
    _case("dgcnn.yaml", "model.encoder_args.NAME=PointTransformerEncoder",
          "model.encoder_args.NAME", "model.encoder_args.NAME"),
    _case("transformer.yaml",
          "model.segmentor_args.NAME=PointTransformer_seg_cluster",
          "model.segmentor_args.NAME", None),
    _case("pointnet2.yaml", "criterion_u_args.NAME=Poly1FocalLoss_U_corr",
          None, "model.NAME")])
def test_unported_model_names_are_refused(name, opt, want, tmp_path):
    """Every model name of ``geot_tpu``'s registry is now the port's: a
    combination ``geot_tpu``'s trainer trains passes ``refuse_unported``
    and its train state builds (``want`` None); one it cannot train (a
    name in a role it cannot fill, an argument its module does not take,
    a semi-supervised config without ``WholePartSeg`` or
    ``WholePartSeg_ntm``: ``tests/test_torch_registry_rest_gate.py``) is
    refused by its dotted key ``want`` before a run directory is made."""
    extra = [opt]
    if opt.startswith("criterion_u_args"):
        extra.append("dataset_u.common.NAME=TeethSegSemiUDataset")
    if want is None:
        cfg = zoo_cfg("torch", name, *extra)
        ttrain.refuse_unported(cfg)
        state = TrainState.create(cfg, cfg.model, seed=0, device="cpu")
        m = make_supervised_step(cfg)(state, _tbatch(zoo_batches(cfg, 1)[0]),
                                      1e-3)
        assert np.isfinite(float(m["loss"]))
        return
    with pytest.raises(NotImplementedError, match=want):
        ttrain.parse_and_run(_cfg_args(name, tmp_path, *extra))
    assert not os.path.exists(tmp_path / "tooth_sup")
