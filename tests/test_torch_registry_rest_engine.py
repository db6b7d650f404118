"""One supervised step of each newly trained model combination against
``geot_tpu``, in float64: ``WholePartSeg_ntm`` over
``PointTransformer_seg_cluster``, ``_classifier``, ``_2classifier``,
``_seg_T`` and ``_seg``; ``WholePartSeg`` over the three variants (``cfgs/tooth_sup/
transformer.yaml`` at ``tests/test_supervised_zoo.py``'s ``TINY`` width);
``VariableSeg`` with ``VariableSegHead`` and ``DistillBaseSeg``
(``pointnet2.yaml`` at ``TINY``); ``BaseCls`` over
``PointTransformerEncoder`` (``cfgs/scanobjectnn``, width 48, 2 blocks,
128 points: the ball's radius 0.4, where 0.1 leaves most groups with
their center alone, whose constant rows give the mini-PointNet no
gradient but rounding noise).

``geot_tpu``'s ``make_supervised_step`` and the port's from the same
weights (drawn by numpy into ``geot_tpu``'s tree, carried across by
``state_from_jax``) and batch: the loss within ``STEP_LOSS_RTOL``, the
running statistics within 1e-8, and AdamW's first moment (0.1 x the
clipped gradient) per tensor within ``STEP_GRAD_TOL`` of the tensor's
largest entry (floored at 1e-6 of the largest gradient: a bias before a
batch-statistics BatchNorm has a zero gradient), as
``tests/test_torch_heritage_models.py``. Dropout and stochastic depth are
off where the config can turn them off.
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

from geot_tpu_torch.core.config import EasyConfig
from geot_tpu_torch.data import build as tbuild
from geot_tpu_torch.engine.convert import params_from_jax, state_from_jax
from geot_tpu_torch.engine.state import TrainState
from geot_tpu_torch.engine.steps import make_supervised_step
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_supervised_zoo import TINY
from test_torch_registry_rest import draw_variables
from test_torch_zoo_models import NO_DROPOUT, _np, _rel, zoo_batches
from test_torch_zoo_train import _adam_mu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_LOSS_RTOL = 1e-6
STEP_GRAD_TOL = 1e-6
VARIANTS = ("cluster", "classifier", "2classifier")
HEAD = {"NAME": "VariableSegHead", "num_classes": 17, "in_channels": 24,
        "dropout_ratio": 0.0}
CLS_ENCODER = {"NAME": "PointTransformerEncoder", "num_groups": 16,
               "group_size": 8, "encoder_dims": 32, "trans_dim": 48,
               "depth": 2, "num_heads": 4, "drop_path_rate": 0.0,
               "radius": 0.4}


def _transformer(wrapper, seg=None):
    name = "PointTransformer_seg" + (f"_{seg}" if seg else "")
    return ("tooth_sup/transformer.yaml",
            TINY["transformer.yaml"] + NO_DROPOUT["transformer.yaml"]
            + [f"model.NAME={wrapper}", f"model.segmentor_args.NAME={name}"],
            None)


def _pointnet2(name, cls_args):
    return ("tooth_sup/pointnet2.yaml",
            TINY["pointnet2.yaml"] + [f"model.NAME={name}"], cls_args)


# case -> (config file, overrides, cls_args replacing the config's)
CASES = {
    **{f"ntm-{v}": _transformer("WholePartSeg_ntm", v)
       for v in VARIANTS + ("T",)},
    "ntm-seg": _transformer("WholePartSeg_ntm"),
    **{f"whole-{v}": _transformer("WholePartSeg", v) for v in VARIANTS},
    "variable_seg": _pointnet2("VariableSeg", HEAD),
    "distill_base_seg": _pointnet2("DistillBaseSeg",
                                   dict(HEAD, in_channels=None,
                                        dropout_ratio=0.0)),
    "cls_encoder": ("scanobjectnn/default.yaml", [], None),
}
N_CLS = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case_cfg(pkg, case):
    path, opts, cls_args = CASES[case]
    cfg = (JEasyConfig if pkg == "jax" else EasyConfig)()
    cfg.load(os.path.join(ROOT, "cfgs", path), recursive=True)
    cfg.update(list(opts) + ["seed=0"])
    if cls_args is not None:
        cfg.model.cls_args = dict(cls_args)
    if case == "cls_encoder":
        cfg.model = {"NAME": "BaseCls", "encoder_args": dict(CLS_ENCODER),
                     "cls_args": {"NAME": "ClsHead", "num_classes": 15,
                                  "mlps": [32], "dropout_ratio": 0.0}}
        cfg.dataset.common.num_points = N_CLS
    return cfg


def case_batch(case, cfg):
    """The first training batch of the case's loader (numpy)."""
    if case != "cls_encoder":
        return zoo_batches(cfg, 1)[0]
    loader = tbuild.build_dataloader_from_cfg(4, cfg.dataset, split="train",
                                              seed=0)
    loader.set_epoch(1)
    batch = next(iter(loader))
    return {k: batch[k] for k in ("pos", "x", "y")}


def case_variables(jmodel, batch):
    """Every case's weights: ``draw_variables`` (seed 3) into the case's
    tree."""
    return draw_variables(jmodel, {k: jnp.asarray(v)
                                   for k, v in batch.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervised_step_matches_geot_tpu(case):
    tcfg, jcfg = case_cfg("torch", case), case_cfg("jax", case)
    batch = case_batch(case, tcfg)
    jmodel = jbuild(jcfg.model)
    variables = case_variables(jmodel, batch)
    b64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
           for k, v in batch.items()}
    lr = build_scheduler_from_cfg(tcfg)(1)
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        tx = joptimizer(None, lr=jcfg.lr, **jcfg.optimizer)
        new, m = jmake_step(jmodel, tx, jcfg)(
            JTrainState.create(v64, tx),
            {k: jnp.asarray(v) for k, v in b64.items()},
            jnp.asarray(lr, jnp.float64))
        new, jloss = _np(new), float(m["loss"])
    finally:
        jax.config.update("jax_enable_x64", False)

    state = TrainState.create(tcfg, tcfg.model, seed=0, device="cpu")
    state.model.double()
    state.load(state_from_jax({"params": variables["params"],
                               "batch_stats": variables["batch_stats"]}))
    tm = make_supervised_step(tcfg)(
        state, {k: torch.from_numpy(v) for k, v in b64.items()}, lr)
    rel = _rel(float(tm["loss"]), jloss)

    sd = state.model.state_dict()
    for k, v in params_from_jax({"params": new.params,
                                 "batch_stats": new.batch_stats}).items():
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
        err = float(np.abs(got - ref).max()
                    / max(np.abs(ref).max(), 1e-6 * gmax))
        worst = max(worst, err)
        assert err <= STEP_GRAD_TOL, (k, err)
    print(f"{case} float64 step: loss {float(tm['loss']):.10f} (relative "
          f"{rel:.2e}), worst per-tensor gradient error {worst:.2e}")
    assert np.isfinite(float(tm["loss"]))
    assert rel <= STEP_LOSS_RTOL
    assert state.step == 1
