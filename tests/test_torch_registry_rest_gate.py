"""The trainer's model gate against ``geot_tpu``'s trainer: for each model
combination of the rest of the registry, ``geot_tpu``'s verdict and the
port's are the same.

``geot_tpu``'s verdict is its trainer's path for the combination, traced
abstractly (``jax.eval_shape``: no compile): the model built from the
config and initialised, the state created and the train step its trainer
runs (``make_supervised_step``, or ``make_semi_step`` with the teacher and
the T-predictor initialised on ``(softmax, eye)`` as
``geot_tpu/engine/train.py:335-346`` does) traced on a batch of the
config's loader; for ``task: partseg`` also its ``evaluate`` on logits of
the model's output shape. The port's verdict: ``refuse_unported``
(``parse_and_run`` calls it before it makes a run directory) and, when it
passes, the train state built. Small widths
(``tests/test_supervised_zoo.py``'s ``TINY``; the semi step at
``tests/test_torch_train.py``'s small config).
"""
import os

import pytest

import jax
import jax.numpy as jnp

from geot_tpu.core.config import EasyConfig as JEasyConfig
from geot_tpu.engine import partseg as jpartseg
from geot_tpu.engine.state import SemiTrainState as JSemiTrainState
from geot_tpu.engine.state import TrainState as JTrainState
from geot_tpu.engine.steps import make_semi_step as jmake_semi_step
from geot_tpu.engine.steps import make_supervised_step as jmake_step
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.optim import build_optimizer_from_cfg as joptimizer

from geot_tpu_torch.core.config import EasyConfig
from geot_tpu_torch.data import build as tdata_build
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.state import SemiTrainState, TrainState

from test_supervised_zoo import TINY
from test_torch_heritage_models import heritage_batch
from test_torch_train import CFG, TRAIN_ARGS, batches  # noqa: F401
from test_torch_zoo_models import zoo_batches
from torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = "model.segmentor_args.NAME=PointTransformer_seg"
CLS_ENC = {"NAME": "PointTransformerEncoder", "num_groups": 16,
           "group_size": 8, "encoder_dims": 32, "trans_dim": 48, "depth": 2,
           "num_heads": 4}
MULTI = {"NAME": "MultiSegHead", "num_classes": 50, "shape_classes": 16}

# combination -> (kind, config file, overrides, model replacing the
# config's or None, whether geot_tpu's trainer trains it)
COMBOS = {
    **{f"sup-{w}-{s or 'seg'}": (
        "sup", "tooth_sup/transformer.yaml",
        TINY["transformer.yaml"] + [f"model.NAME={w}", SEG + s], None, True)
       for w in ("WholePartSeg", "WholePartSeg_ntm")
       for s in ("_cluster", "_classifier", "_2classifier")
       + (("_T", "") if w == "WholePartSeg_ntm" else ())},
    "sup-VariableSeg": ("sup", "tooth_sup/pointnet2.yaml",
                        TINY["pointnet2.yaml"] + ["model.NAME=VariableSeg"],
                        None, True),
    "sup-DistillBaseSeg": ("sup", "tooth_sup/pointnet2.yaml",
                           TINY["pointnet2.yaml"]
                           + ["model.NAME=DistillBaseSeg"], None, True),
    "sup-WholePartSeg_ntm-on-BaseSeg-args": (
        "sup", "tooth_sup/pointnet2.yaml",
        TINY["pointnet2.yaml"] + ["model.NAME=WholePartSeg_ntm"], None,
        False),
    "sup-P3Embed-as-decoder": ("sup", "tooth_sup/pointnet2.yaml",
                               TINY["pointnet2.yaml"]
                               + ["model.decoder_args.NAME=P3Embed"], None,
                               False),
    "sup-VariableSegHead-with-mlps": (
        "sup", "tooth_sup/pointnet2.yaml",
        TINY["pointnet2.yaml"] + ["model.cls_args.NAME=VariableSegHead"],
        None, False),
    "sup-PointTransformerEncoder-as-seg-encoder": (
        "sup", "tooth_sup/dgcnn.yaml",
        TINY["dgcnn.yaml"]
        + ["model.encoder_args.NAME=PointTransformerEncoder"], None, False),
    "semi-ntm": ("semi", None, ["model.NAME=WholePartSeg_ntm",
                                "model_t.NAME=WholePartSeg_ntm"], None, True),
    "semi-ntm-U_T_v1": ("semi", None, [
        "model.NAME=WholePartSeg_ntm", "model_t.NAME=WholePartSeg_ntm",
        "criterion_u_args.NAME=Poly1FocalLoss_U_T_v1"], None, True),
    "semi-ntm-cluster": ("semi", None, [
        "model.NAME=WholePartSeg_ntm", "model_t.NAME=WholePartSeg_ntm",
        SEG + "_cluster", "model_t.segmentor_args.NAME="
        "PointTransformer_seg_cluster"], None, False),
    "semi-seg": ("semi", None, [SEG, "model_t.segmentor_args.NAME="
                                "PointTransformer_seg"], None, False),
    "semi-Ins_T": ("semi", None, ["t_predictor.NAME=Ins_T",
                                  "t_predictor.T_args.NAME=sig_t"], None,
                   False),
    "cls-PointTransformerEncoder": (
        "cls", "scanobjectnn/default.yaml", [],
        {"NAME": "BaseCls", "encoder_args": CLS_ENC,
         "cls_args": {"NAME": "ClsHead", "num_classes": 15, "mlps": [32]}},
        True),
    "cls-PointTransformerGenEncoder": (
        "cls", "scanobjectnn/default.yaml", [],
        {"NAME": "BaseCls",
         "encoder_args": dict(CLS_ENC, NAME="PointTransformerGenEncoder"),
         "cls_args": {"NAME": "ClsHead", "num_classes": 15, "mlps": [32]}},
        False),
    "partseg-MultiSegHead": (
        "partseg", "shapenetpart/pointnet2part.yaml",
        ["model.encoder_args.width=8", "model.encoder_args.num_samples=8",
         "model.encoder_args.strides=[4,4]", "model.encoder_args.blocks=[1,1]",
         "dataset.common.multihead=True", "dataset.common.num_points=256",
         "criterion_args.NAME=MultiShapeCrossEntropy",
         "criterion_args.criterion_args.NAME=CrossEntropy"],
        None, False),
}



def combo_cfg(pkg, combo):
    kind, path, opts, model, _ = COMBOS[combo]
    cfg = (JEasyConfig if pkg == "jax" else EasyConfig)()
    if path is None:
        # semi mode: an unlabelled set and its criterion
        cfg.update(dict(CFG, model={"NAME": "WholePartSeg",
                                    "segmentor_args": dict(TRAIN_ARGS)},
                        model_t={"NAME": "WholePartSeg",
                                 "segmentor_args": dict(TRAIN_ARGS)},
                        dataset_u={"common": {
                            "NAME": "TeethSegSemiUDataset"}}))
        assert ttrain.semi_mode(cfg)
    else:
        cfg.load(os.path.join(ROOT, "cfgs", path), recursive=True)
    cfg.update(list(opts) + ["seed=0"])
    if model is not None:
        cfg.model = model
    if kind == "cls":
        cfg.dataset.common.num_points = 128
    if kind == "partseg":
        cfg.model.cls_args = dict(MULTI)
    return cfg


def combo_batch(kind, cfg, semi_batches):
    if kind == "sup":
        return zoo_batches(cfg, 1)[0]
    if kind == "semi":
        return semi_batches[0]
    if kind == "partseg":
        return heritage_batch(cfg)
    loader = tdata_build.build_dataloader_from_cfg(4, cfg.dataset,
                                                   split="train", seed=0)
    loader.set_epoch(1)
    return {k: v for k, v in next(iter(loader)).items()
            if k in ("pos", "x", "y")}


def geot_tpu_trains(kind, jcfg, batch) -> bool:
    """True when ``geot_tpu``'s trainer path for the combination traces."""
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "dropout": key}
    tx = joptimizer(None, lr=jcfg.lr, **jcfg.optimizer)
    try:
        if kind == "semi":
            bl, bu = ({k: jnp.asarray(b[k]) for k in keys} for b, keys in (
                (batch[0], tdata_build.MODEL_KEYS),
                (batch[1], tdata_build.SEMI_KEYS)))
            model = jbuild(jcfg.model)
            model_t = jbuild(jcfg.get("model_t", jcfg.model))
            t_pred = jbuild(jcfg.t_predictor)
            C = int(jcfg.num_classes)
            step = jmake_semi_step(model, model_t, t_pred, tx, tx, jcfg)

            def run(bl, bu):
                v = model.init(rngs, bl)
                t_vars = t_pred.init(key, jax.nn.softmax(
                    jnp.zeros((1, 8, C)), -1), jnp.eye(C))
                st = JSemiTrainState.create(
                    v, tx, t_vars, tx, C, key, teacher_variables=v,
                    contrast_dim=int(jcfg.model.segmentor_args.get(
                        "trans_dim", 384)))
                return step(st, bl, bu, 1e-3, True)

            jax.eval_shape(run, bl, bu)
            return True
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        model = jbuild(jcfg.model)
        step = jmake_step(model, tx, jcfg)

        def run(b):
            st = JTrainState.create(model.init(rngs, b), tx)
            return step(st, b, 1e-3), model.apply(st.variables
                                                  if hasattr(st, "variables")
                                                  else {"params": st.params,
                                                        "batch_stats":
                                                        st.batch_stats}, b)

        _, out = jax.eval_shape(run, jb)
        if kind == "partseg":
            out = out[0] if isinstance(out, (tuple, list)) else out
            jpartseg.evaluate(lambda v, b: jnp.zeros(out.shape, out.dtype),
                              None, [batch], jcfg)
        return True
    except Exception as e:  # noqa: BLE001 - the verdict
        print(f"geot_tpu: {type(e).__name__}: {str(e)[:200]}")
        return False


def port_trains(kind, cfg) -> bool:
    """True when the port's gate passes the combination and its train
    state builds; a refusal names a key of the config."""
    try:
        ttrain.refuse_unported(cfg)
    except NotImplementedError as e:
        key = str(e).split(": ", 1)[1].split("=", 1)[0]
        assert ttrain._get(cfg, key) is not None or key.endswith("NAME"), e
        print(f"port: {e}")
        return False
    if kind == "semi":
        SemiTrainState.create(cfg, seg_args=dict(cfg.model.segmentor_args),
                              device="cpu", model_name=cfg.model.NAME,
                              teacher_name=cfg.model_t.NAME,
                              teacher_args=dict(cfg.model_t.segmentor_args))
    else:
        TrainState.create(cfg, cfg.model, device="cpu")
    return True


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_port_and_geot_tpu_train_the_same_combinations(combo, batches):
    kind, _, _, _, expected = COMBOS[combo]
    jcfg, tcfg = combo_cfg("jax", combo), combo_cfg("torch", combo)
    batch = combo_batch(kind, tcfg, batches)
    assert geot_tpu_trains(kind, jcfg, batch) is expected
    assert port_trains(kind, tcfg) is expected
