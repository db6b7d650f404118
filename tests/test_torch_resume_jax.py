"""A run that ``geot_tpu`` checkpointed, resumed by the port: ``geot_tpu``'s
trainer runs one epoch of ``cfgs/tooth_semi/smoke.yaml`` (stochastic depth
and dropout off: the frameworks draw different masks) and saves its whole
state; ``semi_state_from_jax`` carries that state across (weights, both
AdamW states by parameter name, ``ema_t``, ``cm``, ``step``); then both
packages resume to epoch 2 and their epoch-2 scalars are compared."""
import json
import os

os.environ.setdefault("GEOT_EXACT_KNN", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from geot_tpu.engine import train as jtrain  # noqa: E402
from geot_tpu.engine.checkpoint import _restore, discover_checkpoint  # noqa: E402,E501
from geot_tpu_torch.core.config import EasyConfig  # noqa: E402
from geot_tpu_torch.engine import train as ttrain  # noqa: E402
from geot_tpu_torch.engine.checkpoint import save_checkpoint  # noqa: E402
from geot_tpu_torch.engine.convert import semi_state_from_jax  # noqa: E402
from geot_tpu_torch.engine.state import SemiTrainState  # noqa: E402
from torch_helpers import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "cfgs", "tooth_semi", "smoke.yaml")
OPTS = ["model.segmentor_args.drop_path_rate=0.0",
        "model.segmentor_args.head_dropout=0.0", "val_freq=1"]
LOSSES = ("train_loss", "train_loss_l", "train_loss_u", "insT_threed_loss")
# Both resumed epochs start from one state; float32 rounding then makes the
# 12 steps drift apart. Measured on an 8-core x86 CPU: loss terms within
# 2.6e-4 relative (insT_threed_loss; the others 2.2e-5), val metrics within
# 2.4e-3 absolute (val_maxillary_acc), test metrics (the best checkpoint,
# epoch 1's state in both) within 5e-8: after 2 epochs the small
# model's softmax is still close to flat, so a ~1e-6 change of the weights
# moves points between near-tied classes.
LOSS_RTOL = 1e-3
METRIC_ATOL = 5e-3



def _scalars(run_dir, step):
    out = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            if d["step"] == step:
                out[d["tag"]] = d["value"]
    return out


def _only_dir(root):
    dirs = [os.path.join(root, "tooth_semi", d)
            for d in os.listdir(os.path.join(root, "tooth_semi"))]
    assert len(dirs) == 1, dirs
    return dirs[0]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_resume")
    jroot, troot = root / "jax", root / "port"
    jtrain.parse_and_run(["--cfg", SMOKE, "epochs=1", f"root_dir={jroot}",
                          *OPTS])
    jdir = _only_dir(jroot)
    jlatest = discover_checkpoint(jdir, "latest")
    payload = _restore(jlatest)
    tree = payload["state"]

    # the same state as a port checkpoint, in a run directory of its own
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    cfg.update(OPTS)
    state = SemiTrainState.create(cfg, seg_args=dict(
        cfg.model.segmentor_args), device="cpu")
    converted = semi_state_from_jax(tree)
    state.load(converted)
    run_dir = troot / "tooth_semi" / "from-geot_tpu"
    extra = {k: float(v) for k, v in payload["extra"].items()
             if k != "ema_selected"}
    extra["epoch"] = int(extra["epoch"])
    # epoch 1 validated best there, so it is the best checkpoint here too
    tlatest = save_checkpoint({"ckpt_dir": str(run_dir / "checkpoint"),
                               "run_name": "from-geot_tpu"}, state,
                              int(payload["epoch"]), additional_dict=extra,
                              is_best=True)

    jtrain.parse_and_run(["--cfg", SMOKE, "mode=resume",
                          f"pretrained_path={jlatest}", "epochs=2",
                          f"root_dir={jroot}", *OPTS])
    tres = ttrain.parse_and_run(["--cfg", SMOKE, "mode=resume",
                                 f"pretrained_path={tlatest}", "epochs=2",
                                 f"root_dir={troot}", "device=cpu", *OPTS])
    return {"tree": tree, "converted": converted, "state": state,
            "jdir": jdir, "tdir": str(run_dir), "tres": tres}


def test_the_whole_state_carries_across(resumed):
    tree, state = resumed["tree"], resumed["state"]
    assert state.step == int(tree["step"]) == 12
    assert torch.equal(state.cm, torch.from_numpy(np.asarray(
        tree["cm"], np.float32)))
    named = dict(state.model.named_parameters())
    for key, opt, module in (("opt", state.opt, state.model),
                             ("t_opt", state.t_opt, state.t_predictor)):
        moments = resumed["converted"][key]
        params = dict(module.named_parameters())
        assert set(moments["exp_avg"]) == set(params)
        assert moments["step"] == 12
        for name, p in params.items():
            st = opt.state[p]
            assert float(st["step"]) == 12.0
            assert torch.equal(st["exp_avg"], moments["exp_avg"][name])
            assert torch.equal(st["exp_avg_sq"], moments["exp_avg_sq"][name])
    # a parameter's moments are its own: the Dense kernel (in, out) of
    # reduce_dim is the Linear weight (out, in)
    mu = tree["opt_state"]["inner_state"]["0"]["mu"]["segmentor"]
    p = named["segmentor.reduce_dim.weight"]
    np.testing.assert_array_equal(state.opt.state[p]["exp_avg"].numpy(),
                                  np.asarray(mu["reduce_dim"]["kernel"]).T)


def test_resumed_epoch_tracks_geot_tpu(resumed):
    j = _scalars(resumed["jdir"], 2)
    t = _scalars(resumed["tdir"], 2)
    worst = {}
    for tag in LOSSES:
        worst[tag] = abs(t[tag] - j[tag]) / abs(j[tag])
        assert worst[tag] <= LOSS_RTOL, (tag, t[tag], j[tag])
    for tag in ("th_percentage", "train_over_th_acc", "teacher_acc",
                "student_acc"):
        assert abs(t[tag] - j[tag]) <= 100 * METRIC_ATOL, tag
    metrics = [k for k in j if k.startswith(("val_", "best_val_",
                                             "test_"))]
    assert len(metrics) >= 20
    for tag in metrics:
        worst[tag] = abs(t[tag] - j[tag])
        assert worst[tag] <= METRIC_ATOL, (tag, t[tag], j[tag])
    assert t["lr"] == np.float32(j["lr"])    # geot_tpu's lr is float32
    print("epoch 2, |port - geot_tpu| (losses relative):",
          {k: f"{v:.2e}" for k, v in worst.items() if v})
    assert resumed["tres"]["best"]["epoch"] in (1, 2)
