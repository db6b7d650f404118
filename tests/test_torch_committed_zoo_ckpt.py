"""The two committed supervised-zoo checkpoints scored by both packages: the
trained weights of ``log/tooth_sup/*pointnet2*`` and ``*dgcnn*``
(``log/tooth_sup/ZOO.md``: test whole mIoU 0.7780 and 0.7910, scored on
a TPU v5e) read through ``geot_tpu``'s ``load_variables``, converted with
``params_from_jax``, and validated over the whole synthetic test split
(24 scans of 40,000 points, 16,000 sampled) by both packages on the CPU,
with exact kNN in ``geot_tpu``.

Marked ``slow``: DGCNN's k = 20 searches over 16,000 points take minutes
on the CPU, and the split is not shrunk. Needs JAX and ``log/``, so it runs
on the CPU machine, never on the card's.
"""
import glob
import os

os.environ.setdefault("GEOT_EXACT_KNN", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# log/tooth_sup/ZOO.md, scored on a TPU v5e with approximate kNN
ZOO_MIOU = {"pointnet2": 0.7780, "dgcnn": 0.7910}


def _recording(step, out):
    def rec(*args):
        logits = step(*args)
        out.append(np.asarray(logits, np.float32))
        return logits
    return rec


@pytest.mark.slow
@pytest.mark.parametrize("model", ["pointnet2", "dgcnn"])
def test_port_scores_the_committed_zoo_checkpoint_as_geot_tpu_does(model):
    runs = glob.glob(os.path.join(ROOT, "log", "tooth_sup", f"*{model}*"))
    ckpts = [os.path.join(r, "checkpoint", f"{model}_sup_best_params_only")
             for r in runs]
    ckpts = [c for c in ckpts if os.path.isdir(c)]
    if not ckpts:
        pytest.skip(f"no committed {model} checkpoint under log/tooth_sup")
    (ckpt,) = ckpts
    run = os.path.dirname(os.path.dirname(ckpt))
    import torch

    from geot_tpu.core.config import EasyConfig as JEasyConfig
    from geot_tpu.data import build as jdata_build
    from geot_tpu.engine import eval as jeval
    from geot_tpu.engine.checkpoint import load_variables as jload
    from geot_tpu.engine.steps import make_eval_step as jmake_eval_step
    from geot_tpu.models import build_model_from_cfg as jbuild
    from geot_tpu_torch.core.config import EasyConfig, build_model_from_cfg
    from geot_tpu_torch.data.build import build_dataloader_from_cfg
    from geot_tpu_torch.engine import eval as teval
    from geot_tpu_torch.engine.convert import params_from_jax
    from geot_tpu_torch.engine.steps import make_eval_step

    # the run's own cfg.yaml (written by yaml.dump), read by each package
    cfg, jcfg = EasyConfig(), JEasyConfig()
    cfg.load(os.path.join(run, "cfg.yaml"))
    jcfg.load(os.path.join(run, "cfg.yaml"))
    assert cfg.seed == 42 and cfg.model.NAME == "BaseSeg"
    variables = jload(ckpt, prefer_ema=False)
    jmodel = jbuild(jcfg.model)
    tmodel = build_model_from_cfg(cfg.model)
    tmodel.load_state_dict(params_from_jax(variables), strict=True)
    tmodel.eval()
    vcfg = {"num_classes": int(cfg.num_classes), "seed": int(cfg.seed)}
    tf = cfg.datatransforms.dict()
    bs = int(cfg.batch_size_test)
    t_loader = build_dataloader_from_cfg(bs, cfg.dataset_l.dict(), None, tf,
                                         split="test", seed=int(cfg.seed))
    j_loader = jdata_build.build_dataloader_from_cfg(
        bs, cfg.dataset_l.dict(), None, tf, split="test",
        seed=int(cfg.seed))
    assert len(t_loader.dataset) == 24

    t_logits, j_logits = [], []
    with torch.no_grad():
        got = teval.validate(_recording(make_eval_step(), t_logits), tmodel,
                             t_loader, vcfg)
    want = jeval.validate(_recording(jmake_eval_step(jmodel), j_logits),
                          variables, j_loader, vcfg)
    agree = [float((x.argmax(-1) == y.argmax(-1)).mean())
             for a, b in zip(t_logits, j_logits) for x, y in zip(a, b)]
    assert len(agree) == 24
    print(f"\n{model}: whole_miou port {got['whole_miou']!r} geot_tpu "
          f"{want['whole_miou']!r} (ZOO.md {ZOO_MIOU[model]}: port "
          f"{got['whole_miou'] - ZOO_MIOU[model]:+.6f}); argmax agreement "
          f"min {min(agree):.6f}")
    print({k: abs(got[k] - want[k]) for k in want})
    assert min(agree) >= 0.999
    assert abs(got["whole_miou"] - want["whole_miou"]) <= 1e-4
