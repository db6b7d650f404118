"""The committed flagship checkpoint scored by the port: the trained weights
of ``log/tooth_semi/...-seed42-20260818-020348-c7750aac`` (val mIoU 0.7923,
``docs/RESULTS.md:15``) read through ``geot_tpu``'s ``load_variables``,
converted with ``params_from_jax``, and validated over the whole synthetic
val split (24 scans of 40,000 points, 16,000 sampled) by both packages on
the CPU, with exact kNN in ``geot_tpu``.

Marked ``slow``: a full-size CPU forward takes seconds in the port and
tens of seconds in ``geot_tpu``, and the split is not shrunk. Needs JAX and
``log/``, so it runs on the CPU machine, never on the card's.
"""
import os
import time

os.environ.setdefault("GEOT_EXACT_KNN", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "log", "tooth_semi",
                   "tooth_semi-train-transformer_finetune_fixmatch_ntm-"
                   "seed42-20260818-020348-c7750aac")
CKPT = os.path.join(RUN, "checkpoint_params_only", "base_best_params_only")
# docs/RESULTS.md:15, scored on a TPU v5e. On the CPU with exact kNN,
# geot_tpu itself scores 0.789704 (measured): 0.0026 below it, so the
# bound below is 0.003, not 0.002. Which of the TPU's approximate k = 32
# search and its arithmetic accounts for the gap is not measured.
REPORTED_MIOU = 0.7923


def _recording(step, out):
    def rec(*args):
        logits = step(*args)
        out.append(np.asarray(logits, np.float32))
        return logits
    return rec


@pytest.mark.slow
def test_port_validates_the_committed_checkpoint_as_geot_tpu_does():
    if not os.path.isdir(CKPT):
        pytest.skip(f"checkpoint not present: {CKPT}")
    import jax  # noqa: F401

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

    # the flagship config; the run's cfg.yaml (written by yaml.dump, read
    # here by the port) adds the serving topology flags fast_pyramid and
    # fast_graph, while 0.7923 is the score of the exact topology
    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs", "tooth_semi",
                          "transformer_finetune_fixmatch_ntm.yaml"),
             recursive=True)
    run_cfg = EasyConfig()
    run_cfg.load(os.path.join(RUN, "cfg.yaml"))
    assert run_cfg.seed == 42 and run_cfg.model.segmentor_args.fast_graph
    variables = jload(CKPT, prefer_ema=False)
    jmodel = jbuild(cfg.model.dict())
    tmodel = build_model_from_cfg(cfg.model)
    tmodel.load_state_dict(params_from_jax(variables), strict=True)
    tmodel.eval()
    vcfg = {"num_classes": int(cfg.num_classes), "seed": int(cfg.seed)}
    tf = cfg.datatransforms.dict()
    t_loader = build_dataloader_from_cfg(int(cfg.batch_size_val),
                                         cfg.dataset_l.dict(), None, tf,
                                         split="val", seed=int(cfg.seed))
    j_loader = jdata_build.build_dataloader_from_cfg(
        int(cfg.batch_size_val), cfg.dataset_l.dict(), None, tf,
        split="val", seed=int(cfg.seed))
    assert len(t_loader.dataset) == 24

    t_logits, j_logits = [], []
    t = time.time()
    got = teval.validate(_recording(make_eval_step(), t_logits), tmodel,
                         t_loader, vcfg)
    t_port = time.time() - t
    t = time.time()
    want = jeval.validate(_recording(jmake_eval_step(jmodel), j_logits),
                          variables, j_loader, vcfg)
    t_jax = time.time() - t

    ratios, agree = [], []
    for a, b in zip(t_logits, j_logits):
        for x, y in zip(a, b):                       # one scan each
            p99 = np.percentile(np.abs(y), 99)
            ratios.append(float(np.abs(x - y).max() / p99))
            agree.append(float((x.argmax(-1) == y.argmax(-1)).mean()))
    assert len(ratios) == 24
    print(f"\nport {t_port:.1f} s, geot_tpu {t_jax:.1f} s for the split; "
          f"per-scan max |dlogit| / logit p99: max {max(ratios):.3e}, "
          f"median {np.median(ratios):.3e}; argmax agreement min "
          f"{min(agree):.6f}")
    print(f"whole_miou port {got['whole_miou']!r} geot_tpu "
          f"{want['whole_miou']!r}")
    print({k: abs(got[k] - want[k]) for k in want})
    # bounds: logits 1e-3 of the scan's p99 (measured 2.7e-4); sampled
    # labels agree (measured 1.0 on every scan); the metrics: one point of
    # the 960,000 upsampled ones labelled differently moves whole_miou by
    # 3.3e-6 (measured), from the last bit of a 3-NN distance that XLA on
    # the CPU computes with fused multiply-adds (tests/test_torch_eval.py)
    assert max(ratios) <= 1e-3
    assert min(agree) >= 0.9999
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    for miou in (got["whole_miou"], want["whole_miou"]):
        assert abs(miou - REPORTED_MIOU) <= 0.003
