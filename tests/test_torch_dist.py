"""The port's data parallelism (``parallel/dist.py``, the dp step of
``engine/steps.py``, SyncBN in ``models/layers/common.py``) against
``geot_tpu``'s dp mesh and against one process on the global batch.

Two ranks run over gloo on the CPU (``tests/torch_dist_worker.py``, with
the rendezvous in the environment as ``engine.launch`` sets it), each on
its block (1 + 1 + 1 clouds) of the small semi config's global batch
(2 + 2 + 2, dropout and stochastic depth off), from ``geot_tpu``'s initial
weights. ``geot_tpu`` runs the same global batch through its step over a
``make_mesh(jax.devices()[:2])`` dp-2 mesh (two of the 8 virtual CPU
devices of ``tests/conftest.py``). Tolerances:

- the loss terms against ``geot_tpu``'s dp-2 step: 1e-5 relative, as the
  single-process step is held (``tests/test_torch_train.py``); the pseudo
  label statistics 1e-6; ``ema_t`` and the BatchNorm running statistics
  1e-6 absolute;
- AdamW's first moment (0.1 x the clipped global gradient) tensor by
  tensor against ``geot_tpu``'s: ``GRAD_TOL`` of the tensor's largest
  entry, floored at ``ZERO_GRAD_FLOOR`` of the largest gradient (float32:
  batch-statistics BatchNorm amplifies rounding, as in the single-process
  step; the worst tensor measured 1.0e-2); the updated weights within ``2 * lr`` (one AdamW
  step moves a weight by at most ``lr`` in either package);
- against the port's own single process on the global batch: the loss
  terms 1e-6 relative, the first moments ``GRAD_TOL``;
- the two ranks against each other: bit-equal after every step.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.engine import predict as jpredict
from geot_tpu.parallel import make_mesh, shard_batch, shard_state

from geot_tpu_torch.data import build as tdata_build
from geot_tpu_torch.engine import predict as tpredict
from geot_tpu_torch.engine.convert import params_from_jax, \
    semi_state_from_jax
from geot_tpu_torch.engine.launch import find_free_port
from geot_tpu_torch.engine.state import SemiTrainState
from geot_tpu_torch.engine.steps import make_semi_step
from geot_tpu_torch.optim import build_scheduler_from_cfg

from test_torch_model import N_POINTS, SMALL_ARGS, jax_small_model
from test_torch_train import (CFG, TRAIN_ARGS, _adam_mu, _jax_init,
                              _jax_semi_state, _jbatch, _np_tree, _rel)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
WORLD = 2
STEPS = 2
GRAD_TOL = 5e-2
# a bias followed by BatchNorm has a zero gradient: its float32 value
# (1e-7 to 2e-5 of the largest gradient here) is rounding, so a tensor's
# scale is floored at this share of the largest gradient
ZERO_GRAD_FLOOR = 1e-3


def run_workers(mode, in_path, out_dir, world=WORLD, timeout=300):
    """``world`` ranks of ``torch_dist_worker.py``; returns their
    outputs."""
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(find_free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(in_path), str(out_dir)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def global_batches():
    """``STEPS`` global (labelled, unlabelled) batch pairs of epoch 1 as
    numpy dicts of the keys the step reads."""
    l, u = tdata_build.build_semi_loaders(CFG)
    l.set_epoch(1)
    u.set_epoch(1)
    return [({k: bl[k] for k in tdata_build.MODEL_KEYS},
             {k: bu[k] for k in tdata_build.SEMI_KEYS})
            for bl, bu in tdata_build.semi_pairs(l, u, limit=STEPS)]


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


@pytest.fixture(scope="module")
def runs(global_batches, tmp_path_factory):
    """geot_tpu's dp-2 step, the port's two ranks (``STEPS`` steps) and the
    port's single process (one step), from the same state."""
    tmp = tmp_path_factory.mktemp("dist")
    lr = build_scheduler_from_cfg(CFG)(1)
    init = _jax_init()
    jstate, before, jstep = _jax_semi_state(init)
    mesh = make_mesh(jax.devices()[:WORLD])
    bl, bu = global_batches[0]
    jnew, jm = jstep(shard_state(jstate, mesh),
                     shard_batch(_jbatch(bl, bl), mesh),
                     shard_batch(_jbatch(bu, bu), mesh),
                     jnp.asarray(lr, jnp.float32), True)
    jnew, jm = _np_tree(jnew), _np_tree(jm)

    torch.save({"cfg": dict(CFG), "seg_args": TRAIN_ARGS,
                "state": semi_state_from_jax(before), "lr": lr,
                "batches": [(_torch_batch(a), _torch_batch(b))
                            for a, b in global_batches]}, tmp / "in.pt")
    run_workers("step", tmp / "in.pt", tmp)
    ranks = [[torch.load(tmp / f"rank{r}_step{i}.pt") for i in range(STEPS)]
             for r in range(WORLD)]
    bn = [torch.load(tmp / f"rank{r}_bn.pt") for r in range(WORLD)]

    state = SemiTrainState.create(CFG, seg_args=TRAIN_ARGS, device="cpu")
    state.load(semi_state_from_jax(before))
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    state.model.train()
    with torch.no_grad():
        single_logits = state.model(_torch_batch(bl))[0]
    single_bn = {k: v.clone() for k, v in state.model.state_dict().items()
                 if "running" in k}
    state.model.load_state_dict(saved)
    single_m = make_semi_step(CFG)(state, _torch_batch(bl),
                                  _torch_batch(bu), lr, True)
    return {"jax": (jnew, jm), "ranks": ranks, "bn": bn,
            "single": (state, single_m, single_logits, single_bn),
            "lr": lr}


def test_ranks_are_bit_equal_after_every_step(runs):
    r0, r1 = runs["ranks"]
    for i in range(STEPS):
        for key in ("model", "t_predictor", "exp_avg"):
            assert r0[i][key].keys() == r1[i][key].keys()
            for k, v in r0[i][key].items():
                assert torch.equal(v, r1[i][key][k]), (i, key, k)
        for key in ("ema_t", "contrast"):
            assert torch.equal(r0[i][key], r1[i][key]), (i, key)
        for k, v in r0[i]["metrics"].items():
            assert torch.equal(v, r1[i]["metrics"][k]), (i, k)
    # and they trained: step 2 moved the weights again
    w = "segmentor.seg_head.3.weight"
    assert not torch.equal(r0[0]["model"][w], r0[1]["model"][w])


def test_dp_step_losses_match_geot_tpus_dp_step(runs):
    _, jm = runs["jax"]
    tm = runs["ranks"][0][0]["metrics"]
    for k in ("loss", "sup_loss", "unsup_loss", "threed_loss"):
        print(f"{k}: port dp-2 {float(tm[k]):.8f} geot_tpu dp-2 "
              f"{float(jm[k]):.8f}")
        assert np.isfinite(float(tm[k]))
        assert _rel(tm[k], jm[k]) <= 1e-5, k
    for k in ("over_th", "pseudo_acc", "teacher_acc", "student_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)


def test_dp_step_state_matches_geot_tpus_dp_step(runs):
    jnew, _ = runs["jax"]
    got = runs["ranks"][0][0]
    np.testing.assert_allclose(got["ema_t"].numpy(), jnew.ema_t, rtol=0,
                               atol=1e-6)
    want = params_from_jax({"params": jnew.params,
                            "batch_stats": jnew.batch_stats})
    lr = runs["lr"]
    moved = 0.0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
        elif v.is_floating_point():
            d = float((got["model"][k] - v).abs().max())
            moved = max(moved, d)
            assert d <= 2 * lr, (k, d)
    mu = params_from_jax({"params": _adam_mu(jnew.opt_state),
                          "batch_stats": {}})
    gmax = max(float(v.abs().max()) for v in mu.values())
    worst = 0.0
    for k, v in mu.items():
        scale = max(float(v.abs().max()), ZERO_GRAD_FLOOR * gmax)
        err = float((got["exp_avg"][k] - v).abs().max()) / scale
        worst = max(worst, err)
        assert err <= GRAD_TOL, (k, err)
    print(f"dp-2 vs geot_tpu dp-2: weights within {moved:.3e} (lr {lr}), "
          f"first moments within {worst:.3e} of their scale")


def test_dp_step_matches_one_process_on_the_global_batch(runs):
    state, sm, _, _ = runs["single"]
    got = runs["ranks"][0][0]
    for k in ("loss", "sup_loss", "unsup_loss", "threed_loss"):
        assert _rel(got["metrics"][k], sm[k]) <= 1e-6, k
    worst = 0.0
    gmax = max(float(state.opt.state[p]["exp_avg"].abs().max())
               for p in state.model.parameters())
    for n, p in state.model.named_parameters():
        ref = state.opt.state[p]["exp_avg"]
        scale = max(float(ref.abs().max()), ZERO_GRAD_FLOOR * gmax)
        err = float((got["exp_avg"][n] - ref).abs().max()) / scale
        worst = max(worst, err)
        assert err <= GRAD_TOL, (n, err)
    print(f"dp-2 vs one process: first moments within {worst:.3e}")


def test_batchnorm_takes_the_global_batch_statistics(runs):
    """The ranks' training forward, gathered, against one process's on
    the global batch: logits within 1e-5 of their scale, and every
    BatchNorm's running statistics within 1e-6 on both ranks (equal
    between them)."""
    _, _, logits, bn = runs["single"]
    r0, r1 = runs["bn"]
    assert torch.equal(r0["logits"], r1["logits"])
    scale = float(logits.abs().max())
    diff = float((r0["logits"] - logits).abs().max())
    print(f"SyncBN forward: max |dlogit| {diff:.3e} of {scale:.3f}")
    assert diff <= 1e-5 * scale
    assert r0["buffers"].keys() == bn.keys() and len(bn) > 10
    for k, v in bn.items():
        assert torch.equal(r0["buffers"][k], r1["buffers"][k]), k
        torch.testing.assert_close(r0["buffers"][k], v, rtol=0, atol=1e-6)


def test_seed_is_drawn_on_rank0_after_the_group_starts(tmp_path):
    run_workers("seed", tmp_path / "none", tmp_path)
    got = [json.load(open(tmp_path / f"rank{r}_seed.json"))
           for r in range(WORLD)]
    np.random.seed(100)
    want = int(np.random.randint(1, 10000))
    np.random.seed(101)
    other = int(np.random.randint(1, 10000))
    assert want != other            # the ranks' own draws differ
    assert [g["seed"] for g in got] == [want] * WORLD
    assert all(g["initialized"] for g in got)


def test_predict_stream_over_two_devices_matches_geot_tpu():
    """``predict_stream(devices=["cpu", "cpu"])``: the labels of one device
    and of ``geot_tpu``'s stream over two of its CPU devices, in input
    order."""
    jmodel, variables = jax_small_model(seed=9)
    model = tpredict.load_model(SMALL_ARGS, device="cpu")
    model.load_state_dict(params_from_jax(variables))
    rng = np.random.default_rng(4)
    items = [(f"scan{i}", rng.standard_normal((700 + 37 * i, 3))
              .astype(np.float32), i % 2) for i in range(5)]
    one = list(tpredict.predict_stream(model, items, num_points=N_POINTS))
    two = list(tpredict.predict_stream(model, items, num_points=N_POINTS,
                                       devices=["cpu", "cpu"]))
    ref = list(jpredict.predict_stream(jmodel, variables, items,
                                       num_points=N_POINTS,
                                       devices=jax.devices()[:2]))
    assert [t[0] for t in two] == [t[0] for t in items] == \
        [t[0] for t in ref]
    agree = []
    for a, b, c in zip(one, two, ref):
        np.testing.assert_array_equal(a[2], b[2])
        agree.append((b[2] == np.asarray(c[2])).mean())
    print(f"label agreement with geot_tpu's 2-device stream: {agree}")
    assert min(agree) >= 0.999


def test_serve_round_robins_over_replicas_with_one_devices_labels():
    """``serve`` with a replica on each of two devices answers requests in
    turn from each, with the labels of one device's ``predict_scan``."""
    import urllib.request

    from geot_tpu_torch.engine import serve as tserve

    httpd = tserve.serve(SMALL_ARGS, port=0, device="cpu", warmup=False,
                         num_points=N_POINTS, devices=["cpu", "cpu"])
    try:
        service = httpd.service
        assert len(service.replicas) == 2
        assert service.replicas[0][0] is not service.replicas[1][0]
        url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
        rng = np.random.default_rng(6)
        for i in range(4):
            pts = rng.standard_normal((500 + i, 3)).astype(np.float32)
            buf = __import__("io").BytesIO()
            np.save(buf, pts)
            req = urllib.request.Request(url + "?jaw=lower",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got = json.loads(r.read())["labels"]
            want, _ = tpredict.predict_scan(service.replicas[0][0], pts,
                                            jaw=0, num_points=N_POINTS)
            assert got == tpredict.map_pred_to_fdi(want, 0)
        assert service.scans_served == 4 and service._rr == 4
    finally:
        httpd.shutdown()
        httpd.server_close()
