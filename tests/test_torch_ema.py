"""The EMA evaluation shadow (``ema_eval``) and the non-finite guard
(``skip_nonfinite_updates``) of the port: the shadow against a host
reference and against ``geot_tpu``, the evaluation view, checkpoints and
``load_variables(prefer_ema)``, a resume from a checkpoint without a
shadow, the trainer's choice of the raw weights when they validate better;
a skipped step leaves the whole state bit-equal (as
``tests/test_nonfinite_guard.py`` holds ``geot_tpu``'s) and the next clean
step trains."""
import json
import os

import numpy as np
import pytest
import torch

import jax

from geot_tpu_torch.engine import checkpoint as ckpt
from geot_tpu_torch.engine import train as ttrain
from geot_tpu_torch.engine.convert import params_from_jax
from geot_tpu_torch.engine.state import SemiTrainState
from geot_tpu_torch.engine.steps import make_semi_step, make_supervised_step

from test_torch_semi_branches import (CFG, CONTRAST, SEG, batches,
                                      check_f64, jax_init, run_both)
# one torch thread (the autouse fixture of test_torch_trainer.py)
from test_torch_trainer import (_flat, _run, _run_dir,  # noqa: F401
                                one_torch_thread)

DECAY = 0.9


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _state(extra=None, seed=0):
    return SemiTrainState.create(dict(CFG, **(extra or {})), seg_args=SEG,
                                 seed=seed, device="cpu")


# --- the shadow -----------------------------------------------------------------

def test_shadow_follows_the_host_reference_over_three_steps():
    """After each of 3 steps the shadow is ``e * 0.9 + p * 0.1`` of the
    student's new weights, each product rounded to float32 and the
    constants those of ``geot_tpu`` (``0.9`` and ``1 - 0.9`` rounded to
    float32), bit for bit; it starts
    as a copy of the initial weights, and is not the student's tensors."""
    cfg = dict(CFG, ema_eval=DECAY)
    state = _state({"ema_eval": DECAY})
    params = dict(state.model.named_parameters())
    assert set(state.ema_params) == set(params)
    ref = {k: v.detach().numpy().copy() for k, v in params.items()}
    for k, v in state.ema_params.items():
        assert v.data_ptr() != params[k].data_ptr()
        np.testing.assert_array_equal(v.numpy(), ref[k])
    bl, bu = (_tensors(b) for b in batches())
    step = make_semi_step(cfg)
    d = np.float32(DECAY)
    for _ in range(3):
        step(state, bl, bu, 1e-3, True)
        for k, p in params.items():
            ref[k] = (ref[k] * d
                      + p.detach().numpy() * np.float32(1.0 - DECAY))
            np.testing.assert_array_equal(state.ema_params[k].numpy(),
                                          ref[k], err_msg=k)
    moved = [k for k in params if not torch.equal(params[k],
                                                  state.ema_params[k])]
    assert len(moved) > 0.5 * len(params)


def test_shadow_matches_geot_tpu():
    """One step with ``ema_eval``, in float64 (loss terms 1e-6 relative,
    first moments 1e-5 of each tensor's scale): each package's shadow is
    ``0.9 e0 + 0.1 p`` of its own new weights to 1e-15. The shadows are
    not compared element by element: one AdamW step moves a weight by ~lr
    x g / |g|, which turns the last digits of a near-zero gradient into a
    visible difference of the weight."""
    init = jax_init()
    jax.config.update("jax_enable_x64", True)
    try:
        jnew, jm, state, tm = run_both({"ema_eval": DECAY}, init, x64=True)
    finally:
        jax.config.update("jax_enable_x64", False)
    check_f64(jnew, jm, state, tm, ("threed_loss",))
    e0 = params_from_jax({"params": init[1]["params"], "batch_stats": {}})
    jp = params_from_jax({"params": jnew.params, "batch_stats": {}})
    je = params_from_jax({"params": jnew.ema_params, "batch_stats": {}})
    tp = dict(state.model.named_parameters())
    assert set(je) == set(state.ema_params) == set(e0)
    for k in e0:
        base = e0[k].double() * DECAY
        torch.testing.assert_close(je[k], base + jp[k] * (1 - DECAY),
                                   rtol=0, atol=1e-15)
        torch.testing.assert_close(state.ema_params[k],
                                   base + tp[k].detach() * (1 - DECAY),
                                   rtol=0, atol=1e-15)


def test_supervised_step_updates_the_shadow():
    state = _state({"ema_eval": DECAY})
    before = {k: v.clone() for k, v in state.ema_params.items()}
    bl, _ = (_tensors(b) for b in batches())
    make_supervised_step(dict(CFG, ema_eval=DECAY))(state, bl, 1e-3)
    assert any(not torch.equal(before[k], v)
               for k, v in state.ema_params.items())
    # the trainer's warm-up passes ema_eval=None: the shadow stays
    before = {k: v.clone() for k, v in state.ema_params.items()}
    make_supervised_step(dict(CFG, ema_eval=None))(state, bl, 1e-3)
    assert all(torch.equal(before[k], v)
               for k, v in state.ema_params.items())


def test_eval_model_is_the_shadow_with_live_batch_statistics():
    state = _state({"ema_eval": DECAY})
    bl, bu = (_tensors(b) for b in batches())
    make_semi_step(dict(CFG, ema_eval=DECAY))(state, bl, bu, 1e-3, True)
    view = state.eval_model()
    assert view is not state.model
    for k, v in view.named_parameters():
        assert torch.equal(v, state.ema_params[k]), k
    live = dict(state.model.named_buffers())
    for k, v in view.named_buffers():
        assert torch.equal(v, live[k]), k
    plain = _state()
    assert plain.ema_params == {} and plain.eval_model() is plain.model


# --- checkpoints ------------------------------------------------------------------

def test_checkpoint_round_trip_and_prefer_ema(tmp_path):
    state = _state({"ema_eval": DECAY})
    bl, bu = (_tensors(b) for b in batches())
    make_semi_step(dict(CFG, ema_eval=DECAY, **CONTRAST))(state, bl, bu,
                                                          1e-3, True)
    cfg = {"ckpt_dir": str(tmp_path), "run_name": "r"}
    for extra, want_ema in (({"ema_selected": 1.0}, True),
                            ({"ema_selected": 0.0}, False), ({}, True)):
        path = ckpt.save_checkpoint(cfg, state, 3, additional_dict=extra)
        fresh = _state({"ema_eval": DECAY}, seed=5)
        assert ckpt.load_checkpoint(path, fresh) == (3, extra)
        a, b = _flat(state.state_dict()), _flat(fresh.state_dict())
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, b[k]), k
        assert int(fresh.contrast.ptr) == int(state.contrast.ptr) > 0
        ema = {**state.model.state_dict(), **state.ema_params}
        raw = state.model.state_dict()
        for prefer, want in ((True, ema), (False, raw),
                             ("auto", ema if want_ema else raw)):
            got = ckpt.load_variables(path, prefer)
            assert got.keys() == raw.keys()
            for k in got:
                assert torch.equal(got[k], want[k]), (prefer, k)
    # a state without a shadow drops a saved one
    plain = _state(seed=6)
    ckpt.load_checkpoint(path, plain)
    assert plain.ema_params == {}


def test_a_checkpoint_without_the_bank_or_the_shadow_still_loads(tmp_path):
    state = _state()
    path = ckpt.save_checkpoint({"ckpt_dir": str(tmp_path)}, state, 1)
    payload = torch.load(path, weights_only=True)
    del payload["state"]["contrast"], payload["state"]["ema_params"]
    torch.save(payload, path)
    fresh = _state({"ema_eval": DECAY}, seed=3)
    missing = []
    ckpt.load_checkpoint(path, fresh, missing_fields=missing)
    assert set(missing) == {"contrast", "ema_params"}
    assert int(fresh.contrast.ptr) == 0


# --- the trainer ----------------------------------------------------------------

def test_resume_from_a_checkpoint_without_a_shadow(tmp_path, monkeypatch):
    """A run without ``ema_eval`` resumed with it: the shadow is seeded
    from the restored weights, then trained and saved."""
    _run(tmp_path, "epochs=1", "val_freq=1")
    latest = ckpt.discover_checkpoint(_run_dir(tmp_path), "latest")
    saved = torch.load(latest, weights_only=True)["state"]
    assert saved["ema_params"] == {}
    seeded = []
    real = SemiTrainState.seed_ema

    def recording(self):
        real(self)
        seeded.append({k: v.clone() for k, v in self.ema_params.items()})

    monkeypatch.setattr(SemiTrainState, "seed_ema", recording)
    _run(tmp_path, "mode=resume", f"pretrained_path={latest}", "epochs=2",
         "ema_eval=0.99", "val_freq=1")
    # one at creation (fresh weights), one from the restored ones
    assert len(seeded) == 2
    for k, v in seeded[1].items():
        assert torch.equal(v, saved["model"][k]), k
    assert any(not torch.equal(v, saved["model"][k])
               for k, v in seeded[0].items())
    after = torch.load(latest, weights_only=True)
    assert after["epoch"] == 2 and after["state"]["ema_params"]


def test_raw_weights_win_when_they_validate_better(tmp_path, monkeypatch):
    """``val`` scores the shadow, ``val_raw`` the student; when the raw
    weights score higher they are the best candidate (``ema_selected``
    0.0) and the test pass loads them from the best checkpoint."""
    real = ttrain.validate
    seen = []

    def fake(step, model, loader, cfg, logger, tag="val", **kw):
        res = real(step, model, loader, cfg, logger, tag=tag, **kw)
        seen.append((tag, {k: v.clone() for k, v in
                           model.state_dict().items()}))
        bump = {"val": 0.1, "val_raw": 0.2}.get(tag, 0.0)
        return dict(res, whole_miou=bump)

    monkeypatch.setattr(ttrain, "validate", fake)
    res = _run(tmp_path, "epochs=1", "val_freq=1", "test_freq=1",
               "ema_eval=0.9")
    assert [t for t, _ in seen] == ["val", "val_raw", "test"]
    assert res["best"]["ema_selected"] == 0.0
    assert res["best"]["miou"] == 0.2 and res["val_raw"]["whole_miou"] == 0.2
    best = ckpt.discover_checkpoint(_run_dir(tmp_path), "best")
    raw = torch.load(best, weights_only=True)["state"]["model"]
    test_sd = seen[2][1]
    for k, v in raw.items():
        assert torch.equal(test_sd[k], v), k
    # the shadow's tree differs from the raw one that was tested
    ema = torch.load(best, weights_only=True)["state"]["ema_params"]
    assert any(not torch.equal(v, raw[k]) for k, v in ema.items())
    with open(os.path.join(_run_dir(tmp_path), "scalars.jsonl")) as f:
        text = f.read()
    assert '"val_raw_whole_miou"' in text


# --- the non-finite guard -----------------------------------------------------------

def _poisoned(b):
    b = {k: v.copy() for k, v in b.items()}
    key = "pos_s" if "pos_s" in b else "pos"
    b[key][0, 0, 0] = np.inf
    return b


def _assert_bit_equal(a, b, skip=("step", "generator")):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if k in skip:
            continue
        if isinstance(v, torch.Tensor):
            assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def _snapshot(state):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat(state.state_dict()).items()}


@pytest.mark.parametrize("kind", ["semi", "supervised"])
def test_a_nonfinite_step_is_skipped_whole(kind):
    """With ``skip_nonfinite_updates``, a batch holding an inf gives
    ``skipped`` 1 and a reported loss 0, and leaves the weights, both
    AdamW states (step counts too), the BatchNorm buffers, ``ema_t``, the
    bank and the EMA shadow bit-equal; ``step`` advances; the next clean
    step trains."""
    cfg = dict(CFG, skip_nonfinite_updates=True, ema_eval=DECAY,
               use_feat_loss=True, feat_k=4, use_identity_loss=True,
               **CONTRAST)
    state = _state(cfg)
    bl, bu = batches()
    if kind == "semi":
        step = make_semi_step(cfg)

        def run(poison):
            return step(state, _tensors(bl), _tensors(
                _poisoned(bu) if poison else bu), 1e-3, True)
    else:
        step = make_supervised_step(cfg)

        def run(poison):
            return step(state, _tensors(_poisoned(bl) if poison else bl),
                        1e-3)
    m = run(False)                       # AdamW states exist from here
    assert float(m["skipped"]) == 0.0
    before = _snapshot(state)
    m = run(True)
    assert float(m["skipped"]) == 1.0 and float(m["loss"]) == 0.0
    assert state.step == 2
    _assert_bit_equal(before, _flat(state.state_dict()))
    m = run(False)
    assert float(m["skipped"]) == 0.0 and np.isfinite(float(m["loss"]))
    after = _flat(state.state_dict())
    moved = [k for k, v in before.items() if isinstance(v, torch.Tensor)
             and k not in ("step",) and not torch.equal(v, after[k])]
    assert any(k.startswith("model/") for k in moved)
    assert any(k.startswith("ema_params/") for k in moved)
    assert any(k.startswith("opt/state/") for k in moved)
    if kind == "semi":
        assert any(k.startswith(("ema_t", "contrast/")) for k in moved)


def test_without_the_guard_a_nonfinite_step_poisons_the_state():
    """The guard's counterpart: the same batch without the switch leaves
    non-finite weights (so the guard's test is not vacuous)."""
    state = _state()
    bl, bu = batches()
    make_semi_step(CFG)(state, _tensors(bl), _tensors(_poisoned(bu)), 1e-3,
                        True)
    assert not all(bool(torch.isfinite(p).all())
                   for p in state.model.parameters())


def test_trainer_counts_skipped_steps(tmp_path, monkeypatch):
    """The epoch's skipped steps are logged and written as
    ``skipped_steps``."""
    real = ttrain.make_semi_step

    def poisoning(cfg):
        step = real(cfg)
        calls = []

        def run(state, bl, bu, lr, use_teacher):
            calls.append(1)
            if len(calls) == 2:
                bu = dict(bu, pos_s=bu["pos_s"].clone())
                bu["pos_s"][0, 0, 0] = float("inf")
            return step(state, bl, bu, lr, use_teacher)
        return run

    monkeypatch.setattr(ttrain, "make_semi_step", poisoning)
    _run(tmp_path, "epochs=1", "val_freq=0", "test_freq=0",
         "skip_nonfinite_updates=True")
    with open(os.path.join(_run_dir(tmp_path), "scalars.jsonl")) as f:
        tags = {d["tag"]: d["value"] for d in map(json.loads, f)}
    assert tags["skipped_steps"] == 1
