"""The package surfaces against ``geot_tpu``'s: the ``__all__`` of
``core``, ``engine``, ``losses``, ``optim``, ``models`` and ``parallel``
name for name (``parallel``'s mesh names wait for ``tp`` / ``sp`` /
``fsdp`` and are the one named exception), and the keywords and names the
port added to match them, each held against ``geot_tpu``'s behaviour."""
import argparse
import importlib
import json
import logging
import os
import random
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import geot_tpu.core as jcore
import geot_tpu.engine as jengine
import geot_tpu.losses as jlosses
import geot_tpu.optim as joptim
import geot_tpu.parallel as jparallel
from geot_tpu.core.config import EasyConfig as JConfig
from geot_tpu.engine import profiler as jprofiler

import geot_tpu_torch.core as tcore
import geot_tpu_torch.engine as tengine
import geot_tpu_torch.losses as tlosses
import geot_tpu_torch.optim as toptim
import geot_tpu_torch.parallel as tparallel
from geot_tpu_torch.core.config import EasyConfig
from geot_tpu_torch.engine import profiler as tprofiler
from geot_tpu_torch.optim.factory import Ctx

# parallel/mesh.py's sharding names: the tp / sp / fsdp axes, not ported
MESH_NAMES = {"auto_mesh", "make_mesh", "param_sharding_rules",
              "shard_batch", "shard_params", "shard_state"}
PACKAGES = ("core", "engine", "losses", "optim", "models", "parallel")


@pytest.mark.parametrize("name", PACKAGES)
def test_all_names_geot_tpus(name):
    want = set(importlib.import_module(f"geot_tpu.{name}").__all__)
    port = importlib.import_module(f"geot_tpu_torch.{name}")
    got = set(port.__all__)
    if name == "parallel":
        assert MESH_NAMES <= want
        want -= MESH_NAMES
    assert got == want, (sorted(want - got), sorted(got - want))
    for n in port.__all__:
        assert getattr(port, n) is not None, n


@pytest.mark.parametrize("v", ["yes", "True", "t", "Y", "1", "no", "FALSE",
                               "f", "n", "0", True, False, "maybe", ""])
def test_str2bool(v):
    def outcome(fn):
        try:
            return fn(v)
        except argparse.ArgumentTypeError as e:
            return type(e), str(e)

    assert outcome(tcore.str2bool) == outcome(jcore.str2bool)


@pytest.mark.parametrize("deterministic", [False, True])
def test_set_random_seed(deterministic, monkeypatch):
    """The same global draws after either package seeds; ``deterministic``
    also turns on torch's deterministic algorithms (warning where one has
    none), cuDNN's flags and the cuBLAS workspace that deterministic
    cuBLAS needs."""
    # unset, and set back to what it was when the test ends
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    draws = []
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        for fn in (jcore.set_random_seed, tcore.set_random_seed):
            assert fn(17, deterministic=deterministic) == 17
            draws.append((random.random(), np.random.random()))
        assert draws[1] == draws[0]
        assert torch.initial_seed() == 17
        flags = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled(),
                 torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        assert flags == ((True, True, True, False) if deterministic
                         else before)
        assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == (
            ":4096:8" if deterministic else None)
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]
        torch.backends.cudnn.benchmark = before[3]


@pytest.mark.parametrize("additional_id", [None, "run7"])
def test_generate_exp_directory(tmp_path, additional_id):
    names = []
    for pkg, cfg in ((jcore, JConfig()), (tcore, EasyConfig())):
        cfg.root_dir = str(tmp_path / pkg.__name__)
        run_dir = pkg.generate_exp_directory(cfg, ["a", "", "b"],
                                             additional_id=additional_id)
        assert run_dir == cfg.run_dir
        assert os.path.isdir(cfg.ckpt_dir)
        assert cfg.log_path == os.path.join(run_dir,
                                            f"{cfg.run_name}.log")
        names.append(cfg.run_name)
    tail = "" if additional_id is None else f"-{additional_id}"
    for name in names:
        assert re.fullmatch(r"a-b-\d{8}-\d{6}-[0-9a-f]{8}" + tail, name)


def test_setup_logger_dist_takes_a_name(tmp_path):
    seen = []
    for pkg in (jcore, tcore):
        for rank in (0, 1):
            log = tmp_path / f"{pkg.__name__}{rank}" / "x.log"
            root = pkg.setup_logger_dist(str(log), rank, name="other")
            seen.append((root is logging.getLogger(), root.level,
                         len(root.handlers), log.parent.exists()))
    assert seen[2:] == seen[:2]
    logging.getLogger().handlers.clear()


def test_step_timer_window(tmp_path, monkeypatch):
    ticks = [1.0, 1.5, 3.5, 4.0, 4.25]
    outs = []
    for mod in (jprofiler, tprofiler):
        times = iter(ticks)
        monkeypatch.setattr(mod.time, "time", lambda: next(times))
        path = tmp_path / f"{mod.__name__}.jsonl"
        timer = mod.StepTimer(str(path), window=2)
        means = []
        for step in range(5):
            timer.tick(step, lr=0.1)
            means.append(timer.mean)
        timer.close()
        outs.append((means, timer.window, [
            json.loads(line) for line in path.read_text().splitlines()]))
    assert outs[1] == outs[0]
    assert outs[0][0][-1] == pytest.approx(0.375)


def test_dist_info_and_free_port():
    assert tparallel.get_dist_info() == jparallel.get_dist_info() == (0, 1)
    port = tparallel.find_free_port()
    assert isinstance(port, int) and 0 < port < 65536


def test_loss_aliases():
    assert tlosses.Idenyity_loss is tlosses.identity_loss
    assert tlosses.threeD_space_loss is tlosses.threed_space_loss
    assert jlosses.Idenyity_loss is jlosses.identity_loss


def test_engine_names():
    np.testing.assert_array_equal(tengine.LABEL_PROJ, jengine.LABEL_PROJ)
    probs = np.random.default_rng(0).dirichlet(np.ones(5), (2, 30)) \
        .astype(np.float32)
    got = tengine.estimate_class_T(torch.from_numpy(probs))
    want = jengine.estimate_class_T(jnp.asarray(probs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_adahessian_transform_matches_optax():
    """``optim.adahessian(...)`` with its own learning rate and decay: three
    updates of two tensors from the same gradients and Hessian diagonals
    as ``geot_tpu``'s optax transform."""
    rng = np.random.default_rng(3)
    shapes = ((4, 3), (5,))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=0.05, b1=0.8, b2=0.99, eps=1e-6,
              weight_decay=0.01, hessian_power=0.5)
    jtx = joptim.adahessian(**kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    ttx = toptim.adahessian(**kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstates = [ttx.init(p) for p in tp]
    for count in (1, 2, 3):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        h = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        ju, jstate = jtx.update([jnp.asarray(a) for a in g], jstate, jp,
                                hessian_diag=[jnp.asarray(a) for a in h])
        jp = [p + u for p, u in zip(jp, ju)]
        tu = ttx.update([torch.from_numpy(a) for a in g], tp, tstates,
                        Ctx(count=count, lr=1.0, wd=[0.0, 0.0],
                            axes=[None, None],
                            hessian=[torch.from_numpy(a) for a in h]))
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                       atol=1e-7)
