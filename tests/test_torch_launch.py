"""The port's launcher (``engine/launch.py``) and the trainer under two
ranks: the launcher's argument errors against ``geot_tpu``'s, fail-fast,
and a two-rank resume over gloo on the CPU (``--devices-per-proc 1``) of a
smoke run that one process trained, with only rank 0 writing scalars,
step times and checkpoints, and every rank holding the same state at the
start and after each step (``GEOT_LOG_STEP_LOSS``, the trainer checks it)."""
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from geot_tpu.engine import launch as jlaunch

from geot_tpu_torch import ops
from geot_tpu_torch.data import tooth_semi as tdata
from geot_tpu_torch.engine import launch as tlaunch
from geot_tpu_torch.engine import train as ttrain

from test_torch_io import write_teeth3ds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "cfgs", "tooth_semi", "smoke.yaml")

ARG_CASES = {
    "no_training_command": ["--nprocs", "1"],
    "nodes_without_coordinator": ["--nprocs", "1", "--nnodes", "2", "--",
                                  "--cfg", "x.yaml"],
    "nodes_without_run_dir": ["--nprocs", "1", "--nnodes", "2",
                              "--coordinator", "h0:1", "--", "--cfg",
                              "x.yaml"],
}


@pytest.mark.parametrize("case", sorted(ARG_CASES))
def test_launcher_argument_errors_match_geot_tpu(case, capsys):
    argv = ARG_CASES[case]
    with pytest.raises(SystemExit) as jexit:
        jlaunch.main(argv)
    jerr = capsys.readouterr().err
    with pytest.raises(SystemExit) as texit:
        tlaunch.main(argv)
    terr = capsys.readouterr().err
    assert jexit.value.code == texit.value.code == 2
    assert jerr.splitlines()[-1].split("error: ")[1] == \
        terr.splitlines()[-1].split("error: ")[1]


def test_a_rank_is_one_device(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["--nprocs", "2", "--devices-per-proc", "4", "--",
                      "--cfg", SMOKE])
    assert "N must be 1" in capsys.readouterr().err


def test_launch_failfast_kills_group(tmp_path):
    """Ranks that die at once take the group down with a nonzero exit
    instead of leaving a rank waiting in the rendezvous."""
    rc = tlaunch.main(["--nprocs", "2", "--devices-per-proc", "1",
                       "--run-dir", str(tmp_path / "r"), "--",
                       "--cfg", "cfgs/does_not_exist.yaml"])
    assert rc != 0
    assert os.path.exists(tmp_path / "r" / "rank1.log")


def _scalars(run_dir, tag):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["tag"] == tag]


def test_two_rank_resume_writes_once_and_keeps_the_ranks_equal(tmp_path):
    """One process trains the smoke config for an epoch on a Teeth3DS tree
    of 8 small scans (4 labelled: 2 steps of 2 + 2 + 2 an epoch); two ranks
    resume it to epoch 2 through the launcher."""
    root = str(tmp_path / "teeth3ds")
    write_teeth3ds(root, [(f"P{i:03d}", i % 2,
                           *tdata._synthetic_scan(40 + i, 600))
                          for i in range(8)])
    data = [f"dataset_l.common.data_root={root}",
            f"dataset_u.common.data_root={root}"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ttrain.parse_and_run(["--cfg", SMOKE, f"root_dir={tmp_path / 'a'}",
                              "device=cpu", "epochs=1", "seed=5", *data])
    finally:
        torch.set_num_threads(n)
    (run_a,) = glob.glob(str(tmp_path / "a" / "tooth_semi" / "*"))
    latest = glob.glob(os.path.join(run_a, "checkpoint", "*latest.pth"))[0]
    assert len(_scalars(run_a, "train_loss")) == 1

    run_b = tmp_path / "b"
    proc = subprocess.run(
        [sys.executable, "-m", "geot_tpu_torch.engine.launch", "--nprocs",
         "2", "--devices-per-proc", "1", "--run-dir", str(run_b), "--",
         "--cfg", SMOKE, "mode=resume", f"pretrained_path={latest}",
         "epochs=2", "seed=5", *data],
        cwd=ROOT, timeout=600, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", GEOT_LOG_STEP_LOSS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:]
    log0 = (run_b / "rank0.log").read_text()
    log1 = (run_b / "rank1.log").read_text()
    assert "rank 0 of 2" in log0 and "resumed from" in log0
    # the trainer checked the ranks' states at the start and after every
    # step of epoch 2
    assert [int(line.split()[-1]) for line in log0.splitlines()
            if "ranks equal after step" in line] == [3, 4]
    # and logged each rank's kernel launches in each step (the CPU's plain
    # versions launch none)
    launches = [json.loads(line.split(" launches step ")[1].split(" ", 1)[1])
                for line in log0.splitlines() if " launches step " in line]
    assert launches == [[dict.fromkeys(ops.LAUNCHES, 0)] * 2] * 2, launches
    # rank 1 logs warnings only, and writes nothing
    assert " INFO " not in log1
    losses = _scalars(run_b, "train_loss")
    assert [r["step"] for r in losses] == [2]
    with open(run_b / "step_times.jsonl") as f:
        assert len(f.read().splitlines()) == 1
    names = sorted(os.listdir(run_b / "checkpoint"))
    assert names == ["b_ckpt_best.pth", "b_ckpt_latest.pth"], names
    saved = torch.load(run_b / "checkpoint" / "b_ckpt_latest.pth",
                       weights_only=True)
    assert saved["epoch"] == 2 and saved["state"]["step"] == 4
