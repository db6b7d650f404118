"""The port's config reader and writer, run directories, scalar and step
logs against ``geot_tpu``'s and against ``yaml.safe_load``: the port reads
``cfgs/`` without the ``yaml`` package, which the card's machine lacks."""
import glob
import json
import math
import os

import pytest
import yaml

from geot_tpu.core import logger as jlogger
from geot_tpu.core.config import EasyConfig as JEasyConfig
from geot_tpu.engine.profiler import StepTimer as JStepTimer
from geot_tpu.engine.writer import SummaryWriter as JSummaryWriter
from geot_tpu_torch.core import logger as tlogger
from geot_tpu_torch.core.config import EasyConfig, dump_yaml, load_yaml
from geot_tpu_torch.core.metrics import AverageMeter, cal_model_parm_nums
from geot_tpu_torch.engine.profiler import StepTimer
from geot_tpu_torch.engine.writer import SummaryWriter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_FILES = sorted(os.path.relpath(p, ROOT) for p in
                   glob.glob(os.path.join(ROOT, "cfgs", "*", "*.yaml")))
FLAGSHIP = os.path.join(ROOT, "cfgs", "tooth_semi",
                        "transformer_finetune_fixmatch_ntm.yaml")
SMOKE = os.path.join(ROOT, "cfgs", "tooth_semi", "smoke.yaml")


def _same(a, b):
    """Equal values of equal types, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


def test_every_config_file_is_listed():
    assert len(CFG_FILES) == 18


@pytest.mark.parametrize("path", CFG_FILES)
def test_load_yaml_equals_safe_load(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    got = load_yaml(text, path)
    assert _same(got, yaml.safe_load(text))
    # what the writer makes of it reads back the same, with either reader
    out = dump_yaml(got)
    assert _same(load_yaml(out), got)
    assert _same(yaml.safe_load(out), got)


@pytest.mark.parametrize("text", [
    "1.0e-4", "1.0e4", "1e-4", "1.", ".5", "-.5", "0.001", "1.0e+3", "-1.5",
    "0", "00", "010", "+1", "-1", "0x1F", "0b11", "1_000", "-0", ".inf",
    "-.inf", ".nan", "yes", "No", "on", "OFF", "True", "false", "~", "null",
    "NULL", "", "pos,x,heights", "/data/Teeth3DS", "a b c", "x#y",
    "'quoted # not a comment'", "'it''s'", '"double"', "[0.9, 1.1]",
    "{split: train}", "{}", "[]", "[a, [1, 2], {b: null}]",
    "value  # a comment"])
def test_scalars_resolve_as_safe_load(text):
    doc = f"key: {text}\n"
    assert _same(load_yaml(doc)["key"], yaml.safe_load(doc)["key"])


def test_block_sequences_anchors_and_nesting_equal_safe_load():
    doc = """
a:
  - 1
  - x: 2   # trailing comment
    y: [3, {z: 4}]
  - - 5
    - 6
  -
    k: v
b:
- p
- q
c: &anc
  d: 1
e: *anc
"""
    assert _same(load_yaml(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("text", [
    "a: |\n  literal", "a: >\n  folded", "a: !!str 1", "---\na: 1",
    "a: [1, 2", "a: 2001-12-14", "a: 1:30", "a:\n\t- 1", "a: b: c",
    "<<: *x", "a: *unknown", "a:\n  - 1\n   - 2", 'a: "esc\\n"'])
def test_unsupported_constructs_raise_with_the_line(text):
    with pytest.raises(ValueError, match=r"<yaml>:\d+: "):
        load_yaml(text)


@pytest.mark.parametrize("path", [FLAGSHIP, SMOKE])
def test_easyconfig_equals_geot_tpu(path):
    opts = ["epochs=3", "--lr", "2e-4", "model.segmentor_args.depth=2",
            "dataset_l.common.num_points=512", "mode=resume", "new.key=x",
            "flags=[1, 2]"]
    got, want = EasyConfig(), JEasyConfig()
    for cfg in (got, want):
        cfg.load(path, recursive=True)
        cfg.update(list(opts))
    assert _same(got.dict(), want.dict())
    assert got.model.segmentor_args.depth == 2 and got.lr == 2e-4
    assert isinstance(got.model, EasyConfig)
    # the run's cfg.yaml reads back to the same config
    assert _same(load_yaml(dump_yaml(got.dict())), got.dict())


def test_smoke_anchor_shares_the_segmentor_args():
    cfg = EasyConfig()
    cfg.load(SMOKE, recursive=True)
    assert cfg.model.segmentor_args == cfg.model_t.segmentor_args
    cfg.update(["model.segmentor_args.drop_path_rate=0.0"])
    assert cfg.model_t.segmentor_args.drop_path_rate == 0.1


def test_run_directories_match_geot_tpu(tmp_path):
    for pkg, mod in (("jax", jlogger), ("torch", tlogger)):
        cfg = EasyConfig(root_dir=str(tmp_path / pkg))
        run_dir = mod.generate_exp_directory(cfg, ["task", "train", "seed1"])
        name = os.path.basename(run_dir)
        assert name.startswith("task-train-seed1-") and len(name.split(
            "-")) == 6
        assert cfg.ckpt_dir == os.path.join(run_dir, "checkpoint")
        assert os.path.isdir(cfg.ckpt_dir)
        assert cfg.log_path == os.path.join(run_dir, f"{name}.log")
        ckpt = os.path.join(cfg.ckpt_dir, "x_ckpt_latest.pth")
        open(ckpt, "w").close()
        again = EasyConfig(mode="resume")
        mod.resume_exp_directory(again, pretrained_path=ckpt)
        assert (again.run_dir, again.ckpt_dir, again.run_name) == (
            run_dir, cfg.ckpt_dir, name)
        assert again.log_path == os.path.join(run_dir, f"{name}-resume.log")


def test_scalar_and_step_logs_match_geot_tpu(tmp_path):
    lines = {}
    for pkg, W, T in (("jax", JSummaryWriter, JStepTimer),
                      ("torch", SummaryWriter, StepTimer)):
        d = tmp_path / pkg
        w = W(str(d), tensorboard=False)
        w.add_scalar("val_miou", 0.25, 3)
        w.close()
        t = T(str(d / "step_times.jsonl"))
        for step in (1, 2):
            t.tick(step, epoch=1)
        t.close()
        lines[pkg] = [[json.loads(x) for x in open(d / f)]
                      for f in ("scalars.jsonl", "step_times.jsonl")]
    for a, b in zip(lines["torch"], lines["jax"]):
        assert [sorted(x) for x in a] == [sorted(x) for x in b]
    assert lines["torch"][0][0]["value"] == 0.25
    assert len(lines["torch"][1]) == 1 and lines["torch"][1][0]["step"] == 2


def test_meter_and_parameter_count():
    import torch

    m = AverageMeter()
    for v, n in ((1.0, 1), (4.0, 3)):
        m.update(v, n)
    assert (m.val, m.avg, m.count) == (4.0, 13.0 / 4, 4)
    net = torch.nn.Linear(5, 3)
    assert cal_model_parm_nums(net) == 18
