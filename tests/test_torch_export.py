"""The port's exported forward (``engine/export.py``) and ``serve
--artifact`` against the eager forward and ``geot_tpu``.

At ``tests/test_export.py``'s small ``SEG`` config, with ``geot_tpu``'s
initial weights carried over by ``params_from_jax``: the artifact exported
on the CPU (the kernels in its graph as ``geot::fps`` and
``geot::knn_small_k``, run by their plain versions here) gives the eager
forward's logits bit for bit and ``geot_tpu``'s ``model.apply`` logits
within 2e-5 of their scale (float32 BatchNorm and attention rounding, as
the port's eager forward already is). Also: ``embed_params=False``, the
export CLI on a checkpoint of the port's trainer, a load in a fresh process
that imports no model code, the serving endpoint on an artifact over HTTP,
``serve``'s argument and input-spec errors against ``geot_tpu``'s, and the
custom ops under ``torch.library.opcheck``.
"""
import io
import json
import os
import subprocess
import sys
import textwrap
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.engine import serve as jserve
from geot_tpu.models import build_model_from_cfg as jbuild

from geot_tpu_torch import ops
from geot_tpu_torch.core.config import build_model_from_cfg
from geot_tpu_torch.engine import export as texport
from geot_tpu_torch.engine import serve as tserve
from geot_tpu_torch.engine.convert import params_from_jax
from geot_tpu_torch.engine.predict import map_pred_to_fdi, predict_scan
from torch_helpers import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = dict(NAME="PointTransformer_seg_T", trans_dim=48, depth=3, num_heads=4,
           group_size=8, num_group=16, encoder_dims=32, nclasses=17,
           drop_path_rate=0.0, downsample_targets=[64, 32, 16],
           extract_layers=[1, 2, 3])
FAST = dict(SEG, fast_pyramid=16, fast_graph=True)
N, B = 128, 2
# the port's float32 forward against flax's: relative to the logit scale
JAX_LOGIT_TOL = 2e-5



@pytest.fixture(scope="module")
def weights():
    """``geot_tpu``'s initial variables of the SEG model and the port's
    state_dict of them."""
    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": SEG})
    key = jax.random.PRNGKey(0)
    pos = jnp.zeros((B, N, 3))
    variables = jax.jit(jmodel.init)(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        {"pos": pos, "x": pos, "cls": jnp.zeros((B, 1), jnp.int32)})
    return jmodel, variables, params_from_jax(variables)


def _port(seg, state_dict):
    model = build_model_from_cfg({"NAME": "WholePartSeg",
                                  "segmentor_args": seg})
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _inputs(seed=0, batch=B):
    pos = np.random.default_rng(seed).standard_normal(
        (batch, N, 3)).astype(np.float32)
    return pos, torch.from_numpy(pos), torch.tensor([[0], [1]][:batch])


def _eager(model, pos, cls):
    with torch.no_grad():
        return model({"pos": pos, "x": pos, "cls": cls})[0]


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    """The exact and the fast forward exported to files, and the eager
    logits of the exact one before its export."""
    _, _, sd = weights
    out = tmp_path_factory.mktemp("art")
    _, pos, cls = _inputs()
    paths = {}
    before = _eager(_port(SEG, sd), pos, cls)
    for name, seg in (("exact", SEG), ("fast", FAST)):
        paths[name] = texport.export_forward(
            _port(seg, sd), n_points=N, batch=B,
            out=str(out / f"{name}.pt2"))
    return paths, before


@pytest.mark.parametrize("name", ["exact", "fast"])
def test_artifact_matches_eager_and_geot_tpu(weights, artifact, name):
    jmodel, variables, sd = weights
    paths, before = artifact
    seg = SEG if name == "exact" else FAST
    model = _port(seg, sd)
    pos_np, pos, cls = _inputs(seed=3)
    eager = _eager(model, pos, cls)
    ep = texport.load_exported(paths[name])
    ops.reset_launches()
    with torch.no_grad():
        got = texport.load_forward(paths[name])(pos, cls)
    assert got.shape == (B, N, 17) and got.dtype == torch.float32
    assert torch.equal(got, eager)
    targets = {str(n.target) for n in ep.graph.nodes}
    assert "geot.fps.default" in targets
    if name == "exact":       # the 3-NN of 128 rows is a small-k search
        assert "geot.knn_small_k.default" in targets
        # exporting left the eager forward as it was
        _, pos0, cls0 = _inputs()
        assert torch.equal(_eager(model, pos0, cls0), before)
    if name == "exact":
        want = np.asarray(jax.jit(jmodel.apply)(variables, {
            "pos": jnp.asarray(pos_np), "x": jnp.asarray(pos_np),
            "cls": jnp.asarray(cls.numpy().astype(np.int32))})[0])
        scale = np.abs(want).max()
        diff = np.abs(got.numpy() - want).max()
        print(f"artifact vs geot_tpu: max |dlogit| {diff:.3e} of {scale:.3f}")
        assert diff <= JAX_LOGIT_TOL * scale
        assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() >= 0.999


def test_fast_export_leaves_the_schedule_cache_real(weights, artifact):
    """The stratified fill's schedule is a constant of the exported graph,
    not a copy from the host in it; the eager cache holds real tensors
    only, whether or not a trace found it empty."""
    tfps = sys.modules["geot_tpu_torch.ops.fps"]
    _, _, sd = weights
    tfps._BITREV.clear()
    ep = texport.export_forward(_port(FAST, sd), n_points=N, batch=1)
    targets = {str(n.target) for n in ep.graph.nodes}
    assert "aten.lift_fresh_copy.default" not in targets
    assert "aten._to_copy.default" not in targets
    assert len(ep.constants) == 1
    for t in tfps._BITREV.values():
        assert type(t) is torch.Tensor
    t = tfps._BITREV[(N, torch.device("cpu"))]
    assert torch.equal(t, torch.from_numpy(tfps._bitrev_schedule(N)))


def test_runtime_params_export(weights):
    _, variables, sd = weights
    model = _port(SEG, sd)
    ep = texport.export_forward(model, n_points=N, batch=B,
                                embed_params=False)
    _, pos, cls = _inputs(seed=4)
    other = {k: v * 1.01 if v.is_floating_point() else v
             for k, v in sd.items()}
    with torch.no_grad():
        got = ep.module()(other, pos, cls)
    assert torch.equal(got, _eager(_port(SEG, other), pos, cls))
    specs = texport.input_specs(ep)
    assert specs[-2:] == [((B, N, 3), torch.float32), ((B, 1), torch.int64)]
    assert len(specs) == len(sd) + 2


def test_export_cli_on_a_port_checkpoint(weights, tmp_path):
    from geot_tpu_torch.engine.checkpoint import save_checkpoint
    from geot_tpu_torch.engine.state import TrainState

    _, _, sd = weights
    cfg = {"lr": 1e-3, "optimizer": {"NAME": "adamw", "weight_decay": 0.05}}
    state = TrainState.create(cfg, {"NAME": "WholePartSeg",
                                    "segmentor_args": SEG}, device="cpu")
    state.model.load_state_dict(sd)
    save_checkpoint({"ckpt_dir": str(tmp_path), "run_name": "exp"}, state,
                    epoch=1)
    yaml_path = tmp_path / "model.yaml"
    yaml_path.write_text("model:\n  NAME: WholePartSeg\n  segmentor_args:\n"
                         + "".join(f"    {k}: {json.dumps(v)}\n"
                                   for k, v in SEG.items()))
    out = tmp_path / "model.pt2"
    texport.export_cli(["--cfg", str(yaml_path), "--ckpt",
                        str(tmp_path / "exp_ckpt_latest.pth"), "--out",
                        str(out), "--n_points", str(N), "--batch", "1",
                        "device=cpu"])
    _, pos, cls = _inputs(seed=5, batch=1)
    with torch.no_grad():
        got = texport.load_forward(str(out))(pos, cls)
    assert torch.equal(got, _eager(_port(SEG, sd), pos, cls))


def test_artifact_loads_without_the_model_code(artifact, tmp_path):
    """A fresh process that imports torch and ``geot_tpu_torch.ops`` only
    runs the artifact; no ``geot_tpu_torch.models`` module, no JAX."""
    paths, _ = artifact
    _, pos, cls = _inputs(seed=6)
    torch.save({"pos": pos, "cls": cls}, tmp_path / "in.pt")
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import torch
        import geot_tpu_torch.ops
        ep = torch.export.load({paths['exact']!r})
        x = torch.load({str(tmp_path / 'in.pt')!r})
        with torch.no_grad():
            out = ep.module()(x["pos"], x["cls"])
        torch.save(out, {str(tmp_path / 'out.pt')!r})
        bad = [m for m in sys.modules if m.startswith(
            "geot_tpu_torch.models") or m.split(".")[0] in
            ("jax", "flax", "geot_tpu", "yaml")]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    with torch.no_grad():
        want = texport.load_forward(paths["exact"])(pos, cls)
    assert torch.equal(torch.load(tmp_path / "out.pt"), want)


def test_serve_artifact_over_http(weights, tmp_path):
    """``serve`` of an artifact (B = 1) answers an OBJ body with the labels
    that ``predict_scan`` gives with the eager model."""
    _, _, sd = weights
    model = _port(SEG, sd)
    path = texport.export_forward(model, n_points=N, batch=1,
                                  out=str(tmp_path / "m.pt2"))
    pts = np.random.default_rng(7).standard_normal((500, 3)).astype(
        np.float32)
    want, _ = predict_scan(model, pts, jaw=1, num_points=N)
    httpd = tserve.serve(port=0, artifact=path, warmup=False)
    try:
        assert httpd.service.num_points == N
        body = "".join(f"v {x!r} {y!r} {z!r}\n"
                       for x, y, z in pts.tolist()).encode()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        req = urllib.request.Request(f"{url}/predict?jaw=upper", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
        assert got["labels"] == map_pred_to_fdi(want, 1)
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.loads(r.read())["scans_served"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()


ARG_CASES = {
    "artifact_with_cfg": ["--artifact", "a.pt2", "--cfg", "c.yaml"],
    "artifact_with_ckpt": ["--artifact", "a.pt2", "--ckpt", "c.pt"],
    "artifact_with_fast": ["--artifact", "a.pt2", "--fast"],
    "artifact_with_override": ["--artifact", "a.pt2", "num_points=8"],
}


@pytest.mark.parametrize("case", sorted(ARG_CASES))
def test_serve_argument_errors_match_geot_tpu(case, capsys):
    argv = ARG_CASES[case]
    with pytest.raises(SystemExit) as jexit:
        jserve.main(argv)
    jerr = capsys.readouterr().err
    with pytest.raises(SystemExit) as texit:
        tserve.main(argv)
    terr = capsys.readouterr().err
    assert jexit.value.code == texit.value.code == 2
    msg = "--artifact conflicts with --cfg/--ckpt/--fast/overrides"
    assert msg in jerr and msg in terr


def test_serve_refuses_a_batched_artifact_as_geot_tpu_does(weights,
                                                           tmp_path):
    """An artifact of batch 2 is refused by both services with the same
    ``ValueError``."""
    from geot_tpu.engine.export import export_forward as jexport

    jmodel, variables, sd = weights
    jpath = jexport(jmodel, variables, n_points=N, batch=2,
                    out=str(tmp_path / "j.bin"))
    tpath = texport.export_forward(_port(SEG, sd), n_points=N, batch=2,
                                   out=str(tmp_path / "t.pt2"))
    with pytest.raises(ValueError) as jerr:
        jserve._Service(None, artifact=jpath, warmup=False)
    with pytest.raises(ValueError) as terr:
        tserve._Service(artifact=tpath, warmup=False)
    head = "must be an embed_params export with (pos (1,N,3), cls (1,1))"
    assert head in str(jerr.value) and head in str(terr.value)
    assert "(2, 128, 3)" in str(jerr.value) and "(2, 128, 3)" in str(
        terr.value)


@pytest.mark.parametrize("op", ["fps", "knn_small_k"])
def test_custom_ops_pass_opcheck(op):
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 300, 3)).astype(np.float32))
    q = x[:, :150].contiguous()
    args = (x, 64) if op == "fps" else (q, x, 3)
    res = torch.library.opcheck(getattr(torch.ops.geot, op).default, args)
    assert set(res.values()) == {"SUCCESS"}, res
    # the fake implementations' shapes and types, by hand too
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        out = (torch.ops.geot.fps(fx, 64) if op == "fps" else
               torch.ops.geot.knn_small_k(mode.from_tensor(q), fx, 3))
    if op == "fps":
        assert out.shape == (2, 64) and out.dtype == torch.int32
    else:
        assert [t.shape for t in out] == [(2, 150, 3)] * 2
        assert [t.dtype for t in out] == [torch.float32, torch.int32]
