"""The port's flagship forward against ``geot_tpu``'s, weights carried
across by ``params_from_jax``; the copies the port keeps of numpy-only
``geot_tpu`` code; the port's import and device rules."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.core.config import EasyConfig
from geot_tpu.data import tooth_semi as jdata
from geot_tpu.engine.checkpoint import convert_torch_seg_t
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu_torch import FLAGSHIP_SEG_ARGS
from geot_tpu_torch.core.config import build_model_from_cfg
from geot_tpu_torch.data import tooth_semi as tdata
from geot_tpu_torch.engine.convert import params_from_jax
from geot_tpu_torch.engine.predict import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the small config of tests/test_parity_torch.py: N <= 256 keeps every JAX
# neighbour search on exact lax.top_k
SMALL_ARGS = {"NAME": "PointTransformer_seg_T", "trans_dim": 48, "depth": 3,
              "num_heads": 4, "group_size": 8, "num_group": 32,
              "encoder_dims": 32, "nclasses": 17, "drop_path_rate": 0.1,
              "downsample_targets": [128, 64, 32], "extract_layers": [1, 2, 3]}
N_POINTS = 256


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_small_model(seed=0):
    """JAX WholePartSeg at the small config, with non-trivial BN running
    stats and T_linear, as a numpy tree."""
    model = jbuild({"NAME": "WholePartSeg", "segmentor_args": SMALL_ARGS})
    pos = jnp.zeros((1, N_POINTS, 3))
    key = jax.random.PRNGKey(seed)
    variables = _to_numpy(model.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        {"pos": pos, "x": pos, "cls": jnp.zeros((1, 1), jnp.int32)}))
    rng = np.random.default_rng(seed)

    def jitter(path, a):
        name = path[-1].key
        if name == "mean":
            return rng.uniform(-0.05, 0.05, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return a

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        jitter, variables["batch_stats"])
    seg = variables["params"]["segmentor"]
    seg["T_linear"] = rng.standard_normal(seg["T_linear"].shape).astype(
        np.float32) * 0.1
    return model, variables


def port_model(variables):
    model = build_model_from_cfg({"NAME": "WholePartSeg",
                                  "segmentor_args": SMALL_ARGS})
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def small():
    jmodel, variables = jax_small_model()
    return jmodel, variables, port_model(variables)


def test_whole_part_seg_matches_jax(small):
    jmodel, variables, tmodel = small
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((2, N_POINTS, 3)).astype(np.float32)
    cls = np.array([[0], [1]], dtype=np.int32)
    j_logit, _, j_sigma, j_feat = jmodel.apply(
        variables, {"pos": jnp.asarray(pts), "x": jnp.asarray(pts),
                    "cls": jnp.asarray(cls)})
    with torch.no_grad():
        t_pts = torch.from_numpy(pts)
        t_logit, _, t_sigma, t_feat = tmodel(
            {"pos": t_pts, "x": t_pts, "cls": torch.from_numpy(cls)})
    j_logit = np.asarray(j_logit)
    t_logit = t_logit.numpy()
    diff = np.abs(t_logit - j_logit).max()
    agree = (t_logit.argmax(-1) == j_logit.argmax(-1)).mean()
    print(f"small-config parity: max |dlogit| {diff:.3e}, "
          f"argmax agreement {agree:.6f}")
    assert diff <= 1e-3
    assert agree >= 0.999
    np.testing.assert_allclose(t_feat.numpy(), np.asarray(j_feat), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(t_sigma.detach().numpy(),
                                  np.asarray(j_sigma))


def test_correction_uses_t_linear(small):
    _, variables, tmodel = small
    T = np.eye(17, dtype=np.float32) * 0.9 + 0.1 / 17
    pts = torch.zeros((1, N_POINTS, 3))
    pts[0, :, 0] = torch.linspace(-1, 1, N_POINTS)
    pts[0, :, 1] = torch.linspace(-1, 1, N_POINTS) ** 2
    with torch.no_grad():
        _, corr, _, _ = tmodel.segmentor(pts, None, None, torch.from_numpy(T))
    want = T @ variables["params"]["segmentor"]["T_linear"].T
    np.testing.assert_allclose(corr.numpy(), want, rtol=1e-6, atol=1e-6)


def test_state_dict_round_trips_through_convert_torch_seg_t(small):
    """The port's parameter names are the reference state_dict's: the JAX
    package's own torch converter reads them back to the original tree."""
    _, variables, tmodel = small
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    params, stats = convert_torch_seg_t(sd, depth=SMALL_ARGS["depth"])
    flat_j = jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"], "batch_stats":
         variables["batch_stats"]})
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        {"params": params, "batch_stats": stats}))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_t[path]), leaf)


def test_params_from_jax_covers_every_port_tensor(small):
    _, variables, tmodel = small
    sd = params_from_jax(variables)
    assert set(sd) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_seeded_init_is_deterministic():
    a = load_model(SMALL_ARGS, seed=3, device="cpu").state_dict()
    b = load_model(SMALL_ARGS, seed=3, device="cpu").state_dict()
    c = load_model(SMALL_ARGS, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    seg = "segmentor."
    assert torch.all(a[seg + "T_linear.weight"] == 0)
    assert torch.all(a[seg + "sigma"] == 0.4)


def test_load_model_from_saved_state_dict(small, tmp_path):
    _, variables, tmodel = small
    path = tmp_path / "weights.pt"
    torch.save(params_from_jax(variables), path)
    loaded = load_model(SMALL_ARGS, ckpt=str(path), device="cpu")
    ref = tmodel.state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, ref[k]), k


# --- copies of geot_tpu code ----------------------------------------------

def test_flagship_args_equal_the_yaml():
    cfg = EasyConfig()
    cfg.load(os.path.join(ROOT, "cfgs", "tooth_semi",
                          "transformer_finetune_fixmatch_ntm.yaml"),
             recursive=True)
    assert FLAGSHIP_SEG_ARGS == dict(cfg.model.segmentor_args)


def test_data_copies_equal_geot_tpu():
    assert tdata.FDI_LABEL_MAP == jdata.FDI_LABEL_MAP
    pts, labels = tdata._synthetic_scan(7, 5000)
    jpts, jlabels = jdata._synthetic_scan(7, 5000)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(labels, jlabels)
    for got, want in zip(tdata.pc_norm(pts), jdata.pc_norm(jpts)):
        np.testing.assert_array_equal(got, want)


# --- import and device rules ----------------------------------------------

def test_port_imports_no_jax_yaml_or_geot_tpu():
    """Import the port and run a CPU forward with jax, flax, yaml and
    geot_tpu blocked."""
    code = textwrap.dedent(f"""
        import sys
        BLOCKED = ("jax", "jaxlib", "flax", "orbax", "yaml", "geot_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        import numpy as np, torch
        import geot_tpu_torch
        from geot_tpu_torch.engine import predict, serve, convert  # noqa
        from geot_tpu_torch.engine.predict import load_model, predict_scan
        from geot_tpu_torch.data.tooth_semi import _synthetic_scan
        model = load_model({SMALL_ARGS!r}, device="cpu")
        pts, _ = _synthetic_scan(0, 1000)
        labels, logits = predict_scan(model, pts, num_points={N_POINTS})
        assert labels.shape == (1000,) and torch.isfinite(logits).all()
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from geot_tpu_torch.engine.serve import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(SMALL_ARGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(SMALL_ARGS, port=0, warmup=False)
