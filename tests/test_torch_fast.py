"""The port's serving topology against ``geot_tpu``'s: ``fps_stratified``,
the fast forward (``fast_pyramid``, ``fast_graph``), bfloat16 compute,
test-time votes in ``validate`` and ``predict_scan``, ensembles and
``predict_stream``.

Weights come from ``tests/test_torch_model.py``'s small config (D = 48,
depth 3, 256 points, so every JAX neighbour search is exact ``lax.top_k``),
carried across by ``params_from_jax``; inputs come from seeded numpy.
"""
import copy
import os

os.environ.setdefault("GEOT_EXACT_KNN", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geot_tpu.data import build as jdata_build  # noqa: E402
from geot_tpu.data.tooth_semi import _synthetic_scan  # noqa: E402
from geot_tpu.data.transforms import build_transforms_from_cfg as jtransforms  # noqa: E402,E501
from geot_tpu.engine import eval as jeval  # noqa: E402
from geot_tpu.engine import predict as jpredict  # noqa: E402
from geot_tpu.engine.steps import make_eval_step as jmake_eval_step  # noqa: E402
from geot_tpu.models import build_model_from_cfg as jbuild  # noqa: E402
from geot_tpu.ops import fps_stratified as jfps_stratified  # noqa: E402

from geot_tpu_torch import FLAGSHIP_SEMI_CFG  # noqa: E402
from geot_tpu_torch.core.config import build_model_from_cfg  # noqa: E402
from geot_tpu_torch.data import build as tdata_build  # noqa: E402
from geot_tpu_torch.data.transforms import build_transforms_from_cfg  # noqa: E402,E501
from geot_tpu_torch.engine import eval as teval  # noqa: E402
from geot_tpu_torch.engine import predict as tpredict  # noqa: E402
from geot_tpu_torch.engine.convert import params_from_jax  # noqa: E402
from geot_tpu_torch.engine.steps import make_eval_step  # noqa: E402
from geot_tpu_torch.ops import fps_stratified  # noqa: E402

from test_torch_model import N_POINTS, SMALL_ARGS, jax_small_model  # noqa: E402,E501
from torch_helpers import one_torch_thread  # noqa: E402,F401

C = 17
# the serving flags at the small width: a true-FPS prefix of 64 (the
# flagship's 1024 of 16,000 points), fast_graph on
FAST_ARGS = dict(SMALL_ARGS, fast_pyramid=64, fast_graph=True)
VOTE_TF = FLAGSHIP_SEMI_CFG["datatransforms"]



@pytest.fixture(scope="module")
def weights():
    return jax_small_model(0)[1]


def _port(args, variables):
    model = build_model_from_cfg({"NAME": "WholePartSeg",
                                  "segmentor_args": args})
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model.eval()


def _forward_both(args, variables, pts, cls):
    """(logits, features) of both packages, as float32 numpy.
    ``geot_tpu``'s float32 forward is compiled (eager, each operation
    compiles on its own); its bfloat16 forward stays eager, the forward the
    bfloat16 test's bars were measured against."""
    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": args})
    batch = {"pos": jnp.asarray(pts), "x": jnp.asarray(pts),
             "cls": jnp.asarray(cls)}
    apply = jmodel.apply if args.get("dtype") else jax.jit(jmodel.apply)
    j_logit, _, _, j_feat = apply(variables, batch)
    with torch.no_grad():
        t = torch.from_numpy(pts)
        t_logit, _, _, t_feat = _port(args, variables)(
            {"pos": t, "x": t, "cls": torch.from_numpy(cls)})
    return (np.asarray(j_logit), np.asarray(j_feat.astype(jnp.float32)),
            t_logit.numpy(), t_feat.float().numpy())


# --- fps_stratified ---------------------------------------------------------

def _cloud(case):
    rng = np.random.default_rng(3)
    if case == "duplicates":
        # 40 distinct points repeated to 256, shuffled: fewer distinct
        # points than the prefix, so FPS repeats indices
        base = rng.standard_normal((2, 40, 3)).astype(np.float32)
        pts = np.concatenate([base] * 7, axis=1)[:, :N_POINTS]
        return np.ascontiguousarray(pts[:, rng.permutation(N_POINTS)])
    return rng.standard_normal((2, N_POINTS, 3)).astype(np.float32)


@pytest.mark.parametrize("npoint,prefix,fill,seed,case", [
    (128, 32, "morton", 0, "normal"),
    (128, 64, "morton", 0, "normal"),
    (N_POINTS, 32, "morton", 0, "normal"),
    (N_POINTS, 64, "morton", 0, "normal"),
    (64, 64, "morton", 0, "normal"),
    (N_POINTS, 64, "morton", 0, "duplicates"),
    (200, 64, "perm", 0, "normal"),
    (N_POINTS, 64, "perm", 3, "duplicates")])
def test_fps_stratified_equals_geot_tpu(npoint, prefix, fill, seed, case):
    pts = _cloud(case)
    want = np.asarray(jfps_stratified(jnp.asarray(pts), npoint, prefix,
                                      perm_seed=seed, fill=fill))
    got = fps_stratified(torch.from_numpy(pts), npoint, prefix,
                         perm_seed=seed, fill=fill)
    assert got.dtype == torch.int32 and got.shape == (2, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    for row in got.numpy():                  # no index repeats
        assert len(set(row.tolist())) == npoint
    if npoint == N_POINTS:                   # a permutation the model inverts
        assert (np.sort(got.numpy(), axis=1) == np.arange(N_POINTS)).all()


def test_fps_stratified_refuses_an_unknown_fill():
    with pytest.raises(ValueError, match="fill"):
        fps_stratified(torch.zeros((1, 16, 3)), 16, 4, fill="random")


# --- the fast forward ---------------------------------------------------------

@pytest.mark.parametrize("fast_graph", [False, True])
@pytest.mark.parametrize("fast_pyramid", [True, 64])
def test_fast_forward_matches_jax(weights, fast_pyramid, fast_graph):
    """The bars of ``test_torch_model.py::test_whole_part_seg_matches_jax``:
    logits within 1e-3, argmax agreement >= 0.999, features within 1e-3;
    the outputs come back in the caller's point order."""
    args = dict(SMALL_ARGS, fast_pyramid=fast_pyramid, fast_graph=fast_graph)
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((2, N_POINTS, 3)).astype(np.float32)
    cls = np.array([[0], [1]], dtype=np.int32)
    j_logit, j_feat, t_logit, t_feat = _forward_both(args, weights, pts, cls)
    diff = np.abs(t_logit - j_logit).max()
    agree = (t_logit.argmax(-1) == j_logit.argmax(-1)).mean()
    print(f"fast_pyramid={fast_pyramid} fast_graph={fast_graph}: max "
          f"|dlogit| {diff:.3e}, argmax agreement {agree:.6f}")
    assert diff <= 1e-3
    assert agree >= 0.999
    np.testing.assert_allclose(t_feat, j_feat, rtol=0, atol=1e-3)


@pytest.mark.parametrize("args", [SMALL_ARGS, FAST_ARGS],
                         ids=["exact", "fast"])
def test_bfloat16_forward_matches_jax(weights, args):
    """bfloat16 compute in both packages. Rounding in bfloat16 is coarse
    next to these random weights' logits (p99 |logit| ~0.7), and the two
    packages' float32 sums round differently before each bfloat16 rounding
    (``geot_tpu`` under ``jit`` agrees with its own eager forward on only
    0.96-0.99 of such points), so the bars are statistical, over 4 clouds:
    argmax agreement >= 0.98; the port's bfloat16-vs-float32 max |dlogit|
    at most 2x ``geot_tpu``'s own; and every point whose float32 top-2
    margin exceeds twice the larger of those two errors takes the same
    class in both."""
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((4, N_POINTS, 3)).astype(np.float32)
    cls = np.array([[0], [1], [0], [1]], dtype=np.int32)
    j32, _, t32, _ = _forward_both(args, weights, pts, cls)
    jbf, _, tbf, tfeat = _forward_both(dict(args, dtype="bfloat16"), weights,
                                       pts, cls)
    model = _port(dict(args, dtype="bfloat16"), weights)
    assert model.segmentor.compute_dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert tbf.dtype == np.float32
    agree = (tbf.argmax(-1) == jbf.argmax(-1)).mean()
    j_err = np.abs(jbf - j32).max()
    t_err = np.abs(tbf - t32).max()
    top2 = np.sort(j32, axis=-1)[..., -2:]
    safe = (top2[..., 1] - top2[..., 0]) > 2 * max(j_err, t_err)
    print(f"bfloat16: argmax agreement {agree:.6f}; bf16-vs-f32 max "
          f"|dlogit| port {t_err:.4e}, geot_tpu {j_err:.4e} (ratio "
          f"{t_err / j_err:.3f}); port vs geot_tpu max |dlogit| "
          f"{np.abs(tbf - jbf).max():.4e}; {safe.mean():.3f} of the points "
          f"have a safe margin")
    assert agree >= 0.98
    assert t_err <= 2 * j_err
    assert (tbf.argmax(-1) == jbf.argmax(-1))[safe].all()


def test_dtype_argument():
    from geot_tpu_torch.models.layers import as_dtype

    assert as_dtype(None) is None
    assert as_dtype("float32") == torch.float32
    assert as_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        as_dtype("int8")


# --- votes --------------------------------------------------------------------

def test_tta_vote_logits_equals_geot_tpu():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 64, C)).astype(np.float32)
    pos = rng.standard_normal((2, 64, 3)).astype(np.float32)
    w = rng.standard_normal((3, C)).astype(np.float32)
    want = jeval.tta_vote_logits(
        jnp.asarray(logits), pos, 3, jtransforms("vote", VOTE_TF),
        np.random.default_rng(9), lambda p: jnp.asarray(p) @ w)
    got = teval.tta_vote_logits(
        torch.from_numpy(logits), pos, 3,
        build_transforms_from_cfg("vote", VOTE_TF),
        np.random.default_rng(9), lambda p: p @ torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_validate_with_votes_equals_geot_tpu(weights, monkeypatch):
    """``validate(num_votes=2)`` over the first 4 val scans, both packages
    in float64 with the same numpy generator: the bounds of
    ``tests/test_torch_eval.py::test_validate_equals_geot_tpu`` (at most 2
    points labelled differently, every output within 5e-6)."""
    ds = {"common": {"NAME": "TeethSegSemiLDataset", "data_root": "",
                     "num_points": N_POINTS}}
    cfg = {"num_classes": C, "seed": 1609}
    t_loader = tdata_build.build_dataloader_from_cfg(2, ds, None, VOTE_TF,
                                                     split="val", seed=1609)
    j_loader = jdata_build.build_dataloader_from_cfg(2, ds, None, VOTE_TF,
                                                     split="val", seed=1609)
    for loader in (t_loader, j_loader):
        loader.dataset.file_list = loader.dataset.file_list[:4]
    seen = {"t": [], "j": []}
    for key, module in (("t", teval), ("j", jeval)):
        real = module._metrics_from_cm
        monkeypatch.setattr(module, "_metrics_from_cm",
                            lambda cm, real=real, out=seen[key]:
                            out.append(np.asarray(cm)) or real(cm))
    args = dict(SMALL_ARGS, drop_path_rate=0.0, head_dropout=0.0)
    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": args})
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), weights)
        want = jeval.validate(jmake_eval_step(jmodel), v64, j_loader, cfg,
                              num_votes=2,
                              data_transform=jtransforms("vote", VOTE_TF))
    finally:
        jax.config.update("jax_enable_x64", False)
    model64 = copy.deepcopy(_port(args, weights)).double()
    got = teval.validate(make_eval_step(), model64, t_loader, cfg,
                         num_votes=2,
                         data_transform=build_transforms_from_cfg("vote",
                                                                  VOTE_TF))
    assert len(seen["t"]) == len(seen["j"]) == 4
    flips = sum(int(np.abs(a.astype(np.int64) - b).sum()) // 2
                for a, b in zip(seen["t"], seen["j"]))
    diffs = {k: abs(got[k] - want[k]) for k in want}
    print(f"validate with 2 votes: {flips} points labelled differently; "
          f"|port - geot_tpu| {diffs}")
    assert flips <= 2
    assert set(got) == set(want)
    assert max(diffs.values()) <= 5e-6, diffs
    # the votes changed the result
    plain = teval.validate(make_eval_step(), model64, t_loader, cfg)
    assert plain != got


# --- ensembles and streaming ----------------------------------------------------

@pytest.fixture(scope="module")
def ensemble():
    """Two members at the serving flags, in both packages."""
    members = [jax_small_model(s)[1] for s in (5, 6)]
    jmodel = jbuild({"NAME": "WholePartSeg", "segmentor_args": FAST_ARGS})
    return jmodel, tuple(members), tuple(_port(FAST_ARGS, v)
                                         for v in members)


def test_ensemble_predict_scan_equals_geot_tpu(ensemble):
    """A two-member ensemble through ``predict_scan``, with and without 2
    test-time votes: the labels of every point equal ``geot_tpu``'s."""
    jmodel, jvars, tmodels = ensemble
    pts, _ = _synthetic_scan(3, 4000)
    for votes in (0, 2):
        kw = dict(jaw=1, num_points=N_POINTS, seed=0, num_votes=votes)
        j_pred, _ = jpredict.predict_scan(
            jmodel, jvars, pts, vote_transform=jtransforms("vote", VOTE_TF),
            **kw)
        t_pred, t_logits = tpredict.predict_scan(
            tmodels, pts, vote_transform=build_transforms_from_cfg(
                "vote", VOTE_TF), **kw)
        assert t_pred.dtype == np.uint8 and t_logits.shape == (N_POINTS, C)
        np.testing.assert_array_equal(t_pred, np.asarray(j_pred))
    with pytest.raises(ValueError, match="vote"):
        tpredict.predict_scan(tmodels, pts, num_points=N_POINTS,
                              num_votes=2)


def test_predict_stream_equals_geot_tpu(ensemble):
    """3 scans streamed through the ensemble: in input order, labels equal
    ``geot_tpu``'s and the port's own ``predict_scan`` in the same draw
    order (one generator across the scans)."""
    jmodel, jvars, tmodels = ensemble
    scans = [(f"s{i}", _synthetic_scan(60 + i, 2000 + 500 * i)[0], i % 2)
             for i in range(3)]
    want = list(jpredict.predict_stream(jmodel, jvars, iter(scans),
                                        num_points=N_POINTS, seed=2,
                                        inflight=2))
    got = list(tpredict.predict_stream(tmodels, iter(scans),
                                       num_points=N_POINTS, seed=2,
                                       inflight=2))
    rng = np.random.default_rng(2)
    assert [g[0] for g in got] == ["s0", "s1", "s2"]
    for (name, pts, pred, jaw), w, (_, p, j) in zip(got, want, scans):
        assert pred.dtype == np.uint8 and pred.shape == (len(p),)
        np.testing.assert_array_equal(pred, w[2], err_msg=name)
        same, _ = tpredict.predict_scan(tmodels, p, jaw=j,
                                        num_points=N_POINTS, seed=rng)
        np.testing.assert_array_equal(pred, same, err_msg=name)


def test_load_model_reads_an_ensemble(ensemble, tmp_path):
    _, jvars, tmodels = ensemble
    paths = []
    for i, v in enumerate(jvars):
        paths.append(str(tmp_path / f"m{i}.pt"))
        torch.save(params_from_jax(v), paths[-1])
    single = tpredict.load_model(FAST_ARGS, paths[0], device="cpu")
    assert isinstance(single, torch.nn.Module)
    for ckpt in (",".join(paths), paths):
        members = tpredict.load_model(FAST_ARGS, ckpt, device="cpu")
        assert isinstance(members, tuple) and len(members) == 2
        for got, want in zip(members, tmodels):
            for k, v in want.state_dict().items():
                assert torch.equal(got.state_dict()[k], v), k


def test_serve_cli_takes_a_config_and_fast_and_refuses_an_artifact():
    from geot_tpu_torch.engine import serve as tserve

    model, n = tserve.serving_args(None, [], fast=True)
    args = model["segmentor_args"]
    assert model["NAME"] == "WholePartSeg"
    assert (args["fast_pyramid"], args["fast_graph"], n) == (1024, True,
                                                             16000)
    assert args["trans_dim"] == 384 and "dtype" not in args
    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "cfgs", "tooth_semi", "smoke.yaml")
    model, n = tserve.serving_args(cfg, ["model.segmentor_args.dtype="
                                         "bfloat16"], fast=False)
    args = model["segmentor_args"]
    assert (args["trans_dim"], args["dtype"], n) == (48, "bfloat16", 16000)
    assert "fast_pyramid" not in args
    # an artifact bakes the topology in: --fast with it is refused, as in
    # geot_tpu (tests/test_torch_export.py serves artifacts)
    with pytest.raises(SystemExit):
        tserve.main(["--artifact", "forward.pt2", "--fast"])
