"""The port's loss registry, pseudo-label refinement, transition-matrix
regularisers, teacher contrast loss and ``reference_bugs`` NTM against
``geot_tpu``'s, on the same numpy-seeded inputs; and one semi step per
``criterion_u`` name against ``geot_tpu``'s (the harness of
``tests/test_torch_semi_branches.py``).

Tolerances, stated per test: losses within 1e-5 relative in float32 (the
two frameworks sum in other orders), float64 within 1e-10; masks and
indices equal.
"""
import contextlib
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.engine import pseudo_mask as jpm
from geot_tpu.engine import semi as jsemi
from geot_tpu.losses import build_criterion_from_cfg as jcriterion
from geot_tpu.losses import contrast as jcontrast
from geot_tpu.losses import inst_loss as jinst

from geot_tpu_torch.engine import pseudo_mask as tpm
from geot_tpu_torch.engine import semi as tsemi
from geot_tpu_torch.losses import LOSSES, build_criterion_from_cfg
from geot_tpu_torch.losses import contrast as tcontrast
from geot_tpu_torch.losses import inst_loss as tinst

from test_torch_semi_branches import (check_f32, check_f64,  # noqa: F401
                                      init, run_both, x64)

C = 17


@pytest.fixture
def exact_knn(monkeypatch):
    """``geot_tpu``'s searches exact (its ``GEOT_EXACT_KNN=1`` mode), as
    the port's always are."""
    monkeypatch.setattr(importlib.import_module("geot_tpu.ops.knn"),
                        "_EXACT_KNN", True)


def _t(a):
    return torch.from_numpy(np.array(a))


@contextlib.contextmanager
def _x64(on):
    """JAX in float64 inside the block when ``on``."""
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _inputs(seed=0, B=2, N=60):
    rng = np.random.default_rng(seed)
    f = np.float32
    logits = (rng.standard_normal((B, N, C)) * 3).astype(f)
    pos = rng.standard_normal((B, N, 3)).astype(f)
    pos[:, 10] = pos[:, 3]               # duplicates: self-search ties
    pos[:, 40] = pos[:, 3]
    probs = _softmax(rng.standard_normal((B, N, C)) * 2).astype(f)
    # points 20 and 21: mutual nearest neighbours, unconfident, with
    # swapped top-2 labels: the top2 criterion widens its mask there
    pos[:, 21] = pos[:, 20] + 1e-3
    probs[:, 20:22] = 0.05 / (C - 2)
    probs[:, 20, [2, 5]] = (0.5, 0.45)
    probs[:, 21, [2, 5]] = (0.45, 0.5)
    conf = rng.uniform(0, 1, (B, N)).astype(f)
    conf[:, 20:22] = 0.1
    T = rng.uniform(0, 1, (C, C)).astype(f)
    T /= T.sum(1, keepdims=True)
    return {
        "logits": logits, "labels": rng.integers(0, C, (B, N)),
        "conf": conf,
        "mask": rng.uniform(0, 1, (B, N)) > 0.4,
        "cur": rng.uniform(-1, 1, (B, N)).astype(f),
        "probs": probs, "pred_u_t": _softmax(logits * 0.7).astype(f),
        "T": T, "delta": (rng.standard_normal((C, C)) * 0.01).astype(f),
        "pos": pos, "cw": rng.uniform(0.5, 1.5, (B, C)).astype(f),
        "teacher": (rng.standard_normal((B, N, C)) * 2).astype(f),
        "shape_logits": (rng.standard_normal((2, B, N, C)) * 3).astype(f),
        "shape_labels": np.array([1, 0]),
        "weight": rng.uniform(0.5, 1.5, C).astype(f).tolist(),
    }


def _args(*names, **kw):
    return lambda d: ([d[n] for n in names],
                      {k: (d[v] if isinstance(v, str) else v)
                       for k, v in kw.items()})


# every registered name: (cfg kwargs, inputs); the top2 case includes
# duplicate points, so its nearest-other-neighbour rests on the tie rule
REGISTRY = [
    ("CrossEntropy", {}, _args("logits", "labels")),
    ("CrossEntropyLoss", {"label_smoothing": 0.1}, _args("logits", "labels")),
    ("SmoothCrossEntropy", {"ignore_index": 3}, _args("logits", "labels")),
    ("SmoothCrossEntropy", {"weight": "w"}, _args("logits", "labels")),
    ("MaskedCrossEntropy", {}, _args("logits", "labels", "mask")),
    ("BCELogits", {}, _args("logits", "labels")),
    ("BCEWithLogitsLoss", {}, _args("logits", "labels")),
    ("FocalLoss", {"gamma": 2.0, "alpha": "w"}, _args("logits", "labels")),
    ("FocalLoss", {"gamma": 1.0, "size_average": False},
     _args("logits", "labels")),
    ("Poly1CrossEntropyLoss", {"weight": "w"}, _args("logits", "labels")),
    ("Poly1CrossEntropyLoss", {"reduction": "none"},
     _args("logits", "labels")),
    ("Poly1FocalLoss", {}, _args("logits", "labels")),
    ("Poly1FocalLoss", {"reduction": "sum"}, _args("logits", "labels")),
    ("Poly1FocalLoss_U", {}, _args("logits", "labels", "conf", thresh=0.5)),
    ("Poly1FocalLoss_U", {}, _args("logits", "labels", "conf", thresh=0.5,
                                   mask="mask")),
    ("Poly1FocalLoss_U_corr", {}, _args("logits", "labels", "conf",
                                        thresh=0.3)),
    ("Poly1FocalLoss_U_T", {}, _args("logits", "labels", "conf", "T",
                                     "pred_u_t", thresh=0.3)),
    ("Poly1FocalLoss_U_Cur", {}, _args("logits", "labels", "conf",
                                       thresh=0.2, cur="cur")),
    ("Poly1FocalLoss_U_Cur", {}, _args("logits", "labels", "conf",
                                       thresh=0.2)),
    ("Poly1FocalLoss_U_top2", {}, _args("logits", "labels", "conf", "probs",
                                        "pos", thresh=0.7)),
    ("Poly1FocalLoss_U_T_v1", {}, _args("logits", "labels", "conf", "T",
                                        "probs", "delta", thresh=0.3)),
    ("Weight_CELoss", {}, _args("logits", "labels", "cw")),
    ("Weight_CELoss_U", {}, _args("logits", "labels", "cw", "conf",
                                  thresh=0.3)),
    ("MSE_Loss_U", {}, _args("logits", "probs", thresh=0.1)),
    ("MultiShapeCrossEntropy", {"criterion_args": {"NAME": "CrossEntropy"}},
     _args("shape_logits", "labels", "shape_labels")),
    ("LabelSmoothingCrossEntropy", {}, _args("logits", "labels")),
    ("SoftTargetCrossEntropy", {}, _args("logits", "probs")),
    ("DistillLoss", {"alpha": 0.3, "tau": 2.0},
     _args("logits", "teacher", "labels")),
]


def test_registry_names_are_geot_tpus():
    from geot_tpu.losses.build import LOSS

    assert set(LOSSES) == set(LOSS._module_dict)
    assert {name for name, _, _ in REGISTRY} == set(LOSSES)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", range(len(REGISTRY)),
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(REGISTRY)])
def test_criterion_matches_geot_tpu(case, dtype):
    """Each registered criterion on the same inputs: every output within
    1e-5 relative (float32) or 1e-10 (float64); masks equal."""
    name, kwargs, make = REGISTRY[case]
    d = _inputs()
    kwargs = {k: (d["weight"] if v == "w" else v) for k, v in kwargs.items()}
    args, kw = make(d)
    x64 = dtype == "float64"

    def cast(a):
        a = np.asarray(a)
        return a.astype(np.float64) if x64 and a.dtype == np.float32 else a

    with _x64(x64):
        want = jcriterion(dict(NAME=name, **kwargs))(
            *[jnp.asarray(cast(a)) for a in args],
            **{k: (jnp.asarray(cast(v)) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        want = jax.tree_util.tree_map(np.asarray, want)
    got = build_criterion_from_cfg(dict(NAME=name, **kwargs))(
        *[_t(cast(a)) for a in args],
        **{k: (_t(cast(v)) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        assert g.shape == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
            assert _rel(g, w) <= (1e-10 if x64 else 1e-5), _rel(g, w)
    if name == "Poly1FocalLoss_U_top2":
        assert got[2].any()           # the widening is live


# --- pseudo-label refinement ------------------------------------------------

def _cloud(seed, N=300, distinct=100):
    """Two clouds of N points sampled from ``distinct`` points: every point
    has copies, so column 0 of a self-search is often not the query."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((2, distinct, 3)).astype(np.float32)
    return base[:, rng.integers(0, distinct, N)]


@pytest.mark.parametrize("duplicates", [False, True])
def test_pseudo_label_refine_variants_match_geot_tpu(exact_knn, duplicates):
    """The refine mask, the margin variants and the neighbour probs equal
    ``geot_tpu``'s (masks equal, floats within 1e-6 absolute)."""
    rng = np.random.default_rng(1)
    pos = (_cloud(2) if duplicates
           else rng.standard_normal((2, 300, 3)).astype(np.float32))
    probs = _softmax(rng.standard_normal((2, 300, C)) * 3).astype(np.float32)
    jp, jx = jnp.asarray(probs), jnp.asarray(pos)
    tp, tx = _t(probs), _t(pos)
    jn, jd = jpm.get_neighbor_probs(jp, jx, 4)
    tn, td = tpm.get_neighbor_probs(tp, tx, 4)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    for th in (0.8, 0.95):
        got = tpm.pseudo_label_refine(tp, th, tx)
        want = np.asarray(jpm.pseudo_label_refine(jp, th, jx))
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size
        for n_nb in (1, 2):
            gm, gmar = tpm.pseudo_label_refine_margin(tp, th, tx,
                                                      n_neighbors=n_nb)
            wm, wmar = jpm.pseudo_label_refine_margin(jp, th, jx,
                                                      n_neighbors=n_nb)
            np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
            np.testing.assert_allclose(gmar.numpy(), np.asarray(wmar),
                                       rtol=0, atol=1e-6)
            g1 = tpm.pseudo_label_refine_margin_v1(tp, th, 0.2, tx,
                                                   n_neighbors=n_nb)
            w1 = jpm.pseudo_label_refine_margin_v1(jp, th, 0.2, jx,
                                                   n_neighbors=n_nb)
            np.testing.assert_array_equal(g1[0].numpy(), np.asarray(w1[0]))
            np.testing.assert_allclose(g1[1].numpy(), np.asarray(w1[1]),
                                       rtol=0, atol=1e-6)
            assert g1[2] == w1[2]
    counts = []
    for mod in (tpm, jpm):
        counter = mod.NeighborAccCounter(C)
        pred = probs.argmax(-1)
        counter.update(_t(pred) if mod is tpm else jnp.asarray(pred),
                       tx if mod is tpm else jx)
        counts.append(counter.acc)
    np.testing.assert_array_equal(*counts)
    np.testing.assert_array_equal(tpm.E_JOINT, jpm.E_JOINT)


# --- the transition-matrix regularisers ----------------------------------------

def _inst_inputs(seed, dt, N=300, near_equal=False):
    rng = np.random.default_rng(seed)
    pos = _cloud(seed, N)
    scale = 0.05 if near_equal else 3.0
    probs = _softmax(rng.standard_normal((2, N, C)) * scale)
    labels = rng.integers(0, 5, (2, N))
    ins = rng.uniform(0, 1, (2 * N, C, C))
    ins /= ins.sum(-1, keepdims=True)
    aidx = rng.integers(0, N, (2, 64))
    return [a.astype(dt) if a.dtype == np.float64 else a
            for a in (pos, probs, labels, ins, aidx)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("near_equal", [False, True])
def test_regularisers_match_geot_tpu(exact_knn, dtype, near_equal):
    """``feature_space_loss``, ``identity_loss`` and ``threed_space_loss``
    exact and with 64 pinned anchors, on clouds with duplicate points.
    Both packages search in float32, so the neighbour sets are the same
    in both dtypes; near-equal softmax rows (random-init scale) are the
    17-channel search's hard case. Bounds (relative): float32 2e-6;
    float64 1e-10, and 1e-7 for the 3D terms, whose weights come from the
    float32 search's d2, where XLA on the CPU contracts the sum of squares
    into fused multiply-adds (ROADMAP section 3: the last bit of a d2).
    Near-equal rows: the two float32 |q|^2 - 2 q.s + |s|^2 expansions round
    differently and a neighbour set can differ by one point; the feature
    loss within 2e-3 (measured at most 3.7e-4 over seeds 0-5, in both
    dtypes)."""
    x64 = dtype == "float64"
    tol = {k: (1e-10 if k in ("feat", "identity") else 1e-7) if x64
           else 2e-6 for k in ("feat", "identity", "threed", "anchored")}
    if near_equal:
        tol["feat"] = 2e-3
    pos, probs, labels, ins, aidx = _inst_inputs(3, np.dtype(dtype),
                                                 near_equal=near_equal)
    with _x64(x64):
        j = [jnp.asarray(a) for a in (pos, probs, labels, ins, aidx)]
        want = {
            "feat": jinst.feature_space_loss(16, 1.0, C)(j[1], j[2], j[3]),
            "identity": jinst.identity_loss()(j[3]),
            "threed": jinst.threed_space_loss(32, 1.0, C)(j[0], j[2], j[3]),
        }
        # anchors drawn by geot_tpu from a key: the same indices are pinned
        key = jax.random.PRNGKey(5)
        jaidx = jax.random.randint(key, (2, 64), 0, pos.shape[1])
        want["anchored"] = jinst.threed_space_loss(32, 1.0, C, anchors=64)(
            j[0], j[2], j[3], rng=key)
        want = {k: float(v) for k, v in want.items()}
    t = [_t(a) for a in (pos, probs, labels, ins)]
    got = {
        "feat": tinst.feature_space_loss(16, 1.0, C)(t[1], t[2], t[3]),
        "identity": tinst.identity_loss()(t[3]),
        "threed": tinst.threed_space_loss(32, 1.0, C)(t[0], t[2], t[3]),
        "anchored": tinst.threed_space_loss(32, 1.0, C, anchors=64)(
            t[0], t[2], t[3], anchor_idx=_t(np.asarray(jaidx))),
    }
    for k in want:
        assert got[k].dtype == t[3].dtype
        assert _rel(float(got[k]), want[k]) <= tol[k], (k, float(got[k]),
                                                        want[k])
    assert tinst.Idenyity_loss is tinst.identity_loss
    assert tinst.threeD_space_loss is tinst.threed_space_loss


def test_anchored_3d_loss_draws_from_the_generator():
    pos, _, labels, ins, _ = _inst_inputs(4, np.float32)
    loss = tinst.threed_space_loss(8, 1.0, C, anchors=32)
    t = [_t(a) for a in (pos, labels, ins)]
    a = loss(*t, generator=torch.Generator().manual_seed(1))
    b = loss(*t, generator=torch.Generator().manual_seed(1))
    c = loss(*t, generator=torch.Generator().manual_seed(2))
    assert float(a) == float(b) != float(c)
    with pytest.raises(ValueError, match="generator"):
        loss(*t)
    # anchors >= N: the exact loss
    exact = tinst.threed_space_loss(8, 1.0, C)(*t)
    assert float(tinst.threed_space_loss(8, 1.0, C, anchors=10 ** 6)(*t)) \
        == float(exact)


# --- the teacher contrast loss ------------------------------------------------

@pytest.mark.parametrize("threshold", [0.5, 2.0])
def test_contrast_loss_matches_geot_tpu(threshold):
    """``contrast_loss_t`` fed ``geot_tpu``'s own draws: the loss within
    1e-5 relative, the new queue within 1e-6, ``ptr`` equal. At threshold
    2.0 no point is confident: loss exactly 0 and the bank unchanged."""
    rng = np.random.default_rng(7)
    B, N, D = 2, 700, 32
    feat_s = rng.standard_normal((B, N, D)).astype(np.float32)
    feat_t = rng.standard_normal((B, N, D)).astype(np.float32)
    score = rng.uniform(0, 1, (B, N)).astype(np.float32)
    # the bank holds more rows than a step adds (4096 >= 1024 in the
    # flagship), and the update wraps past its end
    jstate = jcontrast.ContrastState.create(jax.random.PRNGKey(1), 1024, D)
    jstate = jstate._replace(ptr=jnp.asarray(1000, jnp.int32))
    key = jax.random.PRNGKey(9)
    sel, q = jax.random.split(key)
    S = 512
    draws = (_t(np.asarray(jax.random.uniform(sel, (B, N)))),
             _t(np.asarray(jax.random.permutation(q, B * S))))
    jl, jnew = jcontrast.contrast_loss_t(
        jstate, key, jnp.asarray(feat_s), jnp.asarray(score),
        jnp.asarray(feat_t), threshold=threshold, sample_nums=S)
    tstate = tcontrast.ContrastState(_t(np.asarray(jstate.queue)),
                                     torch.tensor(1000))
    tl, tnew = tcontrast.contrast_loss_t(
        tstate, _t(feat_s), _t(score), _t(feat_t), threshold=threshold,
        sample_nums=S, draws=draws)
    np.testing.assert_allclose(tnew.queue.numpy(), np.asarray(jnew.queue),
                               rtol=0, atol=1e-6)
    assert int(tnew.ptr) == int(jnew.ptr)
    if threshold > 1:
        assert float(tl) == 0.0 == float(jl)
        assert int(tnew.ptr) == 1000
        np.testing.assert_array_equal(tnew.queue.numpy(),
                                      np.asarray(jstate.queue))
    else:
        assert int(tnew.ptr) < 1000      # wrapped
        assert _rel(float(tl), float(jl)) <= 1e-5


def test_contrast_bank_rows_are_unit_and_drawn_from_the_generator():
    a = tcontrast.ContrastState.create(torch.Generator().manual_seed(3),
                                       64, 16)
    b = tcontrast.ContrastState.create(torch.Generator().manual_seed(3),
                                       64, 16)
    assert torch.equal(a.queue, b.queue) and int(a.ptr) == 0
    torch.testing.assert_close(a.queue.norm(dim=-1), torch.ones(64))


# --- reference_bugs ------------------------------------------------------------

@pytest.mark.parametrize("filter_outlier", [False, True])
def test_ntm_reference_bugs_match_geot_tpu(rng, filter_outlier):
    """``ntm_update(reference_bugs=True)``: every output within 1e-5
    relative; and it differs from the fixed update."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((2, 80, C)).astype(np.float32) * 2), -1))
    ema = rng.uniform(0, 1, (C, C)).astype(np.float32)
    ema /= ema.sum(1, keepdims=True)
    sigma = rng.uniform(0.3, 0.6, C).astype(np.float32)
    for bugs in (True, False):
        j = jsemi.ntm_update(jnp.asarray(ema), jnp.asarray(probs),
                             jnp.asarray(sigma),
                             filter_outlier=filter_outlier,
                             reference_bugs=bugs)
        t = tsemi.ntm_update(_t(ema), _t(probs), _t(sigma),
                             filter_outlier=filter_outlier,
                             reference_bugs=bugs)
        for a, b in zip(t, j):
            assert _rel(a, b) <= 1e-5
        if bugs:
            buggy = t
    assert not torch.equal(buggy.ema_t_corr, t.ema_t_corr)


# --- one step per criterion_u name ------------------------------------------------

U_NAMES = ["Poly1FocalLoss_U", "Weight_CELoss_U", "MSE_Loss_U",
           "Poly1FocalLoss_U_T", "Poly1FocalLoss_U_T_v1",
           "Poly1FocalLoss_U_Cur", "Poly1FocalLoss_U_top2"]


def _u_cfg(name):
    # a threshold between the random-init confidences, so masks are mixed
    return {"criterion_u_args": {"NAME": name}, "threshold": 0.1}


@pytest.mark.parametrize("name", U_NAMES)
def test_criterion_u_step_float32(init, name):
    """The whole semi step with ``criterion_u`` = name (``cur`` in the
    batch for ``_U_Cur``): loss terms within 1e-5 relative."""
    check_f32(*run_both(_u_cfg(name), init, cur=name.endswith("Cur")),
              ("threed_loss",))


@pytest.mark.parametrize("name", U_NAMES)
def test_criterion_u_step_float64(init, x64, name):
    """The same step in float64: loss terms 1e-6, first moments 1e-5 of
    each tensor's scale."""
    check_f64(*run_both(_u_cfg(name), init, x64=True,
                        cur=name.endswith("Cur")), ("threed_loss",))
