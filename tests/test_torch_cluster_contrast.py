"""The cluster-contrast family (``geot_tpu_torch/losses/cluster_contrast.py``)
against ``geot_tpu``'s, on ``geot_tpu``'s draws: the samplers' indices and
flags, ``class_contrast_loss`` with one class a prototype, with 3 and 6
confidence subclasses and with teacher features (its loss, the gradient
of the student's features and the new state), ``pcc_top2_loss`` and its
gradient, ``pseudo_label_from_prototype`` and the quantiles; in float32
and float64; with draws that tie (equal top-k keys, which ``lax.top_k``
orders by index), a class with fewer members than ``pixel_update`` (the
enqueue then takes other classes' rows, as ``geot_tpu``'s does) and an
empty class.

Tolerances: sampler indices, flags, pointers and pseudo-labels equal; the
quantile thresholds bit-equal; float32 losses within 1e-6 relative,
gradients within 1e-5 of the largest entry, centres and queues (unit
rows) within 1e-6; float64 within 1e-12, 1e-10 and 1e-12.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.losses import cluster_contrast as J

from geot_tpu_torch.losses import cluster_contrast as T

B, N, D, C = 2, 400, 16, 5
TOL = {"float32": (1e-6, 1e-5, 1e-6), "float64": (1e-12, 1e-10, 1e-12)}


@contextlib.contextmanager
def x64(on):
    if on:
        jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        if on:
            jax.config.update("jax_enable_x64", False)


@contextlib.contextmanager
def tied_draws(monkeypatch, on):
    """``jax.random.uniform`` replaced by draws in {0, 1/4, 1/2, 3/4}: most
    keys of a class tie."""
    if not on:
        yield
        return
    real = jax.random.uniform

    def tied(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        u = real(key, shape) if dtype is None else real(key, shape, dtype)
        return jnp.floor(u * 4) / 4

    monkeypatch.setattr(jax.random, "uniform", tied)
    try:
        yield
    finally:
        monkeypatch.setattr(jax.random, "uniform", real)


def inputs(seed, few=False, empty=False):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, C, (B, N))
    if empty:
        pred[pred == 4] = 3                  # class 4 has no member
    if few:
        pred[pred == 2] = 1
        pred[:, :2] = 2                      # class 2: 2 members a cloud
    label = np.where(rng.uniform(size=(B, N)) < 0.7, pred,
                     rng.integers(0, C, (B, N)))
    return {"feats": rng.standard_normal((B, N, D)),
            "teacher": rng.standard_normal((B, N, D)),
            "pred": pred, "label": label,
            "conf": rng.uniform(size=(B, N)),
            "label2": rng.integers(0, C, (B, N)),
            "mask": rng.uniform(size=(B, N)) < 0.6}


def jstate(P, dt, Q=30):
    """Unit centres and queue rows drawn by numpy, pointers 0."""
    rng = np.random.default_rng(P)
    c = rng.standard_normal((P, D))
    q = rng.standard_normal((P, Q, D))
    return J.ClassContrastState(
        jnp.asarray(c / np.linalg.norm(c, axis=-1, keepdims=True), dt),
        jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True), dt),
        jnp.zeros((P,), jnp.int32))


def tstate(s):
    return T.ClassContrastState(*(torch.from_numpy(np.array(a)) for a in s))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def j_draws(key, M):
    """``class_contrast_loss``'s draws from ``key``, as it makes them."""
    s1, s2 = jax.random.split(key)
    return jax.random.uniform(s1, (B, N)), jax.random.uniform(s2, (M,))


# case -> (subclasses, teacher, dtype, tied draws, inputs)
CASES = {
    "class-f32": (1, False, "float32", False, {}),
    "class-few-members-f64-tied": (1, False, "float64", True,
                                   {"few": True}),
    "subclass3-teacher-empty-class-f32-tied": (3, True, "float32", True,
                                               {"empty": True}),
    "subclass6-empty-class-f64": (6, False, "float64", False,
                                  {"empty": True}),
    "class-teacher-few-f32": (1, True, "float32", False, {"few": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_class_contrast_loss_matches_geot_tpu(case, monkeypatch):
    K, teacher, dtype, ties, spec = CASES[case]
    data = inputs(3, **spec)
    kw = dict(num_classes=C, n_view=24, subclasses=K, pixel_update=8)
    n_bin = 24 // K if K > 1 else 24
    M = B * C * K * n_bin
    key = jax.random.PRNGKey(7)
    with x64(dtype == "float64"), tied_draws(monkeypatch, ties):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        st = jstate(C * K, dt)
        tx = jnp.asarray(data["teacher"], dt) if teacher else None

        def f(x, st, key):
            return J.class_contrast_loss(
                st, key, x, jnp.asarray(data["pred"]),
                jnp.asarray(data["label"]), jnp.asarray(data["conf"], dt),
                teacher_feats=tx, **kw)

        def ref(x, st, key):
            return (jax.value_and_grad(f, has_aux=True)(x, st, key),
                    j_draws(key, M))

        ((jl, jns), jg), jd = jax.jit(ref)(jnp.asarray(data["feats"], dt),
                                          st, key)
        draws = tuple(torch.from_numpy(np.array(d)) for d in jd)
        if ties:
            assert len(np.unique(draws[0].numpy())) == 4
        x = torch.from_numpy(np.array(data["feats"], dt)).requires_grad_()
        tl, tns = T.class_contrast_loss(
            tstate(st), x, torch.from_numpy(data["pred"]),
            torch.from_numpy(data["label"]),
            torch.from_numpy(np.array(data["conf"], dt)),
            teacher_feats=(torch.from_numpy(np.array(data["teacher"], dt))
                           if teacher else None), draws=draws, **kw)
    tl.backward()
    lt, gt, st_t = TOL[dtype]
    assert tl.dtype == x.dtype and np.isfinite(float(jl))
    assert rel(tl.detach(), jl) <= lt, (float(tl), float(jl))
    assert rel(x.grad, jg) <= gt
    assert not tns.centers.requires_grad and not tns.queues.requires_grad
    np.testing.assert_array_equal(tns.ptrs.numpy(), np.asarray(jns.ptrs))
    assert tns.ptrs.dtype == torch.int32
    assert np.abs(tns.centers.numpy() - np.asarray(jns.centers)).max() <= st_t
    assert np.abs(tns.queues.numpy() - np.asarray(jns.queues)).max() <= st_t


@pytest.mark.parametrize("ties", [False, True], ids=["draws", "tied"])
def test_samplers_pick_geot_tpus_indices(ties, monkeypatch):
    """The selections themselves: equal keys in index order."""
    data = inputs(5, few=True)
    pred, label = jnp.asarray(data["pred"]), jnp.asarray(data["label"])
    conf = jnp.asarray(data["conf"], jnp.float32)
    key = jax.random.PRNGKey(11)
    with tied_draws(monkeypatch, ties):
        g = torch.from_numpy(np.array(jax.random.uniform(key, (B, N))))
        # fresh functions: a cached trace would hold the other draws
        want = jax.jit(lambda k, p, lab: J._sample_per_class(
            k, p, lab, C, 24))(key, pred, label)
        want_q = jax.jit(lambda k, p, c: J._sample_subclass_quantile(
            k, p, c, C, 6, 4))(key, pred, conf)
    got = T._sample_per_class(torch.from_numpy(data["pred"]),
                              torch.from_numpy(data["label"]), C, 24, g)
    got_q = T._sample_subclass_quantile(torch.from_numpy(data["pred"]),
                                        torch.from_numpy(np.array(conf)),
                                        C, 6, 4, g)
    for (gi, gv), (wi, wv) in ((got, want), (got_q, want_q)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    if ties:
        # most keys tie: the order is the tie rule's
        assert len(np.unique(g.numpy())) == 4


def test_top_k_orders_equal_keys_by_index():
    key = torch.tensor([[0.5, 2.0, 0.5, 2.0, 2.0, 1.0, 0.5]])
    np.testing.assert_array_equal(T._top_k(key, 5).numpy(),
                                  np.asarray(jax.lax.top_k(
                                      jnp.asarray(key.numpy()), 5)[1]))
    np.testing.assert_array_equal(T._top_k(key, 5).numpy(),
                                  [[1, 3, 4, 5, 0]])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nanquantile_is_jnp_nanquantile_bit_for_bit(dtype):
    rng = np.random.default_rng(12)
    with x64(dtype == "float64"):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        for n in (1, 2, 7, 21, 41, 100, 401):
            a = rng.uniform(size=(3, n)).astype(dt)
            a[0, : n // 2] = np.nan
            a[2] = np.nan                                  # empty
            if n > 3:
                a[1, :3] = a[1, 3]                         # equal values
            qs = jnp.asarray(J.K_SPLIT)
            want = np.asarray(jnp.nanquantile(jnp.asarray(a), qs, axis=-1))
            got = T._nanquantile(torch.from_numpy(a),
                                 torch.tensor(J.K_SPLIT,
                                              dtype=torch.from_numpy(a).dtype))
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,ties", [("float32", False),
                                        ("float64", True)])
def test_pcc_top2_and_pseudo_labels_match_geot_tpu(dtype, ties,
                                                   monkeypatch):
    data = inputs(9)
    lt, gt, _ = TOL[dtype]
    with x64(dtype == "float64"), tied_draws(monkeypatch, ties):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        st = jstate(C * 3, dt)
        key = jax.random.PRNGKey(13)

        def f(x, st, key):
            return J.pcc_top2_loss(
                st, key, x, jnp.asarray(data["pred"]),
                jnp.asarray(data["label2"]), jnp.asarray(data["mask"]),
                jnp.asarray(data["conf"], dt), C, 3, 24)

        def ref(x, st, key):
            return (jax.value_and_grad(f)(x, st, key),
                    jax.random.uniform(key, (B, N)),
                    J.pseudo_label_from_prototype(st, x, C, 3))

        (jl, jg), g, (jpl, jlog) = jax.jit(ref)(
            jnp.asarray(data["feats"], dt), st, key)
        g = torch.from_numpy(np.array(g))
    x = torch.from_numpy(np.array(data["feats"], dt)).requires_grad_()
    ts = tstate(st)
    tl = T.pcc_top2_loss(ts, x, torch.from_numpy(data["pred"]),
                         torch.from_numpy(data["label2"]),
                         torch.from_numpy(data["mask"]),
                         torch.from_numpy(np.array(data["conf"], dt)),
                         C, 3, 24, draws=g)
    tl.backward()
    assert rel(tl.detach(), jl) <= lt
    assert rel(x.grad, jg) <= gt
    pl, logit = T.pseudo_label_from_prototype(ts, x.detach(), C, 3)
    assert pl.dtype == torch.int32
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jpl))
    assert rel(logit, jlog) <= lt


def test_own_draws_and_state_creation():
    """Without draws: the generator's, in the features' dtype, on their
    device; the same generator seed gives the same step."""
    data = inputs(4)
    gen = torch.Generator().manual_seed(0)
    st = T.ClassContrastState.create(gen, C * 3, D, 30,
                                     dtype=torch.float64)
    assert st.centers.dtype == torch.float64 and st.ptrs.dtype == torch.int32
    np.testing.assert_allclose(st.queues.norm(dim=-1).numpy(), 1.0,
                               atol=1e-12)
    outs = []
    for _ in range(2):
        loss, new = T.class_contrast_loss(
            st, torch.from_numpy(data["feats"]),
            torch.from_numpy(data["pred"]), torch.from_numpy(data["label"]),
            torch.from_numpy(data["conf"]), num_classes=C, n_view=24,
            subclasses=3, pixel_update=8,
            generator=torch.Generator().manual_seed(5))
        outs.append((float(loss), new.queues))
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])
    assert np.isfinite(outs[0][0])
    loss = T.pcc_top2_loss(st, torch.from_numpy(data["feats"]),
                           torch.from_numpy(data["pred"]),
                           torch.from_numpy(data["label2"]),
                           torch.from_numpy(data["mask"]),
                           torch.from_numpy(data["conf"]), C, 3, 24,
                           generator=torch.Generator().manual_seed(6))
    assert np.isfinite(float(loss))
