"""The bucket-pruned kernels' plain versions and plans against
``geot_tpu``.

``fps_bucket_ref`` and ``knn_small_k_pruned_ref`` are held against the
Pallas kernels ``fps_bucket_pallas`` and ``knn_small_k_pruned`` run in
interpret mode, ties and clouds that are not a whole number of buckets
included. The CUDA kernels only run on the card (``tests/test_torch_gpu.py``);
what they read, the Morton order, the boxes and the chunk visit order, is
built here in plain PyTorch, so this file also runs the kernels' algorithm
in numpy over those plans and checks it against the exact result: the
skip rules prune work and change no index.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geot_tpu.ops.morton import morton_codes as jmorton_codes
from geot_tpu.ops.morton import spatial_sort as jspatial_sort
from geot_tpu.ops.pallas_fps import fps_bucket_pallas
from geot_tpu.ops.pallas_knn_pruned import knn_small_k_pruned as jpruned
from geot_tpu_torch import ops
from geot_tpu_torch.ops.fps import BUCKET, fps_bucket_plan
from geot_tpu_torch.ops.knn import PRUNED_CHUNK, PRUNED_TILE, knn_pruned_plan

SENT = 1 << 30


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, B, N, dup=False):
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    if dup:       # exact duplicates: ties at equal distance everywhere
        x = np.concatenate([x, x[:, :N // 2], x[:, :N // 5]], axis=1)
    return np.ascontiguousarray(x)


# --- Morton order ------------------------------------------------------------

def test_morton_codes_and_stable_sort_equal_geot_tpu(rng):
    xyz = _cloud(rng, 2, 3000, dup=True)
    codes = ops.morton_codes(_t(xyz)).numpy()
    assert codes.dtype == np.int32
    np.testing.assert_array_equal(codes, np.asarray(jmorton_codes(
        jnp.asarray(xyz))))
    valid = rng.uniform(size=xyz.shape[:2]) < 0.9
    np.testing.assert_array_equal(
        ops.morton_codes(_t(xyz), _t(valid)).numpy(),
        np.asarray(jmorton_codes(jnp.asarray(xyz), jnp.asarray(valid))))
    # stable, as jnp.argsort: exact duplicates (equal codes) keep their
    # index order
    sx, order = ops.spatial_sort(_t(xyz))
    jsx, jorder = jspatial_sort(jnp.asarray(xyz))
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


# --- FPS ---------------------------------------------------------------------

@pytest.mark.parametrize("B,N,npoint,dup", [(2, 2500, 256, False),
                                             (1, 1500, 300, True),
                                             (1, 1024, 64, False)])
def test_fps_bucket_ref_matches_pallas(rng, B, N, npoint, dup):
    xyz = _cloud(rng, B, N, dup)
    got = ops.fps_bucket_ref(_t(xyz), npoint)
    wrapper = ops.fps_bucket(_t(xyz), npoint)           # CPU -> plain
    want = np.asarray(fps_bucket_pallas(jnp.asarray(xyz), npoint,
                                        interpret=True))
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(wrapper.numpy(), want)
    np.testing.assert_array_equal(ops.fps(_t(xyz), npoint).numpy(), want)


def _fps_bucket_emulate(xyz, npoint):
    """The CUDA kernel's algorithm (``csrc/fps_bucket.cu``) in numpy over
    ``fps_bucket_plan``: returns (indices (B, npoint), buckets skipped)."""
    sx, order, boxes = (t.numpy() for t in fps_bucket_plan(_t(xyz)))
    B, nb = boxes.shape[:2]
    out = np.zeros((B, npoint), np.int32)
    skipped = 0
    f32 = np.float32
    for b in range(B):
        pts = sx[b].reshape(nb, BUCKET, 3)
        oi = order[b].reshape(nb, BUCKET)
        mind = np.where(oi < SENT, f32(1e10), f32(-1)).astype(f32)
        bmax = np.full(nb, 1e30, f32)
        barg = np.full(nb, SENT, np.int64)
        last = xyz[b, 0]
        for j in range(1, npoint):
            gap = np.maximum(np.maximum(boxes[b, :, :3] - last,
                                        last - boxes[b, :, 3:]), f32(0))
            sq = gap * gap
            d2box = sq[:, 0] + sq[:, 1] + sq[:, 2]
            for k in range(nb):
                if not d2box[k] * f32(0.99999) < bmax[k]:
                    skipped += 1
                    continue
                diff = pts[k] - last
                sq = diff * diff
                mind[k] = np.minimum(mind[k], sq[:, 0] + sq[:, 1] + sq[:, 2])
                bmax[k] = mind[k].max()
                barg[k] = oi[k][mind[k] == bmax[k]].min()
            top = bmax.max()
            win = barg[bmax == top].min()
            out[b, j] = win
            last = xyz[b, win]
    return out, skipped


@pytest.mark.parametrize("B,N,npoint,dup", [(1, 2500, 400, False),
                                             (1, 2300, 300, True)])
def test_fps_bucket_plan_prunes_and_stays_exact(rng, B, N, npoint, dup):
    xyz = _cloud(rng, B, N, dup)
    got, skipped = _fps_bucket_emulate(xyz, npoint)
    np.testing.assert_array_equal(got, ops.fps_ref(_t(xyz), npoint).numpy())
    assert skipped > 0


# --- small-k kNN -------------------------------------------------------------

@pytest.mark.parametrize("B,Q,N,k,dup", [(2, 600, 2500, 3, False),
                                         (1, 300, 1500, 4, True),
                                         (2, 130, 1024, 1, False)])
def test_knn_pruned_ref_matches_pallas(rng, B, Q, N, k, dup):
    s = _cloud(rng, B, N, dup)
    q = np.ascontiguousarray(np.concatenate(
        [s[:, :Q // 2], rng.standard_normal((B, Q - Q // 2, 3)).astype(
            np.float32)], axis=1))
    d, i = ops.knn_small_k_pruned_ref(_t(q), _t(s), k)
    d_w, i_w = ops.knn_small_k_pruned(_t(q), _t(s), k)   # CPU -> plain
    d_p, i_p = jpruned(jnp.asarray(q), jnp.asarray(s), k, interpret=True)
    # indices equal; distances within 1e-6, as tests/test_torch_ops.py
    # holds knn_small_k_pallas: interpreted on the CPU, XLA rounds the
    # three-term sum differently in the last bit
    for dd, ii in ((d, i), (d_w, i_w)):
        assert ii.dtype == torch.int32 and ii.shape == (B, Q, k)
        np.testing.assert_array_equal(ii.numpy(), np.asarray(i_p))
        np.testing.assert_allclose(dd.numpy(), np.asarray(d_p), rtol=0,
                                   atol=1e-6)
    if dup:
        assert np.all(d.numpy()[:, :Q // 2, 0] == 0.0)


def _knn_pruned_emulate(q, s, k, tq=PRUNED_TILE, cs=PRUNED_CHUNK):
    """The CUDA kernel's algorithm (``csrc/knn_small_k_pruned.cu``) in
    numpy over ``knn_pruned_plan`` with tiles of ``tq`` queries and chunks of
    ``cs`` supports: returns (d2, idx) in caller order and the (tile,
    chunk) pairs skipped."""
    sq, qord, ss, sord, visit, d2cb = (t.numpy() for t in knn_pruned_plan(
        _t(q), _t(s), tq, cs))
    B, Q, _ = q.shape
    N = s.shape[1]
    NT, NC = visit.shape[1:]
    f32 = np.float32
    d_out = np.zeros((B, Q, k), f32)
    i_out = np.zeros((B, Q, k), np.int64)
    skipped = 0
    for b in range(B):
        for t in range(NT):
            rows = np.minimum(np.arange(t * tq, (t + 1) * tq), Q - 1)
            qs = sq[b, rows]
            bd = np.full((len(rows), k), np.inf, f32)
            bi = np.full((len(rows), k), SENT, np.int64)
            worst = f32(np.inf)
            for ci in range(NC):
                if not d2cb[b, t, ci] * f32(0.99999) <= worst:
                    skipped += 1
                    continue
                c = visit[b, t, ci]
                sl = slice(c * cs, min((c + 1) * cs, N))
                diff = qs[:, None, :] - ss[b, sl][None]
                sqd = diff * diff
                d2 = sqd[..., 0] + sqd[..., 1] + sqd[..., 2]
                ids = np.broadcast_to(sord[b, sl], d2.shape)
                cd = np.concatenate([bd, d2], axis=1)
                cidx = np.concatenate([bi, ids], axis=1)
                o = np.lexsort((cidx, cd), axis=1)[:, :k]
                bd = np.take_along_axis(cd, o, 1)
                bi = np.take_along_axis(cidx, o, 1)
                worst = bd[:, k - 1].max()
            n = min(tq, Q - t * tq)
            dst = qord[b, t * tq:t * tq + n]
            d_out[b, dst] = bd[:n]
            i_out[b, dst] = bi[:n]
    return d_out, i_out, skipped


@pytest.mark.parametrize("Q,N,k,dup,tq,cs", [
    (700, 3000, 3, False, PRUNED_TILE, PRUNED_CHUNK),
    (700, 3000, 3, False, 32, 128),
    (600, 2100, 4, True, 32, 64)])
def test_knn_pruned_plan_prunes_and_stays_exact(rng, Q, N, k, dup, tq, cs):
    """At the kernel's tile and chunk sizes and, so that boxes are small
    beside these clouds and chunks do get skipped, at smaller ones."""
    s = _cloud(rng, 2, N, dup)
    q = np.ascontiguousarray(np.concatenate(
        [s[:, :Q // 2], rng.standard_normal((2, Q - Q // 2, 3)).astype(
            np.float32)], axis=1))
    d, i, skipped = _knn_pruned_emulate(q, s, k, tq, cs)
    d_r, i_r = ops.knn_small_k_ref(_t(q), _t(s), k)
    np.testing.assert_array_equal(i, i_r.numpy())
    np.testing.assert_array_equal(d, d_r.numpy())
    assert skipped > 0 or tq == PRUNED_TILE


def test_pruned_wrappers_take_the_plain_version_on_the_cpu(rng):
    """On the CPU the pruned wrappers run the plain versions and count no
    launch."""
    before = dict(ops.LAUNCHES)
    xyz = _t(_cloud(rng, 1, 300))
    ops.fps_bucket(xyz, 16)
    ops.knn_small_k_pruned(xyz, xyz, 4)
    assert ops.LAUNCHES == before
    meta = torch.zeros((1, 300, 3), device="meta")
    with pytest.raises(ValueError):
        ops.fps_bucket(meta, 8)
    with pytest.raises(ValueError):
        ops.knn_small_k_pruned(meta, meta, 3)
