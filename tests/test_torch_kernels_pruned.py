"""The bucket-pruned kernels' plain versions and plans against
``geot_tpu``.

``fps_bucket_ref`` and ``knn_small_k_pruned_ref`` are held against the
Pallas kernels ``fps_bucket_pallas`` and ``knn_small_k_pruned`` run in
interpret mode, ties and clouds that are not a whole number of buckets
included. The CUDA kernels only run on the card (``tests/test_torch_gpu.py``);
what they read, the Morton order and, for the kNN, the sorted supports
and their chunk boxes, is built here by the wrappers' plans (plain PyTorch
on the CPU), so this file also runs the kernels' algorithms in numpy over
those plans and checks them against the exact result and the Pallas
kernels: ``csrc/fps_bucket.cu``'s per-block 256-point buckets with a
cached largest min-distance each and (value, original index) winners
across blocks, and ``csrc/knn_small_k_pruned.cu``'s 32-query warp tiles
visiting 128-support chunks in ascending box distance until the first one
past the tile's worst k-th best. The skip rules prune work and change no
index.
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
from geot_tpu_torch.ops.fps import (BUCKET, BUCKET_BLOCK, CLUSTER_SIZES,
                                    bucket_capacity, fps_bucket_plan,
                                    fps_bucket_size)
from geot_tpu_torch.ops.knn import PRUNED_CHUNK, PRUNED_TILE, knn_pruned_plan

SENT = 1 << 30
NONE = np.int64(0xFFFFFFFF)            # no original index
F32 = np.float32


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
    # index order; the order the plans sort by
    order = fps_bucket_plan(_t(xyz))
    jsx, jorder = jspatial_sort(jnp.asarray(xyz))
    assert order.dtype == torch.int64
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(
        np.take_along_axis(xyz, order.numpy()[..., None], 1),
        np.asarray(jsx))


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


def _fmin_fps(xyz, npoint):
    """FPS with the card kernels' update, ``fminf(mind, d2)`` (a NaN d2
    leaves mind as it is), brute force in numpy: the plain version of
    ``fps_cluster.cu`` where a coordinate is NaN."""
    B = xyz.shape[0]
    out = np.zeros((B, npoint), np.int32)
    for b in range(B):
        mind = np.full(xyz.shape[1], 1e10, F32)
        last = xyz[b, 0]
        for j in range(1, npoint):
            diff = xyz[b] - last
            sq = diff * diff
            mind = np.fmin(mind, sq[:, 0] + sq[:, 1] + sq[:, 2])
            out[b, j] = np.argmax(mind)          # the first largest
            last = xyz[b, out[b, j]]
    return out


def _fps_bucket_emulate(xyz, npoint, C):
    """``csrc/fps_bucket.cu`` in numpy over ``fps_bucket_plan``: block r of
    C owns the sorted positions [r * per_cta, (r + 1) * per_cta) in
    256-point buckets; each bucket keeps its box (``fminf``/``fmaxf`` over
    its real points, from +inf/-inf), its largest min-distance and the
    smallest original index holding it; each step a bucket whose
    ``box_d2 * 0.99999`` is not below that largest is skipped, every other
    one updated with ``fminf``; then each block's winner and the cluster's,
    both in (value desc, original index asc) order. Returns (indices,
    buckets skipped)."""
    order = fps_bucket_plan(_t(xyz)).numpy()
    B, N, _ = xyz.shape
    per = -(-N // C)
    assert -(-per // BUCKET) <= BUCKET_BLOCK
    out = np.zeros((B, npoint), np.int32)
    skipped = 0
    inf = F32(np.inf)
    for b in range(B):
        block, pos = [], []
        for r in range(C):
            lo, hi = min(N, r * per), min(N, (r + 1) * per)
            for q0 in range(lo, hi, BUCKET):
                block.append(r)
                pos.append(q0 + np.arange(BUCKET))
        block, pos = np.array(block), np.array(pos)
        valid = pos < np.minimum(N, (block[:, None] + 1) * per)
        oi = np.where(valid, order[b, np.minimum(pos, N - 1)], NONE)
        pts = np.where(valid[..., None], xyz[b, np.minimum(oi, N - 1)],
                       F32(0))
        mind = np.where(valid, F32(1e10), F32(-1))
        lo = np.fmin.reduce(np.where(valid[..., None], pts, inf), axis=1,
                            initial=inf)
        hi = np.fmax.reduce(np.where(valid[..., None], pts, -inf), axis=1,
                            initial=-inf)
        bval = np.full(len(block), F32(1e10))
        bidx = oi.min(1)
        last = xyz[b, 0]
        for j in range(1, npoint):
            gap = np.fmax(np.fmax(lo - last, last - hi), F32(0))
            d2box = gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1] \
                + gap[:, 2] * gap[:, 2]
            need = d2box * F32(0.99999) < bval
            skipped += int((~need).sum())
            diff = pts[need] - last
            sq = diff * diff
            m = np.fmin(mind[need], sq[..., 0] + sq[..., 1] + sq[..., 2])
            mind[need] = m
            bval[need] = m.max(1)
            bidx[need] = np.where(m == bval[need][:, None], oi[need],
                                  NONE).min(1)
            # each block's winner, then the cluster's
            win = []
            for r in range(C):
                mine = block == r
                if not mine.any():
                    continue
                top = bval[mine].max()
                win.append((top, bidx[mine][bval[mine] == top].min()))
            top = max(v for v, _ in win)
            gi = min(i for v, i in win if v == top)
            out[b, j] = gi
            last = xyz[b, gi]
    return out, skipped


@pytest.mark.parametrize("B,N,npoint,C,case", [
    (1, 2500, 400, 4, "plain"),       # 3 buckets of 256 a block, ragged
    (1, 2300, 300, 2, "dup"),         # duplicates: ties at equal distance
    (2, 1100, 200, 16, "plain"),      # blocks of 69 points
    (1, 17, 20, 16, "plain"),         # blocks with no point
    (1, 3000, 300, 4, "nan")])        # a NaN coordinate
def test_fps_bucket_plan_prunes_and_stays_exact(rng, B, N, npoint, C, case):
    xyz = _cloud(rng, B, N, case == "dup")
    if case == "nan":
        xyz[0, 77, 1] = np.nan
        xyz[0, 1500:1600, 0] = np.nan
    got, skipped = _fps_bucket_emulate(xyz, npoint, C)
    if case == "nan":
        # the card's FPS kernels keep mind where d2 is NaN (fminf), so a NaN
        # point keeps 1e10, wins and is picked again: its bucket is never
        # skipped; the plain version and the Pallas kernel define no NaN
        np.testing.assert_array_equal(got, _fmin_fps(xyz, npoint))
        return
    assert skipped > 0
    np.testing.assert_array_equal(got, ops.fps_ref(_t(xyz), npoint).numpy())
    np.testing.assert_array_equal(got, np.asarray(fps_bucket_pallas(
        jnp.asarray(xyz), npoint, interpret=True)))


@pytest.mark.parametrize("max_active,batch,N,want", [
    ({16: 7, 8: 15, 4: 30, 2: 60}, 1, 150000, 16),
    ({16: 7, 8: 15, 4: 30, 2: 60}, 9, 150000, 16),    # in waves
    ({16: 7, 8: 15, 4: 30, 2: 60}, 9, 80000, 8),
    ({16: 7, 8: 15, 4: 30, 2: 60}, 1, 16000, 16),
    ({16: 7, 8: 15, 4: 30, 2: 60}, 20, 16000, 4),
    ({16: 7, 8: 15, 4: 30, 2: 60}, 90, 16000, 2),
    ({16: 0, 8: 0, 4: 0, 2: 0}, 1, 30000, 4)])
def test_fps_bucket_cluster_size_holds_the_cloud(max_active, batch, N, want):
    assert fps_bucket_size(max_active, batch, N) == want
    assert bucket_capacity(want) >= N
    assert bucket_capacity(CLUSTER_SIZES[0]) == 16 * 44 * 256
    with pytest.raises(ValueError):
        fps_bucket_size(max_active, batch, bucket_capacity(16) + 1)


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


def _knn_pruned_emulate(q, s, k):
    """``csrc/knn_small_k_pruned.cu`` in numpy over ``knn_pruned_plan``: a
    warp per 32 Morton-consecutive queries (the last sorted query repeated
    past Q), its box NaN-keeping; chunk keys (box distance bits, chunk + 1),
    a NaN box (or one with an infinite extent) at distance 0; chunks
    visited in key order until one's distance * 0.99999 exceeds the worst
    k-th best of the warp; candidates with a NaN d2 never enter, and a list
    left short is filled from them in (bits, index) order. Returns d2 and
    idx in the caller's order and the (tile, chunk) pairs not visited."""
    plan = knn_pruned_plan(_t(q), _t(s))
    qord, s4, boxes = (t.numpy() for t in plan)
    B, Q, _ = q.shape
    N = s.shape[1]
    NC = boxes.shape[1]
    ss = s4[..., :3]
    sidx = s4[..., 3].view(np.int32).astype(np.int64)
    d_out = np.zeros((B, Q, k), F32)
    i_out = np.zeros((B, Q, k), np.int64)
    skipped = 0
    inf = F32(np.inf)

    def add6(v):            # v0 + v1 + ... + v5 in float32, left to right
        acc = v[..., 0]
        for c in range(1, 6):
            acc = acc + v[..., c]
        return acc

    for b in range(B):
        lo, hi = boxes[b, :, 0, :3], boxes[b, :, 1, :3]
        chunk_nan = np.isnan(add6(np.concatenate([lo, hi], axis=-1)))
        for t in range(-(-Q // PRUNED_TILE)):
            rows = np.minimum(np.arange(t * PRUNED_TILE,
                                        (t + 1) * PRUNED_TILE), Q - 1)
            qs = q[b, qord[b, rows]]
            tmin, tmax = qs.min(0), qs.max(0)          # NaN-keeping
            if np.isnan(add6(np.concatenate([tmin, tmax]))):
                dist = np.zeros(NC, F32)
            else:
                gap = np.fmax(np.fmax(lo - tmax, tmin - hi), F32(0))
                dist = gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1] \
                    + gap[:, 2] * gap[:, 2]
                dist = np.where(chunk_nan, F32(0), dist)
            keys = (dist.view(np.uint32).astype(np.uint64) << np.uint64(32)
                    | np.arange(1, NC + 1, dtype=np.uint64))
            bd = np.full((PRUNED_TILE, k), inf)
            bi = np.full((PRUNED_TILE, k), SENT, np.int64)
            worst = inf
            visited = 0
            for c in np.argsort(keys):
                if dist[c] * F32(0.99999) > worst:
                    break
                visited += 1
                sl = slice(c * PRUNED_CHUNK, min((c + 1) * PRUNED_CHUNK, N))
                diff = qs[:, None, :] - ss[b, sl][None]
                sq = diff * diff
                d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
                ids = np.broadcast_to(sidx[b, sl], d2.shape)
                cd = np.concatenate([bd, np.where(np.isnan(d2), inf, d2)], 1)
                cidx = np.concatenate([bi, np.where(np.isnan(d2), SENT + 1,
                                                    ids)], 1)
                o = np.lexsort((cidx, cd), axis=1)[:, :k]
                bd = np.take_along_axis(cd, o, 1)
                bi = np.take_along_axis(cidx, o, 1)
                worst = bd[:, k - 1].max()
            skipped += NC - visited
            for lane in np.flatnonzero(bi[:, k - 1] == SENT):
                diff = qs[lane] - ss[b]
                sq = diff * diff
                d2 = sq[:, 0] + sq[:, 1] + sq[:, 2]
                nan = np.flatnonzero(np.isnan(d2))
                nan = nan[np.lexsort((sidx[b, nan],
                                      d2[nan].view(np.uint32)))]
                free = np.flatnonzero(bi[lane] == SENT)
                take = nan[:len(free)]
                bd[lane, free[:len(take)]] = d2[take]
                bi[lane, free[:len(take)]] = sidx[b, take]
            n = min(PRUNED_TILE, Q - t * PRUNED_TILE)
            dst = qord[b, t * PRUNED_TILE:t * PRUNED_TILE + n]
            d_out[b, dst] = bd[:n]
            i_out[b, dst] = bi[:n]
    return d_out, i_out, skipped


def _queries(rng, s, Q):
    """Q queries, the first half of them supports."""
    B = s.shape[0]
    return np.ascontiguousarray(np.concatenate(
        [s[:, :Q // 2], rng.standard_normal((B, Q - Q // 2, 3)).astype(
            F32)], axis=1))


@pytest.mark.parametrize("B,Q,N,k,dup", [(2, 700, 3000, 3, False),
                                         (1, 600, 2100, 4, True),
                                         (2, 130, 1000, 1, False),
                                         (1, 2000, 1200, 2, False)])
def test_knn_pruned_plan_prunes_and_stays_exact(rng, B, Q, N, k, dup):
    """The kernel's 32-query tiles and 128-support chunks: ties from
    duplicated points, ragged last tiles and chunks; equal to the plain
    version and to the Pallas kernel in interpret mode."""
    s = _cloud(rng, B, N, dup)
    q = _queries(rng, s, Q)
    d, i, skipped = _knn_pruned_emulate(q, s, k)
    d_r, i_r = ops.knn_small_k_ref(_t(q), _t(s), k)
    np.testing.assert_array_equal(i, i_r.numpy())
    np.testing.assert_array_equal(d, d_r.numpy())
    assert skipped > 0
    _, i_p = jpruned(jnp.asarray(q), jnp.asarray(s), k, interpret=True)
    np.testing.assert_array_equal(i, np.asarray(i_p))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_knn_pruned_plan_takes_nonfinite_coordinates_as_the_plain_version(
        rng, k):
    """A NaN query (its tile visits every chunk), a cloud whose supports
    are NaN but 2 finite and 1 +inf (NaN chunk boxes), and a NaN support
    among finite ones: the plain version's indices, its d2 where finite."""
    s = _cloud(rng, 2, 1500)
    q = _queries(rng, s, 400)
    q[0, 3, 1] = np.nan
    s[0, 700, 2] = np.nan
    s[1, 2:1499, 2] = np.nan
    s[1, 1499, 0] = np.inf
    d, i, _ = _knn_pruned_emulate(q, s, k)
    d_r, i_r = (t.numpy() for t in ops.knn_small_k_ref(_t(q), _t(s), k))
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_array_equal(np.isnan(d), np.isnan(d_r))
    fin = ~np.isnan(d_r)
    np.testing.assert_array_equal(d[fin], d_r[fin])


def test_pruned_plans_on_the_cpu_follow_geot_tpus_order(rng):
    """The plans' Morton order is ``geot_tpu``'s stable argsort of its
    codes; the kNN plan's rows and boxes are the sorted supports and each
    128-chunk's min and max, NaN kept."""
    xyz = _cloud(rng, 2, 1000, dup=True)
    jorder = np.asarray(jspatial_sort(jnp.asarray(xyz))[1])
    np.testing.assert_array_equal(fps_bucket_plan(_t(xyz)).numpy(), jorder)
    q = _queries(rng, xyz, 300)
    xyz[1, 5, 0] = np.nan
    plan = knn_pruned_plan(_t(q), _t(xyz))
    np.testing.assert_array_equal(
        plan.q_order.numpy(), np.asarray(jspatial_sort(jnp.asarray(q))[1]))
    order = plan.s4[..., 3].contiguous().view(torch.int32).numpy()
    np.testing.assert_array_equal(order[0], jorder[0])
    ss = np.take_along_axis(xyz, order[..., None].astype(np.int64), 1)
    np.testing.assert_array_equal(plan.s4[..., :3].numpy(), ss)
    N = ss.shape[1]
    for c in range(plan.boxes.shape[1]):
        chunk = ss[:, c * PRUNED_CHUNK:min(N, (c + 1) * PRUNED_CHUNK)]
        np.testing.assert_array_equal(plan.boxes[:, c, 0, :3].numpy(),
                                      chunk.min(1))
        np.testing.assert_array_equal(plan.boxes[:, c, 1, :3].numpy(),
                                      chunk.max(1))
    assert np.isnan(plan.boxes[1].numpy()).any()
    assert PRUNED_TILE == 32


def test_knn_pruned_order_sorts_both_clouds_at_once_as_geot_tpu(rng):
    """The kNN plan's one sort of both clouds' joint code row (the
    supports' codes tagged with bit 30) gives each cloud ``geot_tpu``'s
    stable argsort, NaN coordinates and duplicates included, and the
    prepare step over that strided, offset order gives the rows and boxes
    of the support's own order."""
    s = _cloud(rng, 2, 1100, dup=True)
    q = _queries(rng, s, 700)
    q[1, 9, 2] = np.nan
    s[0, 40, 1] = np.nan
    Q = q.shape[1]
    codes = ops.morton_codes_joint(_t(q), _t(s)).numpy()
    np.testing.assert_array_equal(codes[:, :Q],
                                  np.asarray(jmorton_codes(jnp.asarray(q))))
    np.testing.assert_array_equal(
        codes[:, Q:], np.asarray(jmorton_codes(jnp.asarray(s))) | (1 << 30))
    order = ops.knn_pruned_order(_t(q), _t(s))
    np.testing.assert_array_equal(
        order[:, :Q].numpy(), np.asarray(jspatial_sort(jnp.asarray(q))[1]))
    s_order = np.asarray(jspatial_sort(jnp.asarray(s))[1])
    np.testing.assert_array_equal(order[:, Q:].numpy() - Q, s_order)
    for got, want in zip(ops.knn_pruned_prepare(_t(s), order[:, Q:], base=Q),
                         ops.knn_pruned_prepare(_t(s), _t(s_order))):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


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
