"""The decompositions of the two Hopper kernels on the serving and training
paths, run in numpy over the wrappers' own plans, against the plain
versions and ``geot_tpu``'s Pallas kernels in interpret mode.

``csrc/fps_cluster.cu`` spreads one cloud over a cluster of C blocks, each
owning a contiguous index range (``fps_plan``), with per-thread,
per-warp, per-block and cluster-wide argmax steps merged in (key desc,
index asc) order. ``csrc/knn_split.cu`` splits the support range
(``knn_split_plan``), keeps per split the k best in (d2, index) order, and
merges the splits' lists. The CUDA kernels only run on the card
(``tests/test_torch_gpu.py``); this file checks that both decompositions
are exact, ties and ragged ranges included, and the shape rule that sends
a cloud too large for a cluster to the one-block kernel.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geot_tpu.ops.pallas_fps import fps_pallas
from geot_tpu.ops.pallas_knn import knn_small_k_pallas
from geot_tpu_torch import ops
from geot_tpu_torch.ops.fps import (CLUSTER_SIZES, CLUSTER_SLOTS,
                                    CLUSTER_THREADS, fps_cluster_size,
                                    fps_plan)
from geot_tpu_torch.ops.knn import SPLIT_MIN, SPLIT_QTILE, SPLIT_WAVES

NONE = np.uint64(0xFFFFFFFF)
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, B, N, dup=False):
    x = rng.standard_normal((B, N, 3)).astype(F32)
    if dup:       # exact duplicates: ties at equal distance everywhere
        x = np.concatenate([x, x[:, :N // 2], x[:, :N // 5]], axis=1)
    return np.ascontiguousarray(x)


# --- FPS over a cluster ------------------------------------------------------

def _fps_cluster_emulate(xyz, npoint, plan):
    """``csrc/fps_cluster.cu`` in numpy: block r owns ``plan.ranges`` [r];
    thread t of it the points lo + t + s * 256, s < slots, padding at mind
    -1; each step the first largest mind per thread, then per warp and per
    block the largest key with the smallest index, then the same over the
    C block winners."""
    B, N, _ = xyz.shape
    T, S, C = CLUSTER_THREADS, plan.slots, plan.C
    lo = np.array([r[0] for r in plan.ranges(N)])
    n = np.array([r[1] - r[0] for r in plan.ranges(N)])
    local = np.arange(S)[:, None] * T + np.arange(T)[None]      # (S, T)
    idx = lo[:, None, None] + local[None]                        # (C, S, T)
    valid = local[None] < n[:, None, None]
    out = np.zeros((B, npoint), np.int32)
    for b in range(B):
        pts = xyz[b, np.minimum(idx, N - 1)]                     # (C, S, T, 3)
        mind = np.where(valid, F32(1e10), F32(-1))
        last = xyz[b, 0]
        for j in range(1, npoint):
            diff = pts - last
            sq = diff * diff
            mind = np.minimum(mind, sq[..., 0] + sq[..., 1] + sq[..., 2])
            bs = np.argmax(mind, axis=1)                         # (C, T)
            bv = np.take_along_axis(mind, bs[:, None], 1)[:, 0]
            has = bv >= 0
            key = np.where(has, bv.view(np.uint32), 0).astype(np.uint64)
            ti = np.where(has, np.take_along_axis(idx, bs[:, None], 1)[:, 0],
                          NONE).astype(np.uint64)
            key_w = key.reshape(C, T // 32, 32)
            wkey = key_w.max(-1)
            wi = np.where(key_w == wkey[..., None],
                          ti.reshape(C, T // 32, 32), NONE).min(-1)
            ckey = wkey.max(-1)
            ci = np.where(wkey == ckey[:, None], wi, NONE).min(-1)
            gi = ci[ckey == ckey.max()].min()
            out[b, j] = gi
            last = xyz[b, gi]
    return out


@pytest.mark.parametrize("max_active,batch,want", [
    ({16: 7, 8: 16, 4: 33, 2: 66}, 6, 16),
    ({16: 6, 8: 16, 4: 33, 2: 66}, 6, 16),
    ({16: 5, 8: 16, 4: 33, 2: 66}, 6, 8),
    ({16: 5, 8: 16, 4: 33, 2: 66}, 1, 16),
    ({16: 14, 8: 30, 4: 60, 2: 120}, 40, 4),
    ({16: 14, 8: 30, 4: 60, 2: 120}, 200, 2),
    ({16: 0, 8: 3, 4: 7, 2: 66}, 6, 4),
    ({16: 0, 8: 0, 4: 0, 2: 0}, 6, 2)])
def test_cluster_size_is_the_largest_whose_batch_fits(max_active, batch,
                                                       want):
    assert fps_cluster_size(max_active, batch) == want


@pytest.mark.parametrize("N,C", [(16000, 16), (16000, 8), (5200, 16),
                                 (12345, 4), (100, 16), (7, 16),
                                 (16 * 4096, 16), (2 * 4096, 2)])
def test_fps_plan_ranges_are_contiguous_and_fit_the_slots(N, C):
    plan = fps_plan(N, C)
    assert plan.route == "fps_cluster" and plan.C == C
    ranges = plan.ranges(N)
    assert ranges[0][0] == 0 and ranges[-1][1] == N
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert a <= b == c
    assert plan.slots in CLUSTER_SLOTS
    assert plan.per_cta <= CLUSTER_THREADS * plan.slots
    smaller = [s for s in CLUSTER_SLOTS if s < plan.slots]
    assert not smaller or plan.per_cta > CLUSTER_THREADS * smaller[-1]


@pytest.mark.parametrize("C", CLUSTER_SIZES)
def test_fps_plan_routes_an_oversized_cloud_to_the_block_kernel(C):
    most = C * CLUSTER_THREADS * CLUSTER_SLOTS[-1]
    assert fps_plan(most, C).route == "fps_cluster"
    assert fps_plan(most, C).slots == CLUSTER_SLOTS[-1]
    assert fps_plan(most + 1, C).route == "fps"
    assert fps_plan(most + 1, C).ranges(most + 1) == []


@pytest.mark.parametrize("B,N,npoint,C,dup", [
    (1, 3000, 200, 16, False),
    (2, 2500, 150, 8, False),      # 2500 = 8 x 312 + 4: ragged ranges
    (6, 700, 64, 4, False),
    (1, 1300, 300, 16, True),      # duplicates: ties on the key
    (1, 1000, 90, 2, True),
    (1, 100, 130, 16, False)])     # npoint > N: all mind 0 at the end
def test_fps_cluster_decomposition_matches_ref_and_pallas(rng, B, N, npoint,
                                                          C, dup):
    xyz = _cloud(rng, B, N, dup)
    plan = fps_plan(xyz.shape[1], C)
    got = _fps_cluster_emulate(xyz, npoint, plan)
    ref = ops.fps_ref(_t(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(
        fps_pallas(jnp.asarray(xyz), npoint, interpret=True)))
    # every FPS wrapper takes the plain version on the CPU
    for fn in (ops.fps, ops.fps_block,
               lambda x, m: ops.fps_cluster(x, m, plan)):
        np.testing.assert_array_equal(fn(_t(xyz), npoint).numpy(), ref)


# --- small-k kNN split over the support range ----------------------------

def _lex_k_best(d2, ids, k, N):
    """Per row the k entries smallest in (d2, index) order, padded with
    (inf, N) as the kernel's lists start."""
    pad = max(0, k - d2.shape[1])
    d2 = np.concatenate([d2, np.full((d2.shape[0], pad), np.inf, F32)], 1)
    ids = np.concatenate([ids, np.full((ids.shape[0], pad), N)], 1)
    o = np.lexsort((ids, d2), axis=1)[:, :k]
    return np.take_along_axis(d2, o, 1), np.take_along_axis(ids, o, 1)


def _knn_split_emulate(q, s, k, plan):
    """``csrc/knn_split.cu`` in numpy: per split of ``plan`` the k best of
    its supports in (d2, index) order, then per query the k best of the S
    lists."""
    S, split_len = plan
    B, Q, _ = q.shape
    N = s.shape[1]
    d_out = np.zeros((B, Q, k), F32)
    i_out = np.zeros((B, Q, k), np.int64)
    for b in range(B):
        lists_d, lists_i = [], []
        for p in range(S):
            lo, hi = p * split_len, min(N, (p + 1) * split_len)
            assert lo < hi
            diff = q[b][:, None, :] - s[b, lo:hi][None]
            sq = diff * diff
            d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
            ids = np.broadcast_to(np.arange(lo, hi), d2.shape)
            d, i = _lex_k_best(d2, ids, k, N)
            lists_d.append(d)
            lists_i.append(i)
        d_out[b], i_out[b] = _lex_k_best(np.concatenate(lists_d, 1),
                                         np.concatenate(lists_i, 1), k, N)
    return d_out, i_out


# the serving path's 8 searches (B = 1) and the train step's (B = 2, 6)
PATH_SEARCHES = [(1, 4096, 512), (1, 8192, 512), (1, 4096, 4096),
                 (1, 8192, 4096), (1, 8192, 8192), (1, 16000, 8192),
                 (1, 40960, 16000), (2, 16000, 8192), (6, 16000, 8192),
                 (6, 4096, 512)]


@pytest.mark.parametrize("B,Q,N", PATH_SEARCHES)
def test_knn_split_plan_fills_the_card(B, Q, N):
    S, split_len = ops.knn_split_plan(B, Q, N, 132)
    assert S * split_len >= N and (S - 1) * split_len < N   # none empty
    assert S == 1 or split_len >= SPLIT_MIN
    tiles = B * -(-Q // SPLIT_QTILE)
    want = -(-SPLIT_WAVES * 132 // tiles)       # splits that fill the card
    assert S <= max(1, want)                    # and no more
    if N // SPLIT_MIN >= want:                  # not capped by split length
        assert tiles * S >= 2 * 132             # at least two waves


@pytest.mark.parametrize("B,Q,N,dup", [(1, 600, 2500, False),
                                       (2, 300, 1000, True),
                                       (6, 130, 700, False),
                                       (1, 200, 100, False)])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_knn_split_decomposition_matches_ref_and_pallas(rng, B, Q, N, dup,
                                                        k):
    s = _cloud(rng, B, N, dup)
    q = np.ascontiguousarray(np.concatenate(
        [s[:, :Q // 2], rng.standard_normal((B, Q - Q // 2, 3)).astype(F32)],
        axis=1))                               # half the queries are supports
    plan = ops.knn_split_plan(B, Q, s.shape[1], 132)
    d, i = _knn_split_emulate(q, s, k, plan)
    d_r, i_r = ops.knn_small_k_ref(_t(q), _t(s), k)
    np.testing.assert_array_equal(i, i_r.numpy())
    np.testing.assert_array_equal(d, d_r.numpy())
    # interpreted on the CPU, XLA rounds the three-term sum differently in
    # the last bit, as tests/test_torch_ops.py holds knn_small_k_pallas
    d_p, i_p = knn_small_k_pallas(jnp.asarray(q), jnp.asarray(s), k,
                                  interpret=True)
    np.testing.assert_array_equal(i, np.asarray(i_p))
    np.testing.assert_allclose(d, np.asarray(d_p), rtol=0, atol=1e-6)
    for fn in (ops.knn_small_k, ops.knn_small_k_unsplit):
        dw, iw = fn(_t(q), _t(s), k)          # CPU -> plain
        np.testing.assert_array_equal(iw.numpy(), i)
        np.testing.assert_array_equal(dw.numpy(), d)
    if dup:
        assert np.all(d[:, :Q // 2, 0] == 0.0)


def test_new_wrappers_count_no_launch_on_the_cpu(rng):
    before = dict(ops.LAUNCHES)
    xyz = _t(_cloud(rng, 1, 300))
    ops.fps(xyz, 16)
    ops.fps_block(xyz, 16)
    ops.fps_cluster(xyz, 16, fps_plan(300, 16))
    ops.knn_small_k(xyz, xyz, 4)
    ops.knn_small_k_unsplit(xyz, xyz, 4)
    assert ops.LAUNCHES == before
    assert {"fps_cluster", "knn_split"} <= set(ops.LAUNCHES)
    meta = torch.zeros((1, 300, 3), device="meta")
    for call in (lambda: ops.fps_block(meta, 8),
                 lambda: ops.fps_cluster(meta, 8, fps_plan(300, 16)),
                 lambda: ops.knn_small_k_unsplit(meta, meta, 3),
                 lambda: ops.cluster_exchange(1, 8, 2, "cpu")):
        with pytest.raises(ValueError):
            call()


def _knn_split_two_pass_emulate(q, s, k, plan):
    """The split kernel's handling of non-finite d2, query by query: the
    scan inserts finite d2 in index order (strict <); ``fill_nonfinite``
    completes a short list from the split's inf and NaN d2 by (bits of d2,
    index); the merge ranks the S lists by (bits, index), empty slots
    (index N) left out."""
    S, split_len = plan
    B, Q, _ = q.shape
    N = s.shape[1]

    def bits(d):
        return int(np.float32(d).view(np.uint32))

    def put(lst, d, j, key):
        pos = sum(1 for e in lst if key(e[0]) <= key(d))
        lst.insert(pos, (d, j))
        del lst[k:]

    d_out = np.zeros((B, Q, k), F32)
    i_out = np.zeros((B, Q, k), np.int64)
    for b in range(B):
        diff = q[b][:, None, :] - s[b][None]
        sq = diff * diff
        d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
        for r in range(Q):
            merged = []
            for p in range(S):
                lo, hi = p * split_len, min(N, (p + 1) * split_len)
                lst = []
                for j in range(lo, hi):
                    if d2[r, j] < (lst[-1][0] if len(lst) == k else np.inf):
                        put(lst, d2[r, j], j, float)
                if len(lst) < k:
                    for j in range(lo, hi):
                        if not d2[r, j] < np.inf:
                            put(lst, d2[r, j], j, bits)
                for d, j in lst:
                    put(merged, d, j, bits)
            merged += [(np.inf, N)] * (k - len(merged))
            d_out[b, r] = [d for d, _ in merged]
            i_out[b, r] = [j for _, j in merged]
    return d_out, i_out


@pytest.mark.parametrize("k", [1, 2, 4])
def test_knn_split_takes_nonfinite_coordinates_as_the_plain_version(rng, k):
    """A NaN query, NaN and inf supports: the kernel's second pass and
    bit-ranked merge give the plain version's indices (inf after every
    number, NaN after inf, equal d2 by index), never the index N; d2 equal
    where finite and NaN where the plain version's is."""
    s = _cloud(rng, 2, 150)
    q = np.ascontiguousarray(np.concatenate(
        [s[:, :10], rng.standard_normal((2, 10, 3)).astype(F32)], axis=1))
    q[0, 3, 1] = np.nan                     # every d2 of this query is NaN
    s[1, 2:149, 2] = np.nan                 # cloud 1: 2 supports finite,
    s[1, 149, 0] = np.inf                   # 1 at +inf, the rest NaN
    for S, split_len in ((1, 150), (3, 50), (5, 30)):
        d, i = _knn_split_two_pass_emulate(q, s, k, (S, split_len))
        d_r, i_r = ops.knn_small_k_ref(_t(q), _t(s), k)
        np.testing.assert_array_equal(i, i_r.numpy())
        np.testing.assert_array_equal(d, d_r.numpy())   # NaN == NaN here
        assert int(i.max()) < 150
    assert np.isnan(d[0, 3]).all()
    np.testing.assert_array_equal(i[0, 3], np.arange(k))
    if k == 4:      # the 2 finite, the inf, the first NaN
        assert set(i[1, :, :2].ravel()) == {0, 1}
        assert (i[1, :, 2] == 149).all() and (i[1, :, 3] == 2).all()
