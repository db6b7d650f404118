"""The CUDA kernels against their plain versions, and the port's forward on
the card against its CPU forward. Every test needs a CUDA device and skips
without one.

This file imports neither JAX nor ``geot_tpu``, so it runs where only
PyTorch is installed. ``tests/conftest.py`` imports JAX, so on such a
machine run it without the conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from geot_tpu_torch import ops
from geot_tpu_torch.engine.predict import load_model
from geot_tpu_torch.optim.factory import _OPTIMIZERS
from geot_tpu_torch.ops.fps import (BUCKET, CLUSTER_SIZES,
                                    card_bucket_max_active,
                                    card_cluster_size)

from torch_helpers import dense_dtypes

SMALL_ARGS = {"NAME": "PointTransformer_seg_T", "trans_dim": 48, "depth": 3,
              "num_heads": 4, "group_size": 8, "num_group": 32,
              "encoder_dims": 32, "nclasses": 17, "drop_path_rate": 0.1,
              "downsample_targets": [128, 64, 32], "extract_layers": [1, 2, 3]}

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, shape, dup=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dup:   # exact duplicates: ties at equal distance everywhere
        x = np.concatenate([x, x[:, :shape[1] // 2], x[:, :shape[1] // 5]],
                           axis=1)
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("B,N,npoint,dup", [(1, 2000, 512, False),
                                             (2, 16000, 1024, False),
                                             (1, 20000, 256, False),
                                             (1, 100, 64, False),
                                             (1, 300, 400, False),
                                             (2, 1000, 600, True)])
def test_fps_kernel_matches_plain(cuda, B, N, npoint, dup):
    xyz = _cloud(0, (B, N, 3), dup).to(cuda)
    route = ops.fps_plan(N, card_cluster_size(cuda, B)).route
    n0 = dict(ops.LAUNCHES)
    got = ops.fps(xyz, npoint)
    assert ops.LAUNCHES == dict(n0, **{route: n0[route] + 1})
    torch.testing.assert_close(got, ops.fps_ref(xyz, npoint), rtol=0, atol=0)
    assert torch.all(got[:, 0] == 0)
    torch.testing.assert_close(ops.fps_block(xyz, npoint), got, rtol=0,
                               atol=0)


# the flagship's FPS shapes (serving B = 1, teacher B = 2, student B = 6;
# the serving topology's true-FPS prefix of 1024 at B = 1 and 6), ties, a
# cloud whose ranges are ragged, and one smaller than the cluster
@pytest.mark.parametrize("B,N,npoint,dup", [(1, 16000, 8192, False),
                                             (2, 16000, 8192, False),
                                             (6, 16000, 8192, False),
                                             (1, 16000, 1024, False),
                                             (6, 16000, 1024, False),
                                             (1, 3000, 2048, True),
                                             (3, 12345, 3000, False),
                                             (1, 10, 20, False)])
def test_fps_cluster_kernel_matches_plain(cuda, B, N, npoint, dup):
    xyz = _cloud(7, (B, N, 3), dup).to(cuda)
    plan = ops.fps_plan(xyz.shape[1], card_cluster_size(cuda, B))
    assert plan.route == "fps_cluster"
    n0 = ops.LAUNCHES["fps_cluster"]
    got = ops.fps_cluster(xyz, npoint, plan)
    assert ops.LAUNCHES["fps_cluster"] == n0 + 1
    torch.testing.assert_close(got, ops.fps_ref(xyz, npoint), rtol=0, atol=0)


def _sampled(seed, B, distinct, N):
    """B clouds of N points drawn with replacement from ``distinct`` ones,
    as ``predict_scan`` samples a scan smaller than its sample."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, distinct, 3)).astype(np.float32)
    idx = rng.choice(distinct, (B, N), replace=True)
    return torch.from_numpy(np.take_along_axis(base, idx[..., None], 1))


def test_fps_on_a_duplicate_heavy_cloud(cuda):
    """2,000 distinct points sampled to 16,000 -> 1,024: min-distances
    reach 0 after 2,000 picks at most, ties everywhere before."""
    xyz = _sampled(4, 1, 2000, 16000).to(cuda)
    got = ops.fps(xyz, 1024)
    torch.testing.assert_close(got, ops.fps_ref(xyz, 1024), rtol=0, atol=0)
    small = _sampled(5, 2, 300, 16000).to(cuda)     # fewer than 1,024
    torch.testing.assert_close(ops.fps(small, 1024),
                               ops.fps_ref(small, 1024), rtol=0, atol=0)


@pytest.mark.parametrize("distinct", [None, 2000, 300])
def test_fps_stratified_on_the_card_equals_the_cpu(cuda, distinct):
    xyz = (_cloud(6, (2, 16000, 3)) if distinct is None
           else _sampled(6, 2, distinct, 16000))
    n0 = ops.LAUNCHES["fps_cluster"]
    got = ops.fps_stratified(xyz.to(cuda), 16000, 1024)
    assert ops.LAUNCHES["fps_cluster"] == n0 + 1
    want = ops.fps_stratified(xyz, 16000, 1024)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert torch.equal(got.sort(dim=1).values.cpu(),
                       torch.arange(16000, dtype=torch.int32).expand(2, -1))


def test_fps_routes_an_oversized_cloud_to_the_block_kernel(cuda):
    """A cloud past what the bucket kernel's clusters hold goes to the
    one-block kernel."""
    C = card_cluster_size(cuda, 1)
    xyz = _cloud(8, (1, ops.bucket_capacity(16) + 1, 3)).to(cuda)
    assert ops.fps_plan(xyz.shape[1], C).route == "fps"
    n0 = dict(ops.LAUNCHES)
    got = ops.fps(xyz, 200)
    assert ops.LAUNCHES == dict(n0, fps=n0["fps"] + 1)
    torch.testing.assert_close(got, ops.fps_ref(xyz, 200), rtol=0, atol=0)


@pytest.mark.parametrize("N", [16 * 4096 + 1, 150000])
def test_fps_routes_a_cloud_past_the_cluster_to_the_bucket_kernel(cuda, N):
    """A cloud past the cluster kernel's registers (C x 4,096 points) and
    within the bucket kernel's shared memory goes to the bucket kernel
    (its plan's Morton launch, then the kernel), bit-equal to the one-block
    kernel it replaced there."""
    C = card_cluster_size(cuda, 1)
    xyz = _cloud(8, (1, N, 3)).to(cuda)
    assert ops.fps_plan(N, C).route == "fps"
    n0 = dict(ops.LAUNCHES)
    got = ops.fps(xyz, 1000)
    assert ops.LAUNCHES == dict(n0, fps_bucket=n0["fps_bucket"] + 1,
                                morton=n0["morton"] + 1)
    torch.testing.assert_close(got, ops.fps_block(xyz, 1000), rtol=0,
                               atol=0)


def test_cluster_exchange_runs_at_every_size(cuda):
    for C in CLUSTER_SIZES:
        won = ops.cluster_exchange(2, 300, C, cuda)
        torch.cuda.synchronize()
        assert bool(((won >= 0) & (won < C)).all())


@pytest.mark.parametrize("Q,N,k,dup", [(300, 450, 3, False),
                                       (130, 200, 1, False),
                                       (5000, 4100, 4, False),
                                       (48, 64, 2, True),
                                       (4096, 2048, 4, True)])
def test_knn_kernel_matches_plain(cuda, Q, N, k, dup):
    s = _cloud(1, (2, N, 3), dup).to(cuda)
    q = torch.cat([s[:, :Q // 2], _cloud(2, (2, Q - Q // 2, 3)).to(cuda)],
                  dim=1).contiguous()          # half the queries are supports
    n0 = dict(ops.LAUNCHES)
    d, i = ops.knn_small_k(q, s, k)
    assert ops.LAUNCHES == dict(n0, knn_split=n0["knn_split"] + 1)
    d_r, i_r = ops.knn_small_k_ref(q, s, k)
    torch.testing.assert_close(i, i_r, rtol=0, atol=0)
    torch.testing.assert_close(d, d_r, rtol=0, atol=0)
    n0 = ops.LAUNCHES["knn_small_k"]
    d_u, i_u = ops.knn_small_k_unsplit(q, s, k)
    assert ops.LAUNCHES["knn_small_k"] == n0 + 1
    torch.testing.assert_close(i_u, i_r, rtol=0, atol=0)
    torch.testing.assert_close(d_u, d_r, rtol=0, atol=0)


# the serving path's 8 searches (Q, N, k), and the training student's
# B = 6 at the largest, plus ties
@pytest.mark.parametrize("B,Q,N,k,dup", [
    (1, 4096, 512, 3, False), (1, 8192, 512, 3, False),
    (1, 4096, 512, 4, False), (1, 4096, 4096, 4, False),
    (1, 8192, 4096, 4, False), (1, 8192, 8192, 4, False),
    (1, 16000, 8192, 3, False), (1, 40960, 16000, 3, False),
    (6, 16000, 8192, 3, False), (1, 4096, 3000, 4, True),
    # the serving topology's searches: the non-prefix rows of the three
    # FeaturePropagation levels, at B = 1 and at the student's B = 6
    (1, 3584, 512, 3, False), (1, 7680, 512, 3, False),
    (1, 7808, 8192, 3, False), (6, 7808, 8192, 3, False),
    (6, 8192, 4096, 4, False)])
def test_knn_split_kernel_matches_plain_at_path_shapes(cuda, B, Q, N, k, dup):
    s = _cloud(9, (B, N, 3), dup).to(cuda)
    q = torch.cat([s[:, :min(Q, s.shape[1]) // 2],
                   _cloud(10, (B, Q - min(Q, s.shape[1]) // 2, 3)).to(cuda)],
                  dim=1).contiguous()
    n0 = ops.LAUNCHES["knn_split"]
    d, i = ops.knn_split(q, s, k)
    assert ops.LAUNCHES["knn_split"] == n0 + 1
    d_r, i_r = ops.knn_small_k_ref(q, s, k)
    torch.testing.assert_close(i, i_r, rtol=0, atol=0)
    torch.testing.assert_close(d, d_r, rtol=0, atol=0)
    # the path's route at this shape (the pruned kernel at the upsample)
    d_p, i_p = ops.knn_small_k(q, s, k)
    assert torch.equal(i_p, i) and torch.equal(d_p, d)


def _bucket_count(B, N, C):
    """How many buckets ``fps_bucket``'s C blocks hold for B clouds of N
    points (the (step, bucket) updates of one step)."""
    per = -(-N // C)
    return B * sum(-(-max(0, min(N - r * per, per)) // BUCKET)
                   for r in range(C))


# the training FPS shape, small and ragged clouds, ties, a cloud just past
# the cluster kernel's capacity (C x 4,096 points: the route "fps") and a
# whole 150,000-point scan
@pytest.mark.parametrize("B,N,npoint,dup", [(1, 16000, 8192, False),
                                             (2, 2500, 700, False),
                                             (1, 30000, 300, False),
                                             (1, 100, 64, False),
                                             (2, 1000, 600, True),
                                             (1, 16 * 4096 + 1, 2000, False),
                                             (1, 150000, 8192, False)])
def test_fps_bucket_kernel_matches_plain_and_fps(cuda, B, N, npoint, dup):
    xyz = _cloud(4, (B, N, 3), dup).to(cuda)
    n0 = dict(ops.LAUNCHES)
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = ops.fps_bucket(xyz, npoint, skipped=skipped)
    assert ops.LAUNCHES == dict(n0, fps_bucket=n0["fps_bucket"] + 1,
                                morton=n0["morton"] + 1)
    torch.testing.assert_close(got, ops.fps_bucket_ref(xyz, npoint), rtol=0,
                               atol=0)
    path = (ops.fps(xyz, npoint) if N <= 16 * 4096
            else ops.fps_block(xyz, npoint))
    torch.testing.assert_close(got, path, rtol=0, atol=0)
    C = ops.fps_bucket_size(card_bucket_max_active(cuda), B, xyz.shape[1])
    assert 0 <= int(skipped) <= (npoint - 1) * _bucket_count(
        B, xyz.shape[1], C)


def test_fps_bucket_at_smaller_clusters_and_a_nan_coordinate(cuda):
    """Batches too large for clusters of 16 run on smaller ones, with the
    same indices; a NaN coordinate is taken as the cluster kernel takes it
    (its d2 leaves the min-distance as it is)."""
    sizes = set()
    for B in (1, 8, 16):
        xyz = _cloud(5, (B, 20000, 3)).to(cuda)
        sizes.add(ops.fps_bucket_size(card_bucket_max_active(cuda), B,
                                      20000))
        torch.testing.assert_close(ops.fps_bucket(xyz, 3000),
                                   ops.fps(xyz, 3000), rtol=0, atol=0)
    assert len(sizes) > 1
    xyz = _cloud(5, (2, 20000, 3)).to(cuda)
    xyz[0, 77, 1] = float("nan")
    xyz[1, 1000:1100, 0] = float("nan")
    torch.testing.assert_close(ops.fps_bucket(xyz, 500), ops.fps(xyz, 500),
                               rtol=0, atol=0)


def test_morton_kernel_matches_morton_codes(cuda):
    """The plans' first launch: both clouds' codes in one launch (one
    joint row, the second cloud's tagged), bit-equal to ``morton_codes``
    on the card, ragged sizes and duplicates; the plans' orders equal the
    stable sorts of those codes."""
    a = _cloud(3, (2, 16000, 3), dup=True).to(cuda)
    b = _cloud(4, (2, 777, 3)).to(cuda)
    for x in (a, b, a[:, :5].contiguous()):
        n0 = ops.LAUNCHES["morton"]
        assert torch.equal(ops.morton_codes_kernel(x), ops.morton_codes(x))
        assert ops.LAUNCHES["morton"] == n0 + 1
    n0 = ops.LAUNCHES["morton"]
    joint = ops.morton_codes_kernel(a, b)
    assert ops.LAUNCHES["morton"] == n0 + 1
    assert torch.equal(joint, ops.morton_codes_joint(a, b))
    n = a.shape[1]
    assert torch.equal(joint[:, :n], ops.morton_codes(a))
    assert torch.equal(joint[:, n:], ops.morton_codes(b) | (1 << 30))
    assert torch.equal(ops.fps_bucket_plan(a), torch.sort(
        ops.morton_codes(a), dim=-1, stable=True).indices)
    plan = ops.knn_pruned_plan(b, a)
    cpu = ops.knn_pruned_plan(b.cpu(), a.cpu())
    for got, want in zip(plan, cpu):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("Q,N,k,dup", [(300, 450, 3, False),
                                       (130, 200, 1, False),
                                       (5000, 4100, 4, False),
                                       (16000, 8192, 3, False),
                                       (48, 64, 2, True),
                                       (4096, 2048, 4, True)])
def test_knn_pruned_kernel_matches_plain_and_knn(cuda, Q, N, k, dup):
    s = _cloud(5, (2, N, 3), dup).to(cuda)
    q = torch.cat([s[:, :Q // 2], _cloud(6, (2, Q - Q // 2, 3)).to(cuda)],
                  dim=1).contiguous()          # half the queries are supports
    n0 = dict(ops.LAUNCHES)
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    d, i = ops.knn_small_k_pruned(q, s, k, skipped=skipped)
    assert ops.LAUNCHES == dict(
        n0, knn_small_k_pruned=n0["knn_small_k_pruned"] + 1,
        morton=n0["morton"] + 1,
        knn_pruned_prepare=n0["knn_pruned_prepare"] + 1)
    for d_r, i_r in (ops.knn_small_k_pruned_ref(q, s, k),
                     ops.knn_small_k(q, s, k)):
        torch.testing.assert_close(i, i_r, rtol=0, atol=0)
        torch.testing.assert_close(d, d_r, rtol=0, atol=0)
    assert 0 <= int(skipped) <= 2 * -(-q.shape[1] // 32) * -(-N // 128)


@pytest.mark.parametrize("B,Q,N,k", [(1, 40960, 16000, 3),
                                     (1, 155648, 16000, 3),
                                     (1, 24576, 16000, 3),
                                     (1, 32768, 16000, 3),
                                     (2, 16000, 16000, 2),
                                     (1, 16000, 8192, 3)])
def test_knn_route_at_its_crossover_shapes(cuda, B, Q, N, k):
    """``knn_route`` takes the pruned kernel from ``PRUNED_MIN_PAIRS``
    pairs a cloud on (the upsamples of 40,000- and 150,000-point scans),
    ``knn_split`` below (propagation_0, the top2 self-search); either way
    the route is bit-equal to the other kernel."""
    from geot_tpu_torch.ops.knn import PRUNED_MIN_PAIRS

    s = _cloud(11, (B, N, 3)).to(cuda)
    q = torch.cat([s[:, :min(Q, N) // 2],
                   _cloud(12, (B, Q - min(Q, N) // 2, 3)).to(cuda)],
                  dim=1).contiguous()
    route = ops.knn_route(Q, N)
    assert (route == "knn_small_k_pruned") == (Q * N >= PRUNED_MIN_PAIRS)
    n0 = dict(ops.LAUNCHES)
    d, i = ops.knn_small_k(q, s, k)
    assert ops.LAUNCHES[route] == n0[route] + 1
    other = (ops.knn_split if route == "knn_small_k_pruned"
             else ops.knn_small_k_pruned)
    d_o, i_o = other(q, s, k)
    assert torch.equal(i, i_o) and torch.equal(d, d_o)


def test_knn_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 200, 3), device=cuda)
    with pytest.raises(ValueError):
        ops.knn_small_k(q, q, 5)
    with pytest.raises(ValueError):
        ops.knn_small_k(q.double(), q.double(), 3)
    with pytest.raises(ValueError):
        ops.knn_small_k(q, q.cpu(), 3)
    with pytest.raises(ValueError):
        ops.fps(q[:, ::2], 8)                   # not contiguous
    with pytest.raises(ValueError):
        ops.fps(q.double(), 8)
    with pytest.raises(ValueError):
        ops.fps_cluster(q, 8, ops.FpsPlan("fps"))
    with pytest.raises(ValueError):
        ops.knn_small_k_pruned(q, q, 5)
    with pytest.raises(ValueError):
        ops.fps_bucket(torch.zeros((1, ops.bucket_capacity(16) + 1, 3),
                                   device=cuda), 8)


def test_forward_on_the_card_matches_the_cpu(cuda):
    cpu = load_model(SMALL_ARGS, seed=1, device="cpu")
    gpu = load_model(SMALL_ARGS, seed=1, device=cuda)
    pts = _cloud(3, (2, 256, 3))
    n0 = dict(ops.LAUNCHES)
    with torch.no_grad():
        a = cpu(pts)[0]
        b = gpu(pts.to(cuda))[0].cpu()
    assert ops.LAUNCHES["fps_cluster"] == n0["fps_cluster"] + 1
    assert ops.LAUNCHES["knn_split"] > n0["knn_split"]
    assert ops.LAUNCHES["fps"] == n0["fps"]
    assert ops.LAUNCHES["knn_small_k"] == n0["knn_small_k"]
    assert (a - b).abs().max().item() <= 1e-3
    assert (a.argmax(-1) == b.argmax(-1)).float().mean().item() >= 0.999


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_fast_forward_on_the_card_matches_the_cpu(cuda, dtype):
    """The serving topology (prefix 64 of 256 points, fast_graph) on the
    card against the CPU; in bfloat16 both sides round in bfloat16, so the
    bar is the statistical one of ``tests/test_torch_fast.py``."""
    args = dict(SMALL_ARGS, fast_pyramid=64, fast_graph=True, dtype=dtype)
    cpu = load_model(args, seed=1, device="cpu")
    gpu = load_model(args, seed=1, device=cuda)
    pts = _cloud(3, (4, 256, 3))
    n0 = dict(ops.LAUNCHES)
    with torch.no_grad():
        a = cpu(pts)[0]
        b = gpu(pts.to(cuda))[0].cpu()
    assert ops.LAUNCHES["fps_cluster"] == n0["fps_cluster"] + 1
    assert ops.LAUNCHES["fps"] == n0["fps"]
    assert b.dtype == torch.float32
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    if dtype is None:
        assert (a - b).abs().max().item() <= 1e-3
        assert agree >= 0.999
    else:
        assert agree >= 0.98


# --- the semi step's branches on the card ------------------------------------

def test_knn_split_self_search_of_a_whole_cloud(cuda):
    """``Poly1FocalLoss_U_top2``'s k = 2 self-search, (2, 16000) x (2,
    16000): bit-equal to the plain version on a sampled scan and on 2,000
    distinct points sampled to 16,000 (column 0 is then often a copy of
    the query with a smaller index), and launched through ``ops.knn``."""
    rng = np.random.default_rng(4)
    scan = _cloud(5, (2, 16000, 3)).to(cuda)
    base = rng.standard_normal((2, 2000, 3)).astype(np.float32)
    dup = torch.from_numpy(np.ascontiguousarray(
        base[:, rng.integers(0, 2000, 16000)])).to(cuda)
    for xyz in (scan, dup):
        n0 = ops.LAUNCHES["knn_split"]
        d, i = ops.knn(xyz, xyz, 2, squared=True)
        assert ops.LAUNCHES["knn_split"] == n0 + 1
        d_r, i_r = ops.knn_small_k_ref(xyz, xyz, 2)
        assert torch.equal(i, i_r) and torch.equal(d, d_r)
    assert bool((i[..., 0] != torch.arange(16000, device=cuda)).any())
    S, split_len = ops.knn_split_plan(
        2, 16000, 16000,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert S > 1 and S * split_len >= 16000 > (S - 1) * split_len


def _semi_cfg(**extra):
    from geot_tpu_torch import FLAGSHIP_SEMI_CFG

    return dict(FLAGSHIP_SEMI_CFG, num_points=256, batch_size_l=1,
                batch_size_u=1, **extra)


def _semi_batches(device):
    from geot_tpu_torch.data.build import (MODEL_KEYS, build_semi_loaders,
                                           semi_keys, semi_pairs, to_device)

    cfg = _semi_cfg()
    loaders = build_semi_loaders(cfg)
    for loader in loaders:
        loader.set_epoch(1)
    bl, bu = next(semi_pairs(*loaders))
    return (to_device(bl, MODEL_KEYS, device),
            to_device(bu, semi_keys(bu), device))


def test_bf16_train_step_on_the_card(cuda):
    """One semi step with ``segmentor_args.dtype: bfloat16`` on the card
    beside a float32 step from the same state and batch: its Dense layers
    return bfloat16 (the float32 step's only float32), finite losses
    within 5e-2 of the float32 ones and each off it, float32 parameters,
    optimizer state
    and statistics after it, and kernels 1 and 2 launched as often as in
    float32 (they read float32 coordinates: handed a bfloat16 cloud they
    raise)."""
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    cfg = _semi_cfg()
    seg = dict(SMALL_ARGS, drop_path_rate=0.0, head_dropout=0.0)
    bl, bu = _semi_batches(cuda)
    states = {dt: SemiTrainState.create(cfg, seg_args=dict(seg, dtype=dt),
                                        seed=2, device=cuda)
              for dt in ("float32", "bfloat16")}
    states["bfloat16"].load_state_dict(states["float32"].state_dict())
    out = {}
    for dt, state in states.items():
        ops.reset_launches()
        with dense_dtypes(state.model, state.teacher) as seen:
            m = make_semi_step(cfg)(state, bl, bu, 1e-3, True)
        torch.cuda.synchronize()
        out[dt] = ({k: float(m[k]) for k in ("loss", "sup_loss",
                                             "unsup_loss", "threed_loss")},
                   dict(ops.LAUNCHES), seen)
    (l32, n32, s32), (l16, n16, s16) = out["float32"], out["bfloat16"]
    assert torch.bfloat16 in s16 and s32 == {torch.float32}, (s16, s32)
    assert n16 == n32 and n16["fps_cluster"] > 0 and n16["knn_split"] > 0
    for k, v in l16.items():
        assert np.isfinite(v), k
        assert abs(v - l32[k]) <= 5e-2 * abs(l32[k]), (k, v, l32[k])
        assert v != l32[k], k
    st = states["bfloat16"]
    for mod in (st.model, st.teacher, st.t_predictor):
        for k, v in mod.state_dict().items():
            assert not v.is_floating_point() or v.dtype == torch.float32, k
    for opt in (st.opt, st.t_opt):
        for s in opt.state.values():
            for k, v in s.items():
                assert not torch.is_tensor(v) or not v.is_floating_point() \
                    or v.dtype == torch.float32, k
    pos = bl["pos"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        ops.fps(pos, 64)
    with pytest.raises(ValueError, match="float32"):
        ops.knn_small_k(pos, pos, 3)


def test_deterministic_seed_then_a_flagship_forward(cuda, monkeypatch):
    """``set_random_seed(deterministic=True)`` and then the flagship's
    forward at full width (16,000 points, D = 384): cuBLAS takes the
    deterministic mode (the seed sets its workspace), and two forwards
    are equal. The flags are set back after."""
    from geot_tpu_torch import FLAGSHIP_SEG_ARGS
    from geot_tpu_torch.core import set_random_seed

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        set_random_seed(0, deterministic=True)
        model = load_model(FLAGSHIP_SEG_ARGS, seed=1, device=cuda)
        pts = _cloud(4, (2, 16000, 3)).to(cuda)
        with torch.no_grad():
            a, b = model(pts)[0], model(pts)[0]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]
        torch.backends.cudnn.benchmark = before[3]
    assert a.shape == (2, 16000, 17) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_all_flags_step_on_the_card_matches_the_cpu(cuda, dtype):
    """Feature-space, identity and contrast losses, ``pseudo_refine`` and
    ``filter_outlier`` on top of the 3D loss, teacher on, the same contrast
    draws on both devices: ``ptr`` advanced by the same count, every loss
    term within 1e-4 relative but the feature-space term, a sum of +1 and
    -1 weighted distances over 17-channel neighbour sets that follow the
    float32 rounding of random init's near-equal softmax rows: it is held
    within 1e-3 of the whole loss, and the rest of the loss within 1e-4
    (``chip_smoke.py`` phase 11's bounds)."""
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    cfg = _semi_cfg(use_feat_loss=True, use_identity_loss=True,
                    use_contrastive=True, contrast_threshold=0.0,
                    pseudo_refine=True, filter_outlier=True)
    seg = dict(SMALL_ARGS, drop_path_rate=0.0, head_dropout=0.0)
    gen = torch.Generator().manual_seed(3)
    draws = {"contrast": (torch.rand((1, 256), generator=gen),
                          torch.randperm(256, generator=gen))}
    out = {}
    for dev in ("cpu", cuda):
        state = SemiTrainState.create(cfg, seg_args=seg, seed=2, device=dev)
        for mod in (state.model, state.teacher, state.t_predictor):
            mod.to(dtype)
        state.ema_t, state.cm = state.ema_t.to(dtype), state.cm.to(dtype)
        state.contrast.queue = state.contrast.queue.to(dtype)
        bl, bu = ({k: (v.to(dtype) if v.is_floating_point() else v)
                   for k, v in b.items()} for b in _semi_batches(dev))
        m = make_semi_step(cfg)(
            state, bl, bu, 1e-3, True,
            draws={k: tuple(t.to(dev) for t in v) for k, v in draws.items()})
        out[str(dev)] = ({k: float(m[k]) for k in (
            "loss", "sup_loss", "unsup_loss", "feat_loss", "identity_loss",
            "threed_loss", "contrast_loss")}, int(state.contrast.ptr))
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    assert pc == pg > 0
    for d in (lc, lg):
        d["loss"] -= d["feat_loss"]
    for k, v in lc.items():
        tol = 1e-3 * abs(lc["loss"] + lc["feat_loss"]) if k == "feat_loss" \
            else 1e-4 * abs(v)
        assert np.isfinite(lg[k]) and abs(lg[k] - v) <= tol, k


def test_nonfinite_guard_on_the_card(cuda):
    """A batch holding a NaN: ``skipped`` 1 and every tensor of the state
    bit-equal to before the step (``step`` and the generator apart)."""
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    cfg = _semi_cfg(skip_nonfinite_updates=True, ema_eval=0.9,
                    use_contrastive=True, contrast_threshold=0.0)
    state = SemiTrainState.create(cfg, seg_args=SMALL_ARGS, seed=2,
                                  device=cuda)
    step = make_semi_step(cfg)
    bl, bu = _semi_batches(cuda)
    assert float(step(state, bl, bu, 1e-3, True)["skipped"]) == 0.0

    def flat(sd, prefix=""):
        out = {}
        for k, v in sd.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            elif isinstance(v, torch.Tensor):
                out[prefix + str(k)] = v.clone()
        return out

    before = flat(state.state_dict())
    poisoned = dict(bu, pos_s=bu["pos_s"].clone())
    poisoned["pos_s"][0, 0, 0] = float("nan")
    m = step(state, bl, poisoned, 1e-3, True)
    assert float(m["skipped"]) == 1.0 and float(m["loss"]) == 0.0
    after = flat(state.state_dict())
    assert before.keys() == after.keys()
    for k, v in before.items():
        if k != "generator":
            assert torch.equal(v, after[k]), k
    m = step(state, bl, bu, 1e-3, True)
    assert float(m["skipped"]) == 0.0
    assert not torch.equal(before["model/segmentor.seg_head.0.weight"],
                           state.model.state_dict()[
                               "segmentor.seg_head.0.weight"])


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_knn_kernels_take_nonfinite_coordinates_as_the_plain_version(cuda,
                                                                     k):
    """A NaN query and NaN and inf supports, one split and several: both
    small-k kernels return the plain version's indices (never the index
    N, which a gather downstream would read out of bounds) and its d2
    where finite, NaN where it is NaN."""
    s = _cloud(6, (2, 3000, 3))
    q = torch.cat([s[:, :300], _cloud(7, (2, 300, 3))], dim=1).contiguous()
    q[0, 3, 1] = float("nan")
    s[1, 2:2999, 2] = float("nan")     # cloud 1: 2 finite supports, 1 at
    s[1, 2999, 0] = float("inf")       # +inf, the rest NaN
    q, s = q.to(cuda), s.to(cuda)
    d_r, i_r = ops.knn_small_k_ref(q, s, k)
    for fn in (ops.knn_small_k, ops.knn_small_k_unsplit):
        d, i = fn(q, s, k)
        assert torch.equal(i, i_r), fn.__name__
        assert torch.equal(torch.isnan(d), torch.isnan(d_r))
        fin = ~torch.isnan(d_r)
        assert torch.equal(d[fin], d_r[fin])
    assert torch.equal(i_r[0, 3].cpu(), torch.arange(k, dtype=torch.int32))
    assert int(i_r.max()) < 3000


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_pruned_knn_kernel_takes_nonfinite_coordinates_as_the_plain_version(
        cuda, k):
    """The same clouds through the Morton-pruned kernel: the plain
    version's indices for the NaN query and for every query of the cloud
    whose supports are NaN but 2 finite and 1 +inf (whose boxes are NaN),
    its d2 where finite, NaN where it is NaN."""
    s = _cloud(6, (2, 3000, 3))
    q = torch.cat([s[:, :300], _cloud(7, (2, 300, 3))], dim=1).contiguous()
    q[0, 3, 1] = float("nan")
    s[1, 2:2999, 2] = float("nan")
    s[1, 2999, 0] = float("inf")
    q, s = q.to(cuda), s.to(cuda)
    d_r, i_r = ops.knn_small_k_pruned_ref(q, s, k)
    d, i = ops.knn_small_k_pruned(q, s, k)
    assert torch.equal(i, i_r)
    assert torch.equal(torch.isnan(d), torch.isnan(d_r))
    fin = ~torch.isnan(d_r)
    assert torch.equal(d[fin], d_r[fin])


# --- the supervised tooth zoo (cfgs/tooth_sup) ---------------------------------

# the small widths of tests/test_supervised_zoo.py, dropout off
ZOO_TINY = {
    "pointnet2": ["model.encoder_args.width=8",
                  "model.encoder_args.num_samples=8",
                  "model.encoder_args.strides=[4,4]",
                  "model.encoder_args.blocks=[1,1]",
                  "model.cls_args.mlps=[16]",
                  "model.cls_args.dropout_ratio=0.0"],
    "dgcnn": ["model.encoder_args.channels=8",
              "model.encoder_args.embed_dim=32",
              "model.encoder_args.n_blocks=3", "model.encoder_args.k=8",
              "model.cls_args.mlps=[16]", "model.cls_args.dropout_ratio=0.0"],
    "pointmlp": ["model.embed_dim=8", "model.dim_expansion=[2,2]",
                 "model.pre_blocks=[1,1]", "model.pos_blocks=[1,1]",
                 "model.k_neighbors=[8,8]", "model.reducers=[4,4]",
                 "model.de_dims=[16,16]", "model.de_blocks=[1,1]",
                 "model.gmp_dim=8", "model.cls_dim=8"],
    "transformer": ["model.segmentor_args.trans_dim=48",
                    "model.segmentor_args.depth=3",
                    "model.segmentor_args.group_size=8",
                    "model.segmentor_args.num_group=32",
                    "model.segmentor_args.encoder_dims=32",
                    "model.segmentor_args.downsample_targets=[128,64,32]",
                    "model.segmentor_args.extract_layers=[1,2,3]",
                    "model.segmentor_args.drop_path_rate=0.0",
                    "model.segmentor_args.head_dropout=0.0"],
}


def _chain(cuda, B=4):
    """The FPS pyramid of PointNet++ and PointMLP, 16000 -> 4000 -> 1000
    -> 250 -> 62, on B clouds (4 in training, 1 when serving): [(xyz,
    npoint, idx), ...] and the levels."""
    levels = [_cloud(8, (B, 16000, 3)).to(cuda)]
    calls = []
    for npoint in (4000, 1000, 250, 62):
        x = levels[-1]
        idx = ops.fps(x, npoint)
        calls.append((x, npoint, idx))
        levels.append(ops.gather_points(x, idx).contiguous())
    return calls, levels


def test_fps_at_the_zoo_chain_and_its_edge_cases(cuda):
    """Each FPS of the chain at B = 4 is bit-equal to ``fps_ref``; so are
    a 62-point cloud on a 16-block cluster and a cloud of 40 distinct
    points sampled to 1000, where index 0 repeats once every min-distance
    is 0."""
    calls, levels = _chain(cuda)
    for x, npoint, idx in calls:
        assert torch.equal(idx, ops.fps_ref(x, npoint)), (x.shape, npoint)
    x62 = levels[-1]
    plan = ops.fps_plan(62, 16)
    assert plan.route == "fps_cluster" and plan.C == 16
    assert torch.equal(ops.fps_cluster(x62, 30, plan), ops.fps_ref(x62, 30))
    sel = torch.from_numpy(np.random.default_rng(4).choice(40, 1000))
    few = levels[0][:, :40][:, sel.to(cuda)].contiguous()
    got = ops.fps(few, 250)
    assert torch.equal(got, ops.fps_ref(few, 250))
    assert int((got[:, 40:] == 0).sum()) == 4 * 210
    x4 = _cloud(9, (4, 16000, 3)).to(cuda)
    assert torch.equal(ops.fps(x4, 8192), ops.fps_ref(x4, 8192))


def test_knn_split_at_the_decoder_shapes(cuda):
    """The decoders' k = 3 searches at B = 4 (supports of 62, 250, 1000
    and 4000 points; 62 is under the 64-per-split minimum, one split) and
    a support with duplicates: bit-equal to ``knn_small_k_ref``."""
    _, lv = _chain(cuda)
    dup = torch.cat([lv[2], lv[2][:, :500]], dim=1).contiguous()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ops.knn_split_plan(4, 250, 62, sms)[0] == 1
    for q, s in ((lv[3], lv[4]), (lv[2], lv[3]), (lv[1], lv[2]),
                 (lv[0], lv[1]), (lv[1], dup)):
        n0 = ops.LAUNCHES["knn_split"]
        d, i = ops.knn(q, s, 3, squared=True)
        assert ops.LAUNCHES["knn_split"] == n0 + 1
        d_r, i_r = ops.knn_small_k_ref(q, s, 3)
        assert torch.equal(i, i_r) and torch.equal(d, d_r), (q.shape,
                                                            s.shape)


def test_fps_and_knn_at_the_zoo_shapes_when_serving(cuda):
    """A served zoo scan (B = 1): each FPS of the chain runs on the card's
    cluster size for one cloud and is bit-equal to ``fps_ref``; the four
    decoder searches are bit-equal to ``knn_small_k_ref``."""
    calls, lv = _chain(cuda, B=1)
    for x, npoint, idx in calls:
        assert torch.equal(idx, ops.fps_ref(x, npoint)), (x.shape, npoint)
    for q, s in ((lv[3], lv[4]), (lv[2], lv[3]), (lv[1], lv[2]),
                 (lv[0], lv[1])):
        n0 = ops.LAUNCHES["knn_split"]
        d, i = ops.knn(q, s, 3, squared=True)
        assert ops.LAUNCHES["knn_split"] == n0 + 1
        d_r, i_r = ops.knn_small_k_ref(q, s, 3)
        assert torch.equal(i, i_r) and torch.equal(d, d_r), (q.shape,
                                                            s.shape)


def test_upsample_search_of_a_150000_point_scan(cuda):
    """The full-resolution upsample of a 150,000-vertex scan: its points
    padded to 19 x 8,192 = 155,648 rows (``engine.eval.pad_to_bucket``)
    against 16,000 sampled points, k = 3: routed to the pruned kernel with
    its plan, bit-equal to the plain version and to the split kernel."""
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan, pc_norm
    from geot_tpu_torch.engine.eval import pad_to_bucket

    pts, _ = _synthetic_scan(3, 150000)
    norm, _, _ = pc_norm(pts)
    full = torch.from_numpy(pad_to_bucket(norm, 8192))[None].to(cuda)
    sel = np.random.default_rng(0).choice(150000, 16000, replace=False)
    sup = torch.from_numpy(np.ascontiguousarray(norm[sel]))[None].to(cuda)
    assert full.shape == (1, 155648, 3)
    n0 = dict(ops.LAUNCHES)
    d, i = ops.knn(full.contiguous(), sup, 3, squared=True)
    assert ops.LAUNCHES == dict(
        n0, knn_small_k_pruned=n0["knn_small_k_pruned"] + 1,
        morton=n0["morton"] + 1,
        knn_pruned_prepare=n0["knn_pruned_prepare"] + 1)
    d_r, i_r = ops.knn_small_k_ref(full.contiguous(), sup, 3)
    assert torch.equal(i, i_r) and torch.equal(d, d_r)
    d_s, i_s = ops.knn_split(full.contiguous(), sup, 3)
    assert torch.equal(i, i_s) and torch.equal(d, d_s)


def _write_obj(path, pts):
    with open(path, "w") as f:
        f.writelines(f"v {x!r} {y!r} {z!r}\n"
                     for x, y, z in pts.astype(np.float64).tolist())


def test_predict_cli_on_an_obj_directory_on_the_card(cuda, tmp_path):
    """``engine.predict`` on a directory of OBJ scans on the card, the
    flagship YAML at the small width: one JSON per scan with FDI codes of
    its jaw and ``n_points`` equal to its vertex count, and the labels of
    the same CLI on the CPU at argmax agreement >= 0.999 (float32
    near-ties)."""
    import json
    import os

    from geot_tpu_torch.data.tooth_semi import _synthetic_scan
    from geot_tpu_torch.engine import predict

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scans = tmp_path / "scans"
    scans.mkdir()
    sizes = {"p0_lower": 3000, "p1_upper": 5000}
    for stem, n in sizes.items():
        _write_obj(scans / f"{stem}.obj", _synthetic_scan(len(stem) + n, n)[0])
    small = [f"model.segmentor_args.{k}={v}".replace(" ", "")
             for k, v in SMALL_ARGS.items() if k != "NAME"] + \
        ["num_points=256"]
    cfg = os.path.join(root, "cfgs", "tooth_semi",
                       "transformer_finetune_fixmatch_ntm.yaml")
    out = {}
    for dev in ("cuda", "cpu"):
        n = predict.main(["--cfg", cfg, "--input", str(scans), "--output",
                          str(tmp_path / dev), "--seed", "1", *small,
                          f"device={dev}"])
        assert n == 2
        out[dev] = {stem: json.loads((tmp_path / dev / f"{stem}.json")
                                     .read_text()) for stem in sizes}
    for stem, n in sizes.items():
        got, want = out["cuda"][stem], out["cpu"][stem]
        jaw = 0 if "lower" in stem else 1
        assert got["n_points"] == n and got["jaw"] == want["jaw"]
        assert all(lab == 0 or (30 < lab < 50 if jaw == 0 else 10 < lab < 30)
                   for lab in got["labels"])
        agree = np.mean(np.asarray(got["labels"]) ==
                        np.asarray(want["labels"]))
        assert agree >= 0.999, (stem, agree)


@pytest.mark.parametrize("radius,nsample,M,N", [(0.1, 32, 4000, 16000),
                                                 (0.8, 32, 62, 250)])
def test_ball_query_on_the_card_matches_the_cpu(cuda, radius, nsample, M, N):
    s = (_cloud(10, (4, N, 3)) * 0.3).contiguous()
    q = s[:, :M].contiguous()
    want = ops.ball_query(radius, nsample, s, q)
    got = ops.ball_query(radius, nsample, s.to(cuda), q.to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", sorted(ZOO_TINY))
def test_zoo_step_on_the_card_matches_the_cpu(cuda, name):
    """One supervised step of the config at the small widths, 256 points,
    from the same weights, in float64 around the float32 kernels: the loss
    within 1e-9 relative, every gradient (the first AdamW moment) within
    1e-6 of its tensor's largest entry, floored at 1e-6 of the largest
    gradient (biases before a BatchNorm have none in exact arithmetic)."""
    import os

    from geot_tpu_torch.core.config import EasyConfig
    from geot_tpu_torch.data.build import (MODEL_KEYS,
                                           build_dataloader_from_cfg,
                                           to_device)
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step

    cfg = EasyConfig()
    cfg.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cfgs", "tooth_sup", f"{name}.yaml"),
        recursive=True)
    cfg.update(ZOO_TINY[name] + ["dataset_l.common.num_points=256"])
    loader = build_dataloader_from_cfg(int(cfg.batch_size_l), cfg.dataset_l,
                                       None, cfg.datatransforms,
                                       split="train", seed=int(cfg.seed))
    loader.set_epoch(1)
    batch = next(iter(loader))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        st = TrainState.create(cfg, cfg.model, seed=1, device=dev)
        st.model.double()
        if name == "pointmlp":
            st.model.dropout.rate = 0.0
        b = {k: (v.double() if v.is_floating_point() else v)
             for k, v in to_device(batch, MODEL_KEYS, dev).items()}
        m = make_supervised_step(cfg)(st, b, 1e-3)
        res[dev.type] = (float(m["loss"]), {
            n: st.opt.state[p]["exp_avg"].cpu()
            for n, p in st.model.named_parameters()})
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= 1e-9 * abs(lc)
    gmax = max(float(v.abs().max()) for v in gc.values())
    for k, ref in gc.items():
        scale = max(float(ref.abs().max()), 1e-6 * gmax)
        assert float((gg[k] - ref).abs().max()) <= 1e-6 * scale, k


# --- the custom ops, the exported forward and two ranks on the card --------

@pytest.mark.parametrize("B,N,npoint", [(1, 16000, 8192), (2, 4000, 1000)])
def test_custom_fps_op_is_the_direct_kernel_call(cuda, B, N, npoint):
    from geot_tpu_torch.ops.fps import fps_direct

    xyz = _cloud(3, (B, N, 3)).to(cuda)
    n0 = dict(ops.LAUNCHES)
    got = torch.ops.geot.fps(xyz, npoint)
    assert sum(ops.LAUNCHES.values()) == sum(n0.values()) + 1
    assert torch.equal(got, fps_direct(xyz, npoint))
    assert torch.equal(got, ops.fps_ref(xyz, npoint))


@pytest.mark.parametrize("Q,N,k", [(4096, 512, 3), (16000, 8192, 4),
                                   (300, 300, 1)])
def test_custom_knn_op_is_the_direct_kernel_call(cuda, Q, N, k):
    from geot_tpu_torch.ops.knn import knn_small_k_direct

    q, s = _cloud(4, (2, Q, 3)).to(cuda), _cloud(5, (2, N, 3)).to(cuda)
    n0 = ops.LAUNCHES["knn_split"]
    d, i = torch.ops.geot.knn_small_k(q, s, k)
    assert ops.LAUNCHES["knn_split"] == n0 + 1
    d_d, i_d = knn_small_k_direct(q, s, k)
    assert torch.equal(d, d_d) and torch.equal(i, i_d)
    d_r, i_r = ops.knn_small_k_ref(q, s, k)
    assert torch.equal(d, d_r) and torch.equal(i, i_r)


def test_export_round_trip_on_the_card(cuda, tmp_path):
    """The small model exported on the card: the artifact's logits and
    launches equal the eager forward's."""
    from geot_tpu_torch.engine.export import export_forward, load_forward

    model = load_model(dict(SMALL_ARGS, drop_path_rate=0.0), device=cuda)
    pos = _cloud(6, (1, 256, 3)).to(cuda)
    cls = torch.zeros((1, 1), dtype=torch.long, device=cuda)
    with torch.no_grad():
        n0 = dict(ops.LAUNCHES)
        want = model({"pos": pos, "x": pos, "cls": cls})[0]
        eager = {k: ops.LAUNCHES[k] - n0[k] for k in n0}
    path = export_forward(model, n_points=256, batch=1,
                          out=str(tmp_path / "m.pt2"))
    fwd = load_forward(path)
    with torch.no_grad():
        n0 = dict(ops.LAUNCHES)
        got = fwd(pos, cls)
        launched = {k: ops.LAUNCHES[k] - n0[k] for k in n0}
    assert launched == eager and eager["fps_cluster"] == 1
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_two_rank_gloo_step_on_one_card(cuda, tmp_path):
    """Two ranks on cuda:0 over gloo, one semi step of the small config on
    1 + 1 + 1 clouds each: the ranks end bit-equal, and against one process
    on the 2 + 2 + 2 global batch their losses agree within 1e-4 and
    AdamW's first moments (the summed gradients) tensor by tensor within
    5e-2 of the tensor's largest entry, floored at 1e-3 of the largest
    (``tests/test_torch_dist.py``'s CPU bounds)."""
    import os
    import subprocess
    import sys

    from geot_tpu_torch import FLAGSHIP_SEMI_CFG
    from geot_tpu_torch.data import build as tdata_build
    from geot_tpu_torch.engine.launch import find_free_port
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    cfg = dict(FLAGSHIP_SEMI_CFG, num_points=256)
    args = dict(SMALL_ARGS, drop_path_rate=0.0, head_dropout=0.0)
    l, u = tdata_build.build_semi_loaders(cfg)
    l.set_epoch(1)
    u.set_epoch(1)
    bl, bu = next(tdata_build.semi_pairs(l, u))
    state = SemiTrainState.create(cfg, seg_args=args, device=cuda)
    init = {"model": state.model.state_dict(),
            "teacher": state.teacher.state_dict(),
            "t_predictor": state.t_predictor.state_dict(),
            "ema_t": state.ema_t, "cm": state.cm}
    batches = [(tdata_build.to_device(bl, tdata_build.MODEL_KEYS, "cpu"),
                tdata_build.to_device(bu, tdata_build.SEMI_KEYS, "cpu"))]
    torch.save({"cfg": cfg, "seg_args": args, "lr": 1e-3, "batches": batches,
                "state": {k: (v.cpu() if torch.is_tensor(v) else
                              {n: t.cpu() for n, t in v.items()})
                          for k, v in init.items()}}, tmp_path / "in.pt")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="localhost", WORLD_SIZE="2",
               MASTER_PORT=str(find_free_port()), GEOT_DIST_DEVICE="cuda",
               # one card visible: both ranks on it, so over gloo
               CUDA_VISIBLE_DEVICES=os.environ.get(
                   "CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_dist_worker.py"),
         "step", str(tmp_path / "in.pt"), str(tmp_path)], cwd=root,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out[-3000:]
    r0, r1 = (torch.load(tmp_path / f"rank{r}_step0.pt") for r in (0, 1))
    for k, v in r0["model"].items():
        assert torch.equal(v, r1["model"][k]), k
    assert torch.equal(r0["ema_t"], r1["ema_t"])
    want = make_semi_step(cfg)(state, {k: v.to(cuda) for k, v in
                                       batches[0][0].items()},
                               {k: v.to(cuda) for k, v in
                                batches[0][1].items()}, 1e-3, True)
    for k in ("loss", "sup_loss", "unsup_loss"):
        got, ref = float(r0["metrics"][k]), float(want[k])
        assert abs(got - ref) <= 1e-4 * abs(ref), (k, got, ref)
    moments = {n: state.opt.state[p]["exp_avg"].cpu()
               for n, p in state.model.named_parameters()}
    gmax = max(float(v.abs().max()) for v in moments.values())
    for n, ref in moments.items():
        scale = max(float(ref.abs().max()), 1e-3 * gmax)
        err = float((r0["exp_avg"][n] - ref).abs().max()) / scale
        assert err <= 5e-2, (n, err)


# --- the pretraining stage ---------------------------------------------------

PRETRAIN_TINY = {
    "NAME": "ViewGenBase",
    "encoder_args": {"NAME": "PointTransformer_genencoder", "trans_dim": 48,
                     "depth": 3, "num_heads": 4, "group_size": 8,
                     "num_group": 32, "encoder_dims": 32,
                     "extract_layers": [1, 2, 3]},
    "generator_args": {"NAME": "ViewTransformer", "in_channels": 48,
                       "feat_channels": 48, "depth": 1,
                       "channels_per_head": 16, "obj_size": 56,
                       "img_size": 64, "img_ds_ratio": 16},
    "decoder_args": {"NAME": "ViewDecoder", "in_channels": 48,
                     "out_channels": 3},
    "loss_args": {"weight_fg": 1.0, "weight_bg": 0.1}}


def _pretrain_batch(num_points=2048):
    from geot_tpu_torch.data.build import build_dataloader_from_cfg

    loader = build_dataloader_from_cfg(2, {"common": {
        "NAME": "tooth_6000_pca", "data_root": "", "num_points": num_points,
        "n_views": 2, "img_size": 128}}, None, split="train", seed=0)
    loader.set_epoch(1)
    return next(iter(loader))


def test_pretrain_forward_on_the_card_matches_the_cpu(cuda):
    """The generation stack in eval mode, same weights and batch: loss
    within 1e-4 relative, recon within 1e-3, one FPS launch (the
    genencoder's tokenizer) and no other kernel."""
    from geot_tpu_torch.core.config import build_model_from_cfg
    from geot_tpu_torch.engine.pretrain import pretrain_batch
    from geot_tpu_torch.models.segmentation.base_seg import init_weights

    model = build_model_from_cfg(PRETRAIN_TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    batch = _pretrain_batch()
    with torch.no_grad():
        loss_c, rec_c = model(pretrain_batch(batch, "cpu"))
        model.to(cuda)
        ops.reset_launches()
        loss_g, rec_g = model(pretrain_batch(batch, cuda))
        torch.cuda.synchronize()
    route = ops.fps_plan(2048, card_cluster_size(cuda, 2)).route
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {route: 1}
    assert abs(float(loss_g) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    assert float((rec_g.cpu() - rec_c).abs().max()) <= 1e-3


def test_pretrain_then_graft_on_the_card(cuda, tmp_path):
    """Two pretraining steps and a checkpoint on the card, then
    ``load_pretrain_encoder`` into the small flagship: every trunk entry
    equals the checkpoint's ``encoder`` entry, nothing is skipped, and the
    grafted model forwards on the card."""
    from geot_tpu_torch.engine.checkpoint import (load_pretrain_encoder,
                                                  load_variables,
                                                  save_checkpoint)
    from geot_tpu_torch.engine.pretrain import (make_pretrain_step,
                                                pretrain_batch)
    from geot_tpu_torch.engine.state import TrainState

    cfg = {"lr": 5e-4, "optimizer": {"NAME": "adamw", "weight_decay": 0.05},
           "grad_norm_clip": 10}
    state = TrainState.create(cfg, PRETRAIN_TINY, device=cuda)
    step = make_pretrain_step(cfg)
    batch = pretrain_batch(_pretrain_batch(), cuda)
    losses = [float(step(state, batch, 5e-4)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses))
    path = save_checkpoint({"ckpt_dir": str(tmp_path), "run_name": "pt"},
                           state, 1, is_best=True)
    seg = load_model(SMALL_ARGS, seed=0, device=cuda)
    merged, skipped = load_pretrain_encoder(seg.state_dict(), path)
    assert skipped == []
    seg.load_state_dict(merged)
    enc = {k[len("encoder."):]: v for k, v in
           load_variables(path, False).items() if k.startswith("encoder.")}
    sd = seg.state_dict()
    for k, v in enc.items():
        assert torch.equal(sd["segmentor." + k].cpu(), v), k
    pos = batch["pos"][:, :256].contiguous()
    with torch.no_grad():
        logit = seg({"pos": pos, "x": pos,
                     "cls": torch.zeros((2, 1), dtype=torch.long,
                                        device=cuda)})[0]
    assert torch.isfinite(logit).all()


# --- the optimizer family and AdaHessian's diagonal -------------------------

def _optimizer_params(device):
    """A kernel, a bias and a 160 x 144 matrix (adafactor factors it), and
    5 gradients of each, from seeded numpy."""
    rng = np.random.default_rng(0)
    shapes = {"kernel": (6, 5), "bias": (5,), "big": (160, 144)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = [{k: torch.from_numpy((0.1 * rng.standard_normal(s)).astype(
        np.float32)) for k, s in shapes.items()} for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS) + ["lookahead_adamw"])
def test_optimizer_on_the_card_matches_the_cpu(cuda, name):
    """5 updates from the same gradients (the diagonal of AdaHessian: the
    gradients), the weights within 1e-5 of each tensor's largest entry."""
    from geot_tpu_torch.optim import build_optimizer_from_cfg

    params, grads = _optimizer_params("cpu")
    out = []
    for device in (cuda, torch.device("cpu")):
        module = torch.nn.Module()
        for k, v in params.items():
            module.register_parameter(k, torch.nn.Parameter(
                v.clone().to(device)))
        opt = build_optimizer_from_cfg(module, 1e-2, NAME=name,
                                       weight_decay=0.05, lookahead_k=2)
        for g in grads:
            for k, p in module.named_parameters():
                p.grad = g[k].to(device)
            opt.step(hessian=[p.grad for p in opt.params()]
                     if opt.needs_hessian else None)
        out.append({k: p.detach().cpu() for k, p in
                    module.named_parameters()})
    for k, ref in out[1].items():
        err = float((out[0][k] - ref).abs().max() / ref.abs().max())
        assert err <= 1e-5, (k, err)


def test_adahessian_diagonal_on_the_card_matches_the_cpu(cuda):
    """One semi step with AdaHessian at the small width in float64, the
    same batch and z on the card and on the CPU: the squared diagonal's
    second moment and the first moment within 1e-6 of each tensor's
    largest entry (floored at 1e-6 of the largest)."""
    from geot_tpu_torch import FLAGSHIP_SEMI_CFG
    from geot_tpu_torch.data.build import (MODEL_KEYS, SEMI_KEYS,
                                           build_semi_loaders, semi_pairs,
                                           to_device)
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step
    from geot_tpu_torch.optim import rademacher

    cfg = dict(FLAGSHIP_SEMI_CFG, num_points=256,
               optimizer={"NAME": "adahessian", "weight_decay": 0.05})
    seg = dict(SMALL_ARGS, drop_path_rate=0.0, head_dropout=0.0)
    loaders = build_semi_loaders(cfg)
    for loader in loaders:
        loader.set_epoch(1)
    bl, bu = next(semi_pairs(*loaders, limit=1))
    res = []
    for device in (cuda, torch.device("cpu")):
        st = SemiTrainState.create(cfg, seg_args=seg, seed=2, device=device)
        for m in (st.model, st.teacher, st.t_predictor):
            m.double()
        st.ema_t, st.cm = st.ema_t.double(), st.cm.double()
        named = list(st.model.named_parameters()) + list(
            st.t_predictor.named_parameters())
        zs = dict(zip([n for n, _ in named], rademacher(
            [p.detach().cpu() for _, p in named],
            torch.Generator().manual_seed(5))))
        batches = [{k: v.double() if v.is_floating_point() else v
                    for k, v in to_device(b, keys, device).items()}
                   for b, keys in ((bl, MODEL_KEYS), (bu, SEMI_KEYS))]
        make_semi_step(cfg)(st, *batches, 1e-3, True,
                            draws={"hessian": zs})
        res.append({(n, key): (st.t_opt if n.startswith("T_predictor.")
                               else st.opt).state[p][key].cpu()
                    for n, p in named
                    for key in ("exp_avg", "exp_hessian_diag_sq")})
    for key in ("exp_avg", "exp_hessian_diag_sq"):
        ref = {n: v for (n, k), v in res[1].items() if k == key}
        gmax = max(float(v.abs().max()) for v in ref.values())
        for n, v in ref.items():
            err = float((res[0][(n, key)] - v).abs().max()) / max(
                float(v.abs().max()), 1e-6 * gmax)
            assert err <= 1e-6, (key, n, err)


# --- the heritage tasks (task: cls | partseg) --------------------------------

HERITAGE_CHAINS = ((32, 1024, (256, 64, 16, 4)), (32, 1024, (512, 256, 128,
                                                              64)),
                   (8, 2048, (512, 128, 32, 8)))
HERITAGE_TINY = {
    "scanobjectnn/pointnet2cls.yaml": [
        "model.encoder_args.width=8", "model.encoder_args.num_samples=8",
        "model.encoder_args.strides=[4,4]", "model.encoder_args.blocks=[1,1]",
        "model.cls_args.mlps=[32]", "model.cls_args.dropout_ratio=0.0"],
    "scanobjectnn/dgcnncls.yaml": [
        "model.encoder_args.channels=8", "model.encoder_args.embed_dim=32",
        "model.encoder_args.n_blocks=3", "model.encoder_args.k=8",
        "model.cls_args.mlps=[32]", "model.cls_args.dropout_ratio=0.0"],
    "scanobjectnn/pointmlpcls.yaml": [
        "model.encoder_args.embed_dim=8",
        "model.encoder_args.dim_expansion=[2,2]",
        "model.encoder_args.pre_blocks=[1,1]",
        "model.encoder_args.pos_blocks=[1,1]",
        "model.encoder_args.k_neighbors=[8,8]",
        "model.encoder_args.reducers=[4,4]", "model.cls_args.mlps=[32]",
        "model.cls_args.dropout_ratio=0.0"],
    "shapenetpart/pointnet2part.yaml": [
        "model.encoder_args.width=8", "model.encoder_args.num_samples=8",
        "model.encoder_args.strides=[4,4]", "model.encoder_args.blocks=[1,1]",
        "model.cls_args.mlps=[16]", "model.cls_args.dropout_ratio=0.0"],
    "shapenetpart/pointmlppart.yaml": [
        "model.embed_dim=8", "model.dim_expansion=[2,2]",
        "model.pre_blocks=[1,1]", "model.pos_blocks=[1,1]",
        "model.k_neighbors=[8,8]", "model.reducers=[4,4]",
        "model.de_dims=[16,16]", "model.de_blocks=[1,1]", "model.gmp_dim=8",
        "model.cls_dim=8"],
}


def test_fps_at_the_heritage_chains_and_empty_blocks(cuda):
    """The FPS chains of classification (B = 32, 1024 points) and part
    segmentation (B = 8, 2048 points) bit-equal to ``fps_ref``; clouds of
    10 and 17 points on a 16-block cluster, where blocks own no point; 40
    distinct points sampled to 1024."""
    for B, N, npoints in HERITAGE_CHAINS:
        x = _cloud(17, (B, N, 3)).to(cuda)
        for npoint in npoints:
            idx = ops.fps(x, npoint)
            assert torch.equal(idx, ops.fps_ref(x, npoint)), (x.shape,
                                                               npoint)
            x = ops.gather_points(x, idx).contiguous()
    for N, npoint in ((10, 4), (17, 8)):
        plan = ops.fps_plan(N, 16)
        assert any(hi <= lo for lo, hi in plan.ranges(N))
        x = _cloud(N, (32, N, 3)).to(cuda)
        assert torch.equal(ops.fps_cluster(x, npoint, plan),
                           ops.fps_ref(x, npoint))
    sel = torch.from_numpy(np.random.default_rng(41).choice(40, 1024))
    few = _cloud(40, (32, 40, 3))[:, sel].contiguous().to(cuda)
    assert torch.equal(ops.fps(few, 256), ops.fps_ref(few, 256))


def test_knn_split_at_the_part_decoder_shapes(cuda):
    """The part decoders' k = 3 searches, (8, 32) x (8, 8) to (8, 2048) x
    (8, 512), and a support with duplicates: bit-equal to
    ``knn_small_k_ref``."""
    x = _cloud(18, (8, 2048, 3)).to(cuda)
    lv = [x]
    for npoint in (512, 128, 32, 8):
        lv.append(ops.gather_points(lv[-1], ops.fps(lv[-1], npoint))
                  .contiguous())
    dup = torch.cat([lv[2], lv[2][:, :64]], dim=1).contiguous()
    for q, s in ((lv[3], lv[4]), (lv[2], lv[3]), (lv[1], lv[2]),
                 (lv[0], lv[1]), (lv[1], dup)):
        d, i = ops.knn_small_k(q, s, 3)
        d_r, i_r = ops.knn_small_k_ref(q, s, 3)
        assert torch.equal(i, i_r) and torch.equal(d, d_r), (q.shape,
                                                            s.shape)


@pytest.mark.parametrize("path", sorted(HERITAGE_TINY))
def test_heritage_step_on_the_card_matches_the_cpu(cuda, path):
    """One supervised step of each heritage config at the small widths, 4
    clouds of 256 points, from the same weights, in float64 around the
    float32 kernels: the loss within 1e-9 relative, every gradient within
    1e-6 of its tensor's largest entry (floored at 1e-6 of the largest
    gradient)."""
    import os

    from geot_tpu_torch.core.config import EasyConfig
    from geot_tpu_torch.data.build import build_dataloader_from_cfg
    from geot_tpu_torch.engine import cls as cls_mod
    from geot_tpu_torch.engine import partseg as partseg_mod
    from geot_tpu_torch.engine.state import TrainState
    from geot_tpu_torch.engine.steps import make_supervised_step

    cfg = EasyConfig()
    cfg.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cfgs", path), recursive=True)
    cfg.update(HERITAGE_TINY[path] + ["dataset.common.num_points=256",
                                      "seed=0"])
    loader = build_dataloader_from_cfg(
        4, cfg.dataset, split=cfg.dataset.get("train_split", "train"))
    loader.set_epoch(1)
    batch = next(iter(loader))
    batch_fn = (cls_mod if cfg.task == "cls" else partseg_mod)._batch
    res = {}
    for dev in (cuda, torch.device("cpu")):
        st = TrainState.create(cfg, cfg.model, seed=1, device=dev)
        st.model.double()
        if "pointmlppart" in path:
            st.model.dropout.rate = 0.0
        b = {k: (v.double() if v.is_floating_point() else v)
             for k, v in batch_fn(batch, dev).items()}
        m = make_supervised_step(cfg)(st, b, 1e-3)
        res[dev.type] = (float(m["loss"]), {
            n: st.opt.state[p]["exp_avg"].cpu()
            for n, p in st.model.named_parameters()})
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    assert abs(lg - lc) <= 1e-9 * abs(lc)
    gmax = max(float(v.abs().max()) for v in gc.values())
    for k, ref in gc.items():
        scale = max(float(ref.abs().max()), 1e-6 * gmax)
        assert float((gg[k] - ref).abs().max()) <= 1e-6 * scale, k


def test_presample_on_the_card(cuda, tmp_path):
    """``ShapeNetPartNormal(presample=True)`` on the card: one FPS launch a
    shape, and the cached rows are the shape's at ``fps_ref``'s indices."""
    import json
    import os
    import pickle

    from geot_tpu_torch.data.shapenetpart import (SHAPENETPART_CLS2PARTS,
                                                  ShapeNetPartNormal)

    rng = np.random.default_rng(19)
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "train_test_split"))
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        f.write("Airplane\t02691156\nBag\t02773838\n")
    ids = []
    for c, syn in enumerate(("02691156", "02773838")):
        os.makedirs(os.path.join(root, syn))
        for i in range(2):
            n = 300 + 50 * i
            rows = np.concatenate([rng.standard_normal((n, 6)).round(6),
                                   rng.choice(SHAPENETPART_CLS2PARTS[c],
                                              (n, 1))], axis=1)
            np.savetxt(os.path.join(root, syn, f"s{c}{i}.txt"), rows,
                       fmt="%.6f")
            ids.append(f"shape_data/{syn}/s{c}{i}")
    for s in ("train", "val", "test"):
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{s}_file_list.json"), "w") as f:
            json.dump(ids if s == "test" else [], f)
    n0 = ops.LAUNCHES["fps_cluster"]
    ds = ShapeNetPartNormal(data_root=root, num_points=256, split="test",
                            presample=True, device="cuda")
    assert ops.LAUNCHES["fps_cluster"] == n0 + 4 == n0 + len(ds)
    with open(os.path.join(root, "processed", "test_256_fps.pkl"),
              "rb") as f:
        pre_data, pre_cls = pickle.load(f)
    for (_, path), rows in zip(ds.items, pre_data):
        raw = np.loadtxt(path).astype(np.float32)
        idx = ops.fps_ref(torch.from_numpy(raw[None, :, :3]), 256)[0]
        np.testing.assert_array_equal(rows, raw[idx.numpy()])
    assert [int(c[0]) for c in pre_cls] == [0, 0, 1, 1]


# --- the rest of the model registry -----------------------------------------

_SEG_VARIANT_FEAT = {"PointTransformer_seg_cluster": 64,
                     "PointTransformer_seg_classifier": 128,
                     "PointTransformer_seg_2classifier": 48}


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_pyramid"])
@pytest.mark.parametrize("name", sorted(_SEG_VARIANT_FEAT))
def test_seg_variant_on_the_card_matches_the_cpu(cuda, name, fast):
    """``WholePartSeg_ntm`` over each seg variant: logits and features on
    the card against the CPU from the same weights, and the forward's
    launches counted."""
    seg = dict(SMALL_ARGS, NAME=name, drop_path_rate=0.0, fast_pyramid=fast)
    model = load_model(model_cfg={"NAME": "WholePartSeg_ntm",
                                  "segmentor_args": seg}, device="cpu")
    card = load_model(model_cfg={"NAME": "WholePartSeg_ntm",
                                 "segmentor_args": seg}, device=cuda)
    pos = _cloud(3, (2, 256, 3))
    batch = {"pos": pos, "x": pos, "cls": torch.tensor([[0], [1]])}
    with torch.no_grad():
        want = model(batch)
        ops.reset_launches()
        got = card({k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    # one FPS (the serving order's prefix when fast); the searches with
    # 128 queries or more take the split kernel, the others the tiled path
    assert counts.get("fps_cluster") == 1 and set(counts) == {
        "fps_cluster", "knn_split"}, counts
    assert got[1] is None and got[2] is None
    assert got[3].shape == (2, 256, _SEG_VARIANT_FEAT[name])
    for g, w in ((got[0], want[0]), (got[3], want[3])):
        rel = float((g.cpu() - w).abs().max() / w.abs().max())
        assert rel <= 1e-4, (name, rel)


def test_rest_of_the_registry_on_the_card_matches_the_cpu(cuda):
    """One eval forward of each other new name on the card against the
    CPU: the cls-token encoders, the patch embeddings, ``VariableSeg`` and
    ``DistillBaseSeg``, ``MultiSegHead``, ``Ins_T`` over ``sig_t``; and
    ``Gragh_Matching`` raises on the card too."""
    import copy

    from geot_tpu_torch.core.config import build_model_from_cfg
    from geot_tpu_torch.models.segmentation.base_seg import init_weights

    pos, x = _cloud(4, (2, 128, 3)), _cloud(5, (2, 128, 3))
    enc = {"NAME": "PointNet2Encoder", "in_channels": 3, "width": 8,
           "layers": 2, "strides": [4, 4], "radius": 0.2, "num_samples": 8,
           "blocks": [1, 1], "aggr_args": {"feature_type": "dp_fj"}}
    head = {"NAME": "VariableSegHead", "num_classes": 17, "in_channels": 24}
    token = {"num_groups": 16, "group_size": 8, "encoder_dims": 32,
             "trans_dim": 48, "depth": 2, "num_heads": 4, "radius": 0.4}
    cases = [
        ({"NAME": "PointTransformerEncoder", **token}, (pos,)),
        ({"NAME": "PointTransformerGenEncoder", **token, "group": "knn"},
         (pos,)),
        ({"NAME": "PointPatchEmbed", "sample_ratio": 0.25, "group_size": 8,
          "channels": [16, 32], "in_channels": 3}, (pos, x)),
        ({"NAME": "P3Embed", "stages": 2, "sample_ratio": 0.5,
          "group_size": 8, "channels": [8, 16]}, (pos,)),
        ({"NAME": "VariableSeg", "encoder_args": enc,
          "decoder_args": {"NAME": "PointNet2Decoder"}, "cls_args": head},
         (pos, x)),
        ({"NAME": "DistillBaseSeg", "encoder_args": enc,
          "decoder_args": {"NAME": "PointNet2Decoder"}, "cls_args": head},
         (pos, x)),
        ({"NAME": "MultiSegHead", "in_channels": 3, "shape_classes": 4,
          "num_parts": [2, 3, 4, 2]}, (x,)),
        ({"NAME": "Ins_T", "T_args": {"NAME": "sig_t", "nclasses": 17}},
         (torch.softmax(_cloud(6, (2, 16, 17)), -1),)),
    ]
    for cfg, args in cases:
        model = init_weights(build_model_from_cfg(cfg),
                             torch.Generator().manual_seed(0)).eval()
        card = copy.deepcopy(model).to(cuda)
        with torch.no_grad():
            want = model(*args)
            got = card(*(a.to(cuda) for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert g.shape == w.shape, cfg["NAME"]
            rel = float((g.cpu() - w).abs().max() / w.abs().max())
            assert rel <= 1e-4, (cfg["NAME"], rel)
    with pytest.raises(NotImplementedError):
        build_model_from_cfg({"NAME": "Gragh_Matching"}).to(cuda)(
            None, None, None)


# --- the reference op API -----------------------------------------------------

@pytest.mark.parametrize("B,N,npoint", [(2, 16000, 512), (1, 3000, 300)])
def test_fps_weighted_on_the_card_matches_the_cpu(cuda, B, N, npoint):
    x = _cloud(30, (B, N, 3))
    w = torch.from_numpy(np.random.default_rng(31).uniform(
        0.0, 2.0, (B, N)).astype(np.float32))
    w[:, ::9] = 0.0
    got = ops.fps_weighted(x.to(cuda), w.to(cuda), npoint)
    assert torch.equal(got.cpu(), ops.fps_weighted(x, w, npoint))


def test_segment_ops_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(32)
    data = torch.from_numpy(rng.standard_normal((5000, 16)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, 300, 5000).astype(np.int32))
    ids[ids == 7] = 8                       # segment 7 empty
    for name in ("segment_sum", "segment_mean", "segment_max"):
        want = getattr(ops, name)(data, ids, 301)
        got = getattr(ops, name)(data.to(cuda), ids.to(cuda), 301).cpu()
        if name == "segment_max":
            assert torch.equal(got, want) and torch.isneginf(got[7]).all()
        else:
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())


def test_compat_on_the_card_launches_the_kernels(cuda):
    """Every compat call that ``geot_tpu`` sends to a Pallas kernel reaches
    ``geot::fps`` or ``geot::knn_small_k`` for a CUDA tensor, bit-equal to
    the plain version on the same inputs."""
    from geot_tpu_torch.ops.compat import (openpoints_pointops,
                                           pointnet2_utils, pointops)

    x = _cloud(33, (2, 16000, 3)).to(cuda)
    new = x[:, :4096].contiguous()
    feat = _cloud(34, (2, 4096, 8)).to(cuda)
    ops.reset_launches()
    idx, d = pointops.knn(x, x, 3)
    sampled = pointops.fps(x, 512)
    inds = pointnet2_utils.furthest_point_sample(x, 512)
    dist, i3 = pointnet2_utils.three_nn(x, new)
    up = openpoints_pointops.interpolation(new, x, feat, k=3)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert counts == {"fps_cluster": 2, "knn_split": 3}, counts
    d_r, i_r = ops.knn_small_k_ref(x, x, 3)
    assert torch.equal(idx, i_r) and torch.equal(d, d_r)
    ref = ops.fps_ref(x, 512)
    assert torch.equal(inds, ref)
    assert torch.equal(sampled, ops.gather_points(x, ref))
    d_r, i_r = ops.knn_small_k_ref(x, new, 3)
    assert torch.equal(i3, i_r) and torch.equal(dist, d_r.sqrt())
    w = 1.0 / (d_r.sqrt() + 1e-8)
    plain = ops.three_interpolate(feat, i_r, w / w.sum(-1, keepdim=True))
    assert torch.equal(up, plain)


def test_grid_subsample_native_matches_numpy_on_the_cards_host(cuda):
    rng = np.random.default_rng(35)
    pts = (rng.standard_normal((150000, 3)) * 20).astype(np.float32)
    labels = rng.integers(0, 17, 150000).astype(np.int32)
    sub, lab = ops.grid_subsample_native(pts, labels=labels, sample_dl=0.5)
    ref, ref_lab = ops.grid_subsample(pts, labels=labels, sample_dl=0.5,
                                      num_classes=17)
    assert sub.shape == ref.shape
    order, ref_order = np.lexsort(sub.T), np.lexsort(ref.T)
    assert np.abs(sub[order] - ref[ref_order]).max() <= 1e-5
    assert np.array_equal(lab[order], ref_lab[ref_order])


# --- the data side ------------------------------------------------------------

@pytest.mark.parametrize("num_points", [1024, 2048])
def test_sample_mesh_poisson_on_the_kernel_matches_fps_ref(cuda, num_points,
                                                           tmp_path):
    """``sample_mesh_poisson`` thins on ``fps_cluster`` (one launch) at the
    dataset's sizes, (1, 4096) -> 1024 and (1, 8192) -> 2048: the samples
    are the dense samples at ``fps_ref``'s indices on the card, and equal
    to the CPU's."""
    from geot_tpu_torch.data.sample_pc import (dense_surface_samples,
                                               sample_mesh_poisson)

    rng = np.random.default_rng(40)
    verts = rng.standard_normal((500, 3)).astype(np.float32)
    faces = rng.integers(0, 500, (900, 3))
    n0 = dict(ops.LAUNCHES)
    got = sample_mesh_poisson(verts, faces, num_points, device=cuda)
    assert ops.LAUNCHES == dict(n0, fps_cluster=n0["fps_cluster"] + 1)
    dense = dense_surface_samples(verts, faces, 4 * num_points,
                                  np.random.default_rng(0))
    ref = ops.fps_ref(torch.from_numpy(dense[None]).to(cuda), num_points)
    np.testing.assert_array_equal(got, dense[ref[0].cpu().numpy()])
    np.testing.assert_array_equal(
        got, sample_mesh_poisson(verts, faces, num_points, device="cpu"))


@pytest.mark.parametrize("kind,K", [("class", 1), ("subclass", 6),
                                    ("teacher", 6), ("pcc_top2", 6)])
def test_cluster_contrast_on_the_card_matches_the_cpu(cuda, kind, K):
    """The cluster-contrast losses on (2, 4000, 32) features and 17
    classes, float64, the same draws and state on the card and the CPU:
    loss and feature gradient within 1e-9 of their scale, the new centres
    and queues within 1e-9, pointers and pseudo-labels equal; no kernel
    launches."""
    from geot_tpu_torch.losses import cluster_contrast as cc

    B, N, D, C = 2, 4000, 32, 17
    rng = np.random.default_rng(41)
    pred = rng.integers(0, C, (B, N))
    data = {"feats": rng.standard_normal((B, N, D)),
            "teacher": rng.standard_normal((B, N, D)), "pred": pred,
            "label": np.where(rng.uniform(size=(B, N)) < 0.8, pred,
                              rng.integers(0, C, (B, N))),
            "conf": rng.uniform(size=(B, N)),
            "label2": rng.integers(0, C, (B, N)),
            "mask": rng.uniform(size=(B, N)) < 0.3}
    gen = torch.Generator().manual_seed(42)
    state = cc.ClassContrastState.create(gen, C * K, D, dtype=torch.float64)
    M = B * C * K * (100 // K if K > 1 else 100)
    draws = (torch.rand((B, N), generator=gen, dtype=torch.float64),
             torch.rand((M,), generator=gen, dtype=torch.float64))

    def run(dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        st = cc.ClassContrastState(*(a.to(dev) for a in state))
        feats = t["feats"].requires_grad_()
        if kind == "pcc_top2":
            loss, new = cc.pcc_top2_loss(
                st, feats, t["pred"], t["label2"], t["mask"], t["conf"], C,
                K, draws=draws[0].to(dev)), None
        else:
            loss, new = cc.class_contrast_loss(
                st, feats, t["pred"], t["label"], t["conf"], num_classes=C,
                subclasses=K, draws=tuple(d.to(dev) for d in draws),
                teacher_feats=t["teacher"] if kind == "teacher" else None)
        loss.backward()
        labels = cc.pseudo_label_from_prototype(st, t["feats"].detach(), C,
                                                K)
        return loss.detach().cpu(), feats.grad.cpu(), new, labels

    n0 = dict(ops.LAUNCHES)
    lg, gg, ng, (pg, zg) = run(cuda)
    assert ops.LAUNCHES == n0
    lc, gc, nc, (pc, zc) = run(torch.device("cpu"))
    assert torch.isfinite(lg) and abs(float(lg - lc)) <= 1e-9 * abs(
        float(lc))
    assert float((gg - gc).abs().max()) <= 1e-9 * float(gc.abs().max())
    assert torch.equal(pg.cpu(), pc)
    assert float((zg.cpu() - zc).abs().max()) <= 1e-9
    if nc is not None:
        assert torch.equal(ng.ptrs.cpu(), nc.ptrs)
        assert float((ng.centers.cpu() - nc.centers).abs().max()) <= 1e-9
        assert float((ng.queues.cpu() - nc.queues).abs().max()) <= 1e-9
