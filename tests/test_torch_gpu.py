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
from geot_tpu_torch.ops.fps import CLUSTER_SIZES, card_cluster_size

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


# the flagship's FPS shapes (serving B = 1, teacher B = 2, student B = 6),
# ties, a cloud whose ranges are ragged, and one smaller than the cluster
@pytest.mark.parametrize("B,N,npoint,dup", [(1, 16000, 8192, False),
                                             (2, 16000, 8192, False),
                                             (6, 16000, 8192, False),
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


def test_fps_routes_an_oversized_cloud_to_the_block_kernel(cuda):
    C = card_cluster_size(cuda, 1)
    xyz = _cloud(8, (1, C * 256 * 16 + 1, 3)).to(cuda)
    assert ops.fps_plan(xyz.shape[1], C).route == "fps"
    n0 = dict(ops.LAUNCHES)
    got = ops.fps(xyz, 200)
    assert ops.LAUNCHES == dict(n0, fps=n0["fps"] + 1)
    torch.testing.assert_close(got, ops.fps_ref(xyz, 200), rtol=0, atol=0)


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
    (6, 16000, 8192, 3, False), (1, 4096, 3000, 4, True)])
def test_knn_split_kernel_matches_plain_at_path_shapes(cuda, B, Q, N, k, dup):
    s = _cloud(9, (B, N, 3), dup).to(cuda)
    q = torch.cat([s[:, :min(Q, s.shape[1]) // 2],
                   _cloud(10, (B, Q - min(Q, s.shape[1]) // 2, 3)).to(cuda)],
                  dim=1).contiguous()
    n0 = ops.LAUNCHES["knn_split"]
    d, i = ops.knn_small_k(q, s, k)
    assert ops.LAUNCHES["knn_split"] == n0 + 1
    d_r, i_r = ops.knn_small_k_ref(q, s, k)
    torch.testing.assert_close(i, i_r, rtol=0, atol=0)
    torch.testing.assert_close(d, d_r, rtol=0, atol=0)


@pytest.mark.parametrize("B,N,npoint,dup", [(1, 16000, 8192, False),
                                             (2, 2500, 700, False),
                                             (1, 30000, 300, False),
                                             (1, 100, 64, False),
                                             (2, 1000, 600, True)])
def test_fps_bucket_kernel_matches_plain_and_fps(cuda, B, N, npoint, dup):
    xyz = _cloud(4, (B, N, 3), dup).to(cuda)
    n0 = ops.LAUNCHES["fps_bucket"]
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = ops.fps_bucket(xyz, npoint, skipped=skipped)
    assert ops.LAUNCHES["fps_bucket"] == n0 + 1
    torch.testing.assert_close(got, ops.fps_bucket_ref(xyz, npoint), rtol=0,
                               atol=0)
    torch.testing.assert_close(got, ops.fps(xyz, npoint), rtol=0, atol=0)
    nb = -(-xyz.shape[1] // 1024)
    assert 0 <= int(skipped) <= B * nb * (npoint - 1)


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
    n0 = ops.LAUNCHES["knn_small_k_pruned"]
    skipped = torch.zeros(1, dtype=torch.int64, device=cuda)
    d, i = ops.knn_small_k_pruned(q, s, k, skipped=skipped)
    assert ops.LAUNCHES["knn_small_k_pruned"] == n0 + 1
    for d_r, i_r in (ops.knn_small_k_pruned_ref(q, s, k),
                     ops.knn_small_k(q, s, k)):
        torch.testing.assert_close(i, i_r, rtol=0, atol=0)
        torch.testing.assert_close(d, d_r, rtol=0, atol=0)
    assert 0 <= int(skipped) <= 2 * -(-Q // 256) * -(-N // 1024)


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
        ops.fps_bucket(torch.zeros((1, 31 * 1024, 3), device=cuda), 8)


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
