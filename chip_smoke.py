#!/usr/bin/env python3
"""Drive geot_tpu_torch's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py

Phases, each printed with the seconds elapsed when it starts:
1. device: the card's name and power limit; TF32 off.
2. build: the CUDA kernels, one nvcc per source from
   ``geot_tpu_torch/csrc``, all started together.
3. kernels: each kernel against its plain PyTorch version at the shapes the
   paths give it, plus cases with duplicated points (ties): FPS indices and
   kNN indices equal, kNN squared distances bit-equal. FPS: the card's
   cluster size per batch, the cluster exchange alone (8,191 steps of
   block barrier, write-to-peers, synchronisation and reduction, no
   distance work) at each cluster size, then the cluster kernel
   (``fps_cluster``) at (1|2|6, 16000) -> 8192, ties, an odd N and an N
   that its shape rule sends to the one-block kernel (``fps``), and both
   kernels' times in turns. kNN: the split kernel (``knn_split``) and the
   one-thread-per-query kernel (``knn_small_k``) against the plain version
   and each other at the serving path's 8 searches and ties, each timed as
   wrapper calls and kernel-only (a CUDA graph of the calls). The
   bucket-pruned kernels (``fps_bucket``, ``knn_small_k_pruned``; on no
   path, as in ``geot_tpu``) are also held bit for bit against the path's
   kernels, at the training FPS shape too, with the share of work they
   skip. Times from CUDA events after a warm-up.
4. serving: the flagship ``WholePartSeg`` at full width with seeded random
   weights serves 3 synthetic scans of 40,000 points through
   ``predict_scan``; the launch counters must show 1 ``fps_cluster`` and 8
   ``knn_split`` launches per scan and no other. Logits finite, labels FDI
   codes of the jaw, and the card's forward agrees with the same model's
   CPU forward.
5. http: 3 ``POST /predict`` requests with ``.npy`` bodies through
   ``engine.serve`` on 127.0.0.1.
6. train: the flagship FixMatch + NTM recipe at full width (batch 2 + 2 + 2
   of 16,000 points) from seeded weights on the synthetic loaders: the
   ``cal_mean_feature`` bootstrap over 2 labelled batches (1 ``fps_cluster``
   + 7 ``knn_split`` launches each), then 3 ``semi_step`` calls with the
   teacher (2 ``fps_cluster`` + 14 ``knn_split`` each). Losses finite,
   ``ema_t`` rows sum to 1, weights move. Then one step from the same state and batch (1 + 1 + 1 clouds,
   dropout off) on the card and on the CPU, in float32 and in float64:
   loss terms within 1e-4 relative; per-tensor gradients within 1e-3 of
   the tensor's largest in float64 (5e-2 in float32, where batch-statistics
   BatchNorm amplifies rounding).
Then the ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; without a CUDA device it exits 1 at once.

    python3 chip_smoke.py --profile

adds, after phase 6, a ``torch.profiler`` trace of 3 served scans and 2
train steps: device time by kernel and the device's busy share of the wall
time.
"""
from __future__ import annotations

import faulthandler
import io
import json
import math
import os
import subprocess
import sys
import time
import urllib.request

T0 = time.perf_counter()
FP32_PEAK = 67e12        # H100 SXM fp32 outside the tensor cores, at 700 W
HBM_PEAK = 3.35e12       # bytes/s
FULL_POWER_W = 700.0


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Bound:
    """Least time for a piece of work: the larger of its bytes over the
    memory rate and its fp32 operations over the fp32 peak, both scaled by
    the card's power limit over 700 W."""

    def __init__(self, power_limit_w: float):
        self.scale = min(1.0, power_limit_w / FULL_POWER_W)

    def __call__(self, flops: float, nbytes: float):
        t_ops = flops / (FP32_PEAK * self.scale)
        t_bytes = nbytes / (HBM_PEAK * self.scale)
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    log("phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    limit_w = float(smi.rsplit(",", 1)[1].strip().split()[0])
    log(f"device {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    return name, smi, limit_w


def phase_build():
    from geot_tpu_torch.ops import _build

    log("phase 2: build")
    t = time.perf_counter()
    info = _build.build_info()
    log(f"built {os.path.basename(info['path'])} in {info['seconds']:.2f} s "
        f"(wall {time.perf_counter() - t:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())


def _scan_sample(seed: int, num_points: int = 16000):
    """A synthetic scan, normalised and sampled the way ``predict_scan``
    does it."""
    import numpy as np

    from geot_tpu_torch.data.tooth_semi import _synthetic_scan, pc_norm

    pts, _ = _synthetic_scan(seed, 40000)
    norm, center, scale = pc_norm(pts)
    sel = np.random.default_rng(0).choice(len(norm), num_points,
                                          replace=False)
    return pts, np.ascontiguousarray(norm[sel]), center, scale


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` with no host time: ``reps``
    calls captured into one CUDA graph, replayed between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fps_bound(bound: Bound, B: int, N: int, npoint: int):
    return bound(9.0 * B * (npoint - 1) * N, B * N * 12 + B * npoint * 4)


def _kernels_fps(bound: Bound, pos, pos2, pos6, dup):
    """The cluster FPS: the card's cluster size, the exchange's per-step
    latency at each size, indices against ``fps_ref`` (and the one-block
    kernel), and both kernels' times in this run."""
    import importlib

    import torch

    from geot_tpu_torch import ops

    # the module: ``ops.fps`` is the function
    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    dev = pos.device
    max_active = fps_mod.card_max_active(dev)
    sizes = {B: fps_mod.card_cluster_size(dev, B) for B in (1, 2, 6)}
    C = sizes[1]
    log(f"fps_cluster: clusters the card runs at once by size {max_active}; "
        f"cluster size by batch {sizes} (the largest whose B clusters run "
        f"at once)")
    exchange = {}
    for c in [c for c in fps_mod.CLUSTER_SIZES[::-1] if max_active[c] > 0]:
        won = ops.cluster_exchange(1, 8192, c, dev)
        torch.cuda.synchronize()
        check(bool(((won >= 0) & (won < c)).all()),
              f"cluster_exchange C={c}: winners outside 0..{c - 1}")
        ms = cuda_ms(lambda: ops.cluster_exchange(1, 8192, c, dev), 3)
        exchange[f"C{c}"] = ms * 1e3 / 8191
    log("cluster exchange alone, 8191 steps, us per step: "
        + ", ".join(f"C = {k[1:]} {v:.3f}" for k, v in exchange.items()))

    B0, N0 = 1, 16000
    big = torch.randn((1, C * 256 * fps_mod.CLUSTER_SLOTS[-1] + 1, 3),
                      generator=torch.Generator().manual_seed(5)).to(dev)
    odd = pos[:, :12345].contiguous()
    err = 0
    for label, xyz, npoint in (("(1,16000,3)->8192", pos, 8192),
                               ("(2,16000,3)->8192", pos2, 8192),
                               ("(6,16000,3)->8192", pos6, 8192),
                               ("ties (1,5200,3)->2048", dup, 2048),
                               ("odd (1,12345,3)->3000", odd, 3000),
                               (f"oversized (1,{big.shape[1]},3)->300", big,
                                300)):
        plan = ops.fps_plan(xyz.shape[1],
                            fps_mod.card_cluster_size(dev, xyz.shape[0]))
        before = dict(ops.LAUNCHES)
        got = ops.fps(xyz, npoint)
        routed = [k for k in ops.LAUNCHES if ops.LAUNCHES[k] != before[k]]
        check(routed == [plan.route], f"fps {label}: launched {routed}, "
              f"plan {plan}")
        ref = ops.fps_ref(xyz, npoint)
        block = ops.fps_block(xyz, npoint)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps {label}: indices differ from "
              f"fps_ref at {int((got != ref).sum())} places")
        err = max(err, int((got.long() - ref.long()).abs().max()))
        check(torch.equal(block, ref), f"fps_block {label}: indices differ "
              f"from fps_ref at {int((block != ref).sum())} places")
        log(f"fps {label}: route {plan.route} {plan[1:]}; indices bit-equal "
            f"to fps_ref, and so are fps_block's")

    # both kernels in turns (block, cluster, block); the cluster kernel at
    # the sizes the path takes and, where it fits, at half the B = 1 size
    timed = [c for c in dict.fromkeys((C, sizes[6], C // 2))
              if max_active.get(c, 0) > 0]
    rec_new, rec_old = {}, {}
    for label, xyz in (("(1,16000,3)->8192", pos), ("(6,16000,3)->8192",
                                                    pos6)):
        B = xyz.shape[0]
        t = {"fps_block": cuda_ms(lambda: ops.fps_block(xyz, 8192), 5)}
        for c in timed:
            plan = ops.fps_plan(N0, c)
            t[f"C{c}"] = cuda_ms(lambda: ops.fps_cluster(xyz, 8192, plan), 5)
        t["fps_block again"] = cuda_ms(lambda: ops.fps_block(xyz, 8192), 5)
        b_ms, b_by = _fps_bound(bound, B, N0, 8192)
        log(f"fps {label}: fps_cluster "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()
                        if k.startswith("C"))
            + f"; fps_block (one-block kernel) {t['fps_block']:.3f} / "
            f"{t['fps_block again']:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
        ms = t[f"C{sizes[B]}"]
        if B == B0:
            plain_ms = cuda_ms(lambda: ops.fps_ref(xyz, 8192), 1)
            rec_new = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "cluster_size": C,
                       "ms_by_cluster_size": {k: v for k, v in t.items()
                                              if k.startswith("C")},
                       "exchange_us_per_step": exchange}
            rec_old = {"ms": t["fps_block"], "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        else:
            rec_new["ms_b6"] = ms
            rec_old["ms_b6"] = t["fps_block"]
    rec_new["max_abs_err"] = rec_old["max_abs_err"] = float(err)
    return rec_new, rec_old


def _kernels_knn(bound: Bound, path_shapes, ties_case):
    """The split kNN against its plain version and the unsplit kernel at the
    serving path's 8 searches and a ties case; wrapper time (host
    included) and kernel-only time (CUDA graph) of both kernels."""
    import torch

    from geot_tpu_torch import ops

    err = 0.0
    # ms: kernel-only time; wrapper_ms: the wrapper's, host included
    new = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    old = {"ms": 0.0, "wrapper_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    t_ops = t_bytes = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, q, s, k in path_shapes + (ties_case,):
        d, i = ops.knn_small_k(q, s, k)
        d_r, i_r = ops.knn_small_k_ref(q, s, k)
        d_u, i_u = ops.knn_small_k_unsplit(q, s, k)
        torch.cuda.synchronize()
        B, Q, N = q.shape[0], q.shape[1], s.shape[1]
        shape = f"({Q},{N},{k})"
        for name, dd, ii in (("knn_small_k_ref", d_r, i_r),
                             ("knn_small_k_unsplit", d_u, i_u)):
            check(torch.equal(i, ii), f"knn {label} {shape}: idx differ from "
                  f"{name} at {int((i != ii).sum())} places")
            check(torch.equal(d, dd), f"knn {label} {shape}: d2 not "
                  f"bit-equal to {name}, max |diff| "
                  f"{float((d - dd).abs().max())}")
        err = max(err, float((d - d_r).abs().max()))
        S, split_len = ops.knn_split_plan(B, Q, N, sms)
        if label == "ties":
            log(f"knn ties {shape}: {S} splits; idx equal, d2 bit-equal to "
                f"the plain version and the unsplit kernel")
            continue
        t = {"split": cuda_ms(lambda: ops.knn_small_k(q, s, k), 20),
             "split_kernel": graph_ms(lambda: ops.knn_small_k(q, s, k), 20),
             "unsplit": cuda_ms(lambda: ops.knn_small_k_unsplit(q, s, k), 20),
             "unsplit_kernel": graph_ms(
                 lambda: ops.knn_small_k_unsplit(q, s, k), 20),
             "plain": cuda_ms(lambda: ops.knn_small_k_ref(q, s, k), 2)}
        flops, nbytes = 8.0 * B * Q * N, B * ((Q + N) * 12 + Q * k * 8)
        b_ms, b_by = bound(flops, nbytes)
        t_ops += flops
        t_bytes += nbytes
        for rec, w, kern in ((new, "split", "split_kernel"),
                             (old, "unsplit", "unsplit_kernel")):
            rec["wrapper_ms"] += t[w]
            rec["ms"] += t[kern]
            rec["plain_ms"] += t["plain"]
            rec["bound_ms"] += b_ms
        log(f"knn {label} {shape}: {S} splits of {split_len}; idx equal, d2 "
            f"bit-equal; split kernel {t['split_kernel']:.4f} ms (wrapper "
            f"{t['split']:.4f}), unsplit kernel {t['unsplit_kernel']:.4f} ms "
            f"(wrapper {t['unsplit']:.4f}), plain {t['plain']:.2f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    for rec in (new, old):
        rec["bound_by"] = bound(t_ops, t_bytes)[1]
        rec["max_abs_err"] = err
    log(f"knn per scan (8 searches): split kernel {new['ms']:.4f} ms "
        f"(wrapper {new['wrapper_ms']:.4f}), unsplit kernel {old['ms']:.4f} ms "
        f"(wrapper {old['wrapper_ms']:.4f}), plain {new['plain_ms']:.2f} ms, bound "
        f"{new['bound_ms']:.4f} ms")
    return new, old


def phase_kernels(bound: Bound):
    import numpy as np
    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine.eval import BUCKET, pad_to_bucket

    log("phase 3: kernels against their plain versions")
    dev = torch.device("cuda")
    pts, pos0, center, scale = _scan_sample(11)
    pos = torch.from_numpy(pos0)[None].to(dev)                 # (1, 16000, 3)
    pos2 = torch.cat([pos, torch.from_numpy(_scan_sample(12)[1])[None]
                      .to(dev)], dim=0)                         # (2, 16000, 3)
    pos6 = torch.cat([pos2] + [
        torch.from_numpy(_scan_sample(s)[1])[None].to(dev)
        for s in (13, 14, 15, 16)]).contiguous()                # (6, 16000, 3)
    base = pos[:, :3000]
    dup = torch.cat([base, base[:, :1500], base[:, :700]], dim=1).contiguous()

    fps_rec, fpsblock_rec = _kernels_fps(bound, pos, pos2, pos6, dup)

    # the serving path's small-k searches, on the points it gives them
    fps_pts = ops.gather_points(pos, ops.fps(pos, 8192))
    c8192, c4096, c512 = (fps_pts[:, :n].contiguous()
                          for n in (8192, 4096, 512))
    full = torch.from_numpy(pad_to_bucket(pts, BUCKET))[None].to(dev)
    world = (pos * torch.tensor(np.float32(scale), device=dev)
             + torch.from_numpy(center).to(dev)).contiguous()
    path_shapes = (("propagation_2 three_nn", c4096, c512, 3),
                   ("propagation_1 three_nn", c8192, c512, 3),
                   ("dgcnn_pro_2 cross", c4096, c512, 4),
                   ("dgcnn_pro_2 self", c4096, c4096, 4),
                   ("dgcnn_pro_1 cross", c8192, c4096, 4),
                   ("dgcnn_pro_1 self", c8192, c8192, 4),
                   ("propagation_0 three_nn", pos, c8192, 3),
                   ("upsample three_nn", full, world, 3))
    ties = torch.cat([c4096, c4096[:, :1000]], dim=1).contiguous()
    knn_rec, knnu_rec = _kernels_knn(bound, path_shapes,
                                     ("ties", c4096, ties, 4))

    # the bucket-pruned kernels: equal to their plain versions AND to the
    # path's kernels, at the serving and training FPS shapes and the
    # serving search shapes; same bound as the unpruned kernel
    fpsb_rec = {}
    for label, xyz, npoint in (("(1,16000,3)->8192", pos, 8192),
                               ("(6,16000,3)->8192", pos6, 8192),
                               ("ties (1,5200,3)->2048", dup, 2048)):
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        got = ops.fps_bucket(xyz, npoint, skipped=skipped)
        ref = ops.fps_bucket_ref(xyz, npoint)
        unpruned = ops.fps(xyz, npoint)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps_bucket {label}: indices differ "
              f"from fps_bucket_ref at {int((got != ref).sum())} places")
        check(torch.equal(got, unpruned), f"fps_bucket {label}: indices "
              f"differ from fps at {int((got != unpruned).sum())} places")
        B, N, _ = xyz.shape
        share = int(skipped) / (B * -(-N // 1024) * (npoint - 1))
        msg = (f"fps_bucket {label}: indices bit-equal to fps_bucket_ref "
               f"and fps; buckets skipped {100 * share:.1f} %")
        if label.startswith(("(1,", "(6,")):
            plan = ops.fps_bucket_plan(xyz)
            ms = cuda_ms(lambda: ops.fps_bucket(xyz, npoint), 5)
            kern_ms = cuda_ms(lambda: ops.fps_bucket(xyz, npoint, plan=plan),
                              5)
            b_ms, b_by = _fps_bound(bound, B, N, npoint)
            msg += (f"; wrapper {ms:.3f} ms (kernel alone {kern_ms:.3f} ms), "
                    f"bound {b_ms:.4f} ms ({b_by})")
            if label.startswith("(1,"):
                fpsb_rec = {"ms": ms, "kernel_ms": kern_ms,
                            "plain_ms": fps_rec["plain_ms"],
                            "bound_ms": b_ms, "bound_by": b_by,
                            "skip_share": share, "max_abs_err": 0.0}
        log(msg)

    knnp_rec = {"ms": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0,
                "bound_ms": knn_rec["bound_ms"],
                "bound_by": knn_rec["bound_by"], "max_abs_err": 0.0}
    n_skip = n_pairs = 0
    for label, q, s, k in path_shapes + (("ties", c4096, ties, 4),):
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        d, i = ops.knn_small_k_pruned(q, s, k, skipped=skipped)
        d_r, i_r = ops.knn_small_k_pruned_ref(q, s, k)
        d_u, i_u = ops.knn_small_k(q, s, k)
        torch.cuda.synchronize()
        shape = f"({q.shape[1]},{s.shape[1]},{k})"
        for name, dd, ii in (("knn_small_k_pruned_ref", d_r, i_r),
                             ("knn_small_k", d_u, i_u)):
            check(torch.equal(i, ii), f"knn_small_k_pruned {label} {shape}: "
                  f"idx differ from {name} at {int((i != ii).sum())} places")
            check(torch.equal(d, dd), f"knn_small_k_pruned {label} {shape}: "
                  f"d2 not bit-equal to {name}")
        pairs = -(-q.shape[1] // 256) * -(-s.shape[1] // 1024)
        msg = (f"knn_small_k_pruned {label} {shape}: idx equal, d2 "
               f"bit-equal to the plain version and knn_small_k; chunks "
               f"skipped {int(skipped)}/{pairs}")
        if label != "ties":
            n_skip += int(skipped)
            n_pairs += pairs
            plan = ops.knn_pruned_plan(q, s)
            ms = cuda_ms(lambda: ops.knn_small_k_pruned(q, s, k), 10)
            kern_ms = cuda_ms(lambda: ops.knn_small_k_pruned(q, s, k,
                                                             plan=plan), 10)
            plain_ms = cuda_ms(lambda: ops.knn_small_k_pruned_ref(q, s, k), 2)
            knnp_rec["ms"] += ms
            knnp_rec["kernel_ms"] += kern_ms
            knnp_rec["plain_ms"] += plain_ms
            msg += (f"; wrapper {ms:.3f} ms (kernel alone {kern_ms:.3f} ms), "
                    f"plain {plain_ms:.2f} ms")
        log(msg)
    knnp_rec["skip_share"] = n_skip / n_pairs
    log(f"knn_small_k_pruned over the 8 searches of a scan: wrapper "
        f"{knnp_rec['ms']:.3f} ms (kernel alone {knnp_rec['kernel_ms']:.3f} "
        f"ms), knn_small_k {knn_rec['ms']:.4f} ms kernel, bound "
        f"{knnp_rec['bound_ms']:.4f} ms; chunks skipped "
        f"{100 * knnp_rec['skip_share']:.1f} %")
    return {"fps_cluster": fps_rec, "fps": fpsblock_rec,
            "knn_split": knn_rec, "knn_small_k": knnu_rec,
            "fps_bucket": fpsb_rec, "knn_small_k_pruned": knnp_rec}


def _fdi_ok(labels, jaw: int) -> bool:
    lo, hi = (31, 48) if jaw == 0 else (11, 28)
    return all(lab == 0 or lo <= lab <= hi for lab in labels)


def phase_serving():
    import copy

    import numpy as np
    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, ops
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan
    from geot_tpu_torch.engine.predict import (load_model, map_pred_to_fdi,
                                               predict_scan)

    log("phase 4: serving the flagship model")
    model = load_model(FLAGSHIP_SEG_ARGS, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    scans = [_synthetic_scan(seed, 40000)[0] for seed in (21, 22, 23)]
    predict_scan(model, scans[0], jaw=0)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    results, lat = [], []
    for n, pts in enumerate(scans):
        jaw = n % 2
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        pred, logits = predict_scan(model, pts, jaw=jaw)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        grew = {k: ops.LAUNCHES[k] - before[k] for k in before}
        check(grew == dict(dict.fromkeys(ops.LAUNCHES, 0), fps_cluster=1,
                           knn_split=8),
              f"scan {n}: kernel launches {grew}, expected 1 fps_cluster + "
              f"8 knn_split")
        check(logits.shape == (16000, 17) and bool(torch.isfinite(logits).all()),
              f"scan {n}: logits {tuple(logits.shape)} not finite/shaped")
        labels = map_pred_to_fdi(pred, jaw)
        check(pred.shape == (len(pts),) and pred.dtype == np.uint8
              and _fdi_ok(labels, jaw), f"scan {n}: bad labels")
        results.append(labels)
    launches = dict(ops.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"served 3 scans of 40000 points ({n_params} parameters): latency "
        f"{', '.join(f'{x:.1f}' for x in lat)} ms; peak memory "
        f"{peak_mb:.0f} MiB; launches {launches}")

    # the card's forward (kernels) against the same model on the CPU (plain
    # versions), same sampled input
    pos = torch.from_numpy(_scan_sample(21)[1])[None]
    cls = torch.zeros((1, 1), dtype=torch.long)
    with torch.no_grad():
        a = model({"pos": pos.cuda(), "x": None, "cls": cls.cuda()})[0].cpu()
        cpu_model = copy.deepcopy(model).cpu()
        b = cpu_model({"pos": pos, "x": None, "cls": cls})[0]
    diff = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    scale = max(1.0, float(b.abs().max()))
    log(f"card vs CPU forward at full width: max |dlogit| {diff:.3e} "
        f"(logit scale {scale:.2f}), argmax agreement {agree:.6f}")
    check(diff <= 1e-3 * scale and agree >= 0.999,
          "card forward disagrees with the CPU forward")
    return scans, results, launches, lat, peak_mb


def _profile(label: str, fn, reps: int) -> None:
    """Device time by kernel over ``reps`` calls of ``fn`` after a warm-up,
    and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # kernels only: operator rows repeat the time of the kernels they launch
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    log(f"{label} x {reps}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} %), idle "
        f"{100 * (1 - busy_us / wall_us):.1f} %")
    for e in rows[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  "
            f"{e.key[:90]}")


def phase_profile(scans, train):
    """``--profile``: where the time of a served scan and of a train step
    goes on the device."""
    from geot_tpu_torch.data.build import MODEL_KEYS, SEMI_KEYS, to_device
    from geot_tpu_torch.engine.predict import load_model, predict_scan
    from geot_tpu_torch.engine.steps import make_semi_step
    from geot_tpu_torch import FLAGSHIP_SEMI_CFG

    log("phase 7: profile")
    model = load_model(seed=0, device="cuda")
    it = iter(scans * 2)
    _profile("served scan", lambda: predict_scan(model, next(it)), 3)
    state, (bl, bu) = train["state"], train["pairs"][0]
    bl = to_device(bl, MODEL_KEYS, "cuda")
    bu = to_device(bu, SEMI_KEYS, "cuda")
    step = make_semi_step(FLAGSHIP_SEMI_CFG)
    _profile("train step", lambda: step(state, bl, bu, 1e-3, True), 2)


def phase_http(scans, results):
    import numpy as np

    from geot_tpu_torch.engine.serve import serve

    log("phase 5: http")
    httpd = serve(port=0, device="cuda", seed=0, warmup=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            check(json.load(r)["status"] == "ok", "healthz")
        for n, pts in enumerate(scans):
            jaw = n % 2
            buf = io.BytesIO()
            np.save(buf, pts)
            req = urllib.request.Request(
                f"{base}/predict?jaw={'lower' if jaw == 0 else 'upper'}",
                data=buf.getvalue(), method="POST")
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                d = json.load(r)
            dt = (time.perf_counter() - t) * 1e3
            same = float(np.mean(np.asarray(d["labels"]) ==
                                 np.asarray(results[n])))
            check(d["n_points"] == len(pts) and _fdi_ok(d["labels"], jaw)
                  and same >= 0.999, f"http scan {n}: bad answer "
                  f"(agreement with predict_scan {same})")
            log(f"POST /predict scan {n}: {dt:.1f} ms round trip, labels "
                f"agree with predict_scan {same:.6f}")
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            check(json.load(r)["scans_served"] == 3, "scans_served")
    finally:
        httpd.shutdown()
        httpd.server_close()


# biases that feed a batch-statistics BatchNorm: their gradient is zero in
# exact arithmetic, so only its size is checked
_ZERO_GRAD = ("segmentor.encoder.first_conv.0.bias",
              "segmentor.encoder.first_conv.3.bias",
              "segmentor.encoder.second_conv.0.bias",
              "segmentor.seg_head.0.bias")


def _adam_grads(state):
    """name -> the first AdamW moment after one step (0.1 x the clipped
    gradient), on the host."""
    out = {}
    for name, p in list(state.model.named_parameters()) + list(
            state.t_predictor.named_parameters()):
        opt = state.t_opt if name.startswith("T_predictor.") else state.opt
        out[name] = opt.state[p]["exp_avg"].detach().double().cpu()
    return out


def phase_train():
    """The flagship semi-supervised step at full width: returns the
    per-step launch counts and numbers for the kernels line."""

    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data.build import (MODEL_KEYS, SEMI_KEYS,
                                           build_semi_loaders, semi_pairs,
                                           to_device)
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_cm_step, make_semi_step
    from geot_tpu_torch.engine.train import cal_mean_feature
    from geot_tpu_torch.optim import build_scheduler_from_cfg

    log("phase 6: train (flagship FixMatch + NTM step, full width)")
    dev = torch.device("cuda")
    cfg = FLAGSHIP_SEMI_CFG
    C = cfg["num_classes"]
    t = time.perf_counter()
    state = SemiTrainState.create(cfg, seed=0, device=dev)
    loader_l, loader_u = build_semi_loaders(cfg)
    epoch = 1
    for loader in (loader_l, loader_u):
        loader.set_epoch(epoch)
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"state built in {time.perf_counter() - t:.1f} s: student "
        f"{n_params} parameters, batch {cfg['batch_size_l']} + "
        f"{cfg['batch_size_u']} + {cfg['batch_size_u']}, "
        f"{cfg['num_points']} points")

    # cm bootstrap over 2 labelled batches, counted per batch
    cm_step = make_cm_step()
    counted = []

    def counting_step(model, batch):
        ops.reset_launches()
        out = cm_step(model, batch)
        counted.append(dict(ops.LAUNCHES))
        return out

    pairs = list(semi_pairs(loader_l, loader_u, limit=3))
    t = time.perf_counter()
    state.cm = cal_mean_feature(counting_step, state.model,
                                [b for b, _ in pairs[:2]], C, dev)
    torch.cuda.synchronize()
    log(f"cal_mean_feature over 2 batches: {time.perf_counter() - t:.2f} s; "
        f"launches per batch {counted}")
    for c in counted:
        check(c == dict(dict.fromkeys(ops.LAUNCHES, 0), fps_cluster=1,
                        knn_split=7),
              f"cm batch launches {c}, expected 1 fps_cluster + 7 "
              f"knn_split")
    check(bool(torch.isfinite(state.cm).all()), "cm not finite")

    step = make_semi_step(cfg)
    lr = build_scheduler_from_cfg(cfg)(epoch)
    use_teacher = cfg["supervised_epochs"] < epoch <= cfg["switch_ep"]
    check(use_teacher, "epoch 1 of the flagship runs the teacher")
    before = {k: v.detach().clone()
              for k, v in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, per_step = [], []
    for n, (bl, bu) in enumerate(pairs):
        bl = to_device(bl, MODEL_KEYS, dev)
        bu = to_device(bu, SEMI_KEYS, dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        m = step(state, bl, bu, lr, use_teacher)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(dict(ops.LAUNCHES))
        terms = {k: float(m[k]) for k in ("loss", "sup_loss", "unsup_loss",
                                          "threed_loss")}
        log(f"step {n}: {step_ms[-1]:.1f} ms; " + ", ".join(
            f"{k} {v:.6f}" for k, v in terms.items())
            + f"; teacher_acc {float(m['teacher_acc']):.4f}; launches "
            f"{per_step[-1]}")
        check(all(math.isfinite(v) for v in terms.values()),
              f"step {n}: a loss is not finite: {terms}")
        check(per_step[-1] == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                   fps_cluster=2, knn_split=14),
              f"step {n}: launches {per_step[-1]}, expected 2 fps_cluster "
              f"+ 14 knn_split")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    rows = state.ema_t.sum(dim=1)
    check(bool(torch.allclose(rows, torch.ones_like(rows), atol=1e-5)),
          f"ema_t rows do not sum to 1: {rows.tolist()}")
    changed = sum(not torch.equal(before[k], v)
                  for k, v in state.model.named_parameters())
    check(changed > 0.9 * len(before), f"only {changed}/{len(before)} "
          f"parameter tensors changed")
    check(state.step == 3, "step counter")
    log(f"3 steps: {', '.join(f'{x:.1f}' for x in step_ms)} ms; peak memory "
        f"{peak_mb:.0f} MiB; {changed}/{len(before)} parameter tensors "
        f"changed; ema_t rows sum to 1")

    # card vs CPU: one step from the same state and batch, 1 + 1 + 1
    # clouds, stochastic depth and dropout off; in float32, and in float64
    # (the model and step in float64 around the float32 kernels), where
    # rounding no longer hides what the two paths compute
    cfg1 = dict(cfg, batch_size_l=1, batch_size_u=1)
    seg = dict(FLAGSHIP_SEG_ARGS, drop_path_rate=0.0, head_dropout=0.0)
    l1, u1 = build_semi_loaders(cfg1)
    for loader in (l1, u1):
        loader.set_epoch(epoch)
    bl, bu = next(semi_pairs(l1, u1, limit=1))
    compare = {}
    # float32 gradients through batch-statistics BatchNorm differ by up to
    # ~1e-2 of a tensor's scale between two summation orders (PERF.md); the
    # float32 bound only guards against gross errors, float64 holds 1e-3
    for dt, grad_tol in ((torch.float32, 5e-2), (torch.float64, 1e-3)):
        res = {}
        for name in ("cuda", "cpu"):
            st = SemiTrainState.create(cfg1, seg_args=seg, seed=1,
                                       device=name)
            for mod in (st.model, st.teacher, st.t_predictor):
                mod.to(dt)
            st.ema_t = st.ema_t.to(dt)
            st.cm = state.cm.to(name, dt)
            batches = [{k: (v.to(dt) if v.is_floating_point() else v)
                        for k, v in to_device(b, keys, name).items()}
                       for b, keys in ((bl, MODEL_KEYS), (bu, SEMI_KEYS))]
            t = time.perf_counter()
            m = make_semi_step(cfg1)(st, *batches, lr, True)
            if name == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t
            res[name] = ({k: float(m[k]) for k in (
                "loss", "sup_loss", "unsup_loss", "threed_loss")},
                _adam_grads(st), st.ema_t.double().cpu())
            log(f"one {str(dt)[6:]} step, 1 + 1 + 1 clouds, on the {name}: "
                f"{secs:.1f} s; losses {res[name][0]}")
        (lg, gg, eg), (lc, gc, ec) = res["cuda"], res["cpu"]
        rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lg}
        gmax = max(float(v.abs().max()) for v in gc.values())
        errs = {}
        for k, ref in gc.items():
            if k in _ZERO_GRAD:
                check(float(gg[k].abs().max()) <= 1e-4 * gmax
                      and float(ref.abs().max()) <= 1e-4 * gmax,
                      f"{k}: gradient should vanish")
                continue
            scale = float(ref.abs().max())
            errs[k] = (float((gg[k] - ref).abs().max()) / scale if scale > 0
                       else float(gg[k].abs().max()))
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        ema_diff = float((eg - ec).abs().max())
        log(f"card vs CPU {str(dt)[6:]} step: loss terms relative "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + "; per-tensor gradient max |d| / max |g|: worst "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst)
            + f" ({len(errs)} tensors); ema_t max |d| {ema_diff:.2e}")
        check(all(v <= 1e-4 for v in rel.values()),
              f"card vs CPU {dt} loss terms differ: {rel}")
        check(worst[0][1] <= grad_tol,
              f"card vs CPU {dt} gradients differ: {worst}")
        check(ema_diff <= 1e-6, f"card vs CPU {dt} ema_t differ")
        compare[str(dt)[6:]] = {"loss_rel": max(rel.values()),
                                "grad_rel": worst[0][1]}
    return {"step_ms": step_ms, "peak_mb": peak_mb, "per_step": per_step,
            "compare": compare,
            "cm_batches": counted, "state": state, "pairs": pairs}


def main() -> int:
    faulthandler.dump_traceback_later(1100, exit=True)
    name, smi, limit_w = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    phase_build()
    recs = phase_kernels(Bound(limit_w))
    scans, results, serving, _, _ = phase_serving()
    phase_http(scans, results)
    train = phase_train()
    if "--profile" in sys.argv[1:]:
        phase_profile(scans, train)
    # launches on the two main paths: 3 served scans, and the train run
    # (2 cm batches + 3 steps); the first versions of FPS and kNN and the
    # pruned kernels are on neither path
    trained = {k: sum(c[k] for c in train["cm_batches"] + train["per_step"])
               for k in serving}
    per_step = train["per_step"][0]
    log(f"launches: serving {serving}, training {trained}")

    def entry(name, replaces):
        return {"name": name, "route": "cuda",
                "source": f"geot_tpu_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": serving[name] + trained[name],
                "launches_serving_3_scans": serving[name],
                "launches_train_step": per_step[name],
                "library_ms": None, **recs[name]}

    kernels = [
        entry("fps_cluster", "geot_tpu/ops/pallas_fps.py:231"),
        entry("fps", "geot_tpu/ops/pallas_fps.py:231"),
        entry("knn_split", "geot_tpu/ops/pallas_knn.py:98"),
        entry("knn_small_k", "geot_tpu/ops/pallas_knn.py:98"),
        entry("fps_bucket", "geot_tpu/ops/pallas_fps.py:181"),
        entry("knn_small_k_pruned", "geot_tpu/ops/pallas_knn_pruned.py:104"),
    ]
    log("done")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
