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
8. trainer: ``engine.train.parse_and_run`` in this process on
   ``cfgs/tooth_semi/transformer_finetune_fixmatch_ntm.yaml`` at full width,
   in a temporary root directory that is deleted afterwards. Run A: 2
   epochs of 12 steps on the synthetic 24-scan labelled and 48-scan
   unlabelled splits (cm bootstrap over 12 batches, validation after each
   epoch, the test split at epoch 2 on the best checkpoint, checkpoints
   every epoch): losses finite, val/test metrics in [0, 1], the reference's
   epoch scalars present, the latest/best/E1/E2 checkpoints written, and
   the launch counters equal to 2 ``fps_cluster`` + 14 ``knn_split`` a
   step, 1 + 7 a cm batch, 1 + 9 a val/test batch of 2 scans, 0 for the
   other kernels. Run C: ``mode=val`` on A's best checkpoint gives A's best
   val metrics. Run B: ``mode=resume`` from A's epoch-1 checkpoint; its
   epoch-2 scalars agree with A's (loss terms within 0.25 relative,
   metrics within 5e-3 absolute: atomics in the backward pass make the
   card's steps non-deterministic, and B prints how far). Then, in a child
   process with deterministic algorithms (``--resume-check``), the same 2
   epochs and the same resume: every epoch-2 scalar bit-equal.
   Prints epoch wall and data time, host
   ms between steps, validate ms per scan (first pass apart), checkpoint
   bytes and save/load ms, and peak memory.
9. fast serving: the serving topology (``fast_pyramid=1024``,
   ``fast_graph``) through the entry points. ``fps_stratified`` on the
   card is bit-equal to the CPU's on a sampled scan and on a 2,000-point
   scan sampled to 16,000 (duplicates), and is a permutation; the
   flagship at full width with seeded weights serves 6 scans in float32
   and 6 in bfloat16 through ``predict_scan`` (latency, peak memory, a
   profiled window's device idle share), each scan launching 1
   ``fps_cluster`` and 6 ``knn_split`` and nothing else; float32 on the
   card against the port's CPU forward (max |dlogit| <= 1e-3 x the logit
   p99, argmax agreement >= 0.999); bfloat16 on the card against the
   port's CPU bfloat16 forward (argmax agreement >= 0.98, max |dlogit| <=
   2 x the CPU's own bfloat16-vs-float32 difference; bounds fixed before
   the first card run); 2 test-time votes, a two-member ensemble, and
   ``predict_stream`` over 4 scans whose labels equal ``predict_scan``'s in
   the same draw order, each with its launch counts checked; one request
   to ``python -m geot_tpu_torch.engine.serve --fast`` in a child process,
   whose labels equal ``predict_scan``'s.
10. fast trainer: ``parse_and_run`` on
   ``cfgs/tooth_semi/transformer_finetune_fixmatch_ntm_fast.yaml`` (a
   student in the serving topology, the exact teacher) for 1 epoch with
   validation and the test pass, then ``mode=test`` with 2 votes on its
   best checkpoint: metrics in [0, 1], losses finite, launches checked
   against the counts the code implies, ``fps_cluster`` launches counted
   by shape ((6, 16000) -> 1024 and (2, 16000) -> 8192 once a step);
   prints epoch wall and data time, host ms between steps, peak memory.
11. semi-step branches: ``knn_split`` at the self-search of a whole cloud,
   (2, 16000) x (2, 16000), k = 2 (``Poly1FocalLoss_U_top2``), bit-equal to
   the plain version on sampled scans and on 2,000 distinct points sampled
   to 16,000, with its split plan and times; at full width (2 + 2 + 2
   clouds) one warm-up and 2 timed steps each of the flagship, all flags
   (feature-space, identity and contrast losses, ``pseudo_refine``,
   ``filter_outlier``), ``threed_anchors=4096`` and every other
   ``criterion_u`` name, losses finite and launches counted (top2: one
   more ``knn_split``, the self-search); the all-flags step's peak memory
   and, with the anchored and flagship steps, device time by kernel; the
   all-flags step on the card against the CPU (1 + 1 + 1 clouds, dropout
   off, the same contrast draws), in float32 and float64: loss terms
   within 1e-4 relative, the feature-space term within 1e-3 of the whole
   loss and the rest of the loss within 1e-4, ``ema_t`` within 1e-5, the
   bank's ``ptr`` equal; ``skip_nonfinite_updates`` with a NaN in a strong
   view: skipped, the whole state bit-equal, the next step trains; the
   trainer on the flagship YAML with every switch, ``threed_anchors=4096``
   and ``ema_eval=0.99`` for 2 epochs: ``val`` and ``val_raw`` each epoch,
   the test pass on the tree that won, launches as the code implies.
Phase 3 also holds ``fps_cluster`` at the serving topology's prefix,
(1|6, 16000) -> 1024 and a duplicate-heavy cloud, and ``knn_split`` at a
fast scan's 6 searches, against their plain versions, with times and
bounds.
Then the ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; without a CUDA device it exits 1 at once.

    python3 chip_smoke.py --profile

adds, after phase 10, a ``torch.profiler`` trace of 3 served scans, 2
train steps and 2 ``_fast.yaml`` train steps: device time by kernel and
the device's busy share of the wall time.
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
    log(f"knn per scan ({len(path_shapes)} searches): split kernel "
        f"{new['ms']:.4f} ms "
        f"(wrapper {new['wrapper_ms']:.4f}), unsplit kernel {old['ms']:.4f} ms "
        f"(wrapper {old['wrapper_ms']:.4f}), plain {new['plain_ms']:.2f} ms, bound "
        f"{new['bound_ms']:.4f} ms")
    return new, old


def _kernels_fast(bound: Bound, pos, pos6, full, world):
    """The serving topology's kernel shapes: ``fps_cluster`` for the
    true-FPS prefix of 1024 at B = 1 (a served scan) and B = 6 (the fast
    student) and on a duplicate-heavy cloud; ``knn_split`` at a fast scan's
    6 searches, on points in the stratified order."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops

    dev = pos.device
    # 2,000 distinct points sampled to 16,000 with replacement, as
    # predict_scan samples a small scan: min-distances reach 0 and the
    # smallest-index rule decides every later pick
    idx = np.random.default_rng(3).choice(2000, 16000, replace=True)
    dup = pos[:, torch.from_numpy(idx).to(dev)].contiguous()
    fps_rec = {}
    for label, xyz in (("(1,16000,3)->1024", pos),
                       ("(6,16000,3)->1024", pos6),
                       ("duplicate-heavy (1,16000 of 2000,3)->1024", dup)):
        B = xyz.shape[0]
        before = ops.LAUNCHES["fps_cluster"]
        got = ops.fps(xyz, 1024)
        check(ops.LAUNCHES["fps_cluster"] == before + 1,
              f"fps {label}: not routed to fps_cluster")
        ref = ops.fps_ref(xyz, 1024)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps {label}: indices differ from "
              f"fps_ref at {int((got != ref).sum())} places")
        msg = f"fps {label}: indices bit-equal to fps_ref"
        if not label.startswith("dup"):
            ms = cuda_ms(lambda: ops.fps(xyz, 1024), 10)
            b_ms, b_by = _fps_bound(bound, B, 16000, 1024)
            fps_rec[f"ms_b{B}"] = ms
            fps_rec[f"bound_ms_b{B}"] = b_ms
            fps_rec["bound_by"] = b_by
            msg += f"; {ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})"
            if B == 1:
                fps_rec["plain_ms_b1"] = cuda_ms(
                    lambda: ops.fps_ref(xyz, 1024), 1)
                msg += f", plain {fps_rec['plain_ms_b1']:.1f} ms"
        log(msg)

    perm = ops.fps_stratified(pos, 16000, 1024)
    sp = ops.gather_points(pos, perm)
    c512, c4096, c8192 = (sp[:, :n].contiguous() for n in (512, 4096, 8192))
    shapes = (("propagation_2 three_nn, rows 512-4095",
               sp[:, 512:4096].contiguous(), c512, 3),
              ("propagation_1 three_nn, rows 512-8191",
               sp[:, 512:8192].contiguous(), c512, 3),
              ("dgcnn_pro_2 cross", c4096, c512, 4),
              ("dgcnn_pro_1 cross", c8192, c4096, 4),
              ("propagation_0 three_nn, rows 8192-15999",
               sp[:, 8192:].contiguous(), c8192, 3),
              ("upsample three_nn", full, world, 3))
    ties = torch.cat([c8192, c8192[:, :3000]], dim=1).contiguous()
    knn_new, knn_old = _kernels_knn(bound, shapes,
                                    ("ties", sp[:, 8192:].contiguous(),
                                     ties, 3))
    return fps_rec, knn_new, knn_old


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
    fast_fps, fast_knn, fast_knnu = _kernels_fast(bound, pos, pos6, full,
                                                  world)
    fps_rec["fast_prefix_1024"] = fast_fps
    knn_rec["fast_scan_6_searches"] = {
        k: fast_knn[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                 "bound_ms", "bound_by")}
    knnu_rec["fast_scan_6_searches"] = {
        k: fast_knnu[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                  "bound_ms", "bound_by")}
    for rec, extra in ((knn_rec, fast_knn), (knnu_rec, fast_knnu)):
        rec["max_abs_err"] = max(rec["max_abs_err"], extra["max_abs_err"])

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


def _profile(label: str, fn, reps: int, top: int = 15):
    """Device time by kernel over ``reps`` calls of ``fn`` after a warm-up,
    and the device's busy share of the wall time; returns (wall ms, device
    busy ms)."""
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
    for e in rows[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  "
            f"{e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3


def phase_profile(scans, train):
    """``--profile``: where the time of a served scan and of a train step
    goes on the device."""
    from geot_tpu_torch.data.build import MODEL_KEYS, SEMI_KEYS, to_device
    from geot_tpu_torch.engine.predict import load_model, predict_scan
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step
    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG

    log("phase 7: profile")
    model = load_model(seed=0, device="cuda")
    it = iter(scans * 2)
    _profile("served scan", lambda: predict_scan(model, next(it)), 3)
    state, (bl, bu) = train["state"], train["pairs"][0]
    bl = to_device(bl, MODEL_KEYS, "cuda")
    bu = to_device(bu, SEMI_KEYS, "cuda")
    step = make_semi_step(FLAGSHIP_SEMI_CFG)
    _profile("train step", lambda: step(state, bl, bu, 1e-3, True), 2)
    # the _fast.yaml step: a student in the serving topology, the exact
    # teacher
    fast = SemiTrainState.create(
        FLAGSHIP_SEMI_CFG, seg_args=dict(FLAGSHIP_SEG_ARGS, **FAST),
        teacher_args=FLAGSHIP_SEG_ARGS, seed=0, device="cuda")
    fast.cm = state.cm
    _profile("fast train step", lambda: step(fast, bl, bu, 1e-3, True), 2)


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


# the trainer's expected kernel launches: per semi step, per cm-bootstrap
# batch, per val/test batch of 2 scans (the batched forward + one
# full-resolution upsample per scan)
_PER_STEP = {"fps_cluster": 2, "knn_split": 14}
_PER_CM_BATCH = {"fps_cluster": 1, "knn_split": 7}
_PER_EVAL_BATCH = {"fps_cluster": 1, "knn_split": 9}
# epoch-2 scalars of a resume (run B) against the uninterrupted run A, with
# the card's default, non-deterministic backward (atomics): loss terms
# relative, val/test metrics absolute. Three card runs measured at most
# 3.1e-3 for the three loss terms and 1.1e-3, 4.7e-3 and 3.8e-2 for
# insT_threed_loss (the T-predictor's term), the metrics bit-equal; these
# bounds catch a resume that loses state, not rounding. The exact check is
# the deterministic pair (``resume_check``): bit-equal.
RESUME_LOSS_RTOL = 0.25
RESUME_METRIC_ATOL = 5e-3


def _expected(steps: int, cm_batches: int, eval_batches: int):
    from geot_tpu_torch import ops

    out = dict.fromkeys(ops.LAUNCHES, 0)
    for per, n in ((_PER_STEP, steps), (_PER_CM_BATCH, cm_batches),
                   (_PER_EVAL_BATCH, eval_batches)):
        for k, v in per.items():
            out[k] += v * n
    return out


def _epoch_scalars(path: str, skip: int = 0):
    """tag -> value of the epoch-2 lines of a scalars.jsonl, from line
    ``skip`` on; and the file's line count."""
    with open(path) as f:
        lines = f.readlines()
    out = {}
    for line in lines[skip:]:
        d = json.loads(line)
        if d["step"] == 2:
            out[d["tag"]] = d["value"]
    return out, len(lines)


def phase_trainer():
    """The training entry point on the card: ``parse_and_run`` on the
    flagship YAML at full width, in-process so the launch counters can be
    read. Run A trains 2 epochs (val every epoch, test at epoch 2,
    checkpoints every epoch), run C scores A's best checkpoint in
    ``mode=val``, run B resumes from A's epoch-1 checkpoint to epoch 2."""
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path

    log("phase 8: trainer (parse_and_run, flagship YAML, full width)")
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    root = tempfile.mkdtemp(prefix="geot_trainer_")
    # (run, what, ms) of every validate, save and load, each between two
    # synchronisations
    timed = {"validate": [], "save": [], "load": []}
    current = {"run": "A"}
    real = {k: getattr(train_mod, k) for k in ("validate", "save_checkpoint",
                                               "load_checkpoint")}

    def timing(name, fn, what):
        def run(*args, **kwargs):
            label = what(args, kwargs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timed[name].append((current["run"], label,
                                (time.perf_counter() - t) * 1e3))
            return out
        return run

    # a validate call on a loader without a cache is its first pass: it
    # builds the items on the host and copies them to the card
    train_mod.validate = timing(
        "validate", real["validate"],
        lambda a, k: (k.get("tag", "val"), len(a[2].dataset),
                      getattr(a[2], "_geot_eval_cache", None) is None))
    train_mod.save_checkpoint = timing("save", real["save_checkpoint"],
                                       lambda a, k: f"epoch {a[2]}")
    train_mod.load_checkpoint = timing("load", real["load_checkpoint"],
                                       lambda a, k: os.path.basename(a[0]))
    common = [f"root_dir={root}", "val_freq=1", "test_freq=2", "save_freq=1"]
    try:
        # run A
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t = time.perf_counter()
        res_a = train_mod.parse_and_run(["--cfg", cfg_path, "epochs=2",
                                         *common])
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t
        launches_a = dict(ops.LAUNCHES)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        run_dirs = [os.path.join(root, "tooth_semi", d)
                    for d in os.listdir(os.path.join(root, "tooth_semi"))]
        check(len(run_dirs) == 1, f"run A made {run_dirs}")
        run_dir = run_dirs[0]
        name = os.path.basename(run_dir)
        ckdir = os.path.join(run_dir, "checkpoint")
        for tag in ("latest", "best", "E1", "E2"):
            check(os.path.exists(ckpt_path(ckdir, name, tag)),
                  f"run A: no {tag} checkpoint in {os.listdir(ckdir)}")
        scalars = os.path.join(run_dir, "scalars.jsonl")
        a2, n_lines = _epoch_scalars(scalars)
        missing = [t for t in list(train_mod.REF_TAGS)[:9]
                   + ["insT_threed_loss"] if t not in a2]
        check(not missing, f"run A: scalars.jsonl lacks {missing}")
        losses = {t: a2[t] for t in ("train_loss", "train_loss_l",
                                     "train_loss_u", "insT_threed_loss")}
        check(all(math.isfinite(v) for v in losses.values()),
              f"run A: epoch-2 losses not finite: {losses}")
        for split in ("val", "test"):
            bad = {k: v for k, v in res_a[split].items()
                   if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
            check(not bad, f"run A: {split} metrics outside [0, 1]: {bad}")
        want = _expected(steps=24, cm_batches=12, eval_batches=3 * 12)
        check(launches_a == want, f"run A launches {launches_a}, expected "
              f"{want} (24 steps, 12 cm batches, 3 eval passes of 12)")
        epochs = {}
        with open(scalars) as f:
            for line in f:
                d = json.loads(line)
                if d["tag"] in ("epoch_seconds", "data_seconds"):
                    epochs.setdefault(d["step"], {})[d["tag"]] = d["value"]
        with open(os.path.join(run_dir, "step_times.jsonl")) as f:
            steps = [json.loads(x) for x in f]
        step_ms = [s_["dt"] * 1e3 for s_ in steps if s_["step"] % 12 != 1]
        ckpt_bytes = os.path.getsize(ckpt_path(ckdir, name, "latest"))

        # run C: mode=val on A's best checkpoint
        current["run"] = "C"
        ops.reset_launches()
        res_c = train_mod.parse_and_run(
            ["--cfg", cfg_path, "mode=val",
             f"pretrained_path={ckpt_path(ckdir, name, 'best')}",
             f"root_dir={root}"])
        launches_c = dict(ops.LAUNCHES)
        best = res_a["best"]
        diff_c = max(abs(res_c["val"][f"whole_{k}"] - best[k])
                     for k in ("miou", "dsc", "acc"))
        log(f"run C (mode=val, best checkpoint of epoch {best['epoch']}): "
            f"whole miou/dsc/acc {res_c['val']['whole_miou']:.6f} / "
            f"{res_c['val']['whole_dsc']:.6f} / "
            f"{res_c['val']['whole_acc']:.6f}; run A's best "
            f"{best['miou']:.6f} / {best['dsc']:.6f} / {best['acc']:.6f}; "
            f"max |d| {diff_c:.3e}; launches {launches_c}")
        check(diff_c <= 1e-6, "run C does not give run A's best val metrics")
        check(launches_c == _expected(0, 0, 12), f"run C launches "
              f"{launches_c}")

        # run B: resume from A's epoch-1 checkpoint to epoch 2
        current["run"] = "B"
        ops.reset_launches()
        train_mod.parse_and_run(
            ["--cfg", cfg_path, "mode=resume",
             f"pretrained_path={ckpt_path(ckdir, name, 'E1')}", "epochs=2",
             *common])
        launches_b = dict(ops.LAUNCHES)
        b2, _ = _epoch_scalars(scalars, skip=n_lines)
        check(set(b2) == set(a2), f"run B's epoch-2 tags differ from A's: "
              f"{sorted(set(a2) ^ set(b2))}")

        def compare(x, y):
            d = {t: (abs(y[t] - v) / max(abs(v), 1e-30) if t in losses
                     else abs(y[t] - v)) for t, v in x.items()
                 if t not in ("epoch_seconds", "data_seconds")}
            return (d, max(d[t] for t in losses),
                    max(v for t, v in d.items()
                        if t.startswith(("val_", "best_val_", "test_"))))

        diffs, worst_loss, worst_metric = compare(a2, b2)
        log(f"run B (resume from E1): epoch-2 loss terms within "
            f"{worst_loss:.3e} relative of run A ("
            + ", ".join(f"{t} {diffs[t]:.2e}" for t in losses)
            + f"), val/test metrics within {worst_metric:.3e} absolute; "
            f"{sum(1 for v in diffs.values() if v == 0)}/{len(diffs)} "
            f"scalars bit-equal; launches {launches_b}")
        # the same resume with deterministic algorithms, in a child
        # process (cuBLAS takes its workspace setting at start-up)
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--resume-check",
             os.path.join(root, "deterministic")], capture_output=True,
            text=True, timeout=600,
            env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        check(child.returncode == 0, "the deterministic resume failed: "
              + child.stderr[-3000:])
        pair = json.loads([line for line in child.stdout.splitlines()
                           if line.startswith("RESUME_CHECK ")][-1][13:])
        tags = [t_ for t_ in pair["a"] if t_ not in ("epoch_seconds",
                                                     "data_seconds")]
        unequal = {t_: (pair["a"][t_], pair["b"].get(t_)) for t_ in tags
                   if pair["b"].get(t_) != pair["a"][t_]}
        log(f"deterministic algorithms (child process, "
            f"{time.perf_counter() - t:.1f} s): a resume from epoch 1 gives "
            f"{len(tags) - len(unequal)}/{len(tags)} epoch-2 scalars "
            f"bit-equal to the uninterrupted run's")
        check(len(tags) >= 80 and not unequal, f"deterministic resume "
              f"differs: {unequal}")
        check(launches_b == _expected(12, 0, 2 * 12), f"run B launches "
              f"{launches_b}")
        check(worst_loss <= RESUME_LOSS_RTOL, f"run B's losses differ "
              f"from run A's: {worst_loss}")
        check(worst_metric <= RESUME_METRIC_ATOL, f"run B's metrics differ "
              f"from run A's: {worst_metric}")
    finally:
        for k, fn in real.items():
            setattr(train_mod, k, fn)
        shutil.rmtree(root, ignore_errors=True)

    val_first = [ms / n for _, (_, n, first), ms in timed["validate"]
                 if first]
    val_later = [ms / n for _, (_, n, first), ms in timed["validate"]
                 if not first]
    log(f"run A: {wall_a:.1f} s wall; epochs "
        + ", ".join(f"{e}: {v['epoch_seconds']:.2f} s (data "
                    f"{v['data_seconds']:.2f} s)"
                    for e, v in sorted(epochs.items()) if e <= 2)
        + f"; host ms between steps after each epoch's first: mean "
        f"{sum(step_ms) / len(step_ms):.1f} (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}); peak memory {peak_mb:.0f} MiB")
    log("validate ms per scan (run, split, first pass on its loader?): "
        + "; ".join(f"{r} {tag}{' first' if first else ''} {ms / n:.2f}"
                    for r, (tag, n, first), ms in timed["validate"]))
    log(f"checkpoint {ckpt_bytes} bytes; save ms (latest, plus copies to "
        f"best and E<epoch>) "
        + "; ".join(f"{r} {what} {ms:.0f}" for r, what, ms in timed["save"])
        + "; load ms "
        + "; ".join(f"{r} {what} {ms:.0f}" for r, what, ms in timed["load"]))
    log(f"launches: run A {launches_a}")
    return {"launches": launches_a, "epochs": epochs, "step_ms": step_ms,
            "validate_first_ms_per_scan": val_first,
            "validate_ms_per_scan": val_later, "ckpt_bytes": ckpt_bytes,
            "timed": timed, "peak_mb": peak_mb,
            "resume_loss_rel": worst_loss,
            "resume_metric_abs": worst_metric,
            "deterministic_resume_bit_equal": len(tags)}


# the serving topology of geot_tpu's ``serve --fast``
FAST = {"fast_pyramid": 1024, "fast_graph": True}
# launches per fast scan: the true-FPS prefix; the non-prefix rows of the 3
# FeaturePropagation levels, the 2 DGCNN cross-level searches (fast_graph
# drops the 2 fine-level self-searches) and the full-resolution upsample
_PER_FAST_SCAN = {"fps_cluster": 1, "knn_split": 6}
# bfloat16 on the card against the port's CPU bfloat16 forward of the same
# weights and input: bounds fixed from the CPU tests (tests/test_torch_fast.py
# ::test_bfloat16_forward_matches_jax) before the first card run (PERF.md
# §6): argmax agreement >= 0.98, and max |dlogit| at most 2 x the CPU's own
# bfloat16-vs-float32 max |dlogit|
BF16_AGREE = 0.98
BF16_ERR_RATIO = 2.0


def _launch_counts(**per):
    from geot_tpu_torch import ops

    return dict(dict.fromkeys(ops.LAUNCHES, 0), **per)


def phase_fast_serving(scans):
    """The serving topology (``fast_pyramid=1024``, ``fast_graph``) through
    the entry points: ``fps_stratified`` on the card against the CPU,
    ``predict_scan`` in float32 and bfloat16 (latency, idle share, peak
    memory, launches per scan), each forward against the port's CPU
    forward, votes, a two-member ensemble, ``predict_stream`` and one
    request to ``serve --fast`` in a child process."""
    import copy
    import queue
    import threading

    import numpy as np
    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan, pc_norm
    from geot_tpu_torch.data.transforms import build_transforms_from_cfg
    from geot_tpu_torch.engine.predict import (load_model, map_pred_to_fdi,
                                               predict_scan, predict_stream)

    log("phase 9: fast serving (fast_pyramid=1024, fast_graph)")
    small, _ = _synthetic_scan(32, 2000)
    sel = np.random.default_rng(0).choice(2000, 16000, replace=True)
    for label, x in (("a sampled scan", _scan_sample(31)[1]),
                     ("a 2,000-point scan sampled to 16,000",
                      pc_norm(small)[0][sel])):
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))[None]
        got = ops.fps_stratified(xt.cuda(), 16000, 1024).cpu()
        want = ops.fps_stratified(xt, 16000, 1024)
        check(torch.equal(got, want), f"fps_stratified on {label}: card "
              f"differs from CPU at {int((got != want).sum())} places")
        check(torch.equal(got.sort(dim=1).values[0],
                          torch.arange(16000, dtype=torch.int32)),
              f"fps_stratified on {label}: not a permutation")
        log(f"fps_stratified (1,16000)->16000, prefix 1024, on {label}: "
            f"card bit-equal to the CPU, a permutation")

    out = {"launches": _launch_counts()}

    def counted(want, what):
        got = dict(ops.LAUNCHES)
        check(got == want, f"{what}: launches {got}, expected {want}")
        for k in got:
            out["launches"][k] += got[k]

    models = {}
    per_scan = _launch_counts(**_PER_FAST_SCAN)
    for name, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        model = load_model(dict(FLAGSHIP_SEG_ARGS, **FAST, dtype=dtype),
                           seed=0, device="cuda")
        models[name] = model
        predict_scan(model, scans[0], jaw=0)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        lat = []
        for n in range(6):
            pts, jaw = scans[n % len(scans)], n % 2
            ops.reset_launches()
            t = time.perf_counter()
            pred, logits = predict_scan(model, pts, jaw=jaw)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
            counted(per_scan, f"fast {name} scan {n}")
            check(logits.shape == (16000, 17) and logits.dtype ==
                  torch.float32 and bool(torch.isfinite(logits).all()),
                  f"fast {name} scan {n}: logits not finite/shaped")
            check(pred.shape == (len(pts),) and pred.dtype == np.uint8
                  and _fdi_ok(map_pred_to_fdi(pred, jaw), jaw),
                  f"fast {name} scan {n}: bad labels")
        # above what was resident before: the models of earlier phases
        peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
        it = iter(scans * 3)
        wall, busy = _profile(f"fast {name} scan", lambda: predict_scan(
            model, next(it)), 3, top=8)
        out[name] = {"latency_ms": lat, "peak_mb": peak_mb,
                     "profiled_wall_ms_per_scan": wall / 3,
                     "device_busy_ms_per_scan": busy / 3,
                     "idle_share": 1 - busy / wall}
        log(f"fast {name}: 6 scans {', '.join(f'{x:.2f}' for x in lat)} "
            f"ms; peak memory "
            f"{peak_mb:.0f} MiB above the resident {resident / 2 ** 20:.0f} "
            f"MiB; launches per scan {per_scan}")

    # each forward on the card against the port's CPU forward, one input
    pos = torch.from_numpy(_scan_sample(21)[1])[None]
    cls = torch.zeros((1, 1), dtype=torch.long)
    fwd = {}
    with torch.no_grad():
        for name, model in models.items():
            t = time.perf_counter()
            cpu_model = copy.deepcopy(model).cpu()
            fwd[name] = (model({"pos": pos.cuda(), "x": None,
                                "cls": cls.cuda()})[0].cpu(),
                         cpu_model({"pos": pos, "x": None, "cls": cls})[0])
            log(f"fast {name} forward on the CPU: "
                f"{time.perf_counter() - t:.1f} s")
    (a32, b32), (abf, bbf) = fwd["float32"], fwd["bfloat16"]
    p99 = float(b32.abs().flatten().kthvalue(
        int(0.99 * b32.numel())).values)
    diff32 = float((a32 - b32).abs().max())
    agree32 = float((a32.argmax(-1) == b32.argmax(-1)).float().mean())
    diffbf = float((abf - bbf).abs().max())
    agreebf = float((abf.argmax(-1) == bbf.argmax(-1)).float().mean())
    cpu_bf_err = float((bbf - b32).abs().max())
    card_bf_err = float((abf - a32).abs().max())
    log(f"fast float32, card vs CPU: max |dlogit| {diff32:.3e} (logit p99 "
        f"{p99:.3f}: {diff32 / p99:.2e} of it), argmax agreement "
        f"{agree32:.6f}")
    log(f"fast bfloat16, card vs CPU: max |dlogit| {diffbf:.3e}, argmax "
        f"agreement {agreebf:.6f}; bfloat16-vs-float32 max |dlogit| CPU "
        f"{cpu_bf_err:.3e}, card {card_bf_err:.3e}; bound: agreement >= "
        f"{BF16_AGREE}, max |dlogit| <= {BF16_ERR_RATIO} x {cpu_bf_err:.3e}")
    check(diff32 <= 1e-3 * p99 and agree32 >= 0.999,
          "fast float32 forward: card disagrees with the CPU")
    check(agreebf >= BF16_AGREE and diffbf <= BF16_ERR_RATIO * cpu_bf_err,
          "fast bfloat16 forward: card disagrees with the CPU")
    out["card_vs_cpu"] = {"f32_max_abs": diff32, "f32_p99": p99,
                          "f32_agree": agree32, "bf16_max_abs": diffbf,
                          "bf16_agree": agreebf,
                          "bf16_vs_f32_cpu": cpu_bf_err,
                          "bf16_vs_f32_card": card_bf_err}

    # votes, a two-member ensemble and the stream, in float32
    model = models["float32"]
    vote_t = build_transforms_from_cfg(
        "vote", FLAGSHIP_SEMI_CFG["datatransforms"])
    ops.reset_launches()
    t = time.perf_counter()
    pred, _ = predict_scan(model, scans[0], jaw=0, num_votes=2,
                           vote_transform=vote_t)
    torch.cuda.synchronize()
    vote_ms = (time.perf_counter() - t) * 1e3
    counted(_launch_counts(fps_cluster=3, knn_split=3 * 5 + 1), "2 votes")
    check(_fdi_ok(map_pred_to_fdi(pred, 0), 0), "2 votes: bad labels")
    members = (model, load_model(dict(FLAGSHIP_SEG_ARGS, **FAST), seed=1,
                                 device="cuda"))
    ops.reset_launches()
    t = time.perf_counter()
    pred, _ = predict_scan(members, scans[1], jaw=1)
    torch.cuda.synchronize()
    ens_ms = (time.perf_counter() - t) * 1e3
    counted(_launch_counts(fps_cluster=2, knn_split=2 * 5 + 1), "ensemble")
    check(_fdi_ok(map_pred_to_fdi(pred, 1), 1), "ensemble: bad labels")
    items = [(f"scan{n}", scans[n % len(scans)], n % 2) for n in range(4)]
    rng = np.random.default_rng(0)
    expect = [predict_scan(members, p, jaw=j, seed=rng)[0]
              for _, p, j in items]
    list(predict_stream(members, iter(items), seed=0))       # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    streamed = list(predict_stream(members, iter(items), seed=0,
                                   inflight=2))
    stream_s = time.perf_counter() - t
    counted(_launch_counts(fps_cluster=4 * 2, knn_split=4 * (2 * 5 + 1)),
            "stream")
    check([x[0] for x in streamed] == [x[0] for x in items],
          "stream: order")
    for (name, _, got, _), exp in zip(streamed, expect):
        check(np.array_equal(got, exp), f"stream {name}: labels differ "
              f"from predict_scan at {int((got != exp).sum())} points")
    log(f"fast float32: 2 votes {vote_ms:.1f} ms a scan; a two-member "
        f"ensemble {ens_ms:.1f} ms a scan; predict_stream of 4 scans "
        f"through the ensemble {stream_s * 1e3:.1f} ms, labels equal to "
        f"predict_scan in the same draw order")
    out.update(vote_ms=vote_ms, ensemble_ms=ens_ms,
               stream_ms_per_scan=stream_s * 1e3 / 4)

    # one request to the serving CLI with --fast, in a child process
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "geot_tpu_torch.engine.serve", "--fast",
         "--port", "0"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def read():
        for x in proc.stdout:
            lines.put(x)
        lines.put("")                   # the child closed its output

    threading.Thread(target=read, daemon=True).start()
    try:
        line, seen = "", []
        while "serving on" not in line:
            try:
                line = lines.get(timeout=300)
            except queue.Empty:
                line = ""
            seen.append(line)
            check(bool(line), "serve --fast did not start: "
                  + "".join(seen[-20:]))
        base = line.split("serving on ")[1].split()[0]
        buf = io.BytesIO()
        np.save(buf, scans[2])
        req = urllib.request.Request(f"{base}/predict?jaw=lower",
                                     data=buf.getvalue(), method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            d = json.load(r)
        http_ms = (time.perf_counter() - t) * 1e3
        want, _ = predict_scan(model, scans[2], jaw=0)
        same = float(np.mean(np.asarray(d["labels"]) ==
                             np.asarray(map_pred_to_fdi(want, 0))))
        check(d["n_points"] == len(scans[2]) and _fdi_ok(d["labels"], 0)
              and same >= 0.999, f"serve --fast: bad answer (agreement "
              f"with predict_scan {same})")
        log(f"serve --fast (child process): POST /predict {http_ms:.1f} ms "
            f"round trip, labels agree with predict_scan {same:.6f}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    out["http_ms"] = http_ms
    return out


def phase_fast_trainer():
    """``_fast.yaml`` (a student in the serving topology, an exact teacher)
    through ``parse_and_run`` at full width: 1 epoch with validation and
    the test pass, then ``mode=test`` with 2 votes on its best checkpoint;
    ``fps_cluster`` launches counted by (batch, npoint)."""
    import collections
    import importlib
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import ops
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path

    log("phase 10: fast trainer (parse_and_run, _fast.yaml, full width)")
    fps_mod = importlib.import_module("geot_tpu_torch.ops.fps")
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm_fast.yaml")
    root = tempfile.mkdtemp(prefix="geot_fast_trainer_")
    shapes = collections.Counter()
    real = fps_mod.fps_cluster

    def counting(xyz, npoint, plan):
        shapes[f"({xyz.shape[0]},{xyz.shape[1]})->{npoint}"] += 1
        return real(xyz, npoint, plan)

    fps_mod.fps_cluster = counting
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ops.reset_launches()
        t = time.perf_counter()
        res = train_mod.parse_and_run(["--cfg", cfg_path, "epochs=1",
                                       "val_freq=1", f"root_dir={root}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(ops.LAUNCHES)
        shapes_a = dict(shapes)
        peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
        (run_dir,) = [os.path.join(root, "tooth_semi", d)
                      for d in os.listdir(os.path.join(root, "tooth_semi"))]
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            sc = {d["tag"]: d["value"] for d in map(json.loads, f)}
        with open(os.path.join(run_dir, "step_times.jsonl")) as f:
            step_ms = [json.loads(x)["dt"] * 1e3 for x in f]
        for split in ("val", "test"):
            bad = {k: v for k, v in res[split].items()
                   if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
            check(not bad, f"fast run: {split} metrics outside [0, 1]: "
                  f"{bad}")
        check(all(math.isfinite(sc[k]) for k in (
            "train_loss", "train_loss_l", "train_loss_u",
            "insT_threed_loss")), "fast run: a loss is not finite")
        # cm bootstrap 12 batches + 12 steps + val and test 12 batches
        # each: the student (B = 2 or 6, prefix 1024) everywhere, the exact
        # teacher (B = 2, 8192) in the steps; knn_split 5 a fast forward,
        # 7 an exact one, 1 an upsampled scan
        want = _launch_counts(fps_cluster=12 + 2 * 12 + 12 + 12,
                              knn_split=12 * 5 + 12 * (5 + 7)
                              + 2 * 12 * (5 + 2))
        want_shapes = {"(2,16000)->1024": 36, "(6,16000)->1024": 12,
                       "(2,16000)->8192": 12}
        check(launches == want, f"fast run launches {launches}, expected "
              f"{want}")
        check(shapes_a == want_shapes, f"fast run fps_cluster shapes "
              f"{shapes_a}, expected {want_shapes}")

        shapes.clear()
        ops.reset_launches()
        best = ckpt_path(os.path.join(run_dir, "checkpoint"),
                         os.path.basename(run_dir), "best")
        t = time.perf_counter()
        res_t = train_mod.parse_and_run(
            ["--cfg", cfg_path, "mode=test", "num_votes=2",
             f"pretrained_path={best}", f"root_dir={root}"])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t
        launches_t = dict(ops.LAUNCHES)
        want = _launch_counts(fps_cluster=12 * 3,
                              knn_split=12 * (3 * 5 + 2))
        check(launches_t == want, f"mode=test with 2 votes: launches "
              f"{launches_t}, expected {want}")
        check(dict(shapes) == {"(2,16000)->1024": 36},
              f"mode=test fps_cluster shapes {dict(shapes)}")
        bad = {k: v for k, v in res_t["test"].items()
               if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
        check(not bad, f"mode=test with votes: metrics outside [0, 1]: "
              f"{bad}")
    finally:
        fps_mod.fps_cluster = real
        shutil.rmtree(root, ignore_errors=True)
    later = step_ms[1:]
    log(f"fast run: {wall:.1f} s wall; epoch {sc['epoch_seconds']:.2f} s "
        f"(data {sc['data_seconds']:.2f} s); host ms between steps mean "
        f"{sum(later) / len(later):.1f} (min {min(later):.1f}, max "
        f"{max(later):.1f}); peak memory {peak_mb:.0f} MiB above the "
        f"resident {resident / 2 ** 20:.0f} MiB; fps_cluster "
        f"launches by shape {shapes_a}; launches {launches}")
    log(f"mode=test with 2 votes: {test_s:.1f} s; whole miou "
        f"{res_t['test']['whole_miou']:.6f}; launches {launches_t}")
    total = {k: launches[k] + launches_t[k] for k in launches}
    return {"launches": total, "epoch_seconds": sc["epoch_seconds"],
            "data_seconds": sc["data_seconds"], "step_ms": step_ms,
            "fps_cluster_shapes": shapes_a, "peak_mb": peak_mb,
            "wall_s": wall, "test_votes_s": test_s}


# phase 11: the switches of the semi step on top of the flagship, as
# geot_tpu's all-flags runs set them (feat_k 16, the bank at trans_dim and
# 4096 rows); contrast_threshold is lowered where the bank must move, since
# no point of a random-init teacher clears the reference's 0.9
ALL_FLAGS = {"use_feat_loss": True, "feat_k": 16, "use_identity_loss": True,
             "use_contrastive": True, "pseudo_refine": True,
             "filter_outlier": True}
U_NAMES = ("Poly1FocalLoss_U_corr", "Poly1FocalLoss_U", "Weight_CELoss_U",
           "MSE_Loss_U", "Poly1FocalLoss_U_T", "Poly1FocalLoss_U_T_v1",
           "Poly1FocalLoss_U_Cur", "Poly1FocalLoss_U_top2")
# the loss terms of the all-flags step, card against CPU: phase 6's bound;
# the feature-space term against the whole loss (3.3e-5 in float32 at full
# width on an H100 at 700 W, PERF.md section 6)
BRANCH_LOSS_RTOL = 1e-4
BRANCH_FEAT_OF_LOSS = 1e-3
_LOSS_TERMS = ("loss", "sup_loss", "unsup_loss", "feat_loss",
               "identity_loss", "threed_loss", "contrast_loss")


def _state_tensors(state):
    """Every tensor of ``state.state_dict()`` by path, cloned; the
    generator's state apart (a skipped step still draws)."""
    import torch

    out = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif isinstance(v, torch.Tensor) and k != "generator":
                out[prefix + str(k)] = v.detach().clone()
    walk(state.state_dict(), "")
    return out


def _kernels_self_search(bound: Bound):
    """Kernel 2 at the self-search of a whole cloud, (2, 16000) x (2,
    16000), k = 2 (``Poly1FocalLoss_U_top2``): bit-equal to the plain
    version on two sampled scans and on 2,000 distinct points sampled to
    16,000; its split plan; kernel-only, wrapper and plain times."""
    import numpy as np
    import torch

    from geot_tpu_torch import ops

    dev = torch.device("cuda")
    scan = torch.cat([torch.from_numpy(_scan_sample(s)[1])[None]
                      for s in (31, 32)]).to(dev).contiguous()
    rng = np.random.default_rng(5)
    dup = scan[:, torch.from_numpy(rng.integers(0, 2000, 16000)).to(dev)]
    dup = dup.contiguous()
    for label, xyz in (("scans", scan), ("2000 distinct of 16000", dup)):
        d, i = ops.knn_small_k(xyz, xyz, 2)
        d_r, i_r = ops.knn_small_k_ref(xyz, xyz, 2)
        torch.cuda.synchronize()
        check(torch.equal(i, i_r), f"self-search {label}: idx differ from "
              f"knn_small_k_ref at {int((i != i_r).sum())} places")
        check(torch.equal(d, d_r), f"self-search {label}: d2 not bit-equal")
        not_self = int((i[..., 0] != torch.arange(16000, device=dev)).sum())
        log(f"knn_split self-search {label} (2,16000)x(2,16000),k=2: idx "
            f"equal, d2 bit-equal to knn_small_k_ref; column 0 is not the "
            f"query at {not_self} of 32000 rows")
    check(not_self > 0, "the duplicate cloud has no tie at column 0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S, split_len = ops.knn_split_plan(2, 16000, 16000, sms)
    check(S > 1 and (S - 1) * split_len < 16000 <= S * split_len,
          f"split plan ({S}, {split_len}) at Q = N = 16000")
    t = {"ms": graph_ms(lambda: ops.knn_small_k(scan, scan, 2), 20),
         "wrapper_ms": cuda_ms(lambda: ops.knn_small_k(scan, scan, 2), 20),
         "plain_ms": cuda_ms(lambda: ops.knn_small_k_ref(scan, scan, 2), 2)}
    # 8 fp32 operations a pair distance and compare; inputs read once,
    # d2 and idx written once
    b_ms, b_by = bound(8.0 * 2 * 16000 * 16000,
                       2 * (2 * 16000 * 12 + 16000 * 2 * 8))
    log(f"knn_split self-search: {S} splits of {split_len}; kernel "
        f"{t['ms']:.4f} ms (wrapper {t['wrapper_ms']:.4f}), plain "
        f"{t['plain_ms']:.2f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(t, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
                splits=S, split_len=split_len)


def phase_branches(bound: Bound, cm):
    """Every branch of the semi step at full width (2 + 2 + 2 clouds of
    16,000 points): kernel 2 at the self-search shape; one step of the
    flagship, of all flags, of ``threed_anchors=4096`` and of each
    ``criterion_u`` name, timed and counted; the all-flags step on the card
    against the CPU (1 + 1 + 1 clouds, the same contrast draws); a step
    with a NaN skipped whole; the trainer on the flagship YAML with every
    switch of the slice and ``ema_eval``. Returns the kernels' records and
    the launches of the path."""
    import importlib
    import shutil
    import tempfile

    import torch

    from geot_tpu_torch import FLAGSHIP_SEG_ARGS, FLAGSHIP_SEMI_CFG, ops
    from geot_tpu_torch.data.build import (MODEL_KEYS, build_semi_loaders,
                                           semi_keys, semi_pairs, to_device)
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.state import SemiTrainState
    from geot_tpu_torch.engine.steps import make_semi_step

    log("phase 11: the semi-step branches at full width")
    rec = _kernels_self_search(bound)
    knn_mod = importlib.import_module("geot_tpu_torch.ops.knn")
    real_small_k = knn_mod.knn_small_k
    self_searches = []

    def counting(query, support, k):
        if query is support and k == 2:
            self_searches.append(tuple(query.shape))
        return real_small_k(query, support, k)

    dev = torch.device("cuda")
    base = dict(FLAGSHIP_SEMI_CFG, skip_nonfinite_updates=False)
    loaders = build_semi_loaders(base)
    for loader in loaders:
        loader.set_epoch(1)
    pairs = [(to_device(bl, MODEL_KEYS, dev), to_device(bu, semi_keys(bu),
                                                         dev))
             for bl, bu in semi_pairs(*loaders, limit=3)]
    # a per-point score for Poly1FocalLoss_U_Cur
    cur = torch.rand((2, 16000), generator=torch.Generator().manual_seed(9))
    for _, bu in pairs:
        bu["cur"] = cur.to(dev)
    state = SemiTrainState.create(base, seed=0, device=dev)
    state.cm = cm.to(dev)
    lr = 1e-3
    per_step = dict(dict.fromkeys(ops.LAUNCHES, 0), fps_cluster=2,
                    knn_split=14)
    variants = [("flagship", {}),
                ("all flags", dict(ALL_FLAGS, contrast_threshold=0.0)),
                ("threed_anchors=4096", {"threed_anchors": 4096})]
    variants += [(f"criterion_u {n}", {"criterion_u_args": {"NAME": n}})
                 for n in U_NAMES[1:]]
    times, launches = {}, dict.fromkeys(ops.LAUNCHES, 0)
    # every variant starts from the same state
    start = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                 and all(isinstance(t, torch.Tensor) for t in v.values())
                 else v) for k, v in state.state_dict().items()}
    knn_mod.knn_small_k = counting
    try:
        for label, extra in variants:
            state.load_state_dict(start)
            step = make_semi_step(dict(base, **extra))
            step(state, *pairs[0], lr, True)              # warm-up
            torch.cuda.synchronize()
            ms = []
            for bl, bu in pairs[1:]:
                ops.reset_launches()
                n_self = len(self_searches)
                t = time.perf_counter()
                m = step(state, bl, bu, lr, True)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                got = dict(ops.LAUNCHES)
                for k, v in got.items():
                    launches[k] += v
                top2 = label.endswith("top2")
                want = dict(per_step, knn_split=14 + top2)
                check(got == want, f"{label}: launches {got}, expected "
                      f"{want}")
                check(len(self_searches) - n_self == top2,
                      f"{label}: {len(self_searches) - n_self} self-searches")
                terms = {k: float(m[k]) for k in _LOSS_TERMS if k in m}
                check(all(math.isfinite(v) for v in terms.values()),
                      f"{label}: a loss is not finite: {terms}")
            times[label] = ms
            log(f"step {label}: {', '.join(f'{x:.1f}' for x in ms)} ms; "
                + ", ".join(f"{k} {v:.6f}" for k, v in terms.items()))
        rec["launches"] = sum(1 for s in self_searches if s == (2, 16000, 3))
        check(self_searches == [(2, 16000, 3)] * 3,
              f"self-searches {self_searches}, expected 3 at (2, 16000, 3)")
    finally:
        knn_mod.knn_small_k = real_small_k
    flag_ms = sum(times["flagship"]) / 2
    log("step ms against the flagship's " + f"{flag_ms:.1f}: " + "; ".join(
        f"{k} {sum(v) / 2:.1f} ({sum(v) / 2 / flag_ms:.2f}x)"
        for k, v in times.items()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    all_flags = make_semi_step(dict(base, **ALL_FLAGS,
                                    contrast_threshold=0.0))
    all_flags(state, *pairs[1], lr, True)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
    log(f"all-flags step peak memory {peak_mb:.0f} MiB above the resident "
        f"{resident / 2 ** 20:.0f} MiB")
    split = {}
    for label, extra in (("all-flags step", dict(ALL_FLAGS,
                                                 contrast_threshold=0.0)),
                         ("threed_anchors=4096 step",
                          {"threed_anchors": 4096}),
                         ("flagship step", {})):
        step = make_semi_step(dict(base, **extra))
        split[label] = _profile(label, lambda: step(state, *pairs[1], lr,
                                                    True), 1, top=12)

    # card against CPU: one all-flags step from the same seeded state,
    # 1 + 1 + 1 clouds, dropout off, the same contrast draws; in float32,
    # and in float64 (the model and step in float64 around the float32
    # searches), as phase 6
    cfg1 = dict(base, batch_size_l=1, batch_size_u=1, **ALL_FLAGS)
    seg = dict(FLAGSHIP_SEG_ARGS, drop_path_rate=0.0, head_dropout=0.0)
    bl1 = {k: v[:1].cpu() for k, v in pairs[0][0].items()}
    bu1 = {k: v[:1].cpu() for k, v in pairs[0][1].items() if k != "cur"}
    gen = torch.Generator().manual_seed(11)
    draws = (torch.rand((1, 16000), generator=gen),
             torch.randperm(1024, generator=gen))
    th = None
    compare = {}
    for dt in (torch.float32, torch.float64):
        res = {}
        for name in ("cuda", "cpu"):
            st = SemiTrainState.create(cfg1, seg_args=seg, seed=1,
                                       device=name)
            for mod in (st.model, st.teacher, st.t_predictor):
                mod.to(dt)
            st.ema_t, st.cm = st.ema_t.to(dt), cm.to(name, dt)
            st.contrast.queue = st.contrast.queue.to(dt)
            b_l, b_u = ({k: (v.to(name, dt) if v.is_floating_point()
                             else v.to(name)) for k, v in b.items()}
                        for b in (bl1, bu1))
            if th is None:
                # the gate passes the teacher's most confident 2-4 % (some
                # 500 of the cloud's 16,000 points: fewer than the 1,024
                # the loss samples, so its validity mask is live), set in
                # the widest gap between two confidences there, so the
                # CPU's rounding of them passes the same points
                with torch.no_grad():
                    conf = torch.sort(torch.softmax(st.teacher(
                        b_u, if_teacher=True)[0], -1).amax(-1).float()
                        .flatten())[0]
                lo, hi = int(0.96 * conf.numel()), int(0.98 * conf.numel())
                j = lo + int((conf[lo + 1:hi] - conf[lo:hi - 1]).argmax())
                th = float((conf[j] + conf[j + 1]) / 2)
            t = time.perf_counter()
            m = make_semi_step(dict(cfg1, contrast_threshold=th))(
                st, b_l, b_u, lr, True,
                draws={"contrast": tuple(d.to(name) for d in draws)})
            terms = {k: float(m[k]) for k in _LOSS_TERMS}
            res[name] = (terms, int(st.contrast.ptr),
                         st.ema_t.double().cpu())
            log(f"all-flags {str(dt)[6:]} step, 1 + 1 + 1 clouds, on the "
                f"{name}: {time.perf_counter() - t:.1f} s; {terms}; bank "
                f"ptr {res[name][1]}")
        (lg, pg, eg), (lc, pc, ec) = res["cuda"], res["cpu"]
        # the feature-space term sums +1 and -1 weighted distances over
        # 17-channel neighbour sets, which follow the float32 rounding of
        # random init's near-equal softmax rows: it is held within
        # BRANCH_FEAT_OF_LOSS of the whole loss, and the rest of the loss
        # (loss - feat_loss) at the per-term bound
        for d in (lg, lc):
            d["loss_without_feat"] = d["loss"] - d["feat_loss"]
        rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc}
        feat = abs(lg["feat_loss"] - lc["feat_loss"]) / abs(lc["loss"])
        log(f"card vs CPU all-flags {str(dt)[6:]} step: loss terms "
            f"relative " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f"; feat_loss {feat:.2e} of the loss; ptr {pg} and {pc}; "
            f"ema_t max |d| {float((eg - ec).abs().max()):.2e}")
        held = {k: v for k, v in rel.items() if k not in ("loss",
                                                          "feat_loss")}
        check(all(v <= BRANCH_LOSS_RTOL for v in held.values())
              and feat <= BRANCH_FEAT_OF_LOSS,
              f"card vs CPU all-flags {dt} loss terms differ: {rel}; "
              f"feat_loss {feat} of the loss")
        check(pg == pc and 0 < pg < 1024, f"bank ptr {pg} on the card, "
              f"{pc} on the CPU: the same count of valid rows, some but "
              f"not all of the 1,024 sampled")
        # ema_t moves by 1e-3 x class_T, whose filter_outlier anchors
        # (a 0.97 quantile, then an argmax over near-equal softmax rows)
        # follow the forward's rounding: 1e-5, where phase 6 (no filter)
        # holds 1e-6
        check(float((eg - ec).abs().max()) <= 1e-5, "ema_t differs")
        compare[str(dt)[6:]] = dict(rel, feat_of_loss=feat,
                                    ema_t=float((eg - ec).abs().max()))

    # skip_nonfinite_updates: a NaN in the strong view skips the step whole
    guard = dict(base, skip_nonfinite_updates=True, ema_eval=0.99,
                 **ALL_FLAGS, contrast_threshold=0.0)
    gstate = SemiTrainState.create(guard, seed=2, device=dev)
    gstate.cm = cm.to(dev)
    gstep = make_semi_step(guard)
    m = gstep(gstate, *pairs[0], lr, True)
    check(float(m["skipped"]) == 0.0, "a clean step was skipped")
    before = _state_tensors(gstate)
    bl, bu = pairs[1]
    bad = dict(bu, pos_s=bu["pos_s"].clone())
    bad["pos_s"][1, 7, 0] = float("nan")
    m = gstep(gstate, bl, bad, lr, True)
    check(float(m["skipped"]) == 1.0 and float(m["loss"]) == 0.0,
          f"the NaN step: skipped {float(m['skipped'])}, loss "
          f"{float(m['loss'])}")
    after = _state_tensors(gstate)
    unequal = [k for k, v in before.items() if not torch.equal(v, after[k])]
    check(after.keys() == before.keys() and not unequal,
          f"a skipped step changed {unequal[:5]}")
    check(gstate.step == 2, "step counter")
    m = gstep(gstate, *pairs[2], lr, True)
    moved = _state_tensors(gstate)
    changed = {g: sum(1 for k in before if k.startswith(g)
                      and not torch.equal(before[k], moved[k]))
               for g in ("model/", "opt/", "t_opt/", "ema_params/",
                         "ema_t", "contrast/")}
    check(float(m["skipped"]) == 0.0 and all(changed.values()),
          f"the next clean step did not train: {changed}")
    log(f"skip_nonfinite_updates: the NaN step skipped, {len(before)} "
        f"state tensors bit-equal (weights, both AdamW states, BatchNorm "
        f"buffers, ema_t, the bank, the EMA shadow); the next step changed "
        f"{changed}")
    del gstate, before, after, moved

    # the trainer: the flagship YAML with every switch of the slice
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    root = tempfile.mkdtemp(prefix="geot_branches_")
    loads = []
    real_load = train_mod.load_variables

    def recording(path, prefer_ema="auto"):
        loads.append(prefer_ema)
        return real_load(path, prefer_ema)

    train_mod.load_variables = recording
    opts = [f"{k}={v}" for k, v in ALL_FLAGS.items()] + [
        "contrast_threshold=0.0", "threed_anchors=4096", "ema_eval=0.99",
        "skip_nonfinite_updates=True", "epochs=2", "val_freq=1",
        "test_freq=2", f"root_dir={root}"]
    try:
        ops.reset_launches()
        t = time.perf_counter()
        out = train_mod.parse_and_run(["--cfg", cfg_path, *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        trainer_launches = dict(ops.LAUNCHES)
        (run_dir,) = [os.path.join(root, "tooth_semi", d)
                      for d in os.listdir(os.path.join(root, "tooth_semi"))]
        with open(os.path.join(run_dir, "scalars.jsonl")) as f:
            sc = {}
            for d in map(json.loads, f):
                sc.setdefault(d["tag"], []).append(d["value"])
    finally:
        train_mod.load_variables = real_load
        shutil.rmtree(root, ignore_errors=True)
    for split in ("val", "val_raw", "test"):
        bad = {k: v for k, v in out[split].items()
               if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
        check(not bad, f"trainer {split} metrics outside [0, 1]: {bad}")
    for tag in ("manifold_loss_feat", "insT_identity_loss",
                "insT_threed_loss", "contrast_loss", "val_raw_whole_miou"):
        check(tag in sc and all(map(math.isfinite, sc[tag])),
              f"trainer: scalar {tag} missing or not finite")
    check("skipped_steps" not in sc, "trainer skipped steps")
    won = bool(out["best"]["ema_selected"])
    check(loads == [won], f"the test pass loaded {loads}, the best tree was "
          f"{'ema' if won else 'raw'}")
    want = _expected(steps=24, cm_batches=12, eval_batches=5 * 12)
    check(trainer_launches == want, f"trainer launches {trainer_launches}, "
          f"expected {want} (24 steps, 12 cm batches, val + val_raw twice "
          f"and test)")
    for k, v in trainer_launches.items():
        launches[k] += v
    log(f"trainer (every switch, ema_eval=0.99): {wall:.1f} s; epochs "
        + ", ".join(f"{v:.2f} s" for v in sc["epoch_seconds"])
        + f"; val whole miou {out['val']['whole_miou']:.6f} (EMA), val_raw "
        f"{out['val_raw']['whole_miou']:.6f}; best tree "
        f"{'ema' if won else 'raw'} at epoch {out['best']['epoch']}, "
        f"reloaded for the test pass; launches {trainer_launches}")
    return {"self_search": rec, "launches": launches, "step_ms": times,
            "peak_mb": peak_mb, "profile": split, "card_vs_cpu": compare,
            "trainer_s": wall}


def resume_check(root: str) -> int:
    """``--resume-check ROOT`` (phase 8 runs it in a child process with
    ``CUBLAS_WORKSPACE_CONFIG`` set): with deterministic algorithms on, the
    flagship for 2 epochs, then a resume from its epoch-1 checkpoint;
    prints the epoch-2 scalars of both as one ``RESUME_CHECK`` JSON line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from geot_tpu_torch.engine import train as train_mod
    from geot_tpu_torch.engine.checkpoint import ckpt_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cfgs", "tooth_semi",
                            "transformer_finetune_fixmatch_ntm.yaml")
    common = [f"root_dir={root}", "val_freq=1", "test_freq=2", "save_freq=1"]
    train_mod.parse_and_run(["--cfg", cfg_path, "epochs=2", *common])
    run_dir = os.path.join(root, "tooth_semi",
                           os.listdir(os.path.join(root, "tooth_semi"))[0])
    scalars = os.path.join(run_dir, "scalars.jsonl")
    a2, n_lines = _epoch_scalars(scalars)
    e1 = ckpt_path(os.path.join(run_dir, "checkpoint"),
                   os.path.basename(run_dir), "E1")
    train_mod.parse_and_run(["--cfg", cfg_path, "mode=resume",
                             f"pretrained_path={e1}", "epochs=2", *common])
    b2, _ = _epoch_scalars(scalars, skip=n_lines)
    print("RESUME_CHECK " + json.dumps({"a": a2, "b": b2}), flush=True)
    return 0


def main() -> int:
    if "--resume-check" in sys.argv[1:]:
        return resume_check(sys.argv[sys.argv.index("--resume-check") + 1])
    faulthandler.dump_traceback_later(1100, exit=True)
    name, smi, limit_w = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    phase_build()
    recs = phase_kernels(Bound(limit_w))
    scans, results, serving, _, _ = phase_serving()
    phase_http(scans, results)
    train = phase_train()
    trainer = phase_trainer()
    fast = phase_fast_serving(scans)
    fast_trainer = phase_fast_trainer()
    branches = phase_branches(Bound(limit_w), train["state"].cm)
    if "--profile" in sys.argv[1:]:
        phase_profile(scans, train)
    # launches on the main paths: 3 served scans, the train run (2 cm
    # batches + 3 steps), the trainer's run A, the fast scans (12, votes,
    # ensemble, stream), the fast trainer's runs and the branch steps and
    # trainer of phase 11; the first versions of FPS and kNN and the pruned
    # kernels are on no path
    trained = {k: sum(c[k] for c in train["cm_batches"] + train["per_step"])
               for k in serving}
    per_step = train["per_step"][0]
    log(f"launches: serving {serving}, training {trained}, trainer "
        f"{trainer['launches']}, fast serving {fast['launches']}, fast "
        f"trainer {fast_trainer['launches']}, semi-step branches "
        f"{branches['launches']}")

    def entry(name, replaces):
        return {"name": name, "route": "cuda",
                "source": f"geot_tpu_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": (serving[name] + trained[name]
                             + trainer["launches"][name]
                             + fast["launches"][name]
                             + fast_trainer["launches"][name]
                             + branches["launches"][name]),
                "launches_serving_3_scans": serving[name],
                "launches_train_step": per_step[name],
                "launches_trainer_run": trainer["launches"][name],
                "launches_fast_scan": _PER_FAST_SCAN.get(name, 0),
                "launches_fast_serving": fast["launches"][name],
                "launches_fast_trainer": fast_trainer["launches"][name],
                "launches_semi_branches": branches["launches"][name],
                "library_ms": None, **recs[name]}

    kernels = [
        entry("fps_cluster", "geot_tpu/ops/pallas_fps.py:231"),
        entry("fps", "geot_tpu/ops/pallas_fps.py:231"),
        entry("knn_split", "geot_tpu/ops/pallas_knn.py:98"),
        entry("knn_small_k", "geot_tpu/ops/pallas_knn.py:98"),
        entry("fps_bucket", "geot_tpu/ops/pallas_fps.py:181"),
        entry("knn_small_k_pruned", "geot_tpu/ops/pallas_knn_pruned.py:104"),
        # kernel 2 at the self-search of a whole cloud (Poly1FocalLoss_U_top2):
        # launches at that shape in phase 11
        {"name": "knn_split_self_search_2x16000_k2", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_split.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98", "library_ms": None,
         **branches["self_search"]},
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
