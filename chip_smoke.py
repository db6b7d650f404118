#!/usr/bin/env python3
"""Drive geot_tpu_torch's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed with the seconds elapsed when it starts:
1. device: the card's name and power limit; TF32 off.
2. build: the CUDA kernels, compiled with nvcc from ``geot_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version at the shapes the
   serving path gives it, plus a case with duplicated points (ties): FPS
   indices and kNN indices equal, kNN squared distances bit-equal. Times
   from CUDA events after a warm-up.
4. serving: the flagship ``WholePartSeg`` at full width with seeded random
   weights serves 3 synthetic scans of 40,000 points through
   ``predict_scan``; the launch counters must show 1 FPS and 8 small-k kNN
   launches per scan. Logits finite, labels FDI codes of the jaw, and the
   card's forward agrees with the same model's CPU forward.
5. http: 3 ``POST /predict`` requests with ``.npy`` bodies through
   ``engine.serve`` on 127.0.0.1.
Then the ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; without a CUDA device it exits 1 at once.

    python3 chip_smoke.py --profile

adds, after phase 4, a ``torch.profiler`` trace of 3 more scans: device
time by kernel and the device's busy share of the wall time.
"""
from __future__ import annotations

import faulthandler
import io
import json
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
    base = pos[:, :3000]
    dup = torch.cat([base, base[:, :1500], base[:, :700]], dim=1).contiguous()

    fps_err = 0
    fps_rec = {}
    for label, xyz, npoint in (("(1,16000,3)->8192", pos, 8192),
                               ("(2,16000,3)->8192", pos2, 8192),
                               ("ties (1,5200,3)->2048", dup, 2048)):
        got = ops.fps(xyz, npoint)
        ref = ops.fps_ref(xyz, npoint)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"fps {label}: indices differ from "
              f"fps_ref at {int((got != ref).sum())} places")
        fps_err = max(fps_err, int((got.long() - ref.long()).abs().max()))
        if label.startswith("(1,"):
            ms = cuda_ms(lambda: ops.fps(xyz, npoint), 10)
            plain_ms = cuda_ms(lambda: ops.fps_ref(xyz, npoint), 1)
            B, N, _ = xyz.shape
            b_ms, b_by = bound(9.0 * B * (npoint - 1) * N,
                               B * N * 12 + B * npoint * 4)
            fps_rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
            log(f"fps {label}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")
        log(f"fps {label}: indices bit-equal")

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
    knn_err = 0.0
    knn_rec = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    t_ops = t_bytes = 0.0
    for label, q, s, k in path_shapes + (("ties", c4096, ties, 4),):
        d, i = ops.knn_small_k(q, s, k)
        d_r, i_r = ops.knn_small_k_ref(q, s, k)
        torch.cuda.synchronize()
        shape = f"({q.shape[1]},{s.shape[1]},{k})"
        check(torch.equal(i, i_r), f"knn {label} {shape}: idx differ at "
              f"{int((i != i_r).sum())} places")
        check(torch.equal(d, d_r), f"knn {label} {shape}: d2 not bit-equal, "
              f"max |diff| {float((d - d_r).abs().max())}")
        knn_err = max(knn_err, float((d - d_r).abs().max()))
        if label == "ties":
            log(f"knn ties {shape}: idx equal, d2 bit-equal")
            continue
        ms = cuda_ms(lambda: ops.knn_small_k(q, s, k), 10)
        plain_ms = cuda_ms(lambda: ops.knn_small_k_ref(q, s, k), 2)
        Q, N = q.shape[1], s.shape[1]
        flops, nbytes = 8.0 * Q * N, (Q + N) * 12 + Q * k * 8
        b_ms, b_by = bound(flops, nbytes)
        t_ops += flops
        t_bytes += nbytes
        knn_rec["ms"] += ms
        knn_rec["plain_ms"] += plain_ms
        knn_rec["bound_ms"] += b_ms
        log(f"knn {label} {shape}: idx equal, d2 bit-equal; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms "
            f"({b_by})")
    knn_rec["bound_by"] = bound(t_ops, t_bytes)[1]
    log(f"knn per scan (8 searches): kernel {knn_rec['ms']:.3f} ms, plain "
        f"{knn_rec['plain_ms']:.2f} ms, bound {knn_rec['bound_ms']:.4f} ms")
    fps_rec["max_abs_err"] = float(fps_err)
    knn_rec["max_abs_err"] = knn_err
    return fps_rec, knn_rec


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
        check(grew == {"fps": 1, "knn_small_k": 8},
              f"scan {n}: kernel launches {grew}, expected 1 fps + 8 knn")
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


def phase_profile(scans):
    """Device time by kernel over 3 scans, and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from geot_tpu_torch.engine.predict import load_model, predict_scan

    log("phase 4b: profile")
    model = load_model(seed=0, device="cuda")
    predict_scan(model, scans[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for pts in scans:
            predict_scan(model, pts)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # kernels only: operator rows repeat the time of the kernels they launch
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    log(f"3 scans: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} %), idle "
        f"{100 * (1 - busy_us / wall_us):.1f} %")
    for e in rows[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  "
            f"{e.key[:90]}")


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


def main() -> int:
    faulthandler.dump_traceback_later(1100, exit=True)
    name, smi, limit_w = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    phase_build()
    fps_rec, knn_rec = phase_kernels(Bound(limit_w))
    scans, results, launches, _, _ = phase_serving()
    if "--profile" in sys.argv[1:]:
        phase_profile(scans)
    phase_http(scans, results)
    kernels = [
        {"name": "fps", "route": "cuda",
         "source": "geot_tpu_torch/csrc/fps.cu",
         "replaces": "geot_tpu/ops/pallas_fps.py:231",
         "launches": launches["fps"], "library_ms": None, **fps_rec},
        {"name": "knn_small_k", "route": "cuda",
         "source": "geot_tpu_torch/csrc/knn_small_k.cu",
         "replaces": "geot_tpu/ops/pallas_knn.py:98",
         "launches": launches["knn_small_k"], "library_ms": None, **knn_rec},
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
