"""HTTP serving endpoint over ``predict_scan`` (stdlib ``http.server``),
the counterpart of ``geot_tpu/engine/serve.py``.

    python -m geot_tpu_torch.engine.serve [--cfg <yaml>] [--fast]
        [--ckpt <file>[,<file> ...]] [--port 8756] [--seed S] [k=v ...]

``--cfg`` takes the model (``model``: ``WholePartSeg``, ``BaseSeg`` or
``PointMLPPartSegmentor``) and ``num_points`` from a config, with ``k=v``
overrides (e.g. ``model.segmentor_args.dtype=bfloat16``); without it the
flagship is served. ``--fast`` serves the stratified pyramid
(``fast_pyramid=1024``) with ``fast_graph``. ``--ckpt`` takes a checkpoint
of the port's trainer, a state_dict file or a reference GeoT ``.pth``
(``predict.read_weights``); a comma-separated list serves the ensemble of
its members.

    python -m geot_tpu_torch.engine.serve --artifact model.pt2 [--port P]

``--artifact`` serves a forward exported by ``engine.export`` (weights,
point count and serving topology baked in): no model code and no config,
so it conflicts with ``--cfg``, ``--ckpt``, ``--fast`` and overrides, as in
``geot_tpu``. With more than one local card (and no ``--artifact``),
requests round-robin over one replica per card, each behind its own lock
(``geot_tpu/engine/serve.py:134-145``).

API:
  GET  /healthz                    -> {"status": "ok", "scans_served": N}
  GET  /metrics                    -> Prometheus text: requests by outcome,
                                      served-request latency histogram,
                                      scans served, uptime
  POST /predict?jaw={lower|upper}  body: .npy bytes of (P, 3) floats, or
                                   OBJ text (its ``v x y z`` lines)
                                   -> {"labels": [...FDI...], "n_points": P,
                                       "jaw": ..., "seconds": t}
A body that does not parse, a bad ``jaw`` and a prediction that raises are
all answered 400 and counted as ``outcome="error"``, as in ``geot_tpu``.
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..core.config import FLAGSHIP_SEG_ARGS, EasyConfig
from .predict import load_model, local_devices, map_pred_to_fdi, \
    predict_scan

# a single oversized POST must not exhaust host memory (a 1M-point f32 .npy
# is 12 MB), and a stalled upload must not pin a worker thread forever
MAX_BODY_BYTES = 64 << 20
READ_TIMEOUT_S = 30.0


class _Metrics:
    """Request counts by outcome and a latency histogram of the served
    requests, behind their own lock so that a scrape never waits for a
    scan (``geot_tpu/engine/serve.py:56-107``, the same metric names,
    buckets and order)."""

    BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._outcomes = {"ok": 0, "error": 0}
        self._bucket_counts = [0] * (len(self.BUCKETS) + 1)  # +Inf last
        self._lat_sum = 0.0
        self._lat_count = 0

    def observe(self, seconds: float, ok: bool):
        with self._lock:
            self._outcomes["ok" if ok else "error"] += 1
            if ok:   # latency only of served predictions
                i = 0
                while i < len(self.BUCKETS) and seconds > self.BUCKETS[i]:
                    i += 1
                self._bucket_counts[i] += 1
                self._lat_sum += seconds
                self._lat_count += 1

    def render(self, scans_served: int) -> str:
        with self._lock:
            lines = [
                "# HELP geot_requests_total predict requests by outcome",
                "# TYPE geot_requests_total counter",
                *(f'geot_requests_total{{outcome="{k}"}} {v}'
                  for k, v in self._outcomes.items()),
                "# HELP geot_request_seconds served-prediction latency",
                "# TYPE geot_request_seconds histogram",
            ]
            cum = 0
            for le, n in zip((*self.BUCKETS, "+Inf"), self._bucket_counts):
                cum += n
                lines.append(f'geot_request_seconds_bucket{{le="{le}"}} {cum}')
            lines += [
                f"geot_request_seconds_sum {self._lat_sum:.6f}",
                f"geot_request_seconds_count {self._lat_count}",
                "# HELP geot_scans_served_total scans run on the device "
                "(includes warmup-excluded resets)",
                "# TYPE geot_scans_served_total counter",
                f"geot_scans_served_total {scans_served}",
                "# HELP geot_uptime_seconds process uptime",
                "# TYPE geot_uptime_seconds gauge",
                f"geot_uptime_seconds {time.time() - self._t0:.3f}",
            ]
            return "\n".join(lines) + "\n"


class _ArtifactModel(torch.nn.Module):
    """An exported forward (``engine.export``) in the shape ``predict_scan``
    calls: ``model(batch)`` gives the logits of ``batch["pos"]`` and
    ``batch["cls"]``; its parameters are the artifact's, on its device."""

    def __init__(self, exported):
        super().__init__()
        self.fn = exported.module()

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.fn(batch["pos"], batch["cls"])


def _artifact_model(artifact: str):
    """``(model, num_points)`` of an artifact that serves one scan a
    request: its inputs must be ``(pos (1, N, 3), cls (1, 1))``."""
    from .export import input_specs, load_exported

    exported = load_exported(artifact)
    specs = [shape for shape, _ in input_specs(exported)]
    if (len(specs) != 2 or len(specs[0]) != 3 or specs[0][-1] != 3
            or specs[0][0] != 1 or specs[1] != (1, 1)):
        raise ValueError(
            f"artifact {artifact} must be an embed_params export with "
            f"(pos (1,N,3), cls (1,1)) inputs (the endpoint serves one scan "
            f"per request); got input specs {specs} - re-export with "
            f"export_forward(..., embed_params=True, batch=1)")
    return _ArtifactModel(exported), int(specs[0][1])


class _Service:
    """The model (or the ensemble's members) on each device, one lock per
    replica serialising its scans across HTTP threads, and the request
    metrics. Requests round-robin over the replicas."""

    def __init__(self, seg_args: Optional[Dict[str, Any]] = None,
                 ckpt: "str | Sequence[str] | None" = None, seed: int = 0,
                 num_points: int = 16000,
                 device: "str | torch.device" = "cuda", warmup: bool = True,
                 model_cfg: Optional[Dict[str, Any]] = None,
                 artifact: Optional[str] = None,
                 devices: Optional[Sequence] = None):
        if artifact is not None:
            # the artifact holds the weights and the point count; it stays
            # on the device it was exported for, as one replica
            model, self.num_points = _artifact_model(artifact)
            self.replicas = [(model, threading.Lock())]
        else:
            self.num_points = num_points
            self.replicas = [
                (load_model(seg_args, ckpt, seed=seed, device=d,
                            model_cfg=model_cfg), threading.Lock())
                for d in (devices or local_devices(device))]
        self._rr = 0
        self._rr_lock = threading.Lock()
        self.metrics = _Metrics()
        self.scans_served = 0
        if warmup:   # build the kernels and touch every shape, each replica
            pts = np.random.default_rng(0).standard_normal((8192, 3))
            for _ in self.replicas:
                self.predict(pts.astype(np.float32), jaw=0)
            self.scans_served = 0

    @property
    def model(self):
        """The first replica's model."""
        return self.replicas[0][0]

    def predict(self, points: np.ndarray, jaw: int):
        with self._rr_lock:
            i = self._rr
            self._rr += 1
        model, lock = self.replicas[i % len(self.replicas)]
        with lock:
            pred, _ = predict_scan(model, points, jaw=jaw,
                                   num_points=self.num_points)
        with self._rr_lock:
            self.scans_served += 1
        return map_pred_to_fdi(pred, jaw)


def _parse_body(body: bytes) -> np.ndarray:
    """(P, 3) float32 points of a ``.npy`` body or of OBJ text: its lines
    that start with ``v `` (``geot_tpu/engine/serve.py:173-185``); a
    malformed vertex line raises ``ValueError``, unlike the file parser,
    which skips it."""
    if body[:6] == b"\x93NUMPY":
        pts = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        pts = np.array([[float(t) for t in line.split()[1:4]]
                        for line in body.decode().splitlines()
                        if line.startswith("v ")], dtype=np.float32)
    pts = np.asarray(pts, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3 or len(pts) < 4:
        raise ValueError(f"expected (P>=4, 3) points, got {pts.shape}")
    if not np.isfinite(pts).all():
        raise ValueError("points must be finite")
    return pts


def make_handler(service: _Service):
    class Handler(BaseHTTPRequestHandler):
        timeout = READ_TIMEOUT_S

        def log_message(self, *a):
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send(200, {"status": "ok",
                                 "scans_served": service.scans_served})
            elif path == "/metrics":
                body = service.metrics.render(service.scans_served).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            cl = self.headers.get("Content-Length")
            if cl is None:
                self._send(411, {"error": "Content-Length required"})
                return
            try:
                length = int(cl)
            except ValueError:
                length = -1
            if length < 0:
                self._send(400, {"error": f"bad Content-Length: {cl!r}"})
                return
            if length > MAX_BODY_BYTES:
                self._send(413, {"error": f"body {length} bytes exceeds "
                                          f"limit {MAX_BODY_BYTES}"})
                return
            try:
                jaw_s = parse_qs(url.query).get("jaw", ["lower"])[0]
                if jaw_s not in ("lower", "upper"):
                    raise ValueError(f"jaw must be lower|upper, got {jaw_s!r}")
                jaw = 0 if jaw_s == "lower" else 1
                body = self.rfile.read(length)
                if len(body) != length:
                    raise ValueError(
                        f"truncated body: got {len(body)} of {length} bytes")
                points = _parse_body(body)
                t0 = time.perf_counter()
                labels = service.predict(points, jaw)
                dt = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - report, keep serving
                service.metrics.observe(0.0, ok=False)
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            service.metrics.observe(dt, ok=True)
            self._send(200, {"labels": labels, "n_points": len(labels),
                             "jaw": jaw_s, "seconds": round(dt, 4)})

    return Handler


def serve(seg_args: Optional[Dict[str, Any]] = None,
          ckpt: "str | Sequence[str] | None" = None, port: int = 8756,
          host: str = "127.0.0.1", seed: int = 0, num_points: int = 16000,
          device: "str | torch.device" = "cuda", warmup: bool = True,
          model_cfg: Optional[Dict[str, Any]] = None,
          artifact: Optional[str] = None,
          devices: Optional[Sequence] = None) -> ThreadingHTTPServer:
    """Build the service of ``model_cfg`` (a config's ``model``; without
    it a ``WholePartSeg`` of ``seg_args``, by default the flagship), or of
    an exported ``artifact``, and return a started ``ThreadingHTTPServer``
    (the caller owns ``shutdown()``/``server_close()``; port 0 picks a
    free port). ``devices`` lists the devices of the replicas (default:
    ``local_devices(device)``)."""
    service = _Service(seg_args, ckpt, seed=seed, num_points=num_points,
                       device=device, warmup=warmup, model_cfg=model_cfg,
                       artifact=artifact, devices=devices)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def serving_args(cfg_path: Optional[str], opts, fast: bool):
    """``(model_cfg, num_points)`` of a config file with ``k=v`` overrides
    (the flagship ``WholePartSeg`` without one); ``fast`` turns on the
    serving topology as ``geot_tpu/engine/serve.py:309-311`` does (a config
    without ``model.segmentor_args`` raises ``AttributeError`` there and
    here)."""
    cfg = EasyConfig()
    if cfg_path:
        cfg.load(cfg_path, recursive=True)
    else:
        cfg.update({"model": {"NAME": "WholePartSeg",
                              "segmentor_args": dict(FLAGSHIP_SEG_ARGS)}})
    cfg.update(list(opts))
    if fast:
        cfg.model.segmentor_args.fast_pyramid = 1024
        cfg.model.segmentor_args.fast_graph = True
    return dict(cfg.model), int(cfg.get("num_points", 16000))


def main(argv=None):
    parser = argparse.ArgumentParser("GeoT serving endpoint (PyTorch/CUDA)")
    parser.add_argument("--cfg", default=None,
                        help="config whose model and num_points to serve; "
                             "the flagship without one")
    parser.add_argument("--ckpt", default=None,
                        help="a checkpoint of the port's trainer, a "
                             "state_dict file or a reference GeoT .pth; "
                             "comma-separate several for a mean-softmax "
                             "ensemble; seeded random weights without one")
    parser.add_argument("--artifact", default=None,
                        help="serve a forward exported by engine.export; "
                             "no model code or config")
    parser.add_argument("--fast", action="store_true",
                        help="stratified-FPS pyramid (fast_pyramid=1024) + "
                             "fast_graph")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--port", type=int, default=8756)
    parser.add_argument("--host", default="127.0.0.1")
    args, opts = parser.parse_known_args(argv)
    if args.artifact and (args.ckpt or args.fast or args.cfg or opts):
        # the artifact bakes weights, shapes and serving mode at export
        parser.error("--artifact conflicts with --cfg/--ckpt/--fast/"
                     "overrides: those choices were baked in at export; "
                     "re-export to change them")
    if args.artifact:
        httpd = serve(port=args.port, host=args.host,
                      artifact=args.artifact)
    else:
        model_cfg, num_points = serving_args(args.cfg, opts, args.fast)
        httpd = serve(model_cfg=model_cfg, ckpt=args.ckpt, port=args.port,
                      host=args.host, seed=args.seed,
                      num_points=num_points)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(POST /predict, GET /healthz, GET /metrics)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
