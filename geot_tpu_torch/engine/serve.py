"""HTTP serving endpoint over ``predict_scan`` (stdlib ``http.server``),
the counterpart of ``geot_tpu/engine/serve.py:110-330`` for ``.npy``
bodies.

    python -m geot_tpu_torch.engine.serve [--cfg <yaml>] [--fast]
        [--ckpt weights.pt[,more.pt ...]] [--port 8756] [k=v ...]

``--cfg`` takes the model (``model.segmentor_args``) and ``num_points``
from a config, with ``k=v`` overrides (e.g.
``model.segmentor_args.dtype=bfloat16``); without it the flagship is
served. ``--fast`` serves the stratified pyramid (``fast_pyramid=1024``)
with ``fast_graph``. A comma-separated ``--ckpt`` serves the ensemble of
its members.

API:
  GET  /healthz                    -> {"status": "ok", "scans_served": N}
  POST /predict?jaw={lower|upper}  body: .npy bytes of (P, 3) floats
                                   -> {"labels": [...FDI...], "n_points": P,
                                       "jaw": ..., "seconds": t}
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..core.config import FLAGSHIP_SEG_ARGS, EasyConfig
from .predict import load_model, map_pred_to_fdi, predict_scan

# a single oversized POST must not exhaust host memory (a 1M-point f32 .npy
# is 12 MB), and a stalled upload must not pin a worker thread forever
MAX_BODY_BYTES = 64 << 20
READ_TIMEOUT_S = 30.0


class _Service:
    """The model (or the ensemble's members) on its device, and a lock
    serialising scans across HTTP threads."""

    def __init__(self, seg_args: Optional[Dict[str, Any]] = None,
                 ckpt: "str | Sequence[str] | None" = None, seed: int = 0,
                 num_points: int = 16000,
                 device: "str | torch.device" = "cuda", warmup: bool = True):
        self.model = load_model(seg_args, ckpt, seed=seed, device=device)
        self.num_points = num_points
        self._lock = threading.Lock()
        self.scans_served = 0
        if warmup:   # build the kernels and touch every shape once
            pts = np.random.default_rng(0).standard_normal((8192, 3))
            self.predict(pts.astype(np.float32), jaw=0)
            self.scans_served = 0

    def predict(self, points: np.ndarray, jaw: int):
        with self._lock:
            pred, _ = predict_scan(self.model, points, jaw=jaw,
                                   num_points=self.num_points)
            self.scans_served += 1
        return map_pred_to_fdi(pred, jaw)


def _parse_body(body: bytes) -> np.ndarray:
    if body[:6] != b"\x93NUMPY":
        raise ValueError("body must be a .npy array of (P, 3) points")
    pts = np.load(io.BytesIO(body), allow_pickle=False)
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
            if urlparse(self.path).path == "/healthz":
                self._send(200, {"status": "ok",
                                 "scans_served": service.scans_served})
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
            except ValueError as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            t0 = time.perf_counter()
            try:
                labels = service.predict(points, jaw)
            except Exception as e:  # noqa: BLE001 - report, keep serving
                traceback.print_exc()
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"labels": labels, "n_points": len(labels),
                             "jaw": jaw_s,
                             "seconds": round(time.perf_counter() - t0, 4)})

    return Handler


def serve(seg_args: Optional[Dict[str, Any]] = None,
          ckpt: "str | Sequence[str] | None" = None, port: int = 8756,
          host: str = "127.0.0.1", seed: int = 0, num_points: int = 16000,
          device: "str | torch.device" = "cuda",
          warmup: bool = True) -> ThreadingHTTPServer:
    """Build the service and return a started ``ThreadingHTTPServer``
    (the caller owns ``shutdown()``/``server_close()``; port 0 picks a free
    port)."""
    service = _Service(seg_args, ckpt, seed=seed, num_points=num_points,
                       device=device, warmup=warmup)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def serving_args(cfg_path: Optional[str], opts, fast: bool):
    """``(seg_args, num_points)`` of a config file with ``k=v`` overrides
    (the flagship without one); ``fast`` turns on the serving topology as
    ``geot_tpu/engine/serve.py:309-311`` does."""
    cfg = EasyConfig()
    if cfg_path:
        cfg.load(cfg_path, recursive=True)
    else:
        cfg.update({"model": {"segmentor_args": dict(FLAGSHIP_SEG_ARGS)}})
    cfg.update(list(opts))
    if fast:
        cfg.model.segmentor_args.fast_pyramid = 1024
        cfg.model.segmentor_args.fast_graph = True
    return (dict(cfg.model.segmentor_args),
            int(cfg.get("num_points", 16000)))


def main(argv=None):
    parser = argparse.ArgumentParser("GeoT serving endpoint (PyTorch/CUDA)")
    parser.add_argument("--cfg", default=None,
                        help="config whose model and num_points to serve; "
                             "the flagship without one")
    parser.add_argument("--ckpt", default=None,
                        help="state_dict saved with torch.save or a "
                             "checkpoint of the port's trainer; "
                             "comma-separate several for a mean-softmax "
                             "ensemble; seeded random weights without one")
    parser.add_argument("--artifact", default=None,
                        help="an exported forward (not ported)")
    parser.add_argument("--fast", action="store_true",
                        help="stratified-FPS pyramid (fast_pyramid=1024) + "
                             "fast_graph")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--port", type=int, default=8756)
    parser.add_argument("--host", default="127.0.0.1")
    args, opts = parser.parse_known_args(argv)
    if args.artifact:
        raise NotImplementedError(
            "not ported: --artifact (serving an exported forward, "
            "geot_tpu's engine/export.py; it needs the kernels registered "
            "as torch.library custom ops so that torch.export can reach "
            "them)")
    seg_args, num_points = serving_args(args.cfg, opts, args.fast)
    httpd = serve(seg_args, ckpt=args.ckpt, port=args.port, host=args.host,
                  seed=args.seed, num_points=num_points)
    print(f"serving on http://{args.host}:{httpd.server_address[1]}",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
