"""The port's serving path against ``geot_tpu``'s: ``predict_scan`` of the
flagship and of each ``cfgs/tooth_sup`` model, a directory stream of a zoo
model, the full-resolution upsample, the FDI map, and the HTTP endpoint
(OBJ bodies, a failing prediction, ``/metrics``)."""
import io
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geot_tpu.data.tooth_semi import _synthetic_scan
from geot_tpu.engine import eval as jeval
from geot_tpu.engine import predict as jpredict
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu_torch.engine import eval as teval
from geot_tpu_torch.engine import predict as tpredict
from geot_tpu_torch.engine.convert import params_from_jax
from geot_tpu_torch.engine.serve import serve

from test_torch_model import N_POINTS, SMALL_ARGS, jax_small_model, port_model
from test_torch_predict_cli import _jmain, _tmain, jax_variables
from test_torch_zoo_models import CONFIGS, zoo_batches, zoo_cfg


@pytest.fixture(scope="module")
def small():
    jmodel, variables = jax_small_model(seed=5)
    return jmodel, variables, port_model(variables)


def test_predict_scan_matches_jax(small):
    jmodel, variables, tmodel = small
    pts, _ = _synthetic_scan(3, 4000)
    j_pred, j_logits = jpredict.predict_scan(jmodel, variables, pts, jaw=1,
                                             num_points=N_POINTS, seed=0)
    t_pred, t_logits = tpredict.predict_scan(tmodel, pts, jaw=1,
                                             num_points=N_POINTS, seed=0)
    assert t_pred.dtype == np.uint8 and t_pred.shape == (4000,)
    agree = (t_pred == np.asarray(j_pred)).mean()
    print(f"predict_scan label agreement {agree:.6f}")
    assert agree >= 0.999
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """Per ``cfgs/tooth_sup`` config at the small widths: the JAX model,
    its variables and the port's model loaded by ``load_model`` from a
    state_dict file of them."""
    tmp = tmp_path_factory.mktemp("zoo")
    made = {}

    def get(name):
        if name not in made:
            batch = zoo_batches(zoo_cfg("torch", name), n=1)[0]
            jmodel = jbuild(zoo_cfg("jax", name).model)
            variables = jax_variables(jmodel, batch)
            path = str(tmp / f"{name}.pt")
            torch.save(params_from_jax(variables), path)
            made[name] = (jmodel, variables, tpredict.load_model(
                ckpt=path, device="cpu",
                model_cfg=dict(zoo_cfg("torch", name).model)))
        return made[name]

    return get


@pytest.mark.parametrize("name", CONFIGS)
def test_zoo_predict_scan_matches_geot_tpu(zoo, name):
    """``predict_scan`` of each ``cfgs/tooth_sup`` model at the small
    widths, loaded by ``load_model`` from a state_dict file: the labels of
    a 3,000-point scan and the sampled logits against ``geot_tpu``'s
    (logits within 1e-4 of their largest, as the zoo's float32 forward
    tests; labels equal). ``--fast`` on a config without
    ``model.segmentor_args`` raises ``AttributeError`` in both CLIs."""
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan

    jmodel, variables, model = zoo(name)
    pts, _ = _synthetic_scan(50, 3000)
    want, wlog = jpredict.predict_scan(jmodel, variables, pts, jaw=0,
                                       num_points=N_POINTS)
    got, tlog = tpredict.predict_scan(model, pts, jaw=0, num_points=N_POINTS)
    wlog = np.asarray(wlog)
    rel = float(np.abs(tlog.numpy() - wlog).max() / np.abs(wlog).max())
    print(f"{name}: max |dlogit| / max |logit| {rel:.3e}")
    assert rel <= 1e-4
    np.testing.assert_array_equal(got, np.asarray(want))
    if "segmentor_args" not in zoo_cfg("torch", name).model:
        cfg = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "cfgs", "tooth_sup", name)
        for main in (_jmain, _tmain):
            with pytest.raises(AttributeError, match="segmentor_args"):
                main(["--cfg", cfg, "--input", "x.obj", "--fast"])


def test_zoo_directory_stream_where_geot_tpu_raises(zoo):
    """``predict_stream`` of a zoo model (bare logits): the port takes the
    logits through ``_logits_of`` and gives each scan ``predict_scan``'s
    labels in the stream's draw order; ``geot_tpu``'s takes ``[0][0]`` of
    the output, a (C,) row of bare logits, and raises ``ValueError``
    (ROADMAP section 3)."""
    from geot_tpu_torch.data.tooth_semi import _synthetic_scan

    jmodel, variables, model = zoo("pointnet2.yaml")
    scans = [(f"s{i}", _synthetic_scan(80 + i, 1500 + 400 * i)[0], i % 2)
             for i in range(2)]
    with pytest.raises(ValueError, match="Incompatible shapes"):
        list(jpredict.predict_stream(jmodel, variables, iter(scans),
                                     num_points=N_POINTS))
    rng = np.random.default_rng(0)
    for (name_, pts, pred, jaw), (_, p, j) in zip(
            tpredict.predict_stream(model, iter(scans), num_points=N_POINTS),
            scans):
        want, _ = tpredict.predict_scan(model, p, jaw=j, num_points=N_POINTS,
                                        seed=rng)
        np.testing.assert_array_equal(pred, want, err_msg=name_)


def test_upsample_matches_jax():
    rng = np.random.default_rng(0)
    full = rng.standard_normal((3000, 3)).astype(np.float32)
    sel = rng.choice(3000, 256, replace=False)
    pos = full[sel] * 0.5
    center = rng.standard_normal(3).astype(np.float32)
    scale = np.float32(2.0)
    full = full + center
    logits = rng.standard_normal((1, 256, 17)).astype(np.float32)
    want = jeval.get_pred_whole(jnp.asarray(logits), pos[None], [full],
                                [center], [scale], dtype=np.uint8)[0]
    got = teval.get_pred_whole(torch.from_numpy(logits),
                               torch.from_numpy(pos[None]), [full], [center],
                               [scale])[0]
    assert got.dtype == np.uint8
    assert (got == np.asarray(want)).mean() >= 0.999
    np.testing.assert_array_equal(teval.pad_to_bucket(full, 1024),
                                  jeval.pad_to_bucket(full, 1024))


@pytest.mark.parametrize("jaw", [0, 1])
def test_fdi_map_matches_jax(jaw):
    pred = np.arange(17).repeat(3)
    assert tpredict.map_pred_to_fdi(pred, jaw) == \
        jpredict.map_pred_to_fdi(pred, jaw)


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def test_serve_end_to_end_on_cpu(small):
    _, variables, tmodel = small
    httpd = serve(SMALL_ARGS, port=0, num_points=N_POINTS, device="cpu",
                  warmup=False)
    httpd.service.model.load_state_dict(tmodel.state_dict())
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            assert json.load(r) == {"status": "ok", "scans_served": 0}
        pts, _ = _synthetic_scan(4, 3000)
        buf = io.BytesIO()
        np.save(buf, pts)
        d = _post(f"{base}/predict?jaw=upper", buf.getvalue())
        want, _ = tpredict.predict_scan(tmodel, pts, jaw=1,
                                        num_points=N_POINTS)
        assert d["n_points"] == 3000 and d["jaw"] == "upper"
        assert d["labels"] == tpredict.map_pred_to_fdi(want, 1)
        assert all(lab == 0 or 11 <= lab <= 28 for lab in d["labels"])
        for body, path in ((b"v 1 2 3\n", "/predict"),
                           (buf.getvalue(), "/predict?jaw=left")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, body)
            assert e.value.code == 400
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            assert json.load(r)["scans_served"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()


# --- /metrics, OBJ bodies and a failing prediction ---------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def _request_sequence(base, npy, obj, fail):
    """POST a .npy body, an OBJ text body, a malformed OBJ body and a body
    whose prediction raises (``fail`` makes the service's ``predict``
    raise); returns the statuses, the OBJ body's answer and the
    ``/metrics`` text."""
    codes, answers = [], []
    for body, path in ((npy, "/predict?jaw=upper"), (obj, "/predict"),
                       (b"v 1 2 3\nv 4 5 6x\nv 7 8 9\nv 1 1 1\n",
                        "/predict"), (npy, "/predict?jaw=lower")):
        if path.endswith("jaw=lower"):
            fail()
        try:
            answers.append(_post(base + path, body))
            codes.append(200)
        except urllib.error.HTTPError as e:
            answers.append(json.load(e))
            codes.append(e.code)
    status, ctype, text = _get(f"{base}/metrics")
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    return codes, answers, text


def _shape(text):
    """The /metrics lines with the values that measure time blanked: the
    latency buckets, sum and uptime."""
    out = []
    for line in text.splitlines():
        if line.startswith(("geot_request_seconds_bucket",
                            "geot_request_seconds_sum",
                            "geot_uptime_seconds ")):
            line = line.rsplit(" ", 1)[0] + " <t>"
        out.append(line)
    return out


def test_metrics_obj_bodies_and_a_failing_prediction_match_geot_tpu(small):
    """The same requests to both handlers: a .npy and an OBJ body served
    (the OBJ body's labels equal ``predict_scan``'s of its points), a
    malformed OBJ line and a prediction that raises both answered 400 (the
    port answered 500 to the latter before), and ``/metrics`` giving
    ``geot_tpu``'s lines, counts included, up to the latency values."""
    from geot_tpu.core.config import EasyConfig as JEasyConfig
    from geot_tpu.engine.serve import serve as jserve

    _, variables, tmodel = small
    pts, _ = _synthetic_scan(6, 2000)
    buf = io.BytesIO()
    np.save(buf, pts)
    obj = "".join(f"v {x!r} {y!r} {z!r}\nvn 0 0 1\n" for x, y, z in
                  pts.astype(np.float64).tolist()).encode()
    jcfg = JEasyConfig({"model": {"NAME": "WholePartSeg",
                                  "segmentor_args": dict(SMALL_ARGS)},
                        "num_points": N_POINTS})
    texts, codes, answers = {}, {}, {}
    for tag in ("j", "t"):
        httpd = (jserve(jcfg, port=0, warmup=False) if tag == "j" else
                 serve(SMALL_ARGS, port=0, num_points=N_POINTS,
                       device="cpu", warmup=False))
        service = httpd.service
        if tag == "j":
            service.replicas = [(None, variables, service.replicas[0][2])]
        else:
            service.model.load_state_dict(tmodel.state_dict())

        def fail():
            def boom(points, jaw):
                raise RuntimeError("prediction failed")
            service.predict = boom

        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            codes[tag], answers[tag], texts[tag] = _request_sequence(
                base, buf.getvalue(), obj, fail)
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert codes["t"] == codes["j"] == [200, 200, 400, 400]
    assert _shape(texts["t"]) == _shape(texts["j"])
    lines = texts["t"].splitlines()
    for want in ('geot_requests_total{outcome="ok"} 2',
                 'geot_requests_total{outcome="error"} 2',
                 'geot_request_seconds_bucket{le="+Inf"} 2',
                 "geot_request_seconds_count 2",
                 "geot_scans_served_total 2"):
        assert want in lines, want
    want, _ = tpredict.predict_scan(tmodel, pts, jaw=0, num_points=N_POINTS)
    got = answers["t"][1]
    assert got["jaw"] == "lower" and got["n_points"] == 2000
    assert got["labels"] == tpredict.map_pred_to_fdi(want, 0)
    for tag in ("j", "t"):
        assert answers[tag][2]["error"].startswith("ValueError")
        assert answers[tag][3]["error"] == "RuntimeError: prediction failed"
