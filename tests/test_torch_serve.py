"""The port's serving path against ``geot_tpu``'s: ``predict_scan``, the
full-resolution upsample, the FDI map, and the HTTP endpoint."""
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geot_tpu.data.tooth_semi import _synthetic_scan
from geot_tpu.engine import eval as jeval
from geot_tpu.engine import predict as jpredict
from geot_tpu_torch.engine import eval as teval
from geot_tpu_torch.engine import predict as tpredict
from geot_tpu_torch.engine.serve import serve

from test_torch_model import N_POINTS, SMALL_ARGS, jax_small_model, port_model


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
