"""The port's C++ OBJ parser (``geot_tpu_torch/csrc/obj_loader.cpp``,
built with ``g++`` at first use) against its plain version, the port's
numpy parser, and against ``geot_tpu``'s C++ parser: every case of
``tests/test_obj_fuzz.py``'s corpus, a 150,000-vertex scan, and a
comma-decimal locale where one is installed. Exact equality throughout.
A parser that does not build raises with the compiler's output."""
import locale
import os

import numpy as np
import pytest

from geot_tpu.native import get_lib, obj_loader

from geot_tpu_torch.data import io as tio
from geot_tpu_torch.ops import _build

from test_obj_fuzz import CASES


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_parser_matches_numpy_and_geot_tpu(tmp_path, name):
    body, want = CASES[name]
    path = tmp_path / "scan.obj"
    path.write_bytes(body)
    got = tio.load_obj_vertices(str(path))
    plain = tio.load_obj_vertices_numpy(str(path))
    assert got.dtype == np.float32 and got.shape[1:] == (3,)
    np.testing.assert_array_equal(got, plain)
    if want is not None:
        np.testing.assert_array_equal(
            got, np.asarray(want, np.float32).reshape(-1, 3))
    if get_lib() is None:
        pytest.skip("geot_tpu's native parser does not build here")
    np.testing.assert_array_equal(
        got, obj_loader.load_vertices(str(path)).reshape(-1, 3))


def _big_scan(path, n=150_000):
    """A scan of ``n`` vertices at 9 significant digits (every float32
    written exactly), with normals and faces between them."""
    rng = np.random.default_rng(0)
    verts = (rng.standard_normal((n, 3)) * 25).astype(np.float32)
    lines = []
    for i, (x, y, z) in enumerate(verts):
        lines.append(f"v {x:.9g} {y:.9g} {z:.9g}")
        if i % 5 == 0:
            lines.append("vn 0 0 1")
        if i % 9 == 0:
            lines.append(f"f {i % 97 + 1} {(i + 1) % 97 + 1} {i % 89 + 1}")
    path.write_text("\n".join(lines) + "\n")
    return verts


def test_150k_vertex_round_trip(tmp_path):
    path = tmp_path / "big.obj"
    verts = _big_scan(path)
    got = tio.load_obj_vertices(str(path))
    np.testing.assert_array_equal(got, verts)
    np.testing.assert_array_equal(got, tio.load_obj_vertices_numpy(
        str(path)))


def _just_above_float32_midpoints(n=300):
    """Decimal strings a hair above the midpoint of two float32 neighbours
    whose lower one is even: the nearest double is the midpoint itself, so
    python's float() and the float32 cast (round half to even) give the
    lower float, while rounding the decimal to float32 at once gives the
    upper one."""
    from decimal import Decimal, getcontext

    getcontext().prec = 60
    rng = np.random.default_rng(2)
    lo = rng.uniform(-100, 100, n).astype(np.float32)
    bits = lo.view(np.int32) & ~np.int32(1)          # an even mantissa
    lo = bits.view(np.float32)
    hi = np.nextafter(lo, np.float32(np.inf) * np.sign(lo))
    mid = (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    return [str(Decimal(m) + Decimal(m).copy_abs() * Decimal("1e-25")
                * (1 if m > 0 else -1)) for m in mid.tolist()], lo


def test_decimals_round_through_a_double_as_the_numpy_parser(tmp_path):
    """The native parser rounds each coordinate to a double and then to
    float32, as python's float() and the numpy cast do (strtof's single
    rounding would give the other float at each of these)."""
    strs, lo = _just_above_float32_midpoints()
    path = tmp_path / "mid.obj"
    path.write_text("".join(f"v {a} {a} {a}\n" for a in strs))
    got = tio.load_obj_vertices(str(path))
    np.testing.assert_array_equal(got, tio.load_obj_vertices_numpy(
        str(path)))
    np.testing.assert_array_equal(got[:, 0], lo)


def test_parse_ignores_a_comma_decimal_locale(tmp_path):
    """Under a locale whose decimal point is a comma the parse still reads
    "1.5" as 1.5 (it pins the C locale)."""
    path = tmp_path / "scan.obj"
    path.write_bytes(b"v 1.5 -2.25 3e-2\nv 4,5 5 6\n")
    old = locale.setlocale(locale.LC_NUMERIC)
    for name in ("de_DE.UTF-8", "de_DE.utf8", "de_DE", "fr_FR.UTF-8"):
        try:
            locale.setlocale(locale.LC_NUMERIC, name)
            break
        except locale.Error:
            continue
    else:
        name = None
    try:
        got = tio.load_obj_vertices(str(path))
    finally:
        locale.setlocale(locale.LC_NUMERIC, old)
    np.testing.assert_array_equal(got, np.array([[1.5, -2.25, 0.03]],
                                                np.float32))
    np.testing.assert_array_equal(got, tio.load_obj_vertices_numpy(
        str(path)))
    print(f"locale tried: {name or 'none installed, C only'}")


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tio.load_obj_vertices(str(tmp_path / "absent.obj"))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    """No quiet fallback: a compiler that is missing, or that fails, makes
    the parse raise."""
    path = tmp_path / "scan.obj"
    path.write_bytes(b"v 1 2 3\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_native_lib", None)
    monkeypatch.setattr(_build, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="did not run"):
        tio.load_obj_vertices(str(path))
    bad = tmp_path / "cxx"
    bad.write_text("#!/bin/sh\necho 'obj_loader.cpp: error: boom' >&2\n"
                   "exit 3\n")
    os.chmod(bad, 0o755)
    monkeypatch.setattr(_build, "CXX", str(bad))
    with pytest.raises(RuntimeError, match="boom"):
        tio.load_obj_vertices(str(path))
    assert not list((tmp_path / "build").glob("*.so"))
