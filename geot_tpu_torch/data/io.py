"""Point-cloud file IO (``geot_tpu/data/io.py``), numpy only.

``load_obj_vertices`` reads the ``v`` lines of an OBJ mesh,
``load_labels_json`` a Teeth3DS label file, ``_read_ply_xyz`` the vertex
coordinates of an ascii or binary PLY, and ``IO.get`` dispatches on the
extension. ``geot_tpu``'s C++ OBJ parser is not ported: the numpy parser
below is its fallback and follows the same rules (malformed vertex lines
are skipped, never emitted as zeros).
"""
from __future__ import annotations

import json
import os

import numpy as np


def load_obj_vertices(path: str) -> np.ndarray:
    """The ``v x y z`` lines of an OBJ file -> (N, 3) float32.

    A line starts a vertex when it begins with ``v`` and a space or a tab;
    its first three fields are the coordinates and any further ones (w,
    vertex colours) are ignored. A vertex line with fewer than three
    fields, or with a field that is not a number (``3x``), is skipped."""
    verts = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith(("v ", "v\t")):
                parts = line.split()
                try:
                    verts.append((float(parts[1]), float(parts[2]),
                                  float(parts[3])))
                except (ValueError, IndexError):
                    continue
    return np.asarray(verts, dtype=np.float32).reshape(-1, 3)


def load_labels_json(path: str):
    """A Teeth3DS ground-truth file: ``{"labels": [...], ...}``."""
    with open(path, "r") as f:
        return json.load(f)


class IO:
    """Loader by file extension (``geot_tpu/data/io.py:47``)."""

    @classmethod
    def get(cls, path: str):
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            return load_obj_vertices(path)
        if ext == ".json":
            return load_labels_json(path)
        if ext == ".npy":
            return np.load(path)
        if ext == ".npz":
            return np.load(path)["data"]
        if ext == ".txt":
            return np.loadtxt(path, dtype=np.float32)
        if ext == ".h5":
            import h5py

            with h5py.File(path, "r") as f:
                return f["data"][()]
        if ext == ".ply":
            return _read_ply_xyz(path)
        raise ValueError(f"unsupported extension {ext} ({path})")


# PLY scalar types, both spellings -> numpy type codes
_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_ply_xyz(path: str) -> np.ndarray:
    """The x, y, z properties of a PLY's vertices -> (N, 3) float32; ascii,
    binary little-endian or binary big-endian. List properties (faces) are
    not read."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        fmt = next(h.split()[1] for h in header if h.startswith("format"))
        scalars = [h for h in header
                   if h.startswith("property") and "list" not in h]
        props = [h.split()[-1] for h in scalars]
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n, dtype=np.float64).reshape(n, -1)
        else:
            endian = ">" if "big_endian" in fmt else "<"
            dt = np.dtype([(p, endian + _PLY_TYPES[h.split()[1]])
                           for h, p in zip(scalars, props)])
            rows = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            rows = np.stack([rows[p].astype(np.float64) for p in props], -1)
        cols = [props.index(c) for c in ("x", "y", "z")]
        return rows[:, cols].astype(np.float32)
