"""Build and load the port's CUDA kernels.

``csrc/*.cu`` expose ``extern "C"`` launchers and include no PyTorch
header, so ``nvcc`` builds each in seconds: one ``nvcc -c`` per source, all
started together, then one link into a shared library that ``ctypes``
loads. The library's file name carries a hash of the sources and flags, so
a stale build is never loaded; objects go to a directory of the process's
own and the library is renamed into place, so no lock file is ever needed.
The build runs at first use, from the wrapper that first launches a kernel.

``csrc/obj_loader.cpp`` and ``csrc/grid_subsample.cpp`` are host code:
``native_library()`` builds them with
``g++ -O3 -shared -fPIC`` by the same route (hashed name, private object
directory, rename into place), at first use, on any machine with a C++
compiler. A failed build raises with the compiler's output; nothing falls
back to another parser.

Launch counts: each kernel wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "fps.cu", "fps_cluster.cu", "knn_small_k.cu", "knn_split.cu",
    "fps_bucket.cu", "knn_small_k_pruned.cu", "morton.cu"))
BUILD_DIR = _PKG / "_build"
# --fmad=false: the plain versions and the JAX reference round dx*dx,
# dy*dy, dz*dz and each sum separately; a contracted FMA changes d2 in the
# last bit and can flip an FPS argmax or a kNN tie.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NATIVE_SOURCES = (_PKG / "csrc" / "obj_loader.cpp",
                  _PKG / "csrc" / "grid_subsample.cpp")
# the host compiler of ``native_library()``
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# one count per kernel, named after its source in csrc/ (the pruned kNN's
# plan kernel, in knn_small_k_pruned.cu, after its wrapper)
LAUNCHES = {"fps": 0, "fps_cluster": 0, "knn_small_k": 0, "knn_split": 0,
            "fps_bucket": 0, "knn_small_k_pruned": 0, "morton": 0,
            "knn_pruned_prepare": 0}

_lock = threading.Lock()
_lib = None
_native_lib = None
_build_info: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def _hashed_path(stem: str, sources, flags) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    return _hashed_path("libgeot_kernels", SOURCES, NVCC_FLAGS)


def native_library_path() -> Path:
    """Where the host library of ``NATIVE_SOURCES`` lives."""
    return _hashed_path("libgeot_native", NATIVE_SOURCES, (CXX, *CXX_FLAGS))


def build_native() -> dict:
    """Compile the host library if it is not built yet; ``{"path",
    "seconds", "log"}`` as ``build``. Raises ``RuntimeError`` with the
    compiler's output when the compiler is missing or fails."""
    path = native_library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_dir = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp"
    tmp_dir.mkdir(exist_ok=True)
    tmp = tmp_dir / path.name
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), *map(str, NATIVE_SOURCES)]
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except OSError as e:
            raise RuntimeError(f"the host compiler did not run: "
                               f"{' '.join(cmd)}\n{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def native_library() -> ctypes.CDLL:
    """The loaded host library (``obj_count_vertices``,
    ``obj_load_vertices``, ``grid_subsample``), built first if needed."""
    global _native_lib
    with _lock:
        if _native_lib is None:
            lib = ctypes.CDLL(build_native()["path"])
            lib.obj_count_vertices.restype = ctypes.c_long
            lib.obj_count_vertices.argtypes = [ctypes.c_char_p]
            lib.obj_load_vertices.restype = ctypes.c_long
            lib.obj_load_vertices.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long]
            fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
                ctypes.c_int)
            lib.grid_subsample.restype = ctypes.c_long
            lib.grid_subsample.argtypes = [
                fp, ctypes.c_long, ctypes.c_long, fp, ip, ctypes.c_int,
                ctypes.c_float, fp, fp, ip, ctypes.c_long]
            _native_lib = lib
    return _native_lib


def build() -> dict:
    """Compile the library if it is not built yet.

    Returns ``{"path", "seconds", "log"}``: ``seconds`` is 0 and ``log``
    empty when an up-to-date library was already there."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp_dir = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp"
    tmp_dir.mkdir(exist_ok=True)
    tmp = tmp_dir / path.name
    t0 = time.perf_counter()
    log = []
    try:
        objs, procs = [], []
        for src in SOURCES:
            obj = tmp_dir / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(str(obj))
        failed = []
        for cmd, proc in procs:
            out, err = proc.communicate(timeout=600)
            log.append(out + err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "log": "".join(log)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _build_info.update(build())
            lib = ctypes.CDLL(_build_info["path"])
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.geot_fps.argtypes = [p, p, p, i, i, i, p]
            lib.geot_fps.restype = i
            lib.geot_fps_cluster.argtypes = [p, p, i, i, i, i, i, i, p]
            lib.geot_fps_cluster.restype = i
            lib.geot_fps_cluster_max_active.argtypes = [
                i, ctypes.POINTER(ctypes.c_int)]
            lib.geot_fps_cluster_max_active.restype = i
            lib.geot_cluster_exchange.argtypes = [p, i, i, i, p]
            lib.geot_cluster_exchange.restype = i
            lib.geot_knn_small_k.argtypes = [p, p, p, p, i, i, i, i, p]
            lib.geot_knn_small_k.restype = i
            lib.geot_knn_split.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                           i, p]
            lib.geot_knn_split.restype = i
            lib.geot_fps_bucket.argtypes = [p, p, p, p, i, i, i, i, i, p]
            lib.geot_fps_bucket.restype = i
            lib.geot_fps_bucket_max_active.argtypes = [
                i, ctypes.POINTER(ctypes.c_int)]
            lib.geot_fps_bucket_max_active.restype = i
            lib.geot_knn_pruned_prepare.argtypes = [p, p, i, i, p, p, i, i,
                                                    p]
            lib.geot_knn_pruned_prepare.restype = i
            lib.geot_knn_small_k_pruned.argtypes = [p, p, i, p, p, i, i, p,
                                                    p, p, p, p, i, i, i, i,
                                                    p]
            lib.geot_knn_small_k_pruned.restype = i
            lib.geot_morton_codes.argtypes = [p, p, i, p, p, i, i, i, i,
                                              ctypes.c_uint, p]
            lib.geot_morton_codes.restype = i
            _lib = lib
    return _lib


def build_info() -> dict:
    """What ``library()`` built or found: path, seconds and compiler log."""
    library()
    return dict(_build_info)


def check_launch(name: str, rc: int) -> None:
    """Raise on a launcher's CUDA error code, else count the launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1
