"""ctypes bindings to the native host library (`native/host_lib.cpp`).

Counterpart of `gpode_tpu/utils/native.py`: host-side k-means for the
inducing-point initialization and adaptive Dormand-Prince 5(4) integration
for the dataset simulators. The same three C entry points, the same Python
functions, arguments, dtypes and errors.

The port builds its own copy of the library: `native/host_lib.cpp` (read,
never written) compiles with `g++` and exactly the flags of
`native/Makefile` into `gpode_tpu_torch/_build/` (git-ignored) at first use,
under an exclusive `fcntl` lock, into a temporary file renamed into place.
The file name carries a hash of the source, the flags and the target that
`-march=native` resolves to on this host, so an edited source or another
CPU rebuilds and an unchanged one loads as it is.

The branch rule is the JAX package's: the callers take the library where it
loads and scipy where it does not (`available()`); the first call logs which
branch this process took, and why when it is scipy.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "host_lib.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile: CXXFLAGS, then -shared
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

RHS_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_double,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.c_void_p)

SYSTEM_IDS = {"vdp": 0, "fhn": 1}

_logger = logging.getLogger(__name__)
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
# how the library was had: {"path", "seconds" (of the g++ run), "reused"},
# or {"reason"} when the scipy branch was taken
_info: dict = {}


def _target_key(cxx: str) -> str:
    """What `-march=native` resolves to here (the driver line of a dry
    run), so a library built for another CPU is never loaded."""
    proc = subprocess.run([cxx, "-march=native", "-###", "-E", "-x", "c++",
                           os.devnull], capture_output=True, text=True,
                          timeout=60)
    return " ".join(ln for ln in proc.stderr.splitlines() if "cc1" in ln)


def _library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_target_key(cxx).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgpode_host-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library's path, built first under the lock if missing."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    out = _library_path(cxx)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libgpode_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        record = out.with_suffix(".json")
        if out.exists() and record.exists():
            _info.update(json.loads(record.read_text()), reused=True)
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        record.write_text(json.dumps({"seconds": seconds}))
        _info.update(seconds=seconds, reused=False)
        return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gpode_kmeans.restype = ctypes.c_int
    lib.gpode_kmeans.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float)]
    lib.gpode_integrate.restype = ctypes.c_int
    lib.gpode_integrate.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
    lib.gpode_integrate_cb.restype = ctypes.c_int
    lib.gpode_integrate_cb.argtypes = [
        RHS_CALLBACK, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        path = _build()
        _lib = _bind(ctypes.CDLL(str(path)))
        _info["path"] = str(path)
        _logger.info("native host library: %s (%s)", path,
                     "reused" if _info.get("reused") else
                     f"built in {_info['seconds']:.2f} s")
    except Exception as exc:  # the JAX package's rule: scipy where it fails
        _load_failed = True
        _info["reason"] = f"{type(exc).__name__}: {exc}"
        _logger.warning("native host library unavailable (%s): k-means and "
                        "the simulators take scipy", _info["reason"])
    return _lib


def available() -> bool:
    return _load() is not None


def info() -> dict:
    """{"branch": "native" or "scipy"} and how: the library's "path", the
    "seconds" of its g++ build and whether it was "reused", or the
    "reason" the scipy branch was taken."""
    return {"branch": "native" if available() else "scipy", **_info}


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    return lib


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def kmeans(data: np.ndarray, k: int, max_iters: int = 100,
           seed: int = 0) -> np.ndarray:
    """Cluster (n, d) float data into k centers (native Lloyd's algorithm):
    (k, d) float32."""
    lib = _require()
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, d = data.shape
    centers = np.empty((k, d), dtype=np.float32)
    rc = lib.gpode_kmeans(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d, k,
        max_iters, seed, centers.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc < 0:
        raise ValueError(f"gpode_kmeans failed (rc={rc}); need n >= k")
    return centers


def integrate(system: str, x0: np.ndarray, ts: np.ndarray,
              params=(), rtol: float = 1e-10, atol: float = 1e-10) -> np.ndarray:
    """Integrate a built-in system ('vdp' with its mu, 'fhn') from x0 (dim,)
    at times ts: (T, dim) float64."""
    lib = _require()
    x0 = np.ascontiguousarray(x0, dtype=np.float64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    params_arr = np.ascontiguousarray(list(params) or [0.0], dtype=np.float64)
    out = np.empty((ts.shape[0], x0.shape[0]), dtype=np.float64)
    rc = lib.gpode_integrate(SYSTEM_IDS[system], _f64(params_arr), _f64(x0),
                             x0.shape[0], _f64(ts), ts.shape[0], rtol, atol,
                             _f64(out))
    if rc != 0:
        raise RuntimeError(f"gpode_integrate failed (rc={rc})")
    return out


def integrate_callback(f, x0: np.ndarray, ts: np.ndarray,
                       rtol: float = 1e-10, atol: float = 1e-10) -> np.ndarray:
    """Integrate dy/dt = f(t, y) for a Python callable f returning (dim,):
    (T, dim) float64."""
    lib = _require()
    x0 = np.ascontiguousarray(x0, dtype=np.float64)
    dim = x0.shape[0]

    @RHS_CALLBACK
    def cb(t, y_ptr, dy_ptr, _ctx):
        y = np.ctypeslib.as_array(y_ptr, shape=(dim,))
        dy = np.asarray(f(t, y), dtype=np.float64)
        for j in range(dim):
            dy_ptr[j] = dy[j]

    ts = np.ascontiguousarray(ts, dtype=np.float64)
    out = np.empty((ts.shape[0], dim), dtype=np.float64)
    rc = lib.gpode_integrate_cb(cb, None, _f64(x0), dim, _f64(ts),
                                ts.shape[0], rtol, atol, _f64(out))
    if rc != 0:
        raise RuntimeError(f"gpode_integrate_cb failed (rc={rc})")
    return out
