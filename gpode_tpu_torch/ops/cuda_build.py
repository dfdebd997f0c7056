"""Build and load the port's CUDA kernels (`gpode_tpu_torch/csrc/*.cu`).

Each source compiles with `nvcc` into a shared library with a plain C
interface, loaded with `ctypes`. Builds run at first use into
`gpode_tpu_torch/_build/` (git-ignored), all sources in parallel; a library
is named by a hash of its sources and flags, so an edited source rebuilds and
an unchanged one loads as it is. Each build also writes its seconds and ptxas
register / spill lines beside the library (`lib<name>-<hash>.json`), so a
reused library still reports them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# One library per source; the header is shared by all of them.
SOURCES = {"fused_rhs": "fused_rhs.cu", "fused_dopri5": "fused_dopri5.cu",
           "fused_rk4": "fused_rk4.cu", "rbf_gram": "rbf_gram.cu",
           "fused_rhs_wide": "fused_rhs_wide.cu"}
HEADERS = ("rhs_tile.cuh",)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float        # nvcc wall time of the build that made `path`
    ptxas: list[str]      # the `-Xptxas -v` register / spill lines
    reused: bool = False  # True when an up-to-date library was loaded as is


_LOCK = threading.Lock()
_BUILT: dict[str, BuildInfo] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(text: str) -> list[str]:
    keep = ("registers", "spill", "Compiling entry", "smem")
    return [ln.strip() for ln in text.splitlines() if any(k in ln for k in keep)]


def build_all() -> dict[str, BuildInfo]:
    """Build every missing or stale library, one `nvcc` per source, all
    started together. Raises with the compiler output on failure."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name, src in SOURCES.items():
            if name in _BUILT:
                continue
            out = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
            log = out.with_suffix(".json")
            if out.exists() and log.exists():
                rec = json.loads(log.read_text())
                _BUILT[name] = BuildInfo(out, rec["seconds"], rec["ptxas"],
                                         reused=True)
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, out, tmp, time.perf_counter())
        for name, (proc, out, tmp, t0) in jobs.items():
            text, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                                   f"(exit {proc.returncode}):\n{text}")
            info = BuildInfo(out, seconds, _ptxas_lines(text))
            out.with_suffix(".json").write_text(json.dumps(
                {"seconds": seconds, "ptxas": info.ptxas}))
            os.replace(tmp, out)
            _BUILT[name] = info
        return dict(_BUILT)


def kernel_resources(name: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of every kernel of library `name`, from the
    `-Xptxas -v` lines of its build: {mangled entry name: {"registers",
    "spill_stores", "spill_loads"}}."""
    out: dict[str, dict[str, int]] = {}
    entry = None
    for line in build_all()[name].ptxas:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[entry]["spill_stores"] = int(m.group(1))
            out[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (built first if needed)."""
    if name not in _LIBS:
        info = build_all()[name]
        _LIBS[name] = ctypes.CDLL(str(info.path))
    return _LIBS[name]
