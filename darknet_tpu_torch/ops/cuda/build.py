"""Build a CUDA source of `darknet_tpu_torch/csrc` with nvcc into a shared
library with a plain C interface, and load it with ctypes.

The library lands in `darknet_tpu_torch/_build/` (listed in .gitignore),
named by a hash of its source and flags, so an edited source rebuilds and
an unchanged one loads at once.  `build(names)` starts one nvcc per
missing source, all at once.  A missing nvcc raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_loaded: dict = {}
build_log: dict = {}     # name -> {"seconds": float, "ptxas": str, "so": path}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin): the "
                           "CUDA kernels are built from source on first use")
    return nvcc


def _paths(name: str) -> tuple:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(ARCH_FLAGS + FLAGS).encode()).hexdigest()
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(names) -> None:
    """Compile every library of `names` that is not built yet: one nvcc
    per source, all started together."""
    jobs = []
    for name in names:
        src, so = _paths(name)
        if name in _loaded or os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *ARCH_FLAGS, *FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, cmd, tmp, so, time.perf_counter(), proc))
    try:
        for name, cmd, tmp, so, t0, proc in jobs:
            _out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
            os.replace(tmp, so)
            build_log[name] = {"seconds": time.perf_counter() - t0,
                               "ptxas": err, "so": so}
    finally:
        for job in jobs:          # after a failure, stop the other builds
            if job[-1].poll() is None:
                job[-1].kill()
                job[-1].wait()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`."""
    if name in _loaded:
        return _loaded[name]
    build([name])
    so = _paths(name)[1]
    build_log.setdefault(name, {"seconds": 0.0, "ptxas": "", "so": so})
    lib = ctypes.CDLL(so)
    _loaded[name] = lib
    return lib
