"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, written to ``<repo>/build/columnflow_torch/``
under a name that carries the hash of the sources and flags, so a changed
source is rebuilt and an unchanged one is loaded as it is. The library is
loaded with ``ctypes``. Nothing here runs at import time: the CPU tests
import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "columnflow_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
# C entry points of csrc/column_step.cu and their argument types; every one
# returns cudaGetLastError() as an int.
_SIGNATURES = {
    "cf_wta_drift": [_I, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P],
    "cf_wta_rollout_fwd": [_I, _I, _F, _F, _F, _F, _F] + [_P] * 9,
    "cf_wta_rollout_bwd": [_I, _I, _F, _F, _F, _F, _F] + [_P] * 11,
    "cf_wta_wbar_reduce": [_I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register and spill report) of the last build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "columnflow_torch/kernels/csrc at first use and "
                           "need the CUDA toolkit")
    return nvcc


def _library_path() -> tuple[Path, list[Path]]:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libcolumnflow_torch_{digest.hexdigest()[:16]}.so", sources


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so, sources = _library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                        f"{proc.stdout}\n{proc.stderr}")
                build_log = proc.stdout + proc.stderr
                os.replace(tmp, so)  # atomic: concurrent builders agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
