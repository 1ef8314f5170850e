"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface; the compilers run in parallel. A
library is written to ``<repo>/build/columnflow_torch/`` under a name that
carries the hash of its source and flags, so a changed source is rebuilt and
an unchanged one is loaded as it is. The libraries are loaded with
``ctypes``; ``library()`` returns one object whose attributes are the C
entry points of all of them. Nothing here runs at import time: the CPU
tests import every module and have no ``nvcc``.
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
from types import SimpleNamespace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "columnflow_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags. network_sde.cu rounds every float32 operation as its
# plain PyTorch version does (see its header), so nvcc must not contract
# multiply-adds there.
SOURCE_FLAGS = {"column_step": [], "network_sde": ["-fmad=false"]}

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
# C entry points of each source and their argument types; every one returns
# cudaGetLastError() as an int.
_SIGNATURES = {
    "column_step": {
        "cf_wta_drift": [_I, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P],
        "cf_wta_rollout_fwd": [_I, _I, _F, _F, _F, _F, _F] + [_P] * 9,
        "cf_wta_rollout_bwd": [_I, _I, _F, _F, _F, _F, _F] + [_P] * 11,
        "cf_wta_wbar_reduce": [_I, _P, _P, _P],
    },
    "network_sde": {
        "cf_sde_select": [_I, _I, _I, _I, _P, _P, _I, _I] + [_P] * 10,
        "cf_sde_attempt": [_I, _I, _I, _I, _P, _P, _I] + [_P] * 14,
        "cf_sde_replay_fwd": [_I, _I, _I, _I, _P, _I, _I] + [_P] * 13,
        "cf_sde_replay_bwd": [_I, _I, _I, _I, _P, _I, _I, _I] + [_P] * 16,
    },
}

_lock = threading.Lock()
_lib: SimpleNamespace | None = None
build_log = ""  # nvcc's output (ptxas register and spill report) of the last build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "columnflow_torch/kernels/csrc at first use and "
                           "need the CUDA toolkit")
    return nvcc


def _flags(name: str) -> list[str]:
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def _library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in [source] + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def library() -> SimpleNamespace:
    """The loaded kernels, each library built first if its source changed."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs, logs = [], []
        for name in _SIGNATURES:
            so = _library_path(name)
            if so.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
            jobs.append((so, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for so, tmp, cmd, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode == 0:
                os.replace(tmp, so)  # atomic: concurrent builders agree
            else:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        if failed:
            raise RuntimeError("\n".join(failed))
        build_log = "".join(logs)
        fns = {}
        for name, sigs in _SIGNATURES.items():
            lib = ctypes.CDLL(str(_library_path(name)))
            for fname, argtypes in sigs.items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[fname] = fn
        _lib = SimpleNamespace(**fns)
        return _lib
