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
# Per-source flags. Every source but column_step.cu rounds each float32
# operation as its plain PyTorch version does (see their headers), so nvcc
# must not contract multiply-adds there.
SOURCE_FLAGS = {"column_step": [], "network_sde": ["-fmad=false"],
                "network_ode": ["-fmad=false"], "ode_select_team": ["-fmad=false"],
                "ode_emit_team": ["-fmad=false"], "ode_replay_team": ["-fmad=false"],
                "ode_ksweep_team": ["-fmad=false"], "ode_ksweep2_team": ["-fmad=false"],
                "sde3_replay_team": ["-fmad=false"], "sde3_ksweep_team": ["-fmad=false"],
                "sde2_ksweep_team": ["-fmad=false"],
                "sde_select_team": ["-fmad=false"],
                "xor_ode": ["-fmad=false"],
                "xor_sde": ["-fmad=false"], "hopf_ode": ["-fmad=false"],
                "hopf_outer": ["-fmad=false"]}

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
        "cf_sde_select": [_I, _I, _I, _I, _P, _P, _I, _I, _I, _I] + [_P] * 10,
        "cf_sde_attempt": [_I, _I, _I, _I, _P, _P, _I, _I, _I] + [_P] * 14,
        "cf_sde_replay_fwd": [_I, _I, _I, _I, _P, _I, _I, _I] + [_P] * 12,
        "cf_sde_replay_bwd": [_I, _I, _I, _I, _P, _I, _I, _I, _I] + [_P] * 13,
        "cf_sde2_plan": [_I, _I, _I, _P],
        "cf_sde2_max_clusters": [_I, _I, _I, _I, _P],
        "cf_sde2_fwd_team8": [_I, _I, _I, _I, _P, _I, _I] + [_P] * 14,
        "cf_sde2_bwd_team8": [_I, _I, _I, _I, _P, _I, _I, _I] + [_P] * 17,
        "cf_sde3_fwd": [_I, _I, _I, _I, _P, _I, _I, _I] + [_P] * 12,
        "cf_sde3_bwd": [_I, _I, _I, _I, _P, _I, _I, _I, _I, _I] + [_P] * 15,
        "cf_sde3_fwd_team_team8": [_I, _I, _I, _I, _P, _I, _I, _I] + [_P] * 15,
        "cf_sde3_bwd_emit_team8": [_I, _I, _I, _I, _P, _I, _I, _I, _I] + [_P] * 19,
        "cf_sde3_bwd_team": [_I, _I, _I, _I, _P, _I, _I, _I, _I, _I] + [_P] * 21,
        "cf_sde2_bwd": [_I, _I, _I, _I, _P, _I, _I, _I, _I, _I] + [_P] * 19,
    },
    "network_ode": {
        "cf_ode_replay_fwd": [_I, _I, _I, _I, _P, _I] + [_P] * 10,
        "cf_ode_replay_bwd": [_I, _I, _I, _I, _P, _I] + [_P] * 13,
        "cf_ode_select_team8": [_I, _I, _I, _I, _P, _P, _I, _I] + [_P] * 12,
        "cf_ode_attempt_team8": [_I, _I, _I, _I, _P, _P] + [_P] * 16,
        "cf_ode_replay_bwd_emit_team8": [_I, _I, _I, _I, _P, _I] + [_P] * 15,
        "cf_ode_replay_bwd_emit_split3_team8": [_I, _I, _I, _I, _P, _I] + [_P] * 17,
        "cf_ode_replay_fwd_split2_team8": [_I, _I, _I, _I, _P, _I] + [_P] * 12,
        "cf_ode_replay_fwd_team_team8": [_I, _I, _I, _I, _P, _I] + [_P] * 13,
        "cf_ode_replay_bwd_team": [_I, _I, _I, _I, _P, _I] + [_P] * 19,
        "cf_ode_replay_bwd_split2": [_I, _I, _I, _I, _P, _I] + [_P] * 17,
        "cf_ode_block_bytes": [_I, _I, _I, _I, _P],
    },
    "ode_select_team": {
        "cf_ode_select": [_I, _I, _I, _I, _P, _P, _I, _I, _I] + [_P] * 9,
        "cf_ode_attempt": [_I, _I, _I, _I, _P, _P, _I] + [_P] * 13,
        "cf_ode_team_plan": [_I, _I, _I, _I, _I, _I, _I, _P],
    },
    "ode_replay_team": {
        "cf_ode_replay_fwd_team": [_I, _I, _I, _I, _P, _I, _I, _I] + [_P] * 10,
        "cf_ode_replay_fwd_split2": [_I, _I, _I, _I, _P, _I, _I, _I] + [_P] * 10,
        "cf_ode_replay_max_clusters": [_I, _I, _I, _I, _I, _P],
    },
    "ode_emit_team": {
        "cf_ode_replay_bwd_emit": [_I, _I, _I, _I, _P, _I, _I] + [_P] * 11,
        "cf_ode_replay_bwd_emit_split3": [_I, _I, _I, _I, _P, _I, _I] + [_P] * 11,
    },
    "ode_ksweep_team": {
        "cf_ode_replay_bwd_ksweep": [_I, _I, _I, _I, _P, _I, _I] + [_P] * 13,
    },
    "ode_ksweep2_team": {
        "cf_ode_replay_bwd_split2_ksweep": [_I, _I, _I, _I, _P, _I, _I] + [_P] * 13,
    },
    "sde3_replay_team": {
        "cf_sde3_fwd_team": [_I, _I, _I, _I, _P] + [_I] * 5 + [_P] * 12,
        "cf_sde3_bwd_emit": [_I, _I, _I, _I, _P] + [_I] * 6 + [_P] * 13,
        "cf_sde3_max_clusters": [_I] * 5 + [_P],
    },
    "sde3_ksweep_team": {
        "cf_sde3_bwd_ksweep": [_I, _I, _I, _I, _P] + [_I] * 6 + [_P] * 15,
    },
    "sde2_ksweep_team": {
        "cf_sde2_bwd_ksweep": [_I, _I, _I, _I, _P] + [_I] * 6 + [_P] * 15,
    },
    "sde_select_team": {
        "cf_sde_select_team": [_I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I] + [_P] * 10,
        "cf_sde_attempt_team": [_I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I] + [_P] * 14,
        "cf_sde_select_plan": [_I, _I, _I, _I, _I, _P],
        "cf_sde_select_max_clusters": [_I, _I, _I, _I, _I, _I, _P],
    },
    "xor_ode": {
        "cf_xor_select": [_I, _I, _P, _P, _I, _I] + [_P] * 7,
        "cf_xor_attempt": [_I, _I, _P, _P] + [_P] * 11,
        "cf_xor_replay_fwd": [_I, _I, _P, _I] + [_P] * 8,
        "cf_xor_replay_bwd": [_I, _I, _P, _I] + [_P] * 9,
    },
    "xor_sde": {
        "cf_xor_sde_fwd": [_I, _I, _P, _I, _F] + [_P] * 9,
        "cf_xor_sde_bwd": [_I, _I, _P, _I, _F] + [_P] * 10,
        "cf_xor_sde_select": [_I, _I, _P, _P, _I, _I, _I] + [_P] * 8,
        "cf_xor_sde_attempt": [_I, _I, _P, _P, _I, _I] + [_P] * 12,
        "cf_xor_sde_replay_fwd": [_I, _I, _P, _I, _I] + [_P] * 10,
        "cf_xor_sde_replay_bwd": [_I, _I, _P, _I, _I, _I] + [_P] * 11,
    },
    "hopf_ode": {
        "cf_hopf_select": [_I, _I, _P, _P, _I, _I] + [_P] * 6,
        "cf_hopf_attempt": [_I, _I, _P, _P] + [_P] * 10,
        "cf_hopf_replay_fwd": [_I, _I, _P, _I] + [_P] * 7,
        "cf_hopf_replay_bwd": [_I, _I, _P, _I] + [_P] * 9,
    },
    "hopf_outer": {
        "cf_hopf_replay_bwd_emit": [_I, _I, _P, _I] + [_P] * 8,
        "cf_hopf_wide_select": [_I, _I, _P, _P, _I, _I] + [_P] * 8,
        "cf_hopf_wide_attempt": [_I, _I, _P, _P] + [_P] * 12,
        "cf_hopf_wide_replay_fwd": [_I, _I, _P, _I] + [_P] * 9,
        "cf_hopf_wide_replay_bwd_emit": [_I, _I, _P, _I] + [_P] * 10,
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
