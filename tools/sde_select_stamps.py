"""Where an attempt of the SDE selection team goes, phase by phase, on the card.

Builds a copy of ``columnflow_torch/kernels/csrc/sde_select_team.cu`` with
``clock64()`` stamps of thread 0 of block 0 (rank 0 of lane 0's cluster)
around each phase of an attempt (the Brownian data; per drift the rates,
stimulus and the exchange of the own rows, the cluster barrier, the
products, the block barrier and owner tail; the error norm; the elementwise
stages between drifts; the loop's control), runs the selection over 100
grid points at 104 and 13 columns (4 lanes; select16 on both trees, f32 on
the jax.random tree, the three-term split on the krng tree) through the
stamped copy, and prints one JSON line: us per attempt by phase, with the
clock rate inferred from the stamps' total over the call's CUDA-event time.

    python3 tools/sde_select_stamps.py

The copy and its library go under ``build/stamp/``; the package's own
kernels are built as usual (``kernels/_build.py``). Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PHASES = ("noise", "rates_stimulus_exchange", "cluster_barrier", "products",
          "block_barrier_owner_tail", "error_norm", None, "loop_control", "elementwise")
STAMPS = '''
__device__ unsigned long long g_st[16];
__device__ long long g_last;
#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { long long now_ = clock64(); \\
  g_st[i] += (unsigned long long)(now_ - g_last); g_last = now_; } } while (0)
'''
# (anchor in the source, its stamped replacement)
EDITS = (
    ("namespace cgo = cooperative_groups;", "namespace cgo = cooperative_groups;\n" + STAMPS),
    ("  sel_init<kMode>(T, smt, n, C, kStream, b, wpk, iw);",
     "  sel_init<kMode>(T, smt, n, C, kStream, b, wpk, iw);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_last = clock64();"),
    ("  draw_noise<kTree>(sel, kw, t, tm, te, T.scal, T.zb);",
     "  STAMP(7);\n  draw_noise<kTree>(sel, kw, t, tm, te, T.scal, T.zb);\n  STAMP(0);"),
    ("  const bool own = threadIdx.x < nc;\n  float fr = 0.0f;",
     "  STAMP(8);\n  const bool own = threadIdx.x < nc;\n  float fr = 0.0f;"),
    ("  cl.sync();\n  sel_products<kMode, kStream>(T, P, X);\n  __syncthreads();",
     "  STAMP(1);\n  cl.sync();\n  STAMP(2);\n  sel_products<kMode, kStream>(T, P, X);\n"
     "  STAMP(3);\n  __syncthreads();"),
    ("    out[0] = out[1] = out[2] = 0.0f;\n  }\n  T.par ^= 1;",
     "    out[0] = out[1] = out[2] = 0.0f;\n  }\n  __syncthreads();\n  STAMP(4);\n  T.par ^= 1;"),
    ("  const float mean = (float)sel_sum(T, acc) / (float)S;",
     "  STAMP(8);\n  const float mean = (float)sel_sum(T, acc) / (float)S;\n  STAMP(5);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_st[15] += 1;"),
)
READ = '''
extern "C" int cf_stamps(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_st, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_st, sizeof(unsigned long long) * 16);
}
'''


def stamped_library(build):
    """Build the stamped copy with the package's flags; its ctypes handle."""
    csrc = REPO / "columnflow_torch" / "kernels" / "csrc"
    src = (csrc / "sde_select_team.cu").read_text()
    for anchor, new in EDITS:
        if anchor not in src:
            raise RuntimeError(f"stamp anchor not found: {anchor!r}")
        src = src.replace(anchor, new)
    out = REPO / "build" / "stamp"
    out.mkdir(parents=True, exist_ok=True)
    (out / "sde_select_stamped.cu").write_text(src + READ)
    cmd = [build._nvcc(), *build._flags("sde_select_team"), "-I", str(csrc), "-o",
           str(out / "libsde_select_stamped.so"), str(out / "sde_select_stamped.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "libsde_select_stamped.so"))
    lib.cf_sde_select_team.argtypes = build._SIGNATURES["sde_select_team"]["cf_sde_select_team"]
    lib.cf_sde_select_team.restype = ctypes.c_int
    lib.cf_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cf_stamps.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sde_select_stamps: no CUDA device", file=sys.stderr)
        return 2
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.models.network import premix_select16
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.tasks import parity

    dev = torch.device("cuda")
    real = _build.library()
    slib = stamped_library(_build)
    ns._lib = lambda: SimpleNamespace(**{**vars(real),
                                         "cf_sde_select_team": slib.cf_sde_select_team})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    result = {"card": smi, "T": 100, "lanes": 4}
    for cpa in ((64, 32, 8), (8, 4, 1)):
        gen = torch.Generator(device=dev).manual_seed(16)
        task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=4, time_steps=100,
                                 max_steps=4096, device=dev)
        model = parity.sde_model(task.params, task, make_parity_batch(gen, 4, 4, device=dev))
        pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
        ws = {"select16": premix_select16(pw), "f32": pw,
              "split3": ns.select_weights_split3(pw, model.sc)}
        keys = torch.randint(0, 2**32, (4, 2), generator=gen, device=dev, dtype=torch.int64)
        y0 = torch.zeros(4, 3 * task.net.num_pops, device=dev)
        for drift, tree in (("select16", "jax"), ("select16", "kernel"), ("f32", "jax"),
                            ("split3", "kernel")):
            scfg = sa.select_config(task.ts, max_steps=4096, brownian=tree, drift=drift)
            words = sa._sde_key_words(keys, tree)

            def run():
                return ns.select_pass(y0, words, ws[drift], model.sc, model.kv, scfg)

            run()
            torch.cuda.synchronize()
            slib.cf_stamps(None, 1)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            cyc = (ctypes.c_ulonglong * 16)()
            slib.cf_stamps(ctypes.addressof(cyc), 0)
            attempts = cyc[15]
            ghz = sum(cyc[:9]) / (ms * 1e6)
            result[f"{sum(cpa)}_{drift}_{tree}"] = {
                "route": ns._select_team(None, task.net.num_pops, 4, 4, scfg)[0],
                "attempts_lane0": attempts, "ms": ms, "ghz_from_stamps": ghz,
                "us_per_attempt": ms * 1e3 / attempts,
                "us_per_attempt_by_phase": {name: cyc[i] / attempts / ghz / 1e3
                                            for i, name in enumerate(PHASES) if name}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
