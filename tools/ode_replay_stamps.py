"""Where a step of the dopri5 replay team goes, phase by phase, on the card.

Builds a copy of ``columnflow_torch/kernels/csrc/ode_replay_team.cu`` and of
the headers it stamps (``ode_team.cuh``, ``tma_ring.cuh``) with
``clock64()`` stamps of thread 0 of block 0 (rank 0 of lane 0's cluster)
around each phase of a drift evaluation (the rates, their split and the
exchange of the own rows; the cluster barrier; the previous step's rows
written to device memory; the products, and within them the ring's waits
for tiles; the block barrier and owner tail) and between drifts (the stage
sums, the step's rows in registers, the loop), runs B7 split2 and
B7t-team over a 256-step window of the deterministic selection's grid at
104 columns and B7t-team at 32 columns (4 lanes) through the stamped copy,
and prints one JSON line: us per drift and per step by phase, with the clock
rate inferred from the stamps' total over the call's CUDA-event time.

    python3 tools/ode_replay_stamps.py

The copy and its library go under ``build/stamp/``; the package's own
kernels are built as usual (``kernels/_build.py``). Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

WINDOW = 256  # accepted steps of the timed window
PHASES = {0: "rates_split_exchange", 1: "cluster_barrier", 2: "previous_rows_out",
          3: "products", 4: "block_barrier_owner_tail", 5: "stages_rows_loop"}
STAMPS = '''
__device__ unsigned long long g_st[16];
__device__ long long g_last;
#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { long long now_ = clock64(); \\
  g_st[i] += (unsigned long long)(now_ - g_last); g_last = now_; } } while (0)
'''
# (header or source, anchor, its stamped replacement); g_st[6]: the ring's
# waits inside the products, g_st[15]: drift evaluations.
EDITS = (
    ("tma_ring.cuh", '#include "network_drift.cuh"\n',
     '#include "network_drift.cuh"\n' + STAMPS),
    ("tma_ring.cuh", "  if (!kStream) return T.w;\n  const int S = T.p.S;\n",
     "  if (!kStream) return T.w;\n  const long long w0_ = clock64();\n  const int S = T.p.S;\n"),
    ("tma_ring.cuh",
     "  t2_mbar_wait(T.mbar + 1 + g % S, (uint32_t)((g / S) & 1));\n  return t2_stage(T, g % S);",
     "  t2_mbar_wait(T.mbar + 1 + g % S, (uint32_t)((g / S) & 1));\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_st[6] += (unsigned long long)(clock64() - w0_);\n"
     "  return t2_stage(T, g % S);"),
    ("ode_team.cuh", "  if (p.slots == 1) cl.sync();  // every block has read the slot's last exchange\n",
     "  STAMP(5);\n  if (p.slots == 1) cl.sync();  // every block has read the slot's last exchange\n"),
    ("ode_team.cuh", "  cl.sync();\n  after_barrier();\n",
     "  STAMP(0);\n  cl.sync();\n  STAMP(1);\n  after_barrier();\n  STAMP(2);\n"),
    ("ode_team.cuh", "    t3_fwd_products<NT, LB, kStream>(T, n.P, X);\n  __syncthreads();\n",
     "    t3_fwd_products<NT, LB, kStream>(T, n.P, X);\n  STAMP(3);\n  __syncthreads();\n"),
    ("ode_team.cuh", "      out[q][0] = out[q][1] = out[q][2] = 0.0f;\n    }\n  }\n  T.par ^= 1;\n",
     "      out[q][0] = out[q][1] = out[q][2] = 0.0f;\n    }\n  }\n  STAMP(4);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_st[15] += 1;\n  T.par ^= 1;\n"),
    ("ode_team.cuh", "  team3_init(T, smt, n, 1, NT, kT3Replay, b, wpk, iw, kStream, C);\n",
     "  team3_init(T, smt, n, 1, NT, kT3Replay, b, wpk, iw, kStream, C);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_last = clock64();\n"),
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
ENTRIES = ("cf_ode_replay_fwd_team", "cf_ode_replay_fwd_split2")


def stamped_library(build):
    """Build the stamped copy with the package's flags; its ctypes handle."""
    csrc = REPO / "columnflow_torch" / "kernels" / "csrc"
    out = REPO / "build" / "stamp"
    out.mkdir(parents=True, exist_ok=True)
    files = {name: (csrc / name).read_text() for name in ("tma_ring.cuh", "ode_team.cuh")}
    for name, anchor, new in EDITS:
        if anchor not in files[name]:
            raise RuntimeError(f"stamp anchor not found in {name}: {anchor!r}")
        files[name] = files[name].replace(anchor, new)
    for name, text in files.items():
        (out / name).write_text(text)
    (out / "ode_replay_stamped.cu").write_text((csrc / "ode_replay_team.cu").read_text() + READ)
    # the copies beside the source come first on the include path
    cmd = [build._nvcc(), *build._flags("ode_replay_team"), "-I", str(csrc), "-o",
           str(out / "libode_replay_stamped.so"), str(out / "ode_replay_stamped.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "libode_replay_stamped.so"))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES["ode_replay_team"][name]
        fn.restype = ctypes.c_int
    lib.cf_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cf_stamps.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ode_replay_stamps: no CUDA device", file=sys.stderr)
        return 2
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.models.network import prepare_premixed_split2
    from columnflow_torch.solvers.fused import round_max_steps
    from columnflow_torch.tasks import parity

    dev = torch.device("cuda")
    real = _build.library()
    slib = stamped_library(_build)
    no._lib = lambda: SimpleNamespace(**{**vars(real),
                                         **{name: getattr(slib, name) for name in ENTRIES}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    result = {"card": smi, "lanes": 4, "steps": WINDOW}
    for cpa, splits in (((64, 32, 8), (2, 3)), ((16, 8, 8), (3,))):
        gen = torch.Generator(device=dev).manual_seed(17)
        task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=4, time_steps=1000,
                                 max_steps=16384, device=dev)
        model = parity.sde_model(task.params, task, make_parity_batch(gen, 4, 4, device=dev))
        pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
        sc, kv, P = model.sc, model.kv.contiguous(), task.net.num_pops
        y0 = torch.zeros(4, 3 * P, device=dev)
        # a horizon that holds the window's accepted steps at both widths
        cfg = no.ODESelectConfig(0.0, float(task.ts[60]),
                                 max_steps=round_max_steps((4, 3 * P), 16384))
        st, stats = no.ode_select(y0, pw, sc, kv, cfg)
        n = min(int(stats[0]), WINDOW)
        stw = st[:n + 1].contiguous()
        w3 = {k: v.contiguous() for k, v in no._w3(pw, sc).items()}
        w2 = {k: v.contiguous() for k, v in prepare_premixed_split2(pw, sc.fc)[0].items()}
        for NT in splits:
            def run(NT=NT):
                if NT == 3:
                    return no.ode_replay_fwd(y0, stw, pw, sc, kv, w3=w3, route=route)
                return no.ode_replay_fwd_split2(y0, stw, w2, sc, kv, route=route)

            for route in dict.fromkeys([no._replay_team(None, P, 4, 4, NT)[0], "streamed"]):
                run()
                torch.cuda.synchronize()
                slib.cf_stamps(None, 1)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                cyc = (ctypes.c_ulonglong * 16)()
                slib.cf_stamps(ctypes.addressof(cyc), 0)
                drifts = cyc[15]
                ghz = sum(cyc[:6]) / (ms * 1e6)
                key = f"{sum(cpa)}_{'split2' if NT == 2 else 'split3'}_{route}"
                result[key] = {
                    "steps": n, "drifts_block0": drifts, "ms": ms, "ghz_from_stamps": ghz,
                    "us_per_step": ms * 1e3 / n, "us_per_drift": ms * 1e3 / max(drifts, 1),
                    "us_per_drift_by_phase": {name: cyc[i] / max(drifts, 1) / ghz / 1e3
                                              for i, name in PHASES.items()},
                    "ring_wait_us_per_drift": cyc[6] / max(drifts, 1) / ghz / 1e3}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
