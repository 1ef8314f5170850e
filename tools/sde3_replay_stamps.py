"""Where a half step of B3t-team and B4t goes, phase by phase, on the card.

Builds a copy of ``columnflow_torch/kernels/csrc/sde3_replay_team.cu`` and of
the headers it stamps (``ode_team.cuh``, ``tma_ring.cuh``) with
``clock64()`` stamps of thread 0 of block 0 (rank 0 of lane 0's cluster)
around each phase of a drift evaluation (the rates, their split and the
exchange of the own rows; the cluster barrier; the previous step's row
written to device memory; the products, and within them the ring's waits
for tiles; the block barrier and owner tail), of a drift VJP (the own
cotangents in; the products and the partial sums out to the rows' owners;
the cluster barrier; the owners' sums and tail) and between them (the SRA1
stage and update, the seeds, the loop), runs B3t-team and B4t over a
256-half-step window of the fixed grid from the zero state at 104 and 32
columns (4 lanes) on the shape's route and the streamed ring through the
stamped copy, and prints one JSON line: us per drift, per VJP and per half
step by phase, with the clock rate inferred from the stamps' total over the
call's CUDA-event time.

    python3 tools/sde3_replay_stamps.py

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

WINDOW = 256  # half steps of the timed window
DRIFT = {0: "rates_split_exchange", 1: "cluster_barrier", 2: "previous_row_out",
         3: "products", 4: "block_barrier_owner_tail"}
VJP = {7: "cotangent_in", 8: "products_partials_out", 9: "cluster_barrier",
       10: "owner_sums_tail"}
BETWEEN = {5: "sra1_stage_update_loop"}
STAMPS = '''
__device__ unsigned long long g_st[16];
__device__ long long g_last;
#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { long long now_ = clock64(); \\
  g_st[i] += (unsigned long long)(now_ - g_last); g_last = now_; } } while (0)
'''
# (file, anchor, its stamped replacement); g_st[6]: the ring's waits inside
# the products, g_st[15]: drift evaluations, g_st[14]: VJPs.
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
    ("ode_team.cuh", "  double* const cvec = T.cvec;\n  float frp = 0.0f;\n",
     "  double* const cvec = T.cvec;\n  STAMP(5);\n  float frp = 0.0f;\n"),
    ("ode_team.cuh", "  __syncthreads();\n  t3_vjp_products<NT, kStream, kF32>(T, n.P);\n"
     "  cgo::this_cluster().sync();\n",
     "  __syncthreads();\n  STAMP(7);\n  t3_vjp_products<NT, kStream, kF32>(T, n.P);\n  STAMP(8);\n"
     "  cgo::this_cluster().sync();\n  STAMP(9);\n"),
    ("ode_team.cuh", "    out[2] = -(cr / n.tau_s);\n  }\n  T.par ^= 1;\n",
     "    out[2] = -(cr / n.tau_s);\n  }\n  STAMP(10);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_st[14] += 1;\n  T.par ^= 1;\n"),
    ("sde3_replay_team.cu", "  team3_init(T, smt, n, 1, 3, kT3Replay, b, wpk, iw, kStream, C);\n",
     "  team3_init(T, smt, n, 1, 3, kT3Replay, b, wpk, iw, kStream, C);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_last = clock64();\n"),
    ("sde3_replay_team.cu", "  team3_init(T, smt, n, 1, 3, kT3SdeSweep, b, wpk, iw, kStream, C);\n",
     "  team3_init(T, smt, n, 1, 3, kT3SdeSweep, b, wpk, iw, kStream, C);\n"
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
ENTRIES = ("cf_sde3_fwd_team", "cf_sde3_bwd_emit")


def stamped_library(build):
    """Build the stamped copy with the package's flags; its ctypes handle."""
    csrc = REPO / "columnflow_torch" / "kernels" / "csrc"
    out = REPO / "build" / "stamp"
    out.mkdir(parents=True, exist_ok=True)
    files = {name: (csrc / name).read_text()
             for name in ("tma_ring.cuh", "ode_team.cuh", "sde3_replay_team.cu")}
    for name, anchor, new in EDITS:
        if anchor not in files[name]:
            raise RuntimeError(f"stamp anchor not found in {name}: {anchor!r}")
        files[name] = files[name].replace(anchor, new)
    for name, text in files.items():
        if name.endswith(".cuh"):
            (out / name).write_text(text)
    (out / "sde3_replay_stamped.cu").write_text(files["sde3_replay_team.cu"] + READ)
    # the copies beside the source come first on the include path
    cmd = [build._nvcc(), *build._flags("sde3_replay_team"), "-I", str(csrc), "-o",
           str(out / "libsde3_replay_stamped.so"), str(out / "sde3_replay_stamped.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "libsde3_replay_stamped.so"))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = build._SIGNATURES["sde3_replay_team"][name]
        fn.restype = ctypes.c_int
    lib.cf_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cf_stamps.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sde3_replay_stamps: no CUDA device", file=sys.stderr)
        return 2
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.solvers.fused import uniform_step_times
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import parity

    dev = torch.device("cuda")
    real = _build.library()
    slib = stamped_library(_build)
    ns._lib = lambda: SimpleNamespace(**{**vars(real),
                                         **{name: getattr(slib, name) for name in ENTRIES}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    B = 4
    result = {"card": smi, "lanes": B, "half_steps": WINDOW}
    for cpa in ((64, 32, 8), (16, 8, 8)):
        gen = torch.Generator(device=dev).manual_seed(17)
        task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=4, device=dev)
        model = parity.sde_model(task.params, task, make_parity_batch(gen, 4, B, device=dev))
        pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
        sc, kv, P = model.sc, model.kv.contiguous(), task.net.num_pops
        t0s, h = uniform_step_times(task.ts, (B, 3 * P))
        t0s = t0s[:WINDOW].to(dev).contiguous()
        _, i1, i10, _, _ = brownian_pack(gen, task.ts, (B, 1))
        grid = (t0s, torch.full_like(t0s, h), i1.reshape(-1, B)[:WINDOW].contiguous(),
                i10.reshape(-1, B)[:WINDOW].contiguous())
        y0 = torch.zeros(B, 3 * P, device=dev)
        ys = ns.replay3_fwd(y0, *grid, WINDOW, pw, sc, kv)
        ysbar = torch.randn(WINDOW, B, 3 * P, generator=gen, device=dev)
        for bwd in (False, True):
            def run(route):
                if bwd:
                    return ns.replay3_bwd_emit(ys[:-1].contiguous(), ysbar, grid[0], grid[1],
                                               grid[3], WINDOW, 0, pw, sc, kv, route=route)
                return ns.replay3_fwd(y0, *grid, WINDOW, pw, sc, kv, route=route)

            plan = ns._sde3_team(None, P, 4, B, bwd)
            for route in dict.fromkeys(["streamed" if plan.stream else "resident", "streamed"]):
                run(route)
                torch.cuda.synchronize()
                slib.cf_stamps(None, 1)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(route)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                cyc = (ctypes.c_ulonglong * 16)()
                slib.cf_stamps(ctypes.addressof(cyc), 0)
                drifts, vjps = cyc[15], cyc[14]
                ghz = sum(cyc[i] for i in (*DRIFT, *VJP, *BETWEEN)) / (ms * 1e6)

                def us(i, per):
                    return cyc[i] / max(per, 1) / ghz / 1e3

                key = f"{sum(cpa)}_{'B4t' if bwd else 'B3t_team'}_{route}"
                result[key] = {
                    "C": plan.C, "f32": plan.f32, "drifts_block0": drifts, "vjps_block0": vjps,
                    "ms": ms, "ghz_from_stamps": ghz, "us_per_half_step": ms * 1e3 / WINDOW,
                    "us_per_drift_by_phase": {name: us(i, drifts) for i, name in DRIFT.items()},
                    "us_per_vjp_by_phase": ({name: us(i, vjps) for i, name in VJP.items()}
                                            if vjps else None),
                    "us_per_half_step_between": us(5, WINDOW),
                    "ring_wait_us_per_half_step": us(6, WINDOW)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
