"""Where a step of the kernel-mode sweep's cluster team goes, phase by phase,
on the card.

Builds a copy of ``columnflow_torch/kernels/csrc/ode_ksweep_team.cu`` and of
the headers it stamps (``ode_team.cuh``, ``tma_ring.cuh``) with
``clock64()`` stamps of thread 0 of block 0 (rank 0 of the batch's
cluster) around each phase of a drift evaluation (the rates, their split
and the exchange of the own rows; the cluster barrier; the products in the
replay's chunk order, and within them the ring's waits for tiles; the block
barrier, the chunks' sums and the owner tail) and of a drift VJP (the
current's cotangent, the rates' terms and the stimulus; the terms out to
every block; the VJP products and partials out; the cluster barrier; the
owners' sums; the weight-cotangent pass), and between them (the stage sums,
the cotangent updates, the step's fold, the loop). It runs the sweep over
a 256-step window of the deterministic selection's grid at 13 and 32
columns (4 lanes) through the stamped copy and prints one JSON line: us per
drift, per VJP and per step by phase, with the clock rate inferred from the
stamps' total over the call's CUDA-event time.

    python3 tools/ode_ksweep_stamps.py

The copy and its library go under ``build/stamp_ksweep/``; the package's
own kernels are built as usual (``kernels/_build.py``). Needs a CUDA card
and nvcc.
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
DRIFT = {0: "rates_split_exchange", 1: "cluster_barrier", 2: "products",
         3: "block_barrier_chunk_sums_owner_tail"}
VJP = {4: "cotangent_terms_stimulus", 5: "terms_out", 6: "products_partials_out",
       7: "cluster_barrier", 8: "owners_sums", 9: "weight_cotangents"}
BETWEEN = 10  # stages, cotangent updates, the step's fold, the loop
RING, N_DRIFTS, N_VJPS = 11, 14, 15
STAMPS = '''
__device__ unsigned long long g_st[16];
__device__ long long g_last;
#define STAMP(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) { long long now_ = clock64(); \\
  g_st[i] += (unsigned long long)(now_ - g_last); g_last = now_; } } while (0)
#define COUNT(i) do { if (blockIdx.x == 0 && threadIdx.x == 0) g_st[i] += 1; } while (0)
'''
# (header, anchor, its stamped replacement)
EDITS = (
    ("tma_ring.cuh", '#include "network_drift.cuh"\n',
     '#include "network_drift.cuh"\n' + STAMPS),
    ("tma_ring.cuh", "  if (!kStream) return T.w;\n  const int S = T.p.S;\n",
     "  if (!kStream) return T.w;\n  const long long w0_ = clock64();\n  const int S = T.p.S;\n"),
    ("tma_ring.cuh",
     "  t2_mbar_wait(T.mbar + 1 + g % S, (uint32_t)((g / S) & 1));\n  return t2_stage(T, g % S);",
     "  t2_mbar_wait(T.mbar + 1 + g % S, (uint32_t)((g / S) & 1));\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_st[11] += (unsigned long long)(clock64() - w0_);\n"
     "  return t2_stage(T, g % S);"),
    ("ode_team.cuh",
     "  if (p.slots == 1) cl.sync();  // every block has read the slot's last exchange\n"
     "  float fr[IPT];\n",
     "  STAMP(10);\n  if (p.slots == 1) cl.sync();  // every block has read the slot's last exchange\n"
     "  float fr[IPT];\n"),
    ("ode_team.cuh", "  cl.sync();\n  after_barrier();\n",
     "  STAMP(0);\n  cl.sync();\n  STAMP(1);\n  after_barrier();\n"),
    ("ode_team.cuh", "  double* const part = t3k_part(T);  // (G, NP, NB, nc)\n",
     "  STAMP(2);\n  double* const part = t3k_part(T);  // (G, NP, NB, nc)\n"),
    ("ode_team.cuh", "      out[q][0] = out[q][1] = out[q][2] = 0.0f;\n    }\n  }\n  T.par ^= 1;\n",
     "      out[q][0] = out[q][1] = out[q][2] = 0.0f;\n    }\n  }\n  STAMP(3);\n  COUNT(14);\n"
     "  T.par ^= 1;\n"),
    ("ode_team.cuh",
     "  double* const cv = T.cvec + T.par * own;\n"
     "  if (p.slots == 1) cl.sync();  // every block is done with the slot's last exchange\n",
     "  double* const cv = T.cvec + T.par * own;\n  STAMP(10);\n"
     "  if (p.slots == 1) cl.sync();  // every block is done with the slot's last exchange\n"),
    ("ode_team.cuh", "  __syncthreads();\n  {  // the own rows of the rates' terms",
     "  __syncthreads();\n  STAMP(4);\n  {  // the own rows of the rates' terms"),
    ("ode_team.cuh", "  t3k_vjp_products<NT, kStream>(T, P, cv);\n  cl.sync();\n",
     "  STAMP(5);\n  t3k_vjp_products<NT, kStream>(T, P, cv);\n  STAMP(6);\n  cl.sync();\n"
     "  STAMP(7);\n"),
    ("ode_team.cuh", "  // The weight cotangents of the own columns, every row.\n",
     "  STAMP(8);\n  // The weight cotangents of the own columns, every row.\n"),
    ("ode_team.cuh",
     "    A.aiw[q] = first ? (float)s : A.aiw[q] + (float)s;\n  }\n  T.par ^= 1;\n",
     "    A.aiw[q] = first ? (float)s : A.aiw[q] + (float)s;\n  }\n  STAMP(9);\n  COUNT(15);\n"
     "  T.par ^= 1;\n"),
    ("ode_team.cuh", "  const KAcc A = t3k_carve(T, smt, n, work);\n",
     "  const KAcc A = t3k_carve(T, smt, n, work);\n"
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
ENTRY = "cf_ode_replay_bwd_ksweep"


def stamped_library(build):
    """Build the stamped copy with the package's flags; its ctypes handle."""
    csrc = REPO / "columnflow_torch" / "kernels" / "csrc"
    out = REPO / "build" / "stamp_ksweep"
    out.mkdir(parents=True, exist_ok=True)
    files = {name: (csrc / name).read_text() for name in ("tma_ring.cuh", "ode_team.cuh")}
    for name, anchor, new in EDITS:
        if files[name].count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once in {name}: {anchor!r}")
        files[name] = files[name].replace(anchor, new)
    for name, text in files.items():
        (out / name).write_text(text)
    (out / "ode_ksweep_stamped.cu").write_text((csrc / "ode_ksweep_team.cu").read_text() + READ)
    # the copies beside the source come first on the include path
    cmd = [build._nvcc(), *build._flags("ode_ksweep_team"), "-I", str(csrc), "-o",
           str(out / "libode_ksweep_stamped.so"), str(out / "ode_ksweep_stamped.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "libode_ksweep_stamped.so"))
    fn = getattr(lib, ENTRY)
    fn.argtypes = build._SIGNATURES["ode_ksweep_team"][ENTRY]
    fn.restype = ctypes.c_int
    lib.cf_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cf_stamps.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ode_ksweep_stamps: no CUDA device", file=sys.stderr)
        return 2
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.solvers.fused import round_max_steps
    from columnflow_torch.tasks import parity

    dev = torch.device("cuda")
    real = _build.library()
    slib = stamped_library(_build)
    no._lib = lambda: SimpleNamespace(**{**vars(real), ENTRY: getattr(slib, ENTRY)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    result = {"card": smi, "lanes": 4, "steps": WINDOW}
    for cpa in ((8, 4, 1), (16, 8, 8)):
        gen = torch.Generator(device=dev).manual_seed(19)
        task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=4, time_steps=1000,
                                 max_steps=16384, device=dev)
        model = parity.sde_model(task.params, task, make_parity_batch(gen, 4, 4, device=dev))
        pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
        sc, kv, P = model.sc, model.kv.contiguous(), task.net.num_pops
        y0 = torch.zeros(4, 3 * P, device=dev)
        # a horizon that holds the window's accepted steps at both widths
        cfg = no.ODESelectConfig(0.0, float(task.ts[150]),
                                 max_steps=round_max_steps((4, 3 * P), 16384))
        st, stats = no.ode_select(y0, pw, sc, kv, cfg)
        n = min(int(stats[0]), WINDOW)
        stw = st[:n + 1].contiguous()
        ys, co = no.ode_replay_fwd(y0, stw, pw, sc, kv)
        cobar = torch.randn(co.shape, generator=gen, device=dev)
        for route in dict.fromkeys([no.ode_bwd_route(P, 4, 4), "streamed"]):
            def run():
                return no.ode_replay_bwd(ys, cobar, stw, pw, sc, kv, route=route)

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
            drifts, vjps = max(cyc[N_DRIFTS], 1), max(cyc[N_VJPS], 1)
            ghz = sum(cyc[:BETWEEN + 1]) / (ms * 1e6)

            def us(i, per):
                return cyc[i] / per / ghz / 1e3

            result[f"{sum(cpa)}_{route}"] = {
                "steps": n, "drifts_block0": cyc[N_DRIFTS], "vjps_block0": cyc[N_VJPS],
                "ms": ms, "ghz_from_stamps": ghz, "us_per_step": ms * 1e3 / n,
                "us_per_drift_by_phase": {name: us(i, drifts) for i, name in DRIFT.items()},
                "us_per_vjp_by_phase": {name: us(i, vjps) for i, name in VJP.items()},
                "us_per_step_between": us(BETWEEN, n),
                "ring_wait_us_per_step": us(RING, n)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
