"""Where a half step of B4't's cluster team (the SDE's kernel-mode sweep for
the batch, ``sde3_ksweep16_kernel``) goes, phase by phase, on the card.

Builds a copy of ``columnflow_torch/kernels/csrc/sde3_ksweep_team.cu`` and
of the headers it stamps (``ode_team.cuh``, ``tma_ring.cuh``) with
``clock64()`` stamps of thread 0 of block 0 (rank 0 of the batch's
cluster) around each phase of the drift evaluation (the rates, their split
and the exchange of the own rows; the cluster barrier; the products in the
replay's chunk order, and within them the ring's waits for tiles; the block
barrier, the chunks' sums and the owner tail) and of each drift VJP (the
current's cotangent, the rates' terms and the stimulus at the lanes' own
times; the terms out to every block; the VJP products and partials out; the
cluster barrier; the owners' sums; the weight-cotangent pass), and between
them (the lanes' step times, the step's state and cotangent, the block
barrier and the SRA1 stage; then the carry, the fold and the chunk sums).
It runs the sweep at 13 columns (4 lanes) over a 256-half-step window in
the middle of the XLA selection's per-lane grid and over the first 256
steps of the uniform grid, on the shape's route and on "streamed", through
the stamped copy, and prints one JSON line: us per drift, per VJP (with its
weight pass) and per half step by phase, with the clock rate inferred from
the stamps' total over the call's CUDA-event time.

    python3 tools/sde3_ksweep_stamps.py

The copy and its library go under ``build/stamp_sde3_ksweep/``; the
package's own kernels are built as usual (``kernels/_build.py``). Needs a
CUDA card and nvcc.
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
sys.path.insert(0, str(REPO / "tools"))

from ode_ksweep_stamps import EDITS as KSWEEP_EDITS  # noqa: E402
from ode_ksweep_stamps import READ  # noqa: E402

WINDOW = 256  # half steps of each timed window
DRIFT = {0: "rates_split_exchange", 1: "cluster_barrier", 2: "products",
         3: "block_barrier_chunk_sums_owner_tail"}
VJP = {4: "cotangent_terms_stimulus", 5: "terms_out", 6: "products_partials_out",
       7: "cluster_barrier", 8: "owners_sums", 9: "weight_cotangents"}
BETWEEN = 10  # the lanes' times, the state and cotangent loads, the block barrier, the stage
RING, FOLD, N_DRIFTS, N_VJPS = 11, 12, 14, 15
# The dopri5 sweep's stamps of the shared team functions (ode_ksweep_stamps.py),
# without its kernel's start stamp, and this kernel's own: the start, and the
# carry, fold and chunk sums after the second VJP.
EDITS = tuple(e for e in KSWEEP_EDITS if "t3k_carve(T, smt, n, work);" not in e[1]) + (
    ("ode_team.cuh", "  const KSdeAcc A = t3k_carve_sde(T, smt, n, work);\n",
     "  const KSdeAcc A = t3k_carve_sde(T, smt, n, work);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_last = clock64();\n"),
    ("ode_team.cuh", "      A.ciw[q] = fold ? 0.0f : sum;\n    }\n  }\n",
     "      A.ciw[q] = fold ? 0.0f : sum;\n    }\n    STAMP(12);\n  }\n"),
)
ENTRY = "cf_sde3_bwd_ksweep"


def stamped_library(build):
    """Build the stamped copy with the package's flags; its ctypes handle."""
    csrc = REPO / "columnflow_torch" / "kernels" / "csrc"
    out = REPO / "build" / "stamp_sde3_ksweep"
    out.mkdir(parents=True, exist_ok=True)
    files = {name: (csrc / name).read_text() for name in ("tma_ring.cuh", "ode_team.cuh")}
    for name, anchor, new in EDITS:
        if files[name].count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once in {name}: {anchor!r}")
        files[name] = files[name].replace(anchor, new)
    for name, text in files.items():
        (out / name).write_text(text)
    (out / "sde3_ksweep_stamped.cu").write_text((csrc / "sde3_ksweep_team.cu").read_text() + READ)
    # the copies beside the source come first on the include path
    cmd = [build._nvcc(), *build._flags("sde3_ksweep_team"), "-I", str(csrc), "-o",
           str(out / "libsde3_ksweep_stamped.so"), str(out / "sde3_ksweep_stamped.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / "libsde3_ksweep_stamped.so"))
    fn = getattr(lib, ENTRY)
    fn.argtypes = build._SIGNATURES["sde3_ksweep_team"][ENTRY]
    fn.restype = ctypes.c_int
    lib.cf_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cf_stamps.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sde3_ksweep_stamps: no CUDA device", file=sys.stderr)
        return 2
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.solvers.fused import sweep_chunk, uniform_step_times
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import parity

    dev = torch.device("cuda")
    real = _build.library()
    slib = stamped_library(_build)
    ns._lib = lambda: SimpleNamespace(**{**vars(real), ENTRY: getattr(slib, ENTRY)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(23)
    B = 4
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=(8, 4, 1), time_steps=1000, max_steps=3072,
                             device=dev)
    P = task.net.num_pops
    S = 3 * P
    model = parity.sde_model(task.params, task, make_parity_batch(gen, 4, B, device=dev))
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    sc, kv = model.sc, model.kv
    y0 = torch.zeros(B, S, device=dev)
    # the XLA selection's per-lane grid (the --stochastic --adaptive step's)
    cfg = sa.select_config(task.ts, max_steps=3072, brownian="jax", drift="f32")
    words = sa._sde_key_words(torch.randint(0, 2**32, (B, 2), generator=gen, device=dev,
                                            dtype=torch.int64), "jax")
    st, na, _, _ = ns.select_pass(y0, words, pw, sc, kv, cfg)
    ht, dw, i10 = sa._replay_grid(st, words, cfg.t_start, cfg.t_end, cfg.depth, "jax")
    lanes = (ht[:, :-1].T.contiguous(), (ht[:, 1:] - ht[:, :-1]).T.contiguous(),
             dw.T.contiguous(), i10.T.contiguous())
    n_real = 2 * int(na.max())
    ys_l = ns.replay3_fwd(y0, *lanes, n_real, pw, sc, kv)
    k0 = max(0, (n_real // 2 - WINDOW // 2) & ~1)
    w_l = min(WINDOW, n_real - k0)
    # the uniform grid (the --stochastic step's)
    t0u, hu = uniform_step_times(task.ts, (B, S))
    t0u = t0u.to(dev)
    hs_u = torch.full_like(t0u, hu)
    _, i1u, i10u, _, _ = brownian_pack(gen, task.ts, (B, 1))
    n_u = t0u.shape[0]
    i1u, i10u = i1u.reshape(n_u, B).contiguous(), i10u.reshape(n_u, B).contiguous()
    w_u = min(WINDOW, n_u)
    ys_u = ns.replay3_fwd(y0, t0u[:w_u], hs_u[:w_u], i1u[:w_u], i10u[:w_u], w_u, pw, sc, kv)
    windows = {
        "lanes": (ys_l[k0:k0 + w_l].contiguous(),
                  torch.randn(w_l, B, S, generator=gen, device=dev),
                  *(lanes[i][k0:k0 + w_l].contiguous() for i in (0, 1, 3)), w_l, 0,
                  sweep_chunk((B, S), w_l), pw, sc, kv),
        "uniform": (ys_u[:-1].contiguous(), torch.randn(w_u, B, S, generator=gen, device=dev),
                    t0u[:w_u], hs_u[:w_u], i10u[:w_u], w_u, 0, sweep_chunk((B, S), w_u), pw, sc,
                    kv)}
    result = {"card": smi, "columns": 13, "lanes": B, "half_steps": WINDOW,
              "lanes_window_start": k0}
    for grid, bwd in windows.items():
        n = bwd[5]
        for route in dict.fromkeys([ns.sde3_bwd_route(P, 4, B), "streamed"]):
            def run():
                return ns.replay3_bwd(*bwd, route=route)

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
            ghz = (sum(cyc[:BETWEEN + 1]) + cyc[FOLD]) / (ms * 1e6)  # the ring's waits lie in 2

            def us(i, per):
                return cyc[i] / per / ghz / 1e3

            result[f"{grid}_{route}"] = {
                "half_steps": n, "drifts_block0": cyc[N_DRIFTS], "vjps_block0": cyc[N_VJPS],
                "ms": ms, "ghz_from_stamps": ghz, "us_per_half_step": ms * 1e3 / n,
                "us_per_drift": sum(us(i, drifts) for i in DRIFT),
                "us_per_vjp": sum(us(i, vjps) for i in VJP),
                "us_per_weight_pass": us(9, vjps),
                "us_per_drift_by_phase": {name: us(i, drifts) for i, name in DRIFT.items()},
                "us_per_vjp_by_phase": {name: us(i, vjps) for i, name in VJP.items()},
                "us_per_half_step_times_loads_stage": us(BETWEEN, n),
                "us_per_half_step_carry_fold_chunk": us(FOLD, n),
                "ring_wait_us_per_half_step": us(RING, n)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
