#!/usr/bin/env python
"""One train step of the f32-exact deterministic parity engine at 312
columns over the full second, on the card.

The parity task at ``--columns-per-area 192,96,24`` (P = 2496 populations,
state (4, 7488) float32, 4 inputs, batch 4, 1000 grid points over 1 s) with
no engine flag past 103 columns' ``--engine fused``: the selection (B6),
the replay (B7t-team), the emit-mode sweep (B8't) and the exact outer
weight pass (``solvers.fused.ode_outer_arg_grads`` through
``prepare_premixed_split``), through ``tasks.parity.make_train_step``. The
weights are the task's own, drawn from seed 0; the batch from seed 23.

Prints one JSON line per budget: the peak device memory
(``torch.cuda.max_memory_allocated``), the step's wall seconds, each
kernel's and the outer pass's device time from CUDA events around its call
in the step, the accepted and rejected counts, the time the selection
reached, and whether the loss and every gradient are finite. With
``--max-steps`` 16384 (the setting ``columnflow_torch/tasks/parity.py``
documents for these widths) first; if that budget stops short of 1 s, the
step again with twice the budget. Then the card's name and power limit.

    python tools/exact312_step.py            # on a CUDA card; ~14 min with both budgets
    python tools/exact312_step.py --max-steps 512 --time-steps 20  # a short check
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import event_timed  # noqa: E402
from columnflow_torch.config import ColumnConfig  # noqa: E402
from columnflow_torch.data import make_parity_batch  # noqa: E402
from columnflow_torch.kernels import network_ode as no  # noqa: E402
from columnflow_torch.solvers import fused as sf  # noqa: E402
from columnflow_torch.tasks import parity  # noqa: E402

CPA, B, N_IN = (192, 96, 24), 4, 4
TIMED = ("ode_select", "ode_replay_fwd", "ode_replay_bwd_emit", "ode_outer_arg_grads")


def one_step(max_steps: int, time_steps: int, dev) -> dict:
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=CPA, n_inputs=N_IN, time_steps=time_steps,
                             max_steps=max_steps, device=dev)
    stims = make_parity_batch(torch.Generator(device=dev).manual_seed(23), N_IN, B, device=dev)
    step = parity.make_train_step(task)
    for k in no.LAUNCHES:
        no.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = []
    restore = event_timed(sf, TIMED, log)
    try:
        t0 = time.perf_counter()
        rec = step(stims)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        restore()
    device_ms = {}
    for name, start, end in log:
        device_ms[name] = device_ms.get(name, 0.0) + start.elapsed_time(end)
    st = rec["stats"]
    na = int(st.naccept)
    return {"columns": sum(CPA), "P": task.net.num_pops, "lanes": B, "T": time_steps,
            "max_steps": max_steps,
            "max_steps_rounded": sf.round_max_steps((B, 3 * task.net.num_pops), max_steps),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "seconds": seconds, "device_ms": device_ms,
            "launches": {k: v for k, v in no.LAUNCHES.items() if v},
            "naccept": na, "nreject": int(st.nreject), "success": bool(st.success),
            "t_reached": float(st.step_times[na]), "t_end": float(task.ts[-1]),
            "loss": float(rec["loss"]), "loss_finite": bool(torch.isfinite(rec["loss"])),
            "grads_finite": {k: bool(torch.isfinite(p.grad).all())
                             for k, p in task.params.items()},
            "grad_norm": float(rec["gnorm"]), "update_applied": bool(rec["ok"])}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--max-steps", type=int, default=16384)
    p.add_argument("--time-steps", type=int, default=parity.TIME_STEPS)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("exact312_step: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rec = one_step(args.max_steps, args.time_steps, dev)
    print(json.dumps(rec), flush=True)
    if not rec["success"]:
        torch.cuda.empty_cache()
        print(json.dumps(one_step(2 * args.max_steps, args.time_steps, dev)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
