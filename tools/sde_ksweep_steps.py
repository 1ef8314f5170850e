"""The 32-column stochastic parity steps whose reverse sweep runs on the SDE
kernel-mode sweep's cluster team for the batch (B4't: ``cf_sde3_bwd_ksweep``;
B4s: ``cf_sde2_bwd_ksweep``), against the same steps with the 8-block teams
that team replaced (B4't-team, ``cf_sde3_bwd_team``; B4s's
``cf_sde2_bwd``: route "team"), on the card.

Four steps of the parity task at 32 columns (``--columns-per-area 16,8,8``,
batch 4, 1000 grid points over 1 s, max_steps 3072 as on the command line):
``--stochastic`` (the uniform grid), ``--stochastic --adaptive`` (the XLA
selection's per-lane grids) and ``--stochastic --adaptive --engine
fused-split2`` over the whole second and over its first 100 points. Each
step runs in turns on the shape's routes and with ``sde3_bwd_route`` made to
answer "team" (cluster, team, team, cluster), each turn a warm-up and then
the mean host time of REPS steps, every step from the same weights (so that
the adaptive grids are the same); the launches of one step on each route are
counted, and the loss and the gradients of the two routes must agree bit for
bit. It prints one JSON line: the card's name and power limit, and for each
step ms per step on each turn, the launches and the gradients' agreement.

    python3 tools/sde_ksweep_steps.py

Needs a CUDA card and nvcc (the kernels are built at first use).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

CPA = (16, 8, 8)
REPS = 3
STEPS = {  # name: (flags, grid points)
    "stochastic": (dict(stochastic=True), 1000),
    "stochastic_adaptive": (dict(stochastic=True, adaptive=True), 1000),
    "split2_adaptive_100": (dict(stochastic=True, adaptive=True, split2=True), 100),
    "split2_adaptive": (dict(stochastic=True, adaptive=True, split2=True), 1000),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sde_ksweep_steps: no CUDA device", file=sys.stderr)
        return 2
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import parity

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    dev = torch.device("cuda")
    shape_route = ns.sde3_bwd_route
    result = {"card": smi, "columns": sum(CPA), "lanes": 4, "reps": REPS}
    for name, (flags, T) in STEPS.items():
        gen = torch.Generator(device=dev).manual_seed(23)
        task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                                 columns_per_area=CPA, n_inputs=4, time_steps=T,
                                 max_steps=3072, device=dev)
        step = parity.make_train_step(task, **flags)
        stims = make_parity_batch(gen, 4, 4, device=dev)
        keys, noise = None, None
        if flags.get("adaptive"):
            keys = torch.randint(0, 2**32, (4, 2), generator=gen, device=dev, dtype=torch.int64)
        else:
            _, i1, i10, _, _ = brownian_pack(gen, task.ts, (4, 1))
            noise = (i1, i10)
        seed = {k: p.detach().clone() for k, p in task.params.items()}

        def run():
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(seed[k])
            rec = step(stims, keys, noise=noise)
            torch.cuda.synchronize()
            return rec

        entry, outs = {"T": T, "flags": flags}, {}
        for which in ("cluster", "team", "team", "cluster"):
            ns.sde3_bwd_route = shape_route if which == "cluster" else lambda *a: "team"
            before = dict(ns.LAUNCHES)
            rec = run()
            if which not in outs:
                entry[f"{which}_launches"] = {k: v - before[k] for k, v in ns.LAUNCHES.items()
                                              if v != before[k]}
                outs[which] = (rec["loss"].detach().clone(),
                               [p.grad.detach().clone() for p in task.params.values()])
            ms = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                run()
                ms.append((time.perf_counter() - t0) * 1e3)
            entry.setdefault(f"{which}_ms_per_step", []).append(sum(ms) / REPS)
        ns.sde3_bwd_route = shape_route
        (la, ga), (lb, gb) = outs["cluster"], outs["team"]
        entry["loss_and_gradients_bit_for_bit"] = bool(torch.equal(la, lb)) and all(
            torch.equal(a, b) for a, b in zip(ga, gb))
        if rec["stats"] is not None:
            entry["naccept"] = rec["stats"].naccept.tolist()
        result[name] = entry
        del task, step
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
