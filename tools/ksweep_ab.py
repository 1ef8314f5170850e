"""The build seconds of each kernel source, and the kernel-mode dopri5
sweep's cluster team (B8 and B8t-team, ``ode_ksweep_team.cu``) of another
checkout against this one's, on the card.

First every source of ``columnflow_torch/kernels/csrc`` is compiled by its
own nvcc with the package's flags, all at once, and the seconds until each
finishes are recorded (the slowest is the build's critical path). The
other checkout's ``ode_ksweep_team.cu`` (with its own headers) is compiled
beside them. Then both teams run the reverse sweep of the 4-lane
deterministic parity step over a 256-step window of the selection's grid at
13 and 32 columns, on the routes "resident" and "streamed", in turns
(other, this, this, other), each a CUDA-event mean over 3 launches; their
outputs must agree bit for bit. It prints one JSON line: the card's name
and power limit, the build seconds by source, and us per accepted step of
each run.

    python3 tools/ksweep_ab.py OTHER_CSRC

OTHER_CSRC is the other checkout's ``columnflow_torch/kernels/csrc``
directory (for example the parent commit's, from ``git archive``); its
library goes under ``build/ksweep_ab/``. The package's own libraries are
built into the usual cache (``kernels/_build.py``). Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

WINDOW = 256  # accepted steps of each timed window
ENTRY = "cf_ode_replay_bwd_ksweep"


def build_timed(build, other_csrc: Path, out: Path) -> dict:
    """Compile every source (into the package's cache) and the other
    checkout's ode_ksweep_team.cu (into ``out``) at once: {source: seconds
    until its nvcc finished}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    cmds = {name: [build._nvcc(), *build._flags(name), "-o", str(build._library_path(name)),
                   str(build.CSRC / f"{name}.cu")] for name in build._SIGNATURES}
    cmds["other:ode_ksweep_team"] = [build._nvcc(), *build._flags("ode_ksweep_team"), "-o",
                                     str(out / "libother.so"),
                                     str(other_csrc / "ode_ksweep_team.cu")]
    jobs, done = {}, {}
    t0 = time.perf_counter()
    for name, cmd in cmds.items():  # each report to a file: no pipe fills and stalls a job
        log = tempfile.TemporaryFile()
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log)
    while len(done) < len(jobs):
        for name, (proc, log) in jobs.items():
            if name not in done and proc.poll() is not None:
                done[name] = round(time.perf_counter() - t0, 1)
                log.seek(0)
                report = log.read().decode()
                log.close()
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed on {name}:\n{report}")
        time.sleep(0.2)
    return dict(sorted(done.items(), key=lambda kv: kv[1]))


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ksweep_ab: no CUDA device", file=sys.stderr)
        return 2
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import network_ode as no
    from columnflow_torch.solvers.fused import round_max_steps
    from columnflow_torch.tasks import parity

    out = REPO / "build" / "ksweep_ab"
    seconds = build_timed(_build, Path(sys.argv[1]).resolve(), out)
    real = _build.library()
    olib = ctypes.CDLL(str(out / "libother.so"))
    fn = getattr(olib, ENTRY)
    fn.argtypes = _build._SIGNATURES["ode_ksweep_team"][ENTRY]
    fn.restype = ctypes.c_int
    libs = {"this": real, "other": SimpleNamespace(**{**vars(real), ENTRY: fn})}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    result = {"card": smi, "build_seconds": seconds, "lanes": 4, "steps": WINDOW}
    dev = torch.device("cuda")

    def cuda_ms(run, reps=3):
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

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
        for route in ("resident", "streamed"):
            entry, outs = {"steps": n}, {}
            for which in ("other", "this", "this", "other"):
                no._lib = lambda which=which: libs[which]

                def run(route=route):
                    return no.ode_replay_bwd(ys, cobar, stw, pw, sc, kv, route=route)

                outs[which] = run()
                entry.setdefault(f"{which}_us_per_step", []).append(cuda_ms(run) * 1e3 / n)
            entry["elements_parted"] = [int((a != b).sum())
                                        for a, b in zip(outs["other"], outs["this"])]
            result[f"{sum(cpa)}_{route}"] = entry
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
