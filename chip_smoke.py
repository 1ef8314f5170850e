#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's WTA training step on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero without printing a result:

0. card: name and power limit (nvidia-smi), TF32 off.
1. build: the CUDA kernels, compiled by nvcc from columnflow_torch/kernels/csrc.
2. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes (15 and 60 lanes, T = 1500).
3. main path: 5 training steps at batch 16 (15 rollout lanes) and one with
   4 noise repetitions (60 lanes), targets from make_wta_dataset; the launch
   counters must show one forward and one backward kernel per step, and the
   first step must agree with the same step run on the CPU.
   Evaluation path: the trained model's held-out rollout and its drift at
   the end state, through the public fused_drift.
4. times: each kernel's device time and its plain version's time with CUDA
   events, the train step's wall time, and the kernels line.

It needs a CUDA device and the repository beside it; without either it
fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T = 1500            # grid points: 1499 SRA1 steps (0.15 s of model time)
BATCH = 16          # samples per batch, one held out -> 15 rollout lanes
NOISE_REPS = 4      # the README's full-training recipe -> 60 lanes
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
N_POPS, N_STATE = 16, 48
SOURCE = "columnflow_torch/kernels/csrc/column_step.cu"


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def scaled_err(got, want):
    """Largest |got - want| over each state component's largest |want|."""
    scale = want.abs().flatten(0, -2).amax(dim=0).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps, warmup=1, device_time=False):
    """Mean ms per call of ``fn`` between two CUDA events. With
    ``device_time`` the stream first sleeps for longer than the host takes
    to enqueue the calls, so the launches run back to back and the events
    measure the device's time rather than the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if device_time:
        torch.cuda._sleep(int(2e6) * reps)  # ~1 ms of cycles per call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Work and traffic of each kernel, from its shapes (see PERF.md). FLOPs follow
# bench.py's WTA accounting: one drift evaluation = 2 n^2 + 35 n per lane, an
# SRA1 step = 2 drifts + 12 S; a VJP of the drift = 4 n^2 + 35 n (transposed
# product and w_bar outer product); a reverse step = recomputed drift
# + 2 VJPs + 12 S.
DRIFT_FLOPS = 2 * N_POPS * N_POPS + 35 * N_POPS
VJP_FLOPS = 4 * N_POPS * N_POPS + 35 * N_POPS
FWD_STEP_FLOPS = 2 * DRIFT_FLOPS + 12 * N_STATE
BWD_STEP_FLOPS = DRIFT_FLOPS + 2 * VJP_FLOPS + 12 * N_STATE
PARAM_BYTES = 4 * (N_POPS * N_POPS + 3 * N_POPS + N_STATE)


def bound(kernel, B, steps):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FLOPs over the float32 peak; each input read once, each output written
    once."""
    if kernel == "wta_drift":
        nbytes = PARAM_BYTES + 4 * B * (N_STATE + N_POPS + N_STATE)
        flops = B * DRIFT_FLOPS
    elif kernel == "wta_rollout_fwd":
        nbytes = PARAM_BYTES + 4 * B * (N_STATE + (steps + 1) * N_POPS + 2 * steps
                                        + (steps + 1) * N_STATE)
        flops = B * steps * FWD_STEP_FLOPS
    elif kernel == "wta_rollout_bwd":
        # stim rows 0..K-1 (row K is not read), i10, ys, ysbar, cin in;
        # cout and the (B, 16, 16) partials out.
        nbytes = PARAM_BYTES + 4 * B * (steps * N_POPS + steps + 2 * steps * N_STATE
                                        + 2 * N_STATE + N_POPS * N_POPS)
        flops = B * steps * BWD_STEP_FLOPS
    else:  # wta_wbar_reduce
        nbytes = 4 * (B + 1) * N_POPS * N_POPS
        flops = B * N_POPS * N_POPS
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.data import make_wta_dataset, sample_wta_mus, wta_stim_three_phases
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import column_step as cs
    from columnflow_torch.ops.losses import huber_trajectory_loss_wta
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import wta

    dev = torch.device("cuda")

    # -- 0. card --------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")
    check(torch.backends.cudnn.allow_tf32 is False, "TF32 cudnn is on")
    emit("card", nvidia_smi=smi, device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)

    cfg = ColumnConfig.load()
    ts = wta.linspace(0.0, T * wta.DT, T, device=dev)
    h = cs._grid_step(ts)

    def inputs(B, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params, area = wta.build_wta(cfg, gen, device=dev)
        consts, scalars = cs._area_consts(area)
        stim_tb = wta_stim_three_phases(sample_wta_mus(gen, B, device=dev), T)
        stim_tb = stim_tb.transpose(0, 1).contiguous()
        _, i1, i10, _, _ = brownian_pack(gen, ts, (B,))
        g = cs._diffusion_row(100.0, False, dev)
        y0 = torch.zeros(B, N_STATE, device=dev)
        fwd = (h, scalars, params["recurrent_weights"], consts, g, y0, stim_tb, i1, i10)
        ys = cs._rollout_fwd_plain(*fwd)
        ys_req = ys.transpose(0, 1).requires_grad_(True)
        true = torch.rand(B, T, 2, device=dev, generator=gen)
        loss = huber_trajectory_loss_wta(ys_req, true, params["output_weights"])
        ysbar = torch.autograd.grad(loss, ys_req)[0].transpose(0, 1).contiguous()
        bwd = (h, scalars, params["recurrent_weights"], consts, g, stim_tb, i10,
               ys[:-1].contiguous(), ysbar[:-1].contiguous(), ysbar[-1].contiguous())
        y = ys[T // 2].clone()
        y[0, 4], y[0, 20] = 20.4375, 0.0  # lane 0, population 4 at the singularity
        drift = (scalars, y, stim_tb[T // 2].contiguous(), params["recurrent_weights"], consts)
        return dict(fwd=fwd, bwd=bwd, drift=drift, ys=ys)

    # -- 2. kernel vs plain on the card ---------------------------------------
    widths = (BATCH - 1, (BATCH - 1) * NOISE_REPS)
    data = {B: inputs(B, seed=B) for B in widths}
    errs = {}
    for B, d in data.items():
        got = cs.drift(*d["drift"])
        want = cs._drift_plain(*d["drift"])
        torch.cuda.synchronize()
        e_drift = float(((got - want).abs()
                         / cs._drift_abs_terms(*d["drift"]).clamp_min(1e-30)).max())
        check(torch.isfinite(got).all() and e_drift < 1e-6, f"wta_drift B={B}: {e_drift}")
        ys = cs.rollout_fwd(*d["fwd"])
        torch.cuda.synchronize()
        e_fwd = scaled_err(ys, d["ys"])
        check(torch.isfinite(ys).all() and e_fwd < 1e-4, f"wta_rollout_fwd B={B}: {e_fwd}")
        cout, wbar = cs.rollout_bwd(*d["bwd"])
        cout_p, wbar_p = cs._rollout_bwd_plain(*d["bwd"])
        torch.cuda.synchronize()
        e_cout = scaled_err(cout, cout_p)
        e_wbar = float((wbar - wbar_p).norm() / wbar_p.norm())
        check(torch.isfinite(cout).all() and torch.isfinite(wbar).all()
              and e_cout < 1e-4 and e_wbar < 1e-4,
              f"wta_rollout_bwd B={B}: cout {e_cout}, wbar {e_wbar}")
        errs[B] = {
            "wta_drift": float((got - want).abs().max()),
            "wta_rollout_fwd": float((ys - d["ys"]).abs().max()),
            "wta_rollout_bwd": float((cout - cout_p).abs().max()),
            "wta_wbar_reduce": float((wbar - wbar_p).abs().max()),
        }
        emit("kernel_vs_plain", lanes=B, T=T,
             drift_scaled_err=e_drift, drift_tol=1e-6,
             fwd_scaled_err=e_fwd, fwd_tol=1e-4,
             bwd_cout_scaled_err=e_cout, bwd_wbar_rel_l2=e_wbar, bwd_tol=1e-4,
             max_abs_err=errs[B])
    check(all(v > 0 for v in cs.LAUNCHES.values()), f"launch counters: {cs.LAUNCHES}")

    # -- 3. the main path at full width ---------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    states, stims = make_wta_dataset(gen, 64, T, device=dev)
    states = states / 20.0
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    check(tuple(states.shape) == (64, T, 2) and bool(torch.isfinite(states).all()),
          "dataset")
    task = wta.build_task(cfg, gen, lr=0.01, time_steps=T, device=dev)
    step = wta.make_train_step(task)
    mask = task.grad_mask["recurrent_weights"].bool()

    def batch(reps):
        idx = torch.randperm(64, generator=gen, device=dev)[:BATCH]
        bs, bst = states[idx[:-1]], stims[idx[:-1]]
        return bs.repeat(reps, 1, 1), bst.repeat(reps, 1)

    # The first step's inputs and parameters, kept to repeat the step on the
    # CPU with the plain versions.
    bs0, bst0 = batch(1)
    _, i1_0, i10_0, _, _ = brownian_pack(gen, ts, (BATCH - 1,))
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}

    for k in cs.LAUNCHES:
        cs.LAUNCHES[k] = 0
    history = []
    for i in range(6):
        if i == 0:
            loss, gnorm = step(bs0, bst0, noise=(i1_0, i10_0))
            grad0 = task.params["recurrent_weights"].grad.detach().cpu().clone()
        else:
            loss, gnorm = step(*batch(1 if i < 5 else NOISE_REPS), generator=gen)
        grad = task.params["recurrent_weights"].grad
        check(bool(torch.isfinite(loss)), f"step {i}: loss {loss}")
        check(bool((grad[~mask] == 0).all()) and bool((grad[mask] != 0).any()),
              f"step {i}: gradient off the mask")
        history.append({"loss": float(loss), "grad_norm": float(gnorm)})
    torch.cuda.synchronize()
    main_launches = dict(cs.LAUNCHES)
    check(main_launches["rollout_fwd"] == 6 and main_launches["rollout_bwd"] == 6
          and main_launches["wbar_reduce"] == 6,
          f"main path launches {main_launches}, expected 6 forward and 6 backward")

    # The first step again on the CPU, plain versions, same inputs.
    task_cpu = wta.build_task(cfg, torch.Generator().manual_seed(0), lr=0.01,
                              time_steps=T, device="cpu")
    with torch.no_grad():
        for k, p in task_cpu.params.items():
            p.copy_(params0[k])
    loss_cpu, _ = wta.make_train_step(task_cpu, use_fused=True)(
        bs0.cpu(), bst0.cpu(), noise=(i1_0.cpu(), i10_0.cpu()))
    grad_cpu = task_cpu.params["recurrent_weights"].grad
    loss_rel = abs(history[0]["loss"] - float(loss_cpu)) / abs(float(loss_cpu))
    grad_rel = float((grad0 - grad_cpu).norm() / grad_cpu.norm())
    check(loss_rel < 1e-4 and grad_rel < 1e-3,
          f"card vs CPU step: loss rel {loss_rel}, grad rel L2 {grad_rel}")
    emit("main_path", lanes=[BATCH - 1] * 5 + [(BATCH - 1) * NOISE_REPS], T=T,
         dataset_seconds=round(t_data, 3), history=history, launches=main_launches,
         cpu_check={"loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                    "tol": {"loss": 1e-4, "grad": 1e-3}})

    # Evaluation path: held-out rollout with the trained weights, and the
    # drift at its end state through the public fused_drift.
    for k in cs.LAUNCHES:
        cs.LAUNCHES[k] = 0
    held = stims[-(BATCH - 1):]
    tables = wta_stim_three_phases(held, T)
    _, i1, i10, _, _ = brownian_pack(gen, ts, (BATCH - 1,))
    with torch.no_grad():
        ys = cs.wta_rollout_fused(task.params, task.area, tables, ts, i1, i10)
        f_end = cs.fused_drift(ys[:, -1].contiguous(), tables[:, -1].contiguous(),
                               task.params, task.area)
    torch.cuda.synchronize()
    eval_launches = dict(cs.LAUNCHES)
    check(tuple(ys.shape) == (BATCH - 1, T, N_STATE) and bool(torch.isfinite(ys).all())
          and bool(torch.isfinite(f_end).all()), "evaluation path")
    check(eval_launches["rollout_fwd"] == 1 and eval_launches["drift"] == 1,
          f"evaluation launches {eval_launches}")
    emit("eval_path", lanes=BATCH - 1, launches=eval_launches,
         end_drift_abs_max=float(f_end.abs().max()))

    # -- 4. times -------------------------------------------------------------
    kernels = {
        "wta_drift": (lambda d: cs.drift(*d["drift"]), lambda d: cs._drift_plain(*d["drift"])),
        "wta_rollout_fwd": (lambda d: cs.rollout_fwd(*d["fwd"]),
                            lambda d: cs._rollout_fwd_plain(*d["fwd"])),
        "wta_rollout_bwd": (lambda d: cs.rollout_bwd(*d["bwd"]),
                            lambda d: cs._rollout_bwd_plain(*d["bwd"])),
    }
    lib, stream = _build.library(), torch.cuda.current_stream().cuda_stream
    times = {}
    for B, d in data.items():
        for kname, (kern, plain) in kernels.items():
            times[(kname, B)] = [cuda_ms(lambda: kern(d), reps=20, warmup=3, device_time=True),
                                 cuda_ms(lambda: plain(d), reps=2, warmup=1), None]
        # The reverse sweep alone (the wrapper also launches the reduction),
        # and the reduction alone on this width's partials.
        hh, sc, w, consts, g, stim_tb, i10, ys_k, ysbar_k, cin = d["bwd"]
        cout = torch.empty(B, N_STATE, device=dev)
        wpart = torch.empty(B, N_POPS, N_POPS, device=dev)
        wbar = torch.empty(N_POPS, N_POPS, device=dev)

        def sweep_kernel():
            cs._check(lib.cf_wta_rollout_bwd(
                T - 1, B, hh, *sc, w.data_ptr(), consts.data_ptr(), g.data_ptr(),
                stim_tb.data_ptr(), i10.data_ptr(), ys_k.data_ptr(), ysbar_k.data_ptr(),
                cin.data_ptr(), cout.data_ptr(), wpart.data_ptr(), stream),
                "wta_rollout_bwd")

        def reduce_kernel():
            cs._check(lib.cf_wta_wbar_reduce(B, wpart.data_ptr(), wbar.data_ptr(), stream),
                      "wta_wbar_reduce")

        def reduce_plain():  # the kernel's arithmetic: lanes summed in order
            acc = torch.zeros(N_POPS, N_POPS, device=dev)
            for b in range(B):
                acc = acc + wpart[b]
            return acc

        times[("wta_rollout_bwd", B)][0] = cuda_ms(sweep_kernel, reps=20, warmup=3,
                                                   device_time=True)
        times[("wta_wbar_reduce", B)] = [
            cuda_ms(reduce_kernel, reps=100, warmup=3, device_time=True),
            cuda_ms(reduce_plain, reps=100, warmup=3),
            cuda_ms(lambda: wpart.sum(0), reps=100, warmup=3, device_time=True)]
    for B, d in data.items():
        emit("kernel_times", lanes=B, ms={k: v[0] for (k, b), v in times.items() if b == B},
             plain_ms={k: v[1] for (k, b), v in times.items() if b == B},
             library_ms={k: v[2] for (k, b), v in times.items() if b == B},
             ns_per_serial_step={k: v[0] * 1e6 / (T - 1)
                                 for (k, b), v in times.items()
                                 if b == B and k.startswith("wta_rollout")})

    step_ms = {}
    for reps in (1, NOISE_REPS):
        batches = [batch(reps) for _ in range(10)]
        step(*batches[0], generator=gen)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for bs, bst in batches:
            step(bs, bst, generator=gen)
        torch.cuda.synchronize()
        step_ms[(BATCH - 1) * reps] = (time.perf_counter() - t0) * 1e3 / len(batches)
    emit("train_step", ms_per_step={str(k): v for k, v in step_ms.items()},
         iters_per_s={str(k): 1e3 / v for k, v in step_ms.items()})

    # Where a 15-lane step's time goes: device time by kernel over 5 steps.
    # The idle share is held against the step time measured above without
    # the profiler, whose own cost lengthens the profiled wall time.
    from torch.profiler import ProfilerActivity, profile

    batches = [batch(1) for _ in range(5)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bs, bst in batches:
            step(bs, bst, generator=gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(batches)
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if (dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            key = ev.key[:80]
            by_kernel[key] = by_kernel.get(key, 0.0) + dev_us / 1e3 / len(batches)
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    emit("step_profile", lanes=BATCH - 1, profiled_wall_ms_per_step=wall,
         step_ms=step_ms[BATCH - 1],
         device_busy_ms_per_step=busy if busy else "not measured",
         idle_share=1.0 - busy / step_ms[BATCH - 1] if busy else "not measured",
         device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    replaces = {
        "wta_rollout_fwd": "columnflow/kernels/column_step.py:102",
        "wta_rollout_bwd": "columnflow/kernels/column_step.py:315",
        "wta_wbar_reduce": "columnflow/kernels/column_step.py:315",
        "wta_drift": "columnflow/kernels/column_step.py:59",
    }
    counts = {"wta_rollout_fwd": main_launches["rollout_fwd"],
              "wta_rollout_bwd": main_launches["rollout_bwd"],
              "wta_wbar_reduce": main_launches["wbar_reduce"],
              "wta_drift": eval_launches["drift"]}
    B15, B60 = widths
    line = []
    for kname in ("wta_rollout_fwd", "wta_rollout_bwd", "wta_wbar_reduce", "wta_drift"):
        steps = T - 1
        b15, by = bound(kname, B15, steps)
        b60, _ = bound(kname, B60, steps)
        line.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces[kname],
            "launches": counts[kname], "max_abs_err": max(errs[B][kname] for B in widths),
            "ms": times[(kname, B15)][0], "plain_ms": times[(kname, B15)][1],
            "bound_ms": b15, "bound_by": by, "library_ms": times[(kname, B15)][2],
            "lanes": B15,
            "at_60_lanes": {"ms": times[(kname, B60)][0], "plain_ms": times[(kname, B60)][1],
                            "bound_ms": b60, "library_ms": times[(kname, B60)][2]},
        })
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
