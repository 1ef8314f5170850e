#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two training steps on one CUDA card: the
WTA step and the 104-column stochastic-adaptive parity step.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero without printing a result:

0. card: name and power limit (nvidia-smi), TF32 off.
1. build: the CUDA kernels, compiled by nvcc from columnflow_torch/kernels/csrc
   (one nvcc per source, in parallel), with their register and spill report.
WTA (T = 1500 grid points, 15 and 60 lanes):
2. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes.
3. main path: 5 training steps at batch 16 (15 rollout lanes) and one with
   4 noise repetitions (60 lanes), targets from make_wta_dataset; the launch
   counters must show one forward and one backward kernel per step, and the
   first step must agree with the same step run on the CPU.
   Evaluation path: the trained model's held-out rollout and its drift at
   the end state, through the public fused_drift.
4. times: each kernel's device time and its plain version's time with CUDA
   events, the train step's wall time and a profile of it.
Parity (104 columns = 832 populations, state 2496, 4 lanes, 1000 grid
points over 1 s, max_steps 16384, the flagship's flags):
5. kernel vs plain: the selection's attempt entry on 64 states of a
   full-horizon replay; the whole selection over 100 grid points; the
   replay and its reverse sweep on 64-half-step windows early, in the middle
   and late in the full-horizon replay.
6. main path: 3 training steps through the kernels, the launch counters
   asserted per step; a step over 100 grid points repeated on the CPU with
   the plain versions on the card's frozen grid and lane words, over 5 and
   100 grid points.
7. times: each kernel's device time at the main path's shapes, its bound
   and ns per serial step, its plain version's time over 100 grid points,
   the train step's wall time and a profile of it.
Then the kernels line (every kernel of both paths), the card's name and
power limit, and the result line.

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
# The 104-column flagship (bench.py:321-333): columns (64, 32, 8), 4 inputs,
# batch 4, 1000 grid points over 1 s, max_steps 16384, rtol = atol = 1e-3.
PARITY_CPA = (64, 32, 8)
PARITY_T = 1000
PARITY_B = 4
PARITY_MAX_STEPS = 16384
SHORT_T = 100       # grid points of the CPU step check and the plain versions' times
GRAD_T = 5          # grid points (5 ms) of the CPU step check holding every gradient
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate
SDE_SOURCE = "columnflow_torch/kernels/csrc/network_sde.cu"
# The flagship's step settings; its solver flags (--stochastic --adaptive
# --fused --fused-pass --select-bf16 --grad-bf16 --split2) are the port's
# only path.
FLAGSHIP = dict(bptt_every=32, clip_grad_norm=1.0, loss_scale=1e-6)


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


def device_profile(run, n):
    """Device time by kernel (ms per call) of ``run(i)`` for i < n under
    torch.profiler, and the profiled wall time per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if (dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            key = ev.key[:80]
            by_kernel[key] = by_kernel.get(key, 0.0) + dev_us / 1e3 / n
    return wall, by_kernel


def rel_l2_rows(got, want):
    """Largest relative L2 error of a row (one step, every lane)."""
    diff = (got - want).flatten(1).norm(dim=1)
    return float((diff / want.flatten(1).norm(dim=1).clamp_min(1e-30)).max())


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


def wta_phases(dev, cfg):
    """Phases 2-4 for the WTA step; returns its kernels' entries of the
    kernels line."""
    import torch

    from columnflow_torch.data import make_wta_dataset, sample_wta_mus, wta_stim_three_phases
    from columnflow_torch.kernels import _build
    from columnflow_torch.kernels import column_step as cs
    from columnflow_torch.ops.losses import huber_trajectory_loss_wta
    from columnflow_torch.solvers.sde import brownian_pack
    from columnflow_torch.tasks import wta

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
    batches = [batch(1) for _ in range(5)]
    wall, by_kernel = device_profile(lambda i: step(*batches[i], generator=gen), len(batches))
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
    return line


def sde_bound(kernel, P, B, n_in, K, work, n=0, M=0):
    """(bound_ms, bound_by) of a network SDE kernel. ``work`` is what this
    run's data needed: the controller attempts of all lanes (selection) or
    their real half steps (replay). Each (P,) x (P, P) product counts
    2 P^2 operations at the bf16 tensor rate (select16: 1 product per
    drift; split2: 3; a split2 VJP: 2), the elementwise float32 work at
    the float32 rate. Bytes: each input read once, each output written
    once. The replays read the grid, noise, states and cotangents of the
    real half steps only (padding rows are no-ops with zero cotangents)
    and write their outputs whole ((n + 1) rows of ys, n rows of seeds);
    the weights count once (the bf16 select16 copy, or the two split2
    halves)."""
    S = 3 * P
    prod = 2 * P * P
    drift_f32 = 30 * P + 8 * S           # rates, stimulus, currents, tail
    consts = 4 * (2 * P + K * B * n_in)  # bg, adapt, knot values
    if kernel == "sde_select":
        # 5 drifts, 3 SRA1 updates and the error norm per attempt; 2 tree
        # walks of 21 normals and 2 interval normals (~150 operations each)
        flops16 = work * 5 * prod
        flops32 = work * (5 * drift_f32 + 3 * 10 * S + 6 * S + 44 * 150)
        nbytes = (2 * P * P + 2 * n_in * P + consts + 4 * B * S + 16 * B
                  + 4 * B * (M + 1) + 12 * B)
    elif kernel == "sde_replay_fwd":
        flops16 = work * 2 * 3 * prod
        flops32 = work * (2 * drift_f32 + 10 * S)
        nbytes = (4 * P * P + 4 * n_in * P + consts + 4 * B * S + 16 * work
                  + 4 * (n + 1) * B * S)
    else:  # sde_replay_bwd: a recomputed drift and two VJPs per half step
        flops16 = work * 7 * prod
        flops32 = work * (drift_f32 + 2 * (20 * P + 10 * S) + 12 * S)
        nbytes = (4 * P * P + 4 * n_in * P + consts + 12 * work + 2 * 4 * work * S
                  + 4 * n * B * S + 4 * B * S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops16 / BF16_FLOPS + flops32 / FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def parity_phases(dev, cfg):
    """Phases 5-7 for the parity step; returns its kernels' entries of the
    kernels line."""
    import torch

    from columnflow_torch.data import make_parity_batch
    from columnflow_torch.kernels import network_sde as ns
    from columnflow_torch.models.network import premix_select16, prepare_premixed_split2
    from columnflow_torch.solvers import sde_adaptive as sa
    from columnflow_torch.solvers.fused import truncation_stride
    from columnflow_torch.tasks import parity

    gen = torch.Generator(device=dev).manual_seed(1)

    def make_task(time_steps, device=dev, params=None, cpa=PARITY_CPA):
        task = parity.build_task(cfg, torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=cpa, n_inputs=4,
                                 time_steps=time_steps, max_steps=PARITY_MAX_STEPS,
                                 device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        return task

    def lane_words(n):
        return torch.randint(0, 2**32, (n, 2), generator=gen, device=dev, dtype=torch.int64)

    def kernel_inputs(task, stims, keys):
        """What the step hands the kernels: the model, split2 and select16
        weights, the lanes' tree words, the selection's settings."""
        model = parity.sde_model(task.params, task, stims)
        pw = {k: v.detach() for k, v in model.pw.items()}
        w2 = {k: v.contiguous() for k, v in prepare_premixed_split2(pw, model.sc.fc)[0].items()}
        return (model, w2, premix_select16(pw), sa._sde_key_words(keys),
                sa.select_config(task.ts, max_steps=task.max_steps))

    def replay_inputs(st, words, scfg):
        ht, dw, i10 = sa._replay_grid(st, words, scfg.t_start, scfg.t_end, scfg.depth)
        return tuple(x.T.contiguous() for x in (ht[:, :-1], ht[:, 1:] - ht[:, :-1], dw, i10))

    # -- 5. kernel vs plain -------------------------------------------------
    task = make_task(PARITY_T)
    P, B = task.net.num_pops, PARITY_B
    S, n_in, K = 3 * P, 4, 4
    stims, keys = make_parity_batch(gen, n_in, B, device=dev), lane_words(B)
    model, w2, w16, words, scfg = kernel_inputs(task, stims, keys)
    y0 = torch.zeros(B, S, device=dev)
    st, na, nr, ok = ns.select_pass(y0, words, w16, model.sc, model.kv, scfg)
    check(bool(ok.all()), f"full-horizon selection failed: naccept {na.tolist()}")
    grid = replay_inputs(st, words, scfg)        # t0s, hs, dw, i10: (2M, B)
    n_real = 2 * int(na.max())
    ys = ns.replay_fwd(y0, *grid, n_real, w2, model.sc, model.kv)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(ys).all()), "full-horizon replay is not finite")

    # One controller attempt on 64 states of that replay: each at an
    # accepted time of its lane, with 1, 1.5 and 2 times the accepted step.
    N = 64
    lanes = [r % B for r in range(N)]
    rows = [2 * int((r // B) / (N // B) * (int(na[b]) - 1)) for r, b in zip(range(N), lanes)]
    li = torch.tensor(lanes, device=dev)
    ri = torch.tensor(rows, device=dev)
    y1 = ys[ri, li].contiguous()
    t1 = st[li, ri // 2][:, None].contiguous()
    fac = torch.tensor([1.0 + 0.5 * ((r // B) % 3) for r in range(N)], device=dev)[:, None]
    h = ((st[li, ri // 2 + 1][:, None] - t1) * fac).contiguous()
    err_prev = torch.full((N, 1), 0.7, device=dev)
    w_r, kv_r = words[li].contiguous(), model.kv[:, li].contiguous()
    w_t1 = ns._tree(w_r, scfg).evaluate(t1).contiguous()
    att = ns.select_attempt(t1, y1, h, err_prev, w_t1, w_r, w16, model.sc, kv_r, scfg)
    att_p = ns._attempt_plain(t1, y1, h, err_prev, w_t1, w_r, w16, model.sc, kv_r, scfg)
    torch.cuda.synchronize()
    e_err = float(((att.err - att_p.err).abs() / att_p.err.clamp_min(1e-30)).max())
    e_hn = float(((att.h_next - att_p.h_next).abs() / att_p.h_next).max())
    same = bool(torch.equal(att.accept, att_p.accept))
    check(same and e_err < 1e-5 and e_hn < 1e-6,
          f"sde_attempt: accept equal {same}, err rel {e_err}, h_next rel {e_hn}")
    n_acc = int(att.accept.sum())

    # The whole selection over SHORT_T grid points, kernel and plain loop.
    task_s = make_task(SHORT_T, params=task.params)
    model_s, w2_s, w16_s, words_s, scfg_s = kernel_inputs(task_s, stims, keys)
    st_k, na_k, nr_k, ok_k = ns.select_pass(y0, words_s, w16_s, model_s.sc, model_s.kv, scfg_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_p, na_p, nr_p, ok_p = ns._select_plain(y0, words_s, w16_s, model_s.sc, model_s.kv,
                                              scfg_s)
    torch.cuda.synchronize()
    plain_ms = {"sde_select": (time.perf_counter() - t0) * 1e3}
    e_t10 = float(((st_k[:, :11] - st_p[:, :11]).abs() / st_p[:, :11].clamp_min(1e-30)).max())
    e_na = float(((na_k - na_p).abs().float() / na_p.float()).max())
    # The largest difference of accepted times over each lane's common
    # accepted prefix, and the first accepted index where the grids part.
    common = torch.minimum(na_k, na_p).long()[:, None]
    idx = torch.arange(st_k.shape[1], device=dev)[None]
    d_st = torch.where(idx <= common, (st_k - st_p).abs(), 0.0)
    part = [int(torch.nonzero(r).min()) if bool(r.any()) else None for r in d_st > 0]
    check(bool(ok_k.all()) and bool(ok_p.all()) and e_t10 < 1e-6 and e_na < 0.1,
          f"sde_select over {SHORT_T} points: success {ok_k.tolist()} {ok_p.tolist()}, "
          f"first 10 times rel {e_t10}, naccept {na_k.tolist()} vs {na_p.tolist()}")

    # The replay and its reverse sweep on one truncation window (64 half
    # steps) early, in the middle and late, from the kernel's state there.
    W = 64
    errs = {"sde_select": float(d_st.max()), "sde_replay_fwd": 0.0, "sde_replay_bwd": 0.0}
    windows = []
    for k0 in (0, (n_real // 2) & ~1, n_real - W):
        win = tuple(x[k0:k0 + W].contiguous() for x in grid)
        ys_k = ns.replay_fwd(ys[k0].contiguous(), *win, W, w2, model.sc, model.kv)
        ys_p = ns._replay_fwd_plain(ys[k0].contiguous(), *win, W, w2, model.sc, model.kv)
        ysbar = torch.randn(W, B, S, generator=gen, device=dev)
        bwd = (ys_p[:-1].contiguous(), ysbar, win[0], win[1], win[3], W, 0, w2, model.sc,
               model.kv)
        yb, seeds = ns.replay_bwd(*bwd)
        yb_p, seeds_p = ns._replay_bwd_plain(*bwd)
        torch.cuda.synchronize()
        e = {"fwd_scaled": scaled_err(ys_k, ys_p), "seeds_rel_l2": rel_l2_rows(seeds, seeds_p),
             "carry_rel_l2": rel_l2_rows(yb[None], yb_p[None])}
        check(all(torch.isfinite(x).all() for x in (ys_k, seeds, yb))
              and e["fwd_scaled"] < 1e-4 and e["seeds_rel_l2"] < 1e-4
              and e["carry_rel_l2"] < 1e-4, f"replay window at {k0}: {e}")
        errs["sde_replay_fwd"] = max(errs["sde_replay_fwd"], float((ys_k - ys_p).abs().max()))
        errs["sde_replay_bwd"] = max(errs["sde_replay_bwd"], float((seeds - seeds_p).abs().max()))
        windows.append({"start": k0, **e})
    emit("parity_kernel_vs_plain", columns=sum(PARITY_CPA), P=P, lanes=B, T=PARITY_T,
         naccept=na.tolist(), nreject=nr.tolist(), n_real=n_real,
         attempt={"records": N, "accepted": n_acc, "err_rel": e_err, "err_tol": 1e-5,
                  "h_next_rel": e_hn, "h_next_tol": 1e-6, "accept_equal": same},
         selection={"T": SHORT_T, "naccept": na_k.tolist(), "naccept_plain": na_p.tolist(),
                    "nreject": nr_k.tolist(), "nreject_plain": nr_p.tolist(),
                    "first10_rel": e_t10, "first10_tol": 1e-6, "naccept_rel": e_na,
                    "naccept_tol": 0.1, "common_prefix_max_abs": float(d_st.max()),
                    "first_parted_index": part},
         attempt_y_new_max_abs=float((att.y_new - att_p.y_new).abs().max()),
         windows=windows, tol={"fwd_scaled": 1e-4, "seeds_rel_l2": 1e-4, "carry_rel_l2": 1e-4},
         max_abs_err=errs)

    # -- 6. the main path: 3 training steps at full width -----------------------
    step = parity.make_train_step(task, **FLAGSHIP)
    masks = {k: v.bool() for k, v in task.grad_mask.items()}
    params_first = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    for k in ns.LAUNCHES:
        ns.LAUNCHES[k] = 0
    history, step_s = [], []
    for i in range(3):
        stims_i, keys_i = make_parity_batch(gen, n_in, B, device=dev), lane_words(B)
        before = dict(ns.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = step(stims_i, keys_i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launched = {k: ns.LAUNCHES[k] - before[k] for k in ns.LAUNCHES}
        check(launched == {"sde_select": 1, "sde_attempt": 0, "sde_replay_fwd": 1,
                           "sde_replay_bwd": 1}, f"step {i}: launches {launched}")
        stats = rec["stats"]
        check(bool(stats.success.all()) and bool(torch.isfinite(rec["loss"])),
              f"step {i}: success {stats.success.tolist()}, loss {rec['loss']}")
        for k, p in task.params.items():
            check(bool((p.grad[~masks[k]] == 0).all()), f"step {i}: {k} gradient off its mask")
        history.append({"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                        "update_applied": bool(rec["ok"]), "naccept": stats.naccept.tolist(),
                        "nreject": stats.nreject.tolist(), "seconds": step_s[-1]})
    main_launches = dict(ns.LAUNCHES)

    # A step on the card from the parameters of the main path's first step,
    # and the same step on the CPU with the plain versions on the card's
    # frozen grid and lane words (unclipped, so that both gradients are
    # compared as computed). Over GRAD_T grid points
    # (5 ms) every gradient is held at 104 columns, so the reverse sweep and
    # the weight-gradient contraction at P = 832 are compared through the
    # step. Over SHORT_T points the solver's weight gradients are
    # ill-conditioned at 104 columns: the CPU's own gradient moves by O(1)
    # when the weights move by one part in 1e7 ("spread"), so the loss and
    # the output-weight gradient are held there; at 13 columns every
    # gradient.
    check_flags = {**FLAGSHIP, "clip_grad_norm": None}

    def step_grads(cpa, T_check, device, params, grid=None):
        t = make_task(T_check, device=device, params=params, cpa=cpa)
        rec = parity.make_train_step(t, **check_flags)(
            stims.to(device), keys.to(device), grid=None if grid is None
            else tuple(x.to(device) for x in grid))
        return rec, {k: p.grad.detach().cpu().clone() for k, p in t.params.items()}

    def rel_l2(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in a}

    cpu = torch.device("cpu")
    cpu_check = {}
    for cpa, T_check, held_keys in ((PARITY_CPA, GRAD_T, None),
                                    (PARITY_CPA, SHORT_T, ("output_weights",)),
                                    ((8, 4, 1), SHORT_T, None)):
        src = make_task(T_check, cpa=cpa).params if cpa != PARITY_CPA else params_first
        params0 = {k: p.detach().cpu().clone() for k, p in src.items()}
        rec_k, grad_k = step_grads(cpa, T_check, dev, params0)
        sk = rec_k["stats"]
        grid_k = (sk.step_times, sk.naccept, sk.nreject)
        t0 = time.perf_counter()
        rec_c, grad_c = step_grads(cpa, T_check, cpu, params0, grid_k)
        cpu_s = time.perf_counter() - t0
        loss_rel = abs(float(rec_k["loss"]) - float(rec_c["loss"])) / abs(float(rec_c["loss"]))
        grad_rel = rel_l2(grad_k, grad_c)
        entry = {"T": T_check, "naccept": sk.naccept.tolist(), "loss_rel": loss_rel,
                 "grad_rel_l2": grad_rel, "held": held_keys or "all", "cpu_seconds": cpu_s}
        if cpa == PARITY_CPA:
            nudged = {k: v if k == "output_weights" else v * (1.0 + 1e-7)
                      for k, v in params0.items()}
            entry["spread"] = rel_l2(step_grads(cpa, T_check, cpu, nudged, grid_k)[1], grad_c)
        held = max(grad_rel[k] for k in (held_keys or grad_rel))
        check(loss_rel < 1e-4 and held < 1e-3,
              f"card vs CPU parity step at columns {cpa}: {entry}")
        cpu_check[f"{sum(cpa)}_columns_{T_check}_points"] = entry
    emit("parity_main_path", columns=sum(PARITY_CPA), lanes=B, T=PARITY_T,
         max_steps=PARITY_MAX_STEPS, history=history, launches=main_launches,
         cpu_check={"tol": {"loss": 1e-4, "grad": 1e-3}, **cpu_check})

    # -- 7. times -----------------------------------------------------------
    ysbar = torch.randn(2 * PARITY_MAX_STEPS, B, S, generator=gen, device=dev)
    grid_s = replay_inputs(st_k, words_s, scfg_s)
    n_real_s = 2 * int(na_k.max())
    ys_s = ns.replay_fwd(y0, *grid_s, n_real_s, w2_s, model_s.sc, model_s.kv)
    ysbar_s = ysbar[:ys_s.shape[0] - 1]
    stride = truncation_stride((B, S), 2 * PARITY_MAX_STEPS, 2 * FLAGSHIP["bptt_every"])
    calls = {  # (main path shapes, SHORT_T shapes, SHORT_T plain version)
        "sde_select": (
            lambda: ns.select_pass(y0, words, w16, model.sc, model.kv, scfg),
            lambda: ns.select_pass(y0, words_s, w16_s, model_s.sc, model_s.kv, scfg_s), None),
        "sde_replay_fwd": (
            lambda: ns.replay_fwd(y0, *grid, n_real, w2, model.sc, model.kv),
            lambda: ns.replay_fwd(y0, *grid_s, n_real_s, w2_s, model_s.sc, model_s.kv),
            lambda: ns._replay_fwd_plain(y0, *grid_s, n_real_s, w2_s, model_s.sc,
                                         model_s.kv)),
        "sde_replay_bwd": (
            lambda: ns.replay_bwd(ys[:-1], ysbar, grid[0], grid[1], grid[3], n_real, stride,
                                  w2, model.sc, model.kv),
            lambda: ns.replay_bwd(ys_s[:-1], ysbar_s, grid_s[0], grid_s[1], grid_s[3],
                                  n_real_s, stride, w2_s, model_s.sc, model_s.kv),
            lambda: ns._replay_bwd_plain(ys_s[:-1], ysbar_s, grid_s[0], grid_s[1], grid_s[3],
                                         n_real_s, stride, w2_s, model_s.sc, model_s.kv)),
    }
    times = {}
    for name, (full, short, plain) in calls.items():
        times[name] = {"ms": cuda_ms(full, reps=2, warmup=1),
                       "ms_short": cuda_ms(short, reps=3, warmup=1)}
        if plain is not None:
            plain_ms[name] = cuda_ms(plain, reps=1, warmup=0)
    attempts, half_steps = int((na + nr).sum()), int(2 * na.sum())
    serial = {"sde_select": int((na + nr).max()), "sde_replay_fwd": n_real,
              "sde_replay_bwd": n_real}
    work = {"sde_select": attempts, "sde_replay_fwd": half_steps, "sde_replay_bwd": half_steps}
    bounds = {name: sde_bound(name, P, B, n_in, K, work[name], n=2 * PARITY_MAX_STEPS,
                              M=PARITY_MAX_STEPS) for name in calls}
    emit("parity_kernel_times", lanes=B, T=PARITY_T, attempts=attempts,
         real_half_steps=half_steps, bwd_truncation_stride=stride,
         ms={k: v["ms"] for k, v in times.items()},
         ms_at_short_horizon={k: v["ms_short"] for k, v in times.items()},
         plain_ms_at_short_horizon=plain_ms,
         ns_per_serial_step={k: times[k]["ms"] * 1e6 / serial[k] for k in times},
         bound_ms={k: v[0] for k, v in bounds.items()},
         bound_by={k: v[1] for k, v in bounds.items()})

    step_ms = sum(step_s[1:]) * 1e3 / len(step_s[1:])
    emit("parity_train_step", ms_per_step=step_ms, samples_per_s=B * 1e3 / step_ms,
         step_seconds=step_s)
    batches = [(make_parity_batch(gen, n_in, B, device=dev), lane_words(B))]
    wall, by_kernel = device_profile(lambda i: step(*batches[i]), len(batches))
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("parity_step_profile", lanes=B, profiled_wall_ms_per_step=wall, step_ms=step_ms,
         device_busy_ms_per_step=busy if busy else "not measured",
         idle_share=1.0 - busy / step_ms if busy else "not measured",
         device_kernels=len(by_kernel), top_ms_per_step=dict(top))

    replaces = {"sde_select": "columnflow/solvers/sde_adaptive.py:509",
                "sde_replay_fwd": "columnflow/solvers/fused.py:845",
                "sde_replay_bwd": "columnflow/solvers/fused.py:920"}
    return [{"name": name, "route": "cuda", "source": SDE_SOURCE, "replaces": replaces[name],
             "launches": main_launches[name], "max_abs_err": errs[name],
             "ms": times[name]["ms"], "plain_ms": plain_ms[name],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
             "lanes": B, "plain_ms_at": f"{SHORT_T} grid points (ms_short: the kernel there)",
             "ms_short": times[name]["ms_short"],
             "ns_per_serial_step": times[name]["ms"] * 1e6 / serial[name]}
            for name in calls]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from columnflow_torch.config import ColumnConfig
    from columnflow_torch.kernels import _build

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
    line = wta_phases(dev, cfg) + parity_phases(dev, cfg)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
