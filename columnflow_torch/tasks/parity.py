"""4-bit parity classification task (port of ``columnflow/tasks/parity.py``,
the stochastic-adaptive fused-pass training step).

A 3-area hierarchical column network learns to output ~20 Hz for even
parity and ~0 for odd: readout = output-weighted mean L2/3e-family rate of
the final column over the last 100 grid points. One training step
integrates the batch through the Ito SDE with adaptive step-doubling SRA1:
per-lane step-size selection in the selection kernel, one lane-batched
replay over the frozen grids and its reverse sweep in the replay kernels,
then the loss (scaled), masked gradients, max-prescaled global norm,
clipping, a skip on non-finite gradients, Adam and the weight clamps.

The port runs the configuration of the JAX package's flags
``--stochastic --adaptive --fused --fused-pass --select-bf16 --grad-bf16
--split2`` (the 104-column flagship) and no other: those flags are
accepted on the command line and select nothing; other modes are queued in
ROADMAP.md. The Brownian paths come
from the krng tree, as the JAX package's ``--fused-pass`` path draws them;
each lane's tree key words are drawn from a ``torch.Generator``.

    python -m columnflow_torch.tasks.parity --smoke                # on the card
    python -m columnflow_torch.tasks.parity --smoke --device cpu
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from columnflow_torch import resolve_device
from columnflow_torch.config import ColumnConfig
from columnflow_torch.data import make_parity_batch, parity_combinations
from columnflow_torch.kernels.network_sde import SDEConsts
from columnflow_torch.models.network import (
    build_column_network,
    build_network_fused_consts,
    premix_network_weights,
)
from columnflow_torch.ops.interp import step_table_knots
from columnflow_torch.ops.transfer import compute_firing_rate
from columnflow_torch.solvers.sde_adaptive import PremixedNetworkSDE, sdeint_adaptive_batch
from columnflow_torch.tasks.wta import linspace
from columnflow_torch.train.optim import adam, global_norm, mask_grads

DT = 1e-3
STIM_DURATION = 0.5
TIME_STEPS = int(STIM_DURATION * 2 / DT)
OUTPUT_SCALE = 1.0
TARGET_EVEN = 20.0  # Hz


class ParityTask(NamedTuple):
    params: dict
    net: object
    ts: torch.Tensor
    dt: float
    grad_mask: dict
    clamps: dict
    optimizer: torch.optim.Optimizer
    max_steps: int


def build_task(cfg: ColumnConfig, generator: torch.Generator, lr: float = 0.1,
               columns_per_area=(8, 4, 1), n_inputs: int = 4,
               time_steps: int = TIME_STEPS, dt: float = DT, max_steps: int = 3072,
               random_fan_in: bool = False, device=None) -> ParityTask:
    params, net = build_column_network(cfg, generator, columns_per_area=columns_per_area,
                                       n_inputs=n_inputs, random_fan_in=random_fan_in,
                                       device=device)
    for p in params.values():
        p.requires_grad_(True)
    ts = linspace(0.0, time_steps * dt, time_steps, device=device)

    def t(x):
        return torch.as_tensor(x, device=device)

    grad_mask = {"input_weights": t(net.input_mask), "feedforward": t(net.feedforward_mask),
                 "lateral": t(net.lateral_mask), "output_weights": t(net.output_mask)}
    clamps = {"input_weights": (0.0, None), "feedforward": (0.0, None),
              "lateral": (None, 0.0), "output_weights": (0.0, OUTPUT_SCALE)}
    dt_grid = float((ts[1] - ts[0]).item())
    return ParityTask(params, net, ts, dt_grid, grad_mask, clamps,
                      adam(list(params.values()), lr), max_steps)


def sde_model(params, task: ParityTask, stims_raw) -> PremixedNetworkSDE:
    """The SDE the flagship integrates for a batch of input patterns: the
    premixed weights (differentiable), the drift constants and, per lane,
    the knot values of its half-off, half-on stimulus."""
    fc = build_network_fused_consts(task.net, device=stims_raw.device)
    kts, kv = step_table_knots(task.ts.shape[0], task.dt, torch.zeros_like(stims_raw),
                               stims_raw)
    return PremixedNetworkSDE(premix_network_weights(params, task.net), SDEConsts(fc, kts),
                              kv.contiguous())


def batched_rollout(params, task: ParityTask, stims_raw, lane_words,
                    differentiable: bool = True, adaptive_bptt_every: int | None = None,
                    grid=None, return_stats: bool = False):
    """Integrate a batch of input patterns on the flagship path:
    (B, n_inputs) -> (B, T, 3P), at rtol = atol = 1e-3 with the task's
    max_steps.

    ``lane_words`` (B, 2): each lane's Brownian tree key words (uint32
    values in int64). ``grid`` = (step_times, naccept, nreject) replays a
    given frozen grid instead of selecting one."""
    dev = stims_raw.device
    B = stims_raw.shape[0]
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        model = sde_model(params, task, stims_raw)
        ys, stats = sdeint_adaptive_batch(
            model, torch.zeros((B, 3 * task.net.num_pops), device=dev), task.ts,
            torch.as_tensor(lane_words, device=dev), max_steps=task.max_steps,
            bptt_every=adaptive_bptt_every, return_stats=True, grid=grid)
    return (ys, stats) if return_stats else ys


def readout(ys, params, net):
    """Mean rate of the final column over the last 100 grid points,
    weighted by the output vector."""
    P = net.num_pops
    fr = compute_firing_rate(ys[..., :P] - ys[..., P : 2 * P])
    mean_final = torch.mean(fr[:, -100:, -8:], dim=1)
    return torch.sum(mean_final * params["output_weights"] / OUTPUT_SCALE, dim=-1)


def parity_targets(stims_raw, level: float = 15.0):
    """20 Hz if the input sum is even parity, else 0."""
    even = torch.remainder(torch.sum(stims_raw, dim=1), 2.0 * level) == 0.0
    return even.to(torch.float32) * TARGET_EVEN


def make_train_step(task: ParityTask, loss_scale: float = 1.0,
                    bptt_every: int | None = None, clip_grad_norm: float | None = None):
    """The training step of the JAX package's flags ``use_fused, stochastic,
    adaptive, fused_pass, select_bf16, grad_bf16, split2`` (the port's only
    path). ``train_step(stims_raw, lane_words, grid=None)`` updates
    ``task.params`` in place (unless the update is skipped), leaves the
    masked, clipped gradients in their ``.grad``, and returns a dict with
    loss, out, gnorm (tensors), ok (bool) and the selection stats. Reading
    ``ok`` waits for the device once per step."""
    params = task.params

    def train_step(stims_raw, lane_words, grid=None):
        task.optimizer.zero_grad(set_to_none=True)
        ys, stats = batched_rollout(params, task, stims_raw, lane_words,
                                    adaptive_bptt_every=bptt_every, grid=grid,
                                    return_stats=True)
        out = readout(ys, params, task.net)
        loss = torch.mean(torch.abs(out - parity_targets(stims_raw)))
        (loss * loss_scale).backward()
        with torch.no_grad():
            grads = {k: p.grad / loss_scale if loss_scale != 1.0 else p.grad
                     for k, p in params.items()}
            grads = mask_grads(grads, task.grad_mask)
            gnorm, gmax, norm_scaled = global_norm(grads)
            finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
            if clip_grad_norm is not None:
                scale = torch.clamp_max((clip_grad_norm / gmax)
                                        / torch.clamp_min(norm_scaled, 1e-30), 1.0)
                grads = {k: g * scale for k, g in grads.items()}
            if clip_grad_norm is not None:
                ok = bool(finite)
            else:
                ok = bool(finite & (gnorm < 1e4))
            for k, p in params.items():
                p.grad.copy_(grads[k])
            if ok:
                task.optimizer.step()
                for k, (lo, hi) in task.clamps.items():
                    params[k].clamp_(lo, hi)
        return {"loss": loss.detach(), "out": out.detach(), "gnorm": gnorm, "ok": ok,
                "stats": stats}

    return train_step


def train_parity(nr_samples: int = 6400, batch_size: int = 4, seed: int = 0,
                 columns_per_area=(8, 4, 1), n_inputs: int = 4,
                 time_steps: int | None = None, max_steps: int | None = None,
                 loss_scale: float = 1.0, bptt_every: int | None = None,
                 clip_grad_norm: float | None = None, smoke: bool = False, device=None):
    """Training run on the flagship path. Batches and the lanes' tree key
    words are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``smoke``: 8 samples, batch 4, and unless given 200 grid points and
    max_steps 1024 (otherwise TIME_STEPS and 3072).
    Returns (params, history); the last record holds the accuracy over the
    fixed-position patterns."""
    if smoke:
        nr_samples, batch_size = 8, 4
    time_steps = time_steps or (200 if smoke else TIME_STEPS)
    max_steps = max_steps or (1024 if smoke else 3072)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    task = build_task(ColumnConfig.load(), gen, columns_per_area=columns_per_area,
                      n_inputs=n_inputs, time_steps=time_steps, max_steps=max_steps,
                      device=dev)
    step = make_train_step(task, loss_scale=loss_scale, bptt_every=bptt_every,
                           clip_grad_norm=clip_grad_norm)

    def lane_words(n):
        return torch.randint(0, 2**32, (n, 2), generator=gen, device=dev, dtype=torch.int64)

    history = []
    for _ in range(nr_samples // batch_size):
        stims = make_parity_batch(gen, n_inputs, batch_size, device=dev)
        rec = step(stims, lane_words(batch_size))
        history.append({"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                        "update_applied": int(rec["ok"]),
                        "naccept": rec["stats"].naccept.tolist(),
                        "nreject": rec["stats"].nreject.tolist()})
    eval_stims = torch.as_tensor(parity_combinations(n_inputs), device=dev)
    eval_gen = torch.Generator(device=dev).manual_seed(1234)
    words = torch.randint(0, 2**32, (eval_stims.shape[0], 2), generator=eval_gen,
                          device=dev, dtype=torch.int64)
    with torch.no_grad():
        ys = batched_rollout(task.params, task, eval_stims, words, differentiable=False)
        out = readout(ys, task.params, task.net)
    targets = parity_targets(eval_stims)
    acc = float(torch.mean(((out > TARGET_EVEN / 2) == (targets > 0)).float()))
    history.append({"acc": acc, "readouts": out.tolist()})
    return task.params, history


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--samples", type=int, default=6400)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="tiny run: 8 samples, batch 4, 200 grid points")
    for flag in ("fused", "stochastic", "adaptive", "fused-pass", "select-bf16",
                 "grad-bf16", "split2"):
        p.add_argument(f"--{flag}", action="store_true",
                       help="accepted for the JAX package's command line and "
                            "ignored: the port runs only this flag's path")
    p.add_argument("--bptt-every", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--clip-grad-norm", type=float, default=None)
    p.add_argument("--loss-scale", type=float, default=1.0)
    p.add_argument("--columns-per-area", default=None, metavar="N,N,...",
                   help="comma-separated columns per area (default 8,4,1; "
                        "64,32,8 for the 104-column flagship)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)
    cpa = ((8, 4, 1) if args.columns_per_area is None
           else tuple(int(x) for x in args.columns_per_area.split(",")))
    _, hist = train_parity(
        nr_samples=args.samples, batch_size=args.batch_size, seed=args.seed,
        columns_per_area=cpa, max_steps=args.max_steps, loss_scale=args.loss_scale,
        bptt_every=args.bptt_every, clip_grad_norm=args.clip_grad_norm, smoke=args.smoke,
        device=args.device)
    final = next(h for h in reversed(hist) if "loss" in h)
    print(f"final loss {final['loss']:.5f} | acc {hist[-1]['acc']:.2f}")


if __name__ == "__main__":
    main()
