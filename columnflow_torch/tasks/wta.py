"""Winner-take-all training task (port of ``columnflow/tasks/wta.py``).

Learns the lateral-inhibition / self-excitation entries of a two-column
area so its L2/3e rate trajectories match Wong-Wang decision dynamics. One
training step integrates the whole batch (samples x noise realizations) as
one SRA1 rollout, takes the trajectory loss, backpropagates through every
solver step, masks the gradient to the 4 trainable entries and applies
torch RMSprop (lr=10.0, alpha=0.9) with ExponentialLR(0.99).

On CUDA the rollout and its backward are the hand-written kernels of
``kernels.column_step``; on the CPU the same ``torch.autograd.Function``
runs their plain versions, or (``use_fused=False``) autograd runs through
the pure-torch ``solvers.sdeint``.

Like the JAX package, the optimizer also updates ``output_weights`` (their
mask is None, so their gradient passes through).

    python -m columnflow_torch.tasks.wta --smoke           # on the card
    python -m columnflow_torch.tasks.wta --smoke --device cpu
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from columnflow_torch import resolve_device
from columnflow_torch.config import ColumnConfig, legacy_wta_config
from columnflow_torch.data import make_wta_dataset, wta_stim_three_phases
from columnflow_torch.kernels.column_step import make_wta_rollout_diff
from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.wta import (
    build_wta,
    wta_diffusion,
    wta_drift,
    wta_lat_in_mask,
)
from columnflow_torch.ops.losses import huber_trajectory_loss_wta
from columnflow_torch.solvers.sde import brownian_pack, sdeint
from columnflow_torch.train.optim import global_norm, mask_grads, torch_rmsprop

DT = 1e-4
STIM_PHASE = 0.05  # s; three phases -> 1500 steps
TIME_STEPS = int(STIM_PHASE * 3 / DT)


class WTATask(NamedTuple):
    params: dict
    area: object
    ts: torch.Tensor
    dt: float
    grad_mask: dict
    optimizer: torch.optim.Optimizer
    scheduler: object
    rollout: object  # make_wta_rollout_diff on ts, built once per task


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 grid start + i * ((stop - start) / (num - 1)), then the exact
    endpoint: for start = 0 these are the values ``jnp.linspace`` gives (XLA
    folds its stop * (i / (num - 1)) into i * (stop / (num - 1))), so the
    grid, and with it every step's h, equals the JAX package's bit for bit."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    delta = (stop_t - start_t) / float(num - 1)
    out = start_t + torch.arange(num - 1, dtype=torch.float32, device=device) * delta
    return torch.cat([out, stop_t[None]])


def build_task(cfg: ColumnConfig, generator: torch.Generator, lr: float = 10.0,
               alpha: float = 0.9, lr_gamma: float = 0.99,
               time_steps: int = TIME_STEPS, dt: float = DT,
               device=None) -> WTATask:
    params, area = build_wta(cfg, generator, device=device)
    for p in params.values():
        p.requires_grad_(True)
    # The grid: linspace(0, N*dt, N), so the step is N*dt/(N-1), not dt.
    ts = linspace(0.0, time_steps * dt, time_steps, device=device)
    mask = torch.as_tensor(wta_lat_in_mask(), device=device)
    grad_mask = {"recurrent_weights": mask, "output_weights": None}
    optimizer, scheduler = torch_rmsprop(
        [params["recurrent_weights"], params["output_weights"]], lr=lr,
        alpha=alpha, lr_gamma=lr_gamma)
    dt_grid = float((ts[1] - ts[0]).item())
    # Built here, not per step: it reads the grid step back to the host.
    rollout = make_wta_rollout_diff(area, ts, device=device)
    return WTATask(params, area, ts, dt_grid, grad_mask, optimizer, scheduler,
                   rollout)


def batched_rollout(params, task: WTATask, stims, generator=None, noise=None,
                    use_fused: bool | None = None):
    """Integrate a batch of stimuli: stims (B, 2) -> (B, T, 48).

    ``noise`` is the Brownian pack ``(i1, i10)``, each (T-1, B); without it
    the pack is drawn from ``generator``. ``use_fused`` selects the kernel
    rollout (``task.rollout``, a ``make_wta_rollout_diff``); ``None`` picks it
    when the tensors are on CUDA. Both paths give the same trajectories up to
    float32 rounding.
    """
    time_steps = task.ts.shape[0]
    B = stims.shape[0]
    if noise is None:
        _, i1, i10, _, _ = brownian_pack(generator, task.ts, (B,), torch.float32)
    else:
        i1, i10 = noise
    tables = wta_stim_three_phases(stims, time_steps)  # (B, T, 16)
    if use_fused is None:
        use_fused = stims.is_cuda
    if use_fused:
        return task.rollout(params["recurrent_weights"], tables, i1, i10)

    stim = Stimulus(0.0, task.dt, tables.transpose(0, 1))  # time-major

    def drift(t, y):
        return wta_drift(t, y, params, task.area, stim)

    def diffusion(t, y):
        return wta_diffusion(t, y, params, task.area, stim)

    y0 = torch.zeros((B, 48), dtype=torch.float32, device=stims.device)
    ys = sdeint(drift, diffusion, y0, task.ts, None, method="srk",
                noise="scalar", additive=True, noise_pack=(i1, i10, None, None))
    return ys.transpose(0, 1)


def loss_fn(params, task: WTATask, true_states, stims, generator=None,
            noise=None, use_fused: bool | None = None):
    ys = batched_rollout(params, task, stims, generator=generator, noise=noise,
                         use_fused=use_fused)
    return huber_trajectory_loss_wta(ys, true_states, params["output_weights"])


def make_train_step(task: WTATask, use_fused: bool | None = None):
    """Build the training step: batched SDE rollout, loss, masked gradients,
    RMSprop update. ``train_step(true_states, stims, generator=None,
    noise=None) -> (loss, grad_norm)`` updates ``task.params`` in place and
    leaves the masked gradients in their ``.grad``. Nothing in it waits for
    the device."""
    params = task.params

    def train_step(true_states, stims, generator=None, noise=None):
        task.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, task, true_states, stims, generator=generator,
                       noise=noise, use_fused=use_fused)
        loss.backward()
        with torch.no_grad():
            grads = mask_grads({k: p.grad for k, p in params.items()},
                               task.grad_mask)
            for k, p in params.items():
                p.grad.copy_(grads[k])
            gnorm = global_norm(grads)[0]
        task.optimizer.step()
        task.scheduler.step()
        return loss.detach(), gnorm

    return train_step


def train_wta(
    nr_samples: int = 3000,
    batch_size: int = 16,
    seed: int = 0,
    lr: float = 10.0,
    noise_reps: int = 1,
    time_steps: int = TIME_STEPS,
    dataset=None,
    legacy_scale: bool = False,
    device=None,
):
    """Training run (defaults: 3000 samples, batch 16). The last sample of
    each batch is held out for validation. Batches are sampled by a
    ``torch.Generator`` on the device, seeded with ``seed``; ``noise_reps``
    averages the gradient over that many noise realizations per sample.
    Returns (params, history)."""
    dev = resolve_device(device)
    cfg = ColumnConfig.load()
    if legacy_scale:
        cfg = legacy_wta_config(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    task = build_task(cfg, gen, lr=lr, time_steps=time_steps, device=dev)

    if dataset is None:
        states, stims = make_wta_dataset(gen, nr_samples + 10, time_steps,
                                         device=dev)
    else:
        states, stims = (torch.as_tensor(x, device=dev) for x in dataset)
    states = states / 20.0  # scale to L2/3 rates

    step_fn = make_train_step(task)
    n = states.shape[0]
    history = []
    for _ in range(n // batch_size):
        idx = torch.randperm(n, generator=gen, device=dev)[:batch_size]
        bs, bst = states[idx[:-1]], stims[idx[:-1]]  # last held out
        if noise_reps > 1:
            bs = bs.repeat(noise_reps, 1, 1)
            bst = bst.repeat(noise_reps, 1)
        loss, gnorm = step_fn(bs, bst, generator=gen)
        with torch.no_grad():
            val_loss = loss_fn(task.params, task, states[idx[-1:]],
                               stims[idx[-1:]], generator=gen)
        history.append({"loss": float(loss), "val_loss": float(val_loss),
                        "grad_norm": float(gnorm)})
    return task.params, history


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--samples", type=int, default=3000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=10.0,
                   help="the original protocol uses 10.0; 0.01 optimizes stably")
    p.add_argument("--noise-reps", type=int, default=1,
                   help="average gradients over R noise realizations/sample")
    p.add_argument("--legacy-scale", action="store_true",
                   help="build the legacy x1e-3 anatomy generation")
    p.add_argument("--smoke", action="store_true",
                   help="tiny run: 48 samples, batch 8, 300 steps")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    if args.smoke:
        kw = dict(nr_samples=48, batch_size=8, time_steps=300)
    else:
        kw = dict(nr_samples=args.samples, batch_size=args.batch_size)
    _, hist = train_wta(seed=args.seed, lr=args.lr, noise_reps=args.noise_reps,
                        legacy_scale=args.legacy_scale, device=args.device, **kw)
    print(f"final loss {hist[-1]['loss']:.5f} | val {hist[-1]['val_loss']:.5f}")


if __name__ == "__main__":
    main()
