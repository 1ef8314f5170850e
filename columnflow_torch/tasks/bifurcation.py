"""Hopf-bifurcation neural-ODE regression (port of
``columnflow/tasks/bifurcation.py``).

Trains an MLP drift (3 -> 100 -> 100 -> 100 -> 2) to reproduce
supercritical Hopf spiral trajectories under a time-varying sine input
mu(t). Ground truth comes from the per-lane adaptive dopri5
(``data.make_hopf_dataset``); training integrates the MLP over the batch
with one shared controller: the fused dopri5 at rtol 1e-7 / atol 1e-9, the
selection, the dense-output replay and its reverse sweep each one kernel
(``solvers.fused.hopf_odeint_dopri5_fused``). RMSprop(lr 1e-3, alpha
0.99), SmoothL1 trajectory loss. A wider MLP goes in through a ``HopfTask``
built by hand around ``build_hopf_mlp(generator, sizes=..., init_std=...)``,
as in the JAX package (whose ``build_task`` takes no width); past 1 MiB of
parameters the fused solve takes their gradients outside the reverse sweep
("outer" mode), as the JAX package's does.

    python -m columnflow_torch.tasks.bifurcation --smoke               # on the card
    python -m columnflow_torch.tasks.bifurcation --smoke --device cpu  # plain versions

Validation runs the same fused forward without a backward, as the JAX
package's ``val_fn`` does on an accelerator. ``--adjoint backsolve``
raises ``NotImplementedError`` naming ROADMAP.md A7/A8, ``--metrics-out``,
``--profile-dir``, ``--checkpoint-out`` and ``--resume`` name A9, and
``make_dp_train_step`` names A10.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from columnflow_torch import resolve_device
from columnflow_torch.data import make_hopf_dataset
from columnflow_torch.models.hopf import build_hopf_mlp
from columnflow_torch.ops.losses import smooth_l1
from columnflow_torch.solvers.fused import hopf_odeint_dopri5_fused
from columnflow_torch.tasks.wta import linspace
from columnflow_torch.train.optim import torch_rmsprop

TOTAL_TIME = 25.0
TIME_POINTS = 1000


class HopfTask(NamedTuple):
    params: list
    ts: torch.Tensor
    dt: float
    optimizer: torch.optim.Optimizer
    max_steps: int


def build_task(generator: torch.Generator, lr: float = 1e-3, time_points: int = TIME_POINTS,
               total_time: float = TOTAL_TIME, max_steps: int = 1024, device=None) -> HopfTask:
    params = build_hopf_mlp(generator, device=device)
    for layer in params:
        for p in layer.values():
            p.requires_grad_(True)
    ts = linspace(0.0, total_time, time_points, device=device)
    optimizer, _ = torch_rmsprop([p for layer in params for p in layer.values()], lr=lr,
                                 alpha=0.99)
    return HopfTask(params, ts, float((ts[1] - ts[0]).item()), optimizer, max_steps)


def rollout(params, task: HopfTask, y0, mu_table, differentiable: bool = True, grid=None,
            return_stats: bool = False):
    """Batched integration with one shared adaptive controller: y0 (B, 2),
    mu_table (T, B) -> (T, B, 2). ``grid`` = (step_times, naccept) replays
    a given frozen grid."""
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        ys, stats = hopf_odeint_dopri5_fused(params, mu_table, task.dt, y0, task.ts,
                                             max_steps=task.max_steps, grid=grid,
                                             return_stats=True)
    return (ys, stats) if return_stats else ys


def make_train_step(task: HopfTask):
    """The training step: the JAX package's ``make_train_step(task)`` on the
    fused engine. ``train_step(true_y, grid=None)`` with true_y (T, B, 3),
    channels (x, y, mu); it updates ``task.params`` in place, leaves the
    gradients in their ``.grad`` and returns a dict with the loss (a
    tensor) and the selection's stats."""

    def train_step(true_y, grid=None):
        task.optimizer.zero_grad(set_to_none=True)
        pred, stats = rollout(task.params, task, true_y[0, :, :2], true_y[:, :, 2], grid=grid,
                              return_stats=True)
        loss = smooth_l1(pred, true_y[:, :, :2])
        loss.backward()
        task.optimizer.step()
        return {"loss": loss.detach(), "stats": stats}

    return train_step


def validation_loss(task: HopfTask, true_y):
    """SmoothL1 of the fused forward (no backward) against true_y (T, B, 3)."""
    with torch.no_grad():
        pred = rollout(task.params, task, true_y[0, :, :2], true_y[:, :, 2],
                       differentiable=False)
        return smooth_l1(pred, true_y[:, :, :2])


def make_dp_train_step(task: HopfTask, mesh=None):
    raise NotImplementedError("the data-parallel Hopf train step is not ported "
                              "(ROADMAP.md A10: torch.distributed)")


def train_bifurcation(nr_samples: int = 5000, batch_size: int = 32, seed: int = 0,
                      time_points: int = TIME_POINTS, total_time: float = TOTAL_TIME,
                      test_freq: int = 3, max_steps: int = 1024, dataset=None, device=None):
    """Reference defaults: 5000 samples, batch 32. A ``torch.Generator``
    seeded with ``seed`` draws the weights, the dataset (unless given:
    (T, N, 3)) and each step's batch. Every ``test_freq``-th step is
    followed by the validation loss of one held-out sample. Returns
    (params, history)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    task = build_task(gen, time_points=time_points, total_time=total_time, max_steps=max_steps,
                      device=dev)
    n_val = max(1, (nr_samples // batch_size) // test_freq + 1)
    ds = (make_hopf_dataset(gen, nr_samples + n_val, task.ts, device=dev) if dataset is None
          else torch.as_tensor(dataset, dtype=torch.float32, device=dev))
    train_ds, val_ds = ds[:, :nr_samples], ds[:, nr_samples:]
    step = make_train_step(task)
    history, ii, n = [], 0, train_ds.shape[1]
    for it in range(n // batch_size):
        idx = torch.randperm(n, generator=gen, device=dev)[:batch_size]
        rec = {"loss": float(step(train_ds[:, idx])["loss"])}
        if it % test_freq == 0:
            vi = min(ii, val_ds.shape[1] - 1)
            rec["val_loss"] = float(validation_loss(task, val_ds[:, vi:vi + 1]))
            ii += 1
        history.append(rec)
    return task.params, history


def resolve_options(args):
    """Raise ``NotImplementedError`` naming the ROADMAP.md item of any flag
    the JAX command line takes that the port does not run."""
    unported = [
        (args.adjoint != "replay",
         f"--adjoint {args.adjoint}: the continuous adjoint (the unfused odeint with "
         "solvers/adjoint.py) is not ported (ROADMAP.md A7/A8)"),
        (args.checkpoint_out is not None or args.resume is not None,
         "--checkpoint-out/--resume: checkpoints are not ported (ROADMAP.md A9)"),
        (args.metrics_out is not None or args.profile_dir is not None,
         "--metrics-out/--profile-dir: metrics and profiles are not ported (ROADMAP.md A9)"),
    ]
    for hit, why in unported:
        if hit:
            raise NotImplementedError(why)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--samples", type=int, default=5000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="tiny run: 16 samples, batch 8, 100 points over 2.5 s, max_steps 512")
    p.add_argument("--adjoint", default="replay", choices=["replay", "backsolve"],
                   help="replay (discrete backprop through the frozen steps); backsolve "
                        "raises NotImplementedError")
    for flag in ("--metrics-out", "--profile-dir", "--checkpoint-out", "--resume"):
        p.add_argument(flag, default=None, help="not ported: raises")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions of the "
                        "kernels)")
    args = p.parse_args(argv)
    resolve_options(args)
    if args.smoke:
        _, hist = train_bifurcation(nr_samples=16, batch_size=8, time_points=100,
                                    total_time=2.5, max_steps=512, seed=args.seed,
                                    device=args.device)
    else:
        _, hist = train_bifurcation(nr_samples=args.samples, batch_size=args.batch_size,
                                    seed=args.seed, device=args.device)
    print(f"final loss {hist[-1]['loss']:.5f}")


if __name__ == "__main__":
    main()
