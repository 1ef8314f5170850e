"""XOR classification task (port of ``columnflow/tasks/xor.py``: the train
step on the fused engines its command line picks).

Trains the feedforward weights of a 3-column, 2-area network so that the
output column C fires high for different inputs (target 1.0) and low for
same inputs (target 0.25). The four conditions are one batch, integrated as
one (4, 72) state; RMSprop(lr 0.5, alpha 0.95) with a per-update
ExponentialLR(0.8), gradients masked to the L4e/L4i targets.

- deterministic (the default, ``stochastic=False``): adaptive dopri5 at
  rtol 1e-7 / atol 1e-9 under one controller over the batch state, the
  selection, the dense-output replay and its reverse sweep each one kernel
  (``solvers.fused.xor_odeint_dopri5_fused``);
- stochastic (``stochastic=True``): the Ito SDE with the membrane-only
  diffusion sigma = 10, SRA1 on the uniform grid with one scalar Brownian
  per lane, the rollout and its reverse sweep each one kernel
  (``solvers.fused.xor_sdeint_fused``). The Brownian integrals are drawn
  from a ``torch.Generator`` (``solvers.sde.brownian_pack``);
- stochastic-adaptive (``stochastic=True, adaptive=True``): each lane's own
  step-doubling SRA1 controller (PI, rtol = atol = 1e-3, max_steps 2048,
  the float32 drift) selects its grid on the ``jax.random`` tree, or with
  ``fused_pass`` on the krng tree (the JAX package's in-kernel pass), one
  kernel launch for the four lanes; the frozen grids are replayed in one
  lane-batched kernel and its kernel-mode reverse sweep, two half steps per
  accepted step, and interpolated onto the grid
  (``solvers.sde_adaptive.sdeint_adaptive_batch`` with ``XORSDE``). Each
  lane's raw key (B, 2) is drawn from the ``torch.Generator``.

The training run's evaluation integrates the four conditions through the
deterministic fused forward; the JAX package evaluates through its unfused
per-sample ``odeint`` (ROADMAP.md section C).

    python -m columnflow_torch.tasks.xor --smoke                  # on the card
    python -m columnflow_torch.tasks.xor --smoke --stochastic
    python -m columnflow_torch.tasks.xor --smoke --stochastic --adaptive
    python -m columnflow_torch.tasks.xor --smoke --stochastic --adaptive --fused --fused-pass
    python -m columnflow_torch.tasks.xor --smoke --device cpu

The command line resolves as the JAX package's: no flags, ``--fused`` or
``--engine fused`` train the deterministic step, ``--stochastic`` (with or
without ``--fused``) the fixed-grid SDE, ``--stochastic --adaptive`` (with
or without ``--fused``) the stochastic-adaptive step, and with ``--fused
--fused-pass`` its in-kernel selection. ``--fused-pass`` without
``--stochastic --adaptive --fused``, and ``--adaptive`` without
``--stochastic``, are a ValueError (the JAX package refuses the one and
ignores the other). Every other combination raises ``NotImplementedError``
naming its ROADMAP.md item: ``--engine xla``, ``--method`` other than
dopri5, ``--checkpoint-out``/``--resume``, ``--metrics-out``/``--profile-dir``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from columnflow_torch import resolve_device
from columnflow_torch.config import ColumnConfig
from columnflow_torch.data import prep_xor_stim, xor_conditions
from columnflow_torch.kernels.network_sde import SDEConsts
from columnflow_torch.models.xor import (
    FF_SOURCE_MASK,
    FF_TARGET_MASK,
    XOR_STATE_DIM,
    build_xor_fused_consts,
    build_xor_network,
    split_xor_params,
)
from columnflow_torch.ops.interp import step_table_knots
from columnflow_torch.ops.transfer import compute_firing_rate
from columnflow_torch.solvers.fused import xor_odeint_dopri5_fused, xor_sdeint_fused
from columnflow_torch.solvers.sde import brownian_pack
from columnflow_torch.solvers.sde_adaptive import XORSDE, sdeint_adaptive_batch
from columnflow_torch.tasks.wta import linspace
from columnflow_torch.train.optim import mask_grads, torch_rmsprop

DT = 1e-3
STIM_DURATION = 0.5
TIME_STEPS = int(STIM_DURATION * 2 / DT)
# The stochastic-adaptive step's settings (the defaults of the JAX package's
# batched_rollout, columnflow/tasks/xor.py:69-75): rtol = atol = 1e-3 are
# sdeint_adaptive_batch's defaults here too.
ADAPTIVE_MAX_STEPS = 2048


class XORTask(NamedTuple):
    params: dict
    net: object
    fc: dict  # build_xor_fused_consts(net), made once
    ts: torch.Tensor
    dt: float
    grad_mask: dict
    optimizer: torch.optim.Optimizer
    scheduler: object
    max_steps: int


def build_task(cfg: ColumnConfig, generator: torch.Generator, lr: float = 0.5,
               alpha: float = 0.95, lr_gamma: float = 0.8, time_steps: int = TIME_STEPS,
               dt: float = DT, max_steps: int = 3072, device=None) -> XORTask:
    params, net = build_xor_network(cfg, generator, device=device)
    for p in params.values():
        p.requires_grad_(True)
    ts = linspace(0.0, time_steps * dt, time_steps, device=device)
    target = torch.as_tensor(FF_TARGET_MASK, device=device)
    grad_mask = {"ff_w0": torch.tile(target, (2,))[None], "ff_w1": target[None]}
    optimizer, scheduler = torch_rmsprop([params["ff_w0"], params["ff_w1"]], lr=lr, alpha=alpha,
                                         lr_gamma=lr_gamma)
    return XORTask(params, net, build_xor_fused_consts(net, device=device), ts,
                   float((ts[1] - ts[0]).item()), grad_mask, optimizer, scheduler, max_steps)


def drift_inputs(task: XORTask, conditions):
    """What both engines' drift reads besides state and rows for the
    conditions (B, 2): the constants with the knot times, and each lane's
    knot values (K, B, 32) of its half-off, half-on stimulus (the two
    16-population slots flattened)."""
    T = task.ts.shape[0]
    on_vals = prep_xor_stim(conditions, T)[..., -1, :, :].reshape(conditions.shape[0], 32)
    kts, kv = step_table_knots(T, task.dt, torch.zeros_like(on_vals), on_vals)
    return SDEConsts(task.fc, kts), kv.contiguous()


def check_flags(stochastic: bool, adaptive: bool, fused_pass: bool) -> None:
    """Refuse what the JAX package's ``batched_rollout`` refuses
    (``fused_pass`` without the stochastic-adaptive step) and what it would
    ignore (``adaptive`` without ``stochastic``): ValueError."""
    if fused_pass and not (stochastic and adaptive):
        raise ValueError("fused_pass requires stochastic=True and adaptive=True")
    if adaptive and not stochastic:
        raise ValueError("adaptive applies to the stochastic step (the deterministic step is "
                         "adaptive dopri5 already)")


def batched_rollout(params, task: XORTask, conditions, differentiable: bool = True,
                    stochastic: bool = False, noise=None, grid=None, return_stats: bool = False,
                    adaptive: bool = False, fused_pass: bool = False, keys=None):
    """Integrate the conditions (B, 2) -> (B, T, 72).

    Deterministic (default): fused dopri5 with the task's max_steps, at the
    fused engine's rtol 1e-7 / atol 1e-9 (the JAX package's fused path
    passes neither tolerance); ``grid`` = (step_times, naccept) replays a
    given frozen grid. ``stochastic``: the uniform-grid SDE driven by
    ``noise`` = (i1, i10), each (T-1, B) or (T-1, B, 1). With ``adaptive``:
    each lane's selection (``fused_pass``: the krng tree, otherwise the
    ``jax.random`` tree) from ``keys`` (B, 2), each lane's raw key, then the
    lane-batched replay; ``grid`` = (step_times (B, M+1), naccept, nreject)
    replays given frozen grids."""
    check_flags(stochastic, adaptive, fused_pass)
    B = conditions.shape[0]
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        sc, kv = drift_inputs(task, conditions)
        pf = split_xor_params(params)
        y0 = torch.zeros((B, XOR_STATE_DIM), device=conditions.device)
        stats = None
        if stochastic and adaptive:
            if keys is None:
                raise ValueError("the adaptive step needs each lane's raw key (B, 2)")
            ys, stats = sdeint_adaptive_batch(
                XORSDE(pf, sc, kv), y0, task.ts, torch.as_tensor(keys, device=conditions.device),
                max_steps=ADAPTIVE_MAX_STEPS, return_stats=True, grid=grid,
                fused_pass=fused_pass)
        else:
            if stochastic:
                if noise is None:
                    raise ValueError("the stochastic rollout needs a Brownian noise pack")
                ys = xor_sdeint_fused(pf, sc, kv, y0, task.ts, noise)
            else:
                ys, stats = xor_odeint_dopri5_fused(pf, sc, kv, y0, task.ts,
                                                    max_steps=task.max_steps, grid=grid,
                                                    return_stats=True)
            ys = ys.transpose(0, 1)
    return (ys, stats) if return_stats else ys


def readout(ys, targets_raw):
    """The final firing rate of column C through the L2/3e source mask:
    (final_fr_C (B,), loss = mean |final - target|)."""
    fr = compute_firing_rate(ys[..., :24] - ys[..., 24:48])
    mask = torch.as_tensor(FF_SOURCE_MASK, device=ys.device)
    final_c = torch.sum(fr[:, -1, 16:] * mask, dim=-1)
    return final_c, torch.mean(torch.abs(final_c - targets_raw))


def xor_targets(conditions):
    """1.0 for different inputs, 0.25 for same."""
    diff = conditions[:, 0] != conditions[:, 1]
    return torch.where(diff, 1.0, 0.25)


def make_train_step(task: XORTask, stochastic: bool = False, adaptive: bool = False,
                    fused_pass: bool = False):
    """The training step: the JAX package's ``make_train_step(task,
    use_fused=True, stochastic=..., adaptive=..., fused_pass=...)``:
    deterministic, the fixed-grid SDE (``stochastic``), or the
    stochastic-adaptive step (``stochastic`` and ``adaptive``, with
    ``fused_pass`` its in-kernel selection). ``train_step(conditions,
    noise=None, grid=None, keys=None)``: the fixed-grid step needs ``noise``
    = (i1, i10), the adaptive step ``keys`` (B, 2), each lane's raw key. It
    updates ``task.params`` in place, leaves the masked gradients in their
    ``.grad`` and returns a dict with loss, out (tensors) and the
    selection's stats (None for the fixed-grid step)."""
    check_flags(stochastic, adaptive, fused_pass)
    params = task.params

    def train_step(conditions, noise=None, grid=None, keys=None):
        task.optimizer.zero_grad(set_to_none=True)
        ys, stats = batched_rollout(params, task, conditions, stochastic=stochastic,
                                    noise=noise, grid=grid, return_stats=True, adaptive=adaptive,
                                    fused_pass=fused_pass, keys=keys)
        out, loss = readout(ys, xor_targets(conditions))
        loss.backward()
        with torch.no_grad():
            grads = mask_grads({k: p.grad for k, p in params.items()}, task.grad_mask)
            for k, p in params.items():
                p.grad.copy_(grads[k])
        task.optimizer.step()
        task.scheduler.step()
        return {"loss": loss.detach(), "out": out.detach(), "stats": stats}

    return train_step


def evaluate(task: XORTask, conditions):
    """(final_fr_C, loss) of the conditions through the deterministic
    fused forward, without gradients."""
    with torch.no_grad():
        ys = batched_rollout(task.params, task, conditions, differentiable=False)
        return readout(ys, xor_targets(conditions))


def train_xor(nr_samples: int = 160, batch_size: int = 4, seed: int = 0,
              time_steps: int | None = None, max_steps: int | None = None,
              stochastic: bool = False, adaptive: bool = False, fused_pass: bool = False,
              smoke: bool = False, device=None):
    """Training run: nr_samples // batch_size steps, each over the four
    conditions in an order drawn from a ``torch.Generator`` seeded with
    ``seed`` (which also draws the fixed-grid step's Brownian integrals and
    the adaptive step's lane keys), each followed by an evaluation of the
    four conditions. ``smoke``: 8 samples, and unless given 200 grid points
    and max_steps 1024 (otherwise TIME_STEPS and 3072; the deterministic
    selection's budget: the adaptive step's is ``ADAPTIVE_MAX_STEPS``).
    Returns (params, history)."""
    if smoke:
        nr_samples = 8
    time_steps = time_steps or (200 if smoke else TIME_STEPS)
    max_steps = max_steps or (1024 if smoke else 3072)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    task = build_task(ColumnConfig.load(), gen, time_steps=time_steps, max_steps=max_steps,
                      device=dev)
    step = make_train_step(task, stochastic=stochastic, adaptive=adaptive, fused_pass=fused_pass)
    conds_all = torch.as_tensor(xor_conditions(), device=dev)
    history = []
    for _ in range(nr_samples // batch_size):
        conds = conds_all[torch.randperm(4, generator=gen, device=dev)]
        noise = keys = None
        if stochastic and adaptive:
            keys = torch.randint(0, 2**32, (conds.shape[0], 2), generator=gen, device=dev,
                                 dtype=torch.int64)
        elif stochastic:
            _, i1, i10, _, _ = brownian_pack(gen, task.ts, (conds.shape[0], 1))
            noise = (i1, i10)
        rec = step(conds, noise, keys=keys)
        final_c, test_loss = evaluate(task, conds_all)
        out = final_c.cpu().numpy()
        acc = float(np.mean((out > (out.min() + out.max()) / 2)
                            == np.asarray([True, True, False, False])))
        entry = {"loss": float(rec["loss"]), "test_loss": float(test_loss), "acc": acc,
                 "final_fr": out.tolist()}
        if adaptive:
            stats = rec["stats"]
            entry.update(naccept=stats.naccept.tolist(), nreject=stats.nreject.tolist(),
                         success=stats.success.tolist())
        history.append(entry)
    return task.params, history


def resolve_mode(args) -> dict:
    """The ported step that the JAX package's flags select, as
    ``train_xor``'s ``stochastic``, ``adaptive`` and ``fused_pass``. As in
    the JAX command line an explicit ``--fused`` or ``--fused-pass``
    overrides ``--engine``, and ``--engine auto`` at the XOR network's 3
    columns picks the fused engine. ``--fused-pass`` without ``--stochastic
    --adaptive --fused`` is a ValueError (the JAX package's
    ``batched_rollout`` refuses it), as is ``--adaptive`` without
    ``--stochastic`` (it would ignore it). What resolves to an unported path
    raises ``NotImplementedError`` naming the ROADMAP.md item that ports
    it."""
    if args.fused_pass and not (args.stochastic and args.adaptive and args.fused):
        raise ValueError("--fused-pass requires --stochastic --adaptive --fused (the in-kernel "
                         "selection of the fused stochastic-adaptive step)")
    if args.adaptive and not args.stochastic:
        raise ValueError("--adaptive applies to the stochastic step (--stochastic); the "
                         "deterministic step is adaptive dopri5 already")
    unported = [
        (args.ode_method != "dopri5",
         f"--method {args.ode_method}: only dopri5 is ported (ROADMAP.md A7: the other "
         "tableaus and the unfused solvers/dopri.py)"),
        (args.checkpoint_out is not None or args.resume is not None,
         "--checkpoint-out/--resume: checkpoints are not ported (ROADMAP.md A9)"),
        (args.metrics_out is not None or args.profile_dir is not None,
         "--metrics-out/--profile-dir: metrics and profiles are not ported (ROADMAP.md A9)"),
        (not args.fused and args.engine == "xla" and args.adaptive,
         "--engine xla --stochastic --adaptive: the XLA engine's adaptive SDE (the unfused "
         "sdeint_adaptive_batch on xor_drift, or the vmapped sdeint_adaptive) is not ported "
         "(ROADMAP.md A7)"),
        (not args.fused and args.engine == "xla",
         "--engine xla: the XLA engine (the unfused per-sample odeint and sdeint) is not "
         "ported (ROADMAP.md A7)"),
    ]
    for hit, why in unported:
        if hit:
            raise NotImplementedError(why)
    return {"stochastic": args.stochastic, "adaptive": args.adaptive,
            "fused_pass": args.fused_pass}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--samples", type=int, default=160)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="tiny run: 8 samples, 200 grid points, max_steps 1024")
    p.add_argument("--engine", default="auto", choices=["auto", "xla", "fused"],
                   help="auto and fused run the fused engines; xla raises NotImplementedError")
    p.add_argument("--fused", action="store_true", help="the fused engine (the default)")
    p.add_argument("--stochastic", action="store_true",
                   help="train through the Ito SDE: SRA1 on the uniform grid")
    p.add_argument("--adaptive", action="store_true",
                   help="with --stochastic: each lane's adaptive step-doubling SRA1 on the "
                        "jax.random tree's path, then the lane-batched replay of the frozen "
                        "grids with their gradients")
    p.add_argument("--fused-pass", action="store_true",
                   help="with --stochastic --adaptive --fused: the selection on the krng tree "
                        "(the JAX package's in-kernel pass)")
    p.add_argument("--method", default="dopri5", dest="ode_method",
                   help="only dopri5 is ported; anything else raises NotImplementedError")
    for flag in ("--metrics-out", "--profile-dir", "--checkpoint-out", "--resume"):
        p.add_argument(flag, default=None, help="not ported: raises")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions of the "
                        "kernels)")
    args = p.parse_args(argv)
    mode = resolve_mode(args)
    _, hist = train_xor(nr_samples=args.samples, seed=args.seed, smoke=args.smoke,
                        device=args.device, **mode)
    print(f"final loss {hist[-1]['loss']:.5f} | acc {hist[-1]['acc']:.2f}")


if __name__ == "__main__":
    main()
