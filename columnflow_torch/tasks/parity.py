"""4-bit parity classification task (port of ``columnflow/tasks/parity.py``:
the deterministic fused-dopri5 training step and the stochastic-adaptive
fused-pass one).

A 3-area hierarchical column network learns to output ~20 Hz for even
parity and ~0 for odd: readout = output-weighted mean L2/3e-family rate of
the final column over the last 100 grid points. Two training steps are
ported, selected as in the JAX package:

- deterministic (the default, ``stochastic=False``): the batch is
  integrated as one ODE state by adaptive dopri5 at rtol 1e-7 / atol 1e-9
  (the fused engine's own tolerances) under one shared controller: step-size
  selection, the dense-output replay and its reverse sweep each one kernel
  (``solvers.fused.odeint_dopri5_fused``). Below 104 columns the f32-exact
  engine; from 104 through 312 columns (``split2=True``) the
  ``fused-split2`` tier, whose weight gradients are taken outside the
  kernels;
- stochastic (``stochastic=True``, the 104-column flagship's flags
  ``--stochastic --adaptive --fused --fused-pass --select-bf16 --grad-bf16
  --split2``): the Ito SDE with adaptive step-doubling SRA1, per-lane
  selection in the selection kernel, one lane-batched replay over the frozen
  grids and its reverse sweep (``solvers.sde_adaptive``). The Brownian paths
  come from the krng tree; each lane's tree key words are drawn from a
  ``torch.Generator``.

Both end in the loss (scaled), masked gradients, max-prescaled global norm,
optional clipping, a skip on non-finite (and, unclipped, exploding)
gradients, Adam and the weight clamps.

    python -m columnflow_torch.tasks.parity --smoke                # on the card
    python -m columnflow_torch.tasks.parity --smoke --columns-per-area 64,32,8  # split2 tier
    python -m columnflow_torch.tasks.parity --smoke --device cpu
    python -m columnflow_torch.tasks.parity --smoke --stochastic --adaptive \
        --fused --fused-pass --select-bf16 --grad-bf16 --split2

Every other combination of the JAX package's flags raises
``NotImplementedError`` naming its ROADMAP.md item: ``--engine xla`` or past
312 columns (the unfused ``solvers/dopri.py``), the split2 tier at 63
columns or fewer (its weight gradients in the kernel), ``--method`` other
than dopri5 (the other tableaus), a stochastic run with only some of the
flagship's flags (the fixed-grid SDE A6a, the XLA selection A5a),
``--random-fan-in``/``--legacy-host-rng`` (A3), ``--position-invariant``
and ``--reference-rails`` (A6b), and checkpoints, metrics, profiles and
evaluation (``--metrics-out``, ``--profile-dir``, ``--checkpoint-out``,
``--resume``, ``--eval``, ``--eval-demo``: A9). ``--split2`` without
``--fused`` is a ValueError, as in the JAX package. There is no
``--rtol``/``--atol``: the fused path runs 1e-7 / 1e-9 whatever they say.
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
from columnflow_torch.solvers.fused import odeint_dopri5_fused, outer_by_default
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
    """The system both paths integrate for a batch of input patterns: the
    premixed weights (differentiable), the drift constants and, per lane,
    the knot values of its half-off, half-on stimulus."""
    fc = build_network_fused_consts(task.net, device=stims_raw.device)
    kts, kv = step_table_knots(task.ts.shape[0], task.dt, torch.zeros_like(stims_raw),
                               stims_raw)
    return PremixedNetworkSDE(premix_network_weights(params, task.net), SDEConsts(fc, kts),
                              kv.contiguous())


def batched_rollout(params, task: ParityTask, stims_raw, lane_words=None,
                    differentiable: bool = True, adaptive_bptt_every: int | None = None,
                    grid=None, return_stats: bool = False, stochastic: bool = False,
                    split2: bool = False):
    """Integrate a batch of input patterns: (B, n_inputs) -> (B, T, 3P).

    Deterministic (default): fused dopri5 over the whole batch state with
    the task's max_steps, at the fused engine's rtol 1e-7 / atol 1e-9 (the
    JAX package's fused path passes neither tolerance on either); with
    ``split2`` the ``fused-split2`` tier.
    ``grid`` = (step_times, naccept) replays a given frozen grid.

    ``stochastic``: the flagship path, at rtol = atol = 1e-3. ``lane_words``
    (B, 2): each lane's Brownian tree key words (uint32 values in int64).
    ``grid`` = (step_times, naccept, nreject)."""
    dev = stims_raw.device
    B = stims_raw.shape[0]
    y0 = torch.zeros((B, 3 * task.net.num_pops), device=dev)
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        model = sde_model(params, task, stims_raw)
        if stochastic:
            ys, stats = sdeint_adaptive_batch(
                model, y0, task.ts, torch.as_tensor(lane_words, device=dev),
                max_steps=task.max_steps, bptt_every=adaptive_bptt_every,
                return_stats=True, grid=grid)
        else:
            ys, stats = odeint_dopri5_fused(model.pw, model.sc, model.kv, y0, task.ts,
                                            max_steps=task.max_steps, grid=grid,
                                            return_stats=True, split2=split2)
            ys = ys.transpose(0, 1)
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


def make_train_step(task: ParityTask, stochastic: bool = False, loss_scale: float = 1.0,
                    bptt_every: int | None = None, clip_grad_norm: float | None = None,
                    split2: bool = False):
    """The training step. ``stochastic=False``: the JAX package's
    ``make_train_step(task, use_fused=True)``, deterministic fused dopri5,
    or with ``split2`` its ``make_train_step(task, use_fused=True,
    split2=True)``, the ``fused-split2`` tier; ``train_step(stims_raw,
    grid=None)``. ``stochastic=True``: its flags ``use_fused, stochastic, adaptive,
    fused_pass, select_bf16, grad_bf16, split2``; ``train_step(stims_raw,
    lane_words, grid=None)``.

    The step updates ``task.params`` in place (unless the update is
    skipped), leaves the masked, clipped gradients in their ``.grad``, and
    returns a dict with loss, out, gnorm (tensors), ok (bool) and the
    selection stats. Reading ``ok`` waits for the device once per step."""
    params = task.params
    if bptt_every is not None and not stochastic:
        raise ValueError("bptt_every truncates the stochastic path's reverse sweep; "
                         "the deterministic step has no truncation")
    if stochastic and split2:
        raise ValueError("split2 selects the deterministic engine's tier; the stochastic "
                         "step always runs its own split2 replay")

    def train_step(stims_raw, lane_words=None, grid=None):
        if stochastic and lane_words is None:
            raise ValueError("the stochastic step needs each lane's tree key words")
        task.optimizer.zero_grad(set_to_none=True)
        ys, stats = batched_rollout(params, task, stims_raw, lane_words,
                                    adaptive_bptt_every=bptt_every, grid=grid,
                                    return_stats=True, stochastic=stochastic,
                                    split2=split2)
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
                 stochastic: bool = False, loss_scale: float = 1.0,
                 bptt_every: int | None = None, clip_grad_norm: float | None = None,
                 smoke: bool = False, device=None, split2: bool = False):
    """Training run, deterministic unless ``stochastic`` (with ``split2``
    the deterministic ``fused-split2`` tier). Batches (and the
    stochastic path's tree key words) are drawn from a ``torch.Generator``
    seeded with ``seed``. ``smoke``: 8 samples, batch 4, and unless given
    200 grid points and max_steps 1024 (otherwise TIME_STEPS and 3072).
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
    step = make_train_step(task, stochastic=stochastic, loss_scale=loss_scale,
                           bptt_every=bptt_every, clip_grad_norm=clip_grad_norm,
                           split2=split2)

    def lane_words(n, g=gen):
        if not stochastic:
            return None
        return torch.randint(0, 2**32, (n, 2), generator=g, device=dev, dtype=torch.int64)

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
    with torch.no_grad():
        ys = batched_rollout(task.params, task, eval_stims,
                             lane_words(eval_stims.shape[0], eval_gen),
                             differentiable=False, stochastic=stochastic, split2=split2)
        out = readout(ys, task.params, task.net)
    targets = parity_targets(eval_stims)
    acc = float(torch.mean(((out > TARGET_EVEN / 2) == (targets > 0)).float()))
    history.append({"acc": acc, "readouts": out.tolist()})
    return task.params, history


_FLAGSHIP_FLAGS = ("adaptive", "fused", "fused_pass", "select_bf16", "grad_bf16", "split2")
# resolve_engine's bands (columnflow/tasks/parity.py:725-726): the split2
# tier from 104 through 312 columns, the XLA engine past that.
_SPLIT2_MIN_COLUMNS, _FUSED_MAX_COLUMNS = 104, 312


def resolve_mode(args, total_columns: int) -> dict:
    """The ported step that the JAX package's flags select, as
    ``train_parity``'s ``stochastic`` and ``split2``. As in the JAX command
    line, any explicit solver flag overrides ``--engine``: ``--fused``
    alone is the f32-exact engine, ``--fused --split2`` the split2 tier,
    ``--split2`` without ``--fused`` a ValueError (the JAX package's
    ``batched_rollout`` refuses it). Without such a flag ``--engine`` (auto
    by default) picks: fused, fused-split2, or by the column count the
    exact engine below 104 columns and the split2 tier through 312. The
    stochastic flagship takes all seven of its flags. Anything else raises
    ``NotImplementedError`` naming the ROADMAP.md item that ports it."""
    unported = [
        (args.random_fan_in or args.legacy_host_rng,
         "--random-fan-in/--legacy-host-rng: randomized fan-in masks are not ported "
         "(ROADMAP.md A3)"),
        (args.position_invariant,
         "--position-invariant: training on all 2^n patterns is not ported (ROADMAP.md A6b)"),
        (args.reference_rails,
         "--reference-rails: stepping on a non-finite gradient is not ported (ROADMAP.md A6b)"),
        (any(getattr(args, f) is not None for f in
             ("metrics_out", "profile_dir", "checkpoint_out", "resume", "eval_ckpt"))
         or args.eval_demo,
         "--metrics-out/--profile-dir/--checkpoint-out/--resume/--eval/--eval-demo: metrics, "
         "profiles, checkpoints and evaluation are not ported (ROADMAP.md A9)"),
    ]
    for hit, why in unported:
        if hit:
            raise NotImplementedError(why)
    if args.method != "dopri5":
        raise NotImplementedError(
            f"--method {args.method}: only dopri5 is ported (ROADMAP.md A7: the other "
            "tableaus and the unfused solvers/dopri.py)")
    if args.stochastic:
        missing = [f for f in _FLAGSHIP_FLAGS if not getattr(args, f)]
        if not args.adaptive:
            raise NotImplementedError(
                "--stochastic without --adaptive (alone or with --fused): the fixed-grid SDE "
                "step is not ported (ROADMAP.md A6a); the ported stochastic step takes all of "
                "--adaptive --fused --fused-pass --select-bf16 --grad-bf16 --split2, and the "
                "adaptive step's XLA selection is ROADMAP.md A5a")
        if missing or args.engine not in (None, "auto"):
            raise NotImplementedError(
                "the stochastic step is ported with all of --adaptive --fused --fused-pass "
                "--select-bf16 --grad-bf16 --split2 (missing: "
                f"{', '.join('--' + f.replace('_', '-') for f in missing) or 'none'}; "
                f"--engine {args.engine}): the adaptive step's XLA selection (--adaptive "
                "without --fused-pass) is ROADMAP.md A5a")
        return {"stochastic": True, "split2": False}
    stray = [f for f in ("adaptive", "fused_pass", "select_bf16", "grad_bf16")
             if getattr(args, f)]
    if stray:
        raise NotImplementedError(
            f"--{stray[0].replace('_', '-')} belongs to the stochastic step (add "
            "--stochastic and the flagship's other flags); the deterministic step takes "
            "no other solver flag (ROADMAP.md A5a)")
    if args.split2 and not args.fused:
        raise ValueError("split2 is the fused engines' scale tier; it requires --fused "
                         "(or --engine fused-split2)")
    if args.fused:
        split2 = args.split2
    else:
        engine = args.engine or "auto"
        if engine == "xla" or (engine == "auto" and total_columns > _FUSED_MAX_COLUMNS):
            raise NotImplementedError(
                f"--engine {engine} at {total_columns} columns: the XLA engine (the unfused "
                "solvers/dopri.py) is not ported (ROADMAP.md A7)")
        split2 = engine == "fused-split2" or (
            engine == "auto" and total_columns >= _SPLIT2_MIN_COLUMNS)
    if split2 and not outer_by_default(8 * total_columns, 4):
        raise NotImplementedError(
            f"the split2 tier at {total_columns} columns takes its weight gradients in the "
            "reverse-sweep kernel (arg_grads 'auto' -> 'kernel': the weights hold at most "
            "1 MiB), which is not ported: ROADMAP.md B8s (B8 kernel mode with the split2 "
            "prepare)")
    return {"stochastic": False, "split2": split2}


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
                       help="the JAX package's solver flag: --fused alone runs the "
                            "f32-exact fused dopri5 step, --fused --split2 its split2 tier, "
                            "all seven the stochastic flagship; any other combination "
                            "raises")
    p.add_argument("--engine", choices=("auto", "fused", "xla", "fused-split2"), default=None,
                   help="deterministic engine when no solver flag is given: auto (by "
                        "the column count: fused below 104, fused-split2 through 312), "
                        "fused, fused-split2; xla raises NotImplementedError")
    p.add_argument("--method", default="dopri5",
                   help="only dopri5 is ported; anything else raises NotImplementedError")
    p.add_argument("--bptt-every", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--clip-grad-norm", type=float, default=None)
    p.add_argument("--loss-scale", type=float, default=1.0)
    p.add_argument("--columns-per-area", default=None, metavar="N,N,...",
                   help="comma-separated columns per area (default 8,4,1; "
                        "64,32,8 for the 104-column flagship)")
    for flag in ("random-fan-in", "legacy-host-rng", "position-invariant", "reference-rails",
                 "eval-demo"):
        p.add_argument(f"--{flag}", action="store_true", help="not ported: raises")
    for flag in ("--metrics-out", "--profile-dir", "--checkpoint-out", "--resume"):
        p.add_argument(flag, default=None, help="not ported: raises")
    p.add_argument("--eval", default=None, metavar="CKPT", dest="eval_ckpt",
                   help="not ported: raises")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)
    cpa = ((8, 4, 1) if args.columns_per_area is None
           else tuple(int(x) for x in args.columns_per_area.split(",")))
    _, hist = train_parity(
        nr_samples=args.samples, batch_size=args.batch_size, seed=args.seed,
        columns_per_area=cpa, max_steps=args.max_steps,
        **resolve_mode(args, sum(cpa)),
        loss_scale=args.loss_scale,
        bptt_every=args.bptt_every, clip_grad_norm=args.clip_grad_norm, smoke=args.smoke,
        device=args.device)
    final = next(h for h in reversed(hist) if "loss" in h)
    print(f"final loss {final['loss']:.5f} | acc {hist[-1]['acc']:.2f}")


if __name__ == "__main__":
    main()
