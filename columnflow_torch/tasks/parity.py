"""4-bit parity classification task (port of ``columnflow/tasks/parity.py``:
the fused engines' training steps).

A 3-area hierarchical column network learns to output ~20 Hz for even
parity and ~0 for odd: readout = output-weighted mean L2/3e-family rate of
the final column over the last 100 grid points. The training steps are
selected by the JAX package's flags (``make_train_step``):

- deterministic (the default): the batch is integrated as one ODE state by
  adaptive dopri5 at rtol 1e-7 / atol 1e-9 (the fused engine's own
  tolerances) under one shared controller: step-size selection, the
  dense-output replay and its reverse sweep each one kernel
  (``solvers.fused.odeint_dopri5_fused``). Below 104 columns the f32-exact
  engine (``--engine fused`` through 312), its weight gradients in the
  reverse sweep through 63 columns and outside it from 64, as the JAX
  package takes them; from 104 through 312 columns (``split2=True``; at
  any width with ``--engine fused-split2`` or ``--fused --split2``) the
  ``fused-split2`` tier, by the same rule (the reverse-sweep kernel B8s
  through 63 columns);
- ``stochastic``: the Ito SDE (sigma = 10 on the whole state, one scalar
  Brownian per lane). On the fixed grid (SRA1 over ``task.ts`` through
  ``solvers.fused.sdeint_fused`` on the three-term split: below 64 columns
  in kernel mode, from 64 through 312 columns, where the weights hold more
  than 1 MiB, in outer mode, the weight gradients taken outside the
  reverse sweep as the JAX package takes them), or
  with ``adaptive``: step-doubling SRA1 with a PI controller per lane
  (``solvers.sde_adaptive.sdeint_adaptive_batch``), then one lane-batched
  replay over the frozen grids and its reverse sweep. ``fused_pass``: the
  selection draws from the krng tree (the JAX package's in-kernel pass);
  otherwise from the ``jax.random`` tree (its XLA pass). ``select_bf16``:
  the bf16 selection drift, else the float32 one (the in-kernel pass: the
  three-term split); ``split2`` with ``grad_bf16``: the two-term replay
  with the bf16 weight gradients outside the kernels; ``split2`` alone: the
  two-term replay with its exact weight gradients, in the reverse sweep
  through 63 columns (B4s) and outside it from 64
  (``outer_arg_grads_split2``); otherwise the
  three-term replay, its weight gradients in the reverse sweep through 63
  columns and outside it from 64 (exact, or with ``grad_bf16`` the bf16
  substitute, which takes them outside at every width).

All end in the loss (scaled), masked gradients, max-prescaled global norm,
optional clipping, a skip on non-finite (and, unclipped, exploding)
gradients, Adam and the weight clamps. Each lane's Brownian tree key (raw
key data) or the fixed grid's noise pack is drawn from a
``torch.Generator`` (``train_parity``), or handed in (the tests hand in the
JAX package's).

    python -m columnflow_torch.tasks.parity --smoke                # on the card
    python -m columnflow_torch.tasks.parity --smoke --columns-per-area 64,32,8  # split2 tier
    python -m columnflow_torch.tasks.parity --smoke --engine fused --columns-per-area 64,32,8 \
        --max-steps 16384                                      # the f32-exact engine there
    # at 312 columns (192,96,24) its selection needs ~2.1e4 accepted steps for the
    # second: --max-steps 32768 (16384 ends at ~0.79 s; tools/exact312_step.py)
    python -m columnflow_torch.tasks.parity --smoke --device cpu
    python -m columnflow_torch.tasks.parity --smoke --stochastic   # the fixed-grid SDE
    python -m columnflow_torch.tasks.parity --smoke --stochastic --columns-per-area 64,32,8
    python -m columnflow_torch.tasks.parity --smoke --stochastic --adaptive
    python -m columnflow_torch.tasks.parity --smoke --stochastic --adaptive \
        --columns-per-area 64,32,8 --max-steps 16384 --bptt-every 32 \
        --clip-grad-norm 1.0 --loss-scale 1e-6     # bench.py's primary configuration
    python -m columnflow_torch.tasks.parity --smoke --stochastic --adaptive \
        --fused --fused-pass --select-bf16 --grad-bf16 --split2
    python -m columnflow_torch.tasks.parity --smoke --stochastic --adaptive \
        --engine fused --columns-per-area 64,32,8 --max-steps 16384 --bptt-every 32 \
        --clip-grad-norm 1.0 --loss-scale 1e-6     # the f32-exact engine at 104 columns
    python -m columnflow_torch.tasks.parity --smoke --stochastic --columns-per-area 16,8,8
    python -m columnflow_torch.tasks.parity --smoke --engine fused-split2 \
        --columns-per-area 16,8,8                  # split2 in kernel mode (B8s)
    python -m columnflow_torch.tasks.parity --smoke --stochastic --adaptive \
        --engine fused-split2 --columns-per-area 16,8,8   # B4s
    python -m columnflow_torch.tasks.parity --smoke --stochastic --adaptive \
        --engine fused-split2 --columns-per-area 64,32,8 --max-steps 16384
                                                   # the exact split2 outer pass

``resolve_mode`` resolves the command line's flags as the JAX package's
``main`` does (explicit engine flags switch ``--engine`` off). Every
combination that resolves to an unported path raises
``NotImplementedError`` naming its ROADMAP.md item: the XLA engine
(``--engine xla``, past 312 columns, an explicit flag without ``--fused``,
the stochastic-adaptive step past 8 lanes at 104 columns or more: A7),
``--method`` other than dopri5 (A7),
``--random-fan-in``/``--legacy-host-rng``
(A3), ``--position-invariant`` and ``--reference-rails`` (A6b), and
checkpoints, metrics, profiles and evaluation (A9). A flag that the JAX
package would reject is a ValueError; so is one that it would ignore.
There is no ``--rtol``/``--atol``: the fused path runs 1e-7 / 1e-9 whatever
they say.
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
from columnflow_torch.solvers.fused import (
    sde_tier,
    odeint_dopri5_fused,
    sdeint_fused,
)
from columnflow_torch.solvers.sde import brownian_pack
from columnflow_torch.solvers.sde_adaptive import (
    PremixedNetworkSDE,
    resolve_selection,
    sdeint_adaptive_batch,
)
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


class Flags(NamedTuple):
    """The JAX package's solver flags of the fused engines (``use_fused`` is
    implied: the port has no XLA engine)."""

    stochastic: bool = False
    adaptive: bool = False
    fused_pass: bool = False
    select_bf16: bool = False
    grad_bf16: bool = False
    split2: bool = False


def check_flags(f: Flags, total_columns: int | None = None) -> None:
    """Refuse what the JAX package's ``batched_rollout`` refuses (ValueError)
    and what it would ignore, and, given the column count, what resolves to
    an unported tier (NotImplementedError naming its ROADMAP.md item)."""
    if (f.fused_pass or f.grad_bf16) and not (f.stochastic and f.adaptive):
        raise ValueError("fused_pass and grad_bf16 require stochastic=True and adaptive=True")
    if f.split2 and f.stochastic and not f.adaptive:
        raise ValueError("split2 is the fused engines' scale tier; it requires the deterministic "
                         "path or stochastic=True with adaptive=True")
    if f.adaptive and not f.stochastic:
        raise ValueError("adaptive applies to the stochastic step (the deterministic step is "
                         "adaptive dopri5 already)")
    if f.select_bf16 and not f.adaptive:
        raise ValueError("select_bf16 picks the adaptive selection's drift; without adaptive "
                         "it would be ignored")
    if total_columns is None or not (f.stochastic and f.adaptive):
        return  # the fixed-grid step has a ported tier at every fused width
    P = 8 * total_columns
    meta = {"wT": torch.empty(P, P, device="meta"), "iwT": torch.empty(4, P, device="meta")}
    resolve_selection(f.fused_pass, None, f.select_bf16)
    sde_tier(meta, "split2" if f.split2 else "split", "gradbf16" if f.grad_bf16 else None,
              "auto", True)


def batched_rollout(params, task: ParityTask, stims_raw, lane_words=None,
                    differentiable: bool = True, adaptive_bptt_every: int | None = None,
                    grid=None, return_stats: bool = False, noise=None, **flags):
    """Integrate a batch of input patterns: (B, n_inputs) -> (B, T, 3P).

    ``flags`` (``Flags``'s fields) select the engine. Deterministic
    (default): fused dopri5 over the whole batch state with the task's
    max_steps, at the fused engine's rtol 1e-7 / atol 1e-9 (the JAX
    package's fused path passes neither tolerance on either); with
    ``split2`` the ``fused-split2`` tier. ``grid`` = (step_times, naccept)
    replays a given frozen grid.

    ``stochastic`` without ``adaptive``: SRA1 on the uniform grid of
    ``task.ts`` on the three-term split, driven by ``noise`` = (i1, i10),
    each (T-1, B) (or (T-1, B, 1)); ``arg_grads`` "auto" takes the weight
    gradients in the reverse sweep below 64 columns and outside it from 64
    on, as the JAX package does. With ``adaptive``: rtol = atol = 1e-3,
    ``lane_words`` (B, 2) each lane's raw key; ``grid`` = (step_times,
    naccept, nreject)."""
    f = Flags(**flags)
    check_flags(f)
    dev = stims_raw.device
    B = stims_raw.shape[0]
    y0 = torch.zeros((B, 3 * task.net.num_pops), device=dev)
    stats = None
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        model = sde_model(params, task, stims_raw)
        if f.stochastic and f.adaptive:
            if lane_words is None:
                raise ValueError("the adaptive step needs each lane's tree key words (raw key "
                                 "data, (B, 2))")
            ys, stats = sdeint_adaptive_batch(
                model, y0, task.ts, torch.as_tensor(lane_words, device=dev),
                max_steps=task.max_steps, bptt_every=adaptive_bptt_every,
                return_stats=True, grid=grid, fused_pass=f.fused_pass,
                select_bf16=f.select_bf16, prepare="split2" if f.split2 else "split",
                grad_bf16=f.grad_bf16)
        elif f.stochastic:
            if noise is None:
                raise ValueError("the fixed-grid step needs its noise pack (i1, i10)")
            ys = sdeint_fused(model.pw, model.sc, model.kv, y0, ts=task.ts, noise_pack=noise,
                              prepare="split", vjp_drift=None).transpose(0, 1)
        else:
            ys, stats = odeint_dopri5_fused(model.pw, model.sc, model.kv, y0, task.ts,
                                            max_steps=task.max_steps, grid=grid,
                                            return_stats=True, split2=f.split2)
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


def make_train_step(task: ParityTask, loss_scale: float = 1.0, bptt_every: int | None = None,
                    clip_grad_norm: float | None = None, **flags):
    """The JAX package's ``make_train_step(task, use_fused=True, **flags)``
    with ``flags`` the fields of ``Flags``: the deterministic fused dopri5
    (no flags; ``split2``: the ``fused-split2`` tier), the fixed-grid SDE
    (``stochastic``), or the stochastic-adaptive step (``stochastic``,
    ``adaptive`` and its tiers). ``train_step(stims_raw, lane_words=None,
    grid=None, noise=None)``: the adaptive step takes each lane's raw key
    (``lane_words`` (B, 2)), the fixed-grid step its noise pack.

    The step updates ``task.params`` in place (unless the update is
    skipped), leaves the masked, clipped gradients in their ``.grad``, and
    returns a dict with loss, out, gnorm (tensors), ok (bool) and the
    selection stats (None on the fixed grid). Reading ``ok`` waits for the
    device once per step."""
    params = task.params
    f = Flags(**flags)
    check_flags(f)
    if bptt_every is not None and not f.adaptive:
        raise ValueError("bptt_every truncates the adaptive replay's reverse sweep; the "
                         "deterministic and fixed-grid steps have no truncation")

    def train_step(stims_raw, lane_words=None, grid=None, noise=None):
        task.optimizer.zero_grad(set_to_none=True)
        ys, stats = batched_rollout(params, task, stims_raw, lane_words,
                                    adaptive_bptt_every=bptt_every, grid=grid,
                                    return_stats=True, noise=noise, **f._asdict())
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
                 clip_grad_norm: float | None = None, smoke: bool = False, device=None,
                 **flags):
    """Training run with the step ``flags`` select (``make_train_step``).
    Batches, each adaptive lane's raw key and the fixed grid's noise packs
    are drawn from a ``torch.Generator`` seeded with ``seed``. ``smoke``: 8
    samples, batch 4, and unless given 200 grid points and max_steps 1024
    (otherwise TIME_STEPS and 3072). Returns (params, history); the last
    record holds the accuracy over the fixed-position patterns."""
    f = Flags(**flags)
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
                           clip_grad_norm=clip_grad_norm, **f._asdict())

    def draws(n, g=gen):
        """(lane keys, noise pack) of a batch of n lanes for this step."""
        if f.stochastic and f.adaptive:
            return torch.randint(0, 2**32, (n, 2), generator=g, device=dev,
                                 dtype=torch.int64), None
        if f.stochastic:
            _, i1, i10, _, _ = brownian_pack(g, task.ts, (n, 1))
            return None, (i1, i10)
        return None, None

    history = []
    for _ in range(nr_samples // batch_size):
        stims = make_parity_batch(gen, n_inputs, batch_size, device=dev)
        keys, noise = draws(batch_size)
        rec = step(stims, keys, noise=noise)
        stats = rec["stats"]
        entry = {"loss": float(rec["loss"]), "grad_norm": float(rec["gnorm"]),
                 "update_applied": int(rec["ok"])}
        if stats is not None:
            entry.update(naccept=stats.naccept.tolist(), nreject=stats.nreject.tolist(),
                         success=stats.success.tolist())
        history.append(entry)
    eval_stims = torch.as_tensor(parity_combinations(n_inputs), device=dev)
    eval_gen = torch.Generator(device=dev).manual_seed(1234)
    with torch.no_grad():
        keys, noise = draws(eval_stims.shape[0], eval_gen)
        ys = batched_rollout(task.params, task, eval_stims, keys, differentiable=False,
                             noise=noise, **f._asdict())
        out = readout(ys, task.params, task.net)
    targets = parity_targets(eval_stims)
    acc = float(torch.mean(((out > TARGET_EVEN / 2) == (targets > 0)).float()))
    history.append({"acc": acc, "readouts": out.tolist()})
    return task.params, history


# resolve_engine's bands (columnflow/tasks/parity.py:725-726): the split2
# tier from 104 through 312 columns, the XLA engine past that; the
# stochastic-adaptive step takes XLA past 8 lanes from 104 columns on.
_SPLIT2_MIN_COLUMNS, _FUSED_MAX_COLUMNS, _FUSED_MAX_LANES = 104, 312, 8
_ENGINE_FLAGS = ("fused", "split2", "select_bf16", "grad_bf16", "fused_pass")


def resolve_engine(engine: str, total_columns: int, stochastic: bool = False,
                   adaptive: bool = False, batch_size: int | None = None) -> dict:
    """The JAX package's ``resolve_engine`` (``columnflow/tasks/parity.py:
    729-788``): the flags {use_fused, split2, select_bf16, grad_bf16} that
    ``--engine`` picks for the network's size."""
    base = dict(use_fused=False, split2=False, select_bf16=False, grad_bf16=False)
    if engine == "xla":
        return base
    if engine == "fused":
        return dict(base, use_fused=True)
    if engine == "fused-split2":
        return dict(base, use_fused=True, split2=True)
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}: use auto|xla|fused|fused-split2")
    if (stochastic and adaptive and batch_size is not None and batch_size > _FUSED_MAX_LANES
            and total_columns >= _SPLIT2_MIN_COLUMNS):
        return dict(base, select_bf16=True)
    if total_columns > _FUSED_MAX_COLUMNS:
        return base
    if total_columns >= _SPLIT2_MIN_COLUMNS:
        flags = dict(base, use_fused=True, split2=not stochastic or adaptive)
        if stochastic and adaptive:
            flags.update(select_bf16=True, grad_bf16=True)
        return flags
    return dict(base, use_fused=True)


def resolve_mode(args, total_columns: int) -> dict:
    """The ported step that the JAX package's command line selects, as
    ``train_parity``'s flags (``Flags``). As in the JAX ``main``, any
    explicit engine flag (``--fused``, ``--split2``, ``--select-bf16``,
    ``--grad-bf16``, ``--fused-pass``) switches ``--engine`` off; otherwise
    ``resolve_engine`` picks by the column count (and, for the
    stochastic-adaptive step, the batch size). What the JAX package would
    refuse or ignore is a ValueError; what resolves to an unported path
    raises ``NotImplementedError`` naming the ROADMAP.md item that ports
    it."""
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
    flags = {k: bool(getattr(args, k)) for k in Flags._fields}
    if any(getattr(args, f) for f in _ENGINE_FLAGS):
        use_fused, engine = args.fused, "manual flags"
    else:
        engine = args.engine or "auto"
        picked = resolve_engine(engine, total_columns, args.stochastic, args.adaptive,
                                args.batch_size)
        use_fused, flags["split2"] = picked["use_fused"], picked["split2"]
        for k in ("select_bf16", "grad_bf16"):
            flags[k] = flags[k] or picked[k]
    f = Flags(**flags)
    if f.fused_pass and not (f.stochastic and f.adaptive and use_fused):
        raise ValueError("fused_pass requires stochastic=True, adaptive=True and use_fused=True "
                         "(--stochastic --adaptive --fused)")
    if f.grad_bf16 and not (f.stochastic and f.adaptive and use_fused):
        raise ValueError("grad_bf16 requires stochastic=True, adaptive=True and use_fused=True "
                         "(--stochastic --adaptive --fused)")
    if f.split2 and not (use_fused and (not f.stochastic or f.adaptive)):
        raise ValueError("split2 is the fused engines' scale tier; it requires --fused (or "
                         "--engine fused-split2) and either the deterministic path or "
                         "--stochastic --adaptive")
    if not use_fused:
        raise NotImplementedError(
            f"{engine} at {total_columns} columns resolves to the XLA engine (the unfused "
            "solvers/dopri.py, sdeint and sdeint_adaptive_batch), which is not ported "
            "(ROADMAP.md A7)")
    check_flags(f, total_columns)
    return f._asdict()


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
                       help="the JAX package's solver flag, resolved as its command line "
                            "does (resolve_mode); a combination that resolves to an "
                            "unported path raises")
    p.add_argument("--engine", choices=("auto", "fused", "xla", "fused-split2"), default=None,
                   help="engine when no explicit engine flag is given: auto (by the column "
                        "count: fused below 104, fused-split2 through 312; with --stochastic "
                        "the fused fixed-grid SDE through 312, its weight gradients outside "
                        "the sweep from 64 columns), fused, fused-split2; xla raises "
                        "NotImplementedError")
    p.add_argument("--method", default="dopri5",
                   help="only dopri5 is ported; anything else raises NotImplementedError")
    p.add_argument("--bptt-every", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--clip-grad-norm", type=float, default=None)
    p.add_argument("--loss-scale", type=float, default=1.0)
    p.add_argument("--columns-per-area", default=None, metavar="N,N,...",
                   help="comma-separated columns per area (default 8,4,1; "
                        "64,32,8 for the 104-column configurations)")
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
    for i, h in enumerate(x for x in hist if "naccept" in x):
        # The selection's counts: success False means the step budget
        # (--max-steps) ran out before the last grid point.
        print(f"step {i}: naccept {h['naccept']} | nreject {h['nreject']} | "
              f"success {h['success']}")
    print(f"final loss {final['loss']:.5f} | acc {hist[-1]['acc']:.2f}")


if __name__ == "__main__":
    main()
