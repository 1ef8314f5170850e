"""The fused solvers (ports of ``sdeint_fused`` and ``odeint_dopri5_fused``
in ``columnflow/solvers/fused.py``).

``odeint_dopri5_fused`` (below, second half): adaptive dopri5 with the
selection, the dense-output replay and its reverse sweep each one kernel
(``kernels.network_ode``), specialised to the parity task's deterministic
drift: the f32-exact engine (three-term split; the weight gradients in the
reverse-sweep kernel through 63 columns, outside the kernels from 64 as the
JAX package takes them) and the ``fused-split2`` tier (two-term split, by
the same rule: the reverse-sweep kernel B8s through 63 columns, the
emit-mode sweep and the weight gradients outside the kernels from 64).
Outside the kernels means ``ode_outer_arg_grads``, on the replay's own
split.

``sdeint_fused``: fixed-grid SRA1 with its gradient, specialised to what
the parity task integrates: ``network_drift_premixed`` with the knot
stimulus and the constant diffusion sigma = 10, lane-batched on per-lane
step grids (the 2-D ``ts_steps`` mode, the adaptive replay's engine) or on
one uniform grid (``ts``). The weight gradients are resolved as in the JAX
package (``resolve_sde_arg_grads``), and these tiers are ported
(``sde_tier``):

- the three-term split (``prepare="split"``, ``prepare_premixed_split``) in
  kernel mode: the sweep kernel B3t forward, the reverse-sweep kernel B4't
  (B4't-team where the batch and the weights do not fit a block) with the
  weight cotangents in it (``_Replay3``); both grid modes;
- the three-term split in outer mode (the fixed-grid step from 64 columns,
  where the weights hold more than 1 MiB, and the adaptive replay's
  f32-exact engine there or under the gradbf16 substitute): B3t-team
  forward (B3t where the weights fit a block), the emit-mode sweep B4t for
  the state cotangent and each step's seed, then the weight VJPs outside
  the kernels on the steps' own times (``_Replay3Outer``): exact
  (``outer_arg_grads_split3``) on the uniform grid or per-lane grids, or,
  with ``vjp_drift="gradbf16"`` on per-lane grids, the bf16 substitute
  (``outer_arg_grads``);
- the two-term split (``prepare="split2"``) on per-lane grids: in outer
  mode with the bf16 substitute ``network_drift_premixed_gradbf16`` for the
  weight gradients (``vjp_drift="gradbf16"``) or without it: the replay
  kernel B3, the emit-mode sweep B4 for the state cotangent and its
  per-step seeds, then the weight-gradient contraction over all steps
  outside the kernels (``_Replay``: ``outer_arg_grads``, or the exact
  ``outer_arg_grads_split2``); in kernel mode (``vjp_drift`` None, weights
  of at most 1 MiB) B3 and the reverse-sweep kernel B4s with the weight
  cotangents in it (``_Replay2``).

The XOR task's drift (``xor_drift_batched``) has its own two entry points,
in kernel mode: ``xor_odeint_dopri5_fused`` (the kernels of
``kernels.xor_ode``) and ``xor_sdeint_fused``, the SDE with one scalar
Brownian per lane on the uniform grid or, lane-batched, on per-lane grids
(the adaptive replay's engine; ``kernels.xor_sde``). The Hopf task's MLP
drift (``hopf_mlp_drift``) has ``hopf_odeint_dopri5_fused`` (the kernels
of ``kernels.hopf_ode``): kernel mode for the reference MLP, outer mode
(the emit-mode sweep B8ho and ``hopf_outer_arg_grads``) past 1 MiB of
parameters or on request.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from columnflow_torch.kernels.network_ode import (
    ODESelectConfig,
    ode_replay_bwd,
    ode_replay_bwd_emit,
    ode_replay_bwd_split2,
    ode_replay_fwd,
    ode_replay_fwd_split2,
    ode_select,
    step_vjp,
)
from columnflow_torch.kernels.hopf_ode import (
    MuTable,
    hopf_replay_bwd,
    hopf_replay_bwd_emit,
    hopf_replay_fwd,
    hopf_select,
    hopf_step_vjp,
    pack_params,
    unpack_params,
)
from columnflow_torch.kernels.network_sde import (
    SIGMA,
    SDEConsts,
    replay2_bwd,
    replay3_bwd,
    replay3_bwd_emit,
    replay3_fwd,
    replay_bwd,
    replay_fwd,
    step_vjp_split2,
    step_vjp_split3,
)
from columnflow_torch.kernels.xor_ode import xor_replay_bwd, xor_replay_fwd, xor_select
from columnflow_torch.kernels.xor_sde import (
    xor_sde_bwd,
    xor_sde_fwd,
    xor_sde_replay_bwd,
    xor_sde_replay_fwd,
)
from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.network import (
    _bf,
    network_drift_premixed_gradbf16,
    network_drift_premixed_gradbf16_vjp,
    prepare_premixed_split,
    prepare_premixed_split2,
)
from columnflow_torch.models.hopf import PARAM_KEYS
from columnflow_torch.models.xor import PF_KEYS, XOR_STATE_DIM
from columnflow_torch.ops.arith import div
from columnflow_torch.ops.interp import interp_knots


def sde_chunk(state_shape, n_steps: int) -> int:
    """The step chunk of ``sdeint_fused`` for a float32 state of
    ``state_shape`` (its VMEM heuristic, ``columnflow/solvers/fused.py:
    1213-1229``). The port runs each sweep in one launch and needs the chunk
    only where the JAX package's arithmetic depends on it."""
    state_bytes = 4 * int(np.prod(state_shape))
    floor = 4 if state_bytes > (32 << 10) else 16
    return min(int(max(floor, min(1024, (2 << 20) // (6 * state_bytes)))), n_steps)


def sweep_chunk(state_shape, n_steps: int, bptt_every: int | None = None) -> int:
    """``sde_chunk`` capped at ``bptt_every``, as ``sdeint_fused`` caps it:
    the steps whose weight cotangents the JAX kernel-mode sweep sums before
    adding them to the total."""
    chunk = sde_chunk(state_shape, n_steps)
    return chunk if bptt_every is None else min(chunk, max(1, bptt_every))


def truncation_stride(state_shape, n_steps: int, bptt_every: int | None = None) -> int:
    """The backward sweep zeroes the state cotangent after every step k
    with k % stride == 0 (0: never). JAX zeroes it at the start of every
    kc-th chunk, the remainder chunk included, i.e. at multiples of
    chunk * kc (``sweep_chunk``)."""
    if bptt_every is None:
        return 0
    chunk = sweep_chunk(state_shape, n_steps, bptt_every)
    return chunk * max(1, round(bptt_every / chunk))


def uniform_step_times(ts, state_shape):
    """(t0s (n,) float32 on ts' device, h) of the uniform-grid SDE kernel:
    h = ts[1] - ts[0] in float32, and step i of chunk c (its first step
    off = c * chunk) at (float32(off) h + ts[0]) + float32(i - off) h, in
    float32, as ``_make_sde_chunk_kernel`` computes it."""
    ts = torch.as_tensor(ts, dtype=torch.float32)
    n = ts.shape[0] - 1
    h, t_base = float(ts[1] - ts[0]), float(ts[0])
    k, chunk = torch.arange(n), sde_chunk(state_shape, n)
    off = k // chunk * chunk
    t0s = (off.to(torch.float32) * h + t_base) + (k - off).to(torch.float32) * h
    return t0s.to(ts.device), h


def outer_step_times(ts):
    """(t0s (n,) float32 on ts' device, h) of the uniform grid as the JAX
    package's outer weight-gradient pass computes them: t_base + h k in
    float32 (``_outer_sde_arg_grads``, ``columnflow/solvers/fused.py:1396``),
    which can lie an ulp from the sweep kernels' chunked times
    (``uniform_step_times``)."""
    ts = torch.as_tensor(ts, dtype=torch.float32)
    n = ts.shape[0] - 1
    h, t_base = float(ts[1] - ts[0]), float(ts[0])
    return (torch.arange(n, dtype=torch.float32) * h + t_base).to(ts.device), h


# Float32 bytes of one (P, P) temporary per step that a sub-block of
# ``outer_arg_grads_split3`` may hold: its peak is about a dozen of them.
OUTER_SUB_BYTES = 128 << 20


def outer_arg_grads_split3(ys_prev, seeds, t0s, hs, i10, pw, sc: SDEConsts, kv,
                           block: int = 256):
    """The exact weight gradients (d wT, d iwT) of the three-term replay in
    outer mode: ``_outer_sde_arg_grads`` with ``vjp_step=None``
    (``columnflow/solvers/fused.py:1373-1437``). For every step k the VJP of
    one SRA1 step at ys_prev[k] through ``prepare_premixed_split`` for the
    step's total output cotangent seeds[k] (``step_vjp_split3``: the second
    stage's drift first, then the first's; each product's cotangent
    contracted over the lanes of its own step in float64, rounded to bf16
    and accumulated per step, folded once per step; d iwT in float32).
    t0s, hs (n,) (the uniform grid, ``outer_step_times``) or (n, B);
    i10 (n, B). The steps' cotangents are summed in float32 over blocks of
    min(block, n) steps, and each block's sum is added to the total, as
    JAX's scan over 256-step blocks does (its in-block order is XLA's; here
    sub-blocks of as many steps as keep one (P, P) float32 temporary per
    step under ``OUTER_SUB_BYTES``). PyTorch ops: the JAX package computes
    this in XLA, outside any Pallas kernel."""
    w3 = prepare_premixed_split({k: v.detach() for k, v in pw.items()}, sc.fc)[0]
    return _outer_exact(step_vjp_split3, w3, ys_prev, seeds, t0s, hs, i10, pw, sc, kv, block)


def outer_arg_grads_split2(ys_prev, seeds, t0s, hs, i10, pw, sc: SDEConsts, kv,
                           block: int = 256):
    """``outer_arg_grads_split3`` on the two-term split: the exact weight
    gradients of the split2 replay in outer mode (``_outer_sde_arg_grads``
    with ``vjp_step=None`` and ``prepare_premixed_split2``,
    ``columnflow/solvers/fused.py:1373-1437``; the adaptive replay's
    ``--split2`` without ``--grad-bf16`` from 64 columns). Per step the VJP
    of one SRA1 step through the two-term split
    (``step_vjp_split2(..., weights=True)``: two bf16 accumulators opened by
    the second stage's drift, one ``split2_fold``); the same blocks and
    sub-blocks. PyTorch ops, as XLA computes it in the JAX package."""
    w2 = prepare_premixed_split2({k: v.detach() for k, v in pw.items()}, sc.fc)[0]
    return _outer_exact(lambda *a: step_vjp_split2(*a, weights=True), w2, ys_prev, seeds, t0s,
                        hs, i10, pw, sc, kv, block)


def _outer_exact(vjp, w, ys_prev, seeds, t0s, hs, i10, pw, sc: SDEConsts, kv, block: int):
    """What both exact outer passes share: ``vjp(t0, h, y, i10, c, w, sc,
    kv)`` -> (state cotangent, the steps' d wT, d iwT) over sub-blocks of
    steps, summed in float32 within each block of min(block, n) steps, the
    blocks' sums added to the total."""
    n, B, S = ys_prev.shape
    P = S // 3
    d_wT = torch.zeros_like(pw["wT"], dtype=torch.float32)
    d_iwT = torch.zeros_like(pw["iwT"], dtype=torch.float32)
    blk = max(1, min(block, n))
    sub = max(1, min(blk, OUTER_SUB_BYTES // (4 * P * P)))
    lanes = t0s.dim() == 2
    for b0 in range(0, n, blk):
        b1 = min(b0 + blk, n)
        part_w, part_iw = torch.zeros_like(d_wT), torch.zeros_like(d_iwT)
        for s0 in range(b0, b1, sub):
            sl = slice(s0, min(s0 + sub, b1))
            t0 = t0s[sl, :, None] if lanes else t0s[sl, None, None]
            h = hs[sl, :, None] if lanes else hs[sl, None, None]
            _, g_w, g_iw = vjp(t0, h, ys_prev[sl], i10[sl, :, None], seeds[sl], w, sc, kv)
            part_w += g_w.sum(0)
            part_iw += g_iw.sum(0)
        d_wT += part_w
        d_iwT += part_iw
    return d_wT, d_iwT


def outer_arg_grads(ys_prev, seeds, t0s, hs, i10, pw, sc: SDEConsts, kv,
                    block: int = 64, sigma: float = SIGMA):
    """Weight gradients (d wT, d iwT) of the steps 0..n-1 given each
    step's total output cotangent ``seeds`` (n, B, 3P): the VJP of one
    ``network_drift_premixed_gradbf16`` SRA1 step with respect to the
    weights, at every step, summed over steps in float32. As in
    ``jax.vjp`` through the drift's bf16 casts, each drift evaluation's
    weight cotangent (contracted over the lanes) is rounded to bf16 before
    the sums. Steps are processed ``block`` at a time."""
    fc = sc.fc
    stim = Stimulus(0.0, 0.0, kv)
    interp = lambda t, t0, dt, v: interp_knots(t, sc.knot_ts, v)  # noqa: E731
    d_wT = torch.zeros_like(pw["wT"], dtype=torch.float32)
    d_iwT = torch.zeros_like(pw["iwT"], dtype=torch.float32)
    for s in range(0, ys_prev.shape[0], block):
        y, c = ys_prev[s:s + block], seeds[s:s + block]
        t0, h = t0s[s:s + block, :, None], hs[s:s + block, :, None]
        i10_h = i10[s:s + block, :, None] / torch.where(h > 0, h, 1.0)
        f1 = network_drift_premixed_gradbf16(t0, y, pw, fc, stim, interp_fn=interp)
        h2 = y + (0.75 * h) * f1 + (1.5 * i10_h) * sigma
        c3 = div(h * c, 3.0)
        c_h2, (x2, e2, cc2) = network_drift_premixed_gradbf16_vjp(
            t0 + 0.75 * h, h2, c3 * 2.0, pw, fc, stim, interp_fn=interp)
        _, (x1, e1, cc1) = network_drift_premixed_gradbf16_vjp(
            t0, y, c3 + (0.75 * h) * c_h2, pw, fc, stim, interp_fn=interp)
        for d, a1, a2 in ((d_wT, x1, x2), (d_iwT, e1, e2)):
            per_step = (_bf(torch.bmm(a1.transpose(1, 2), cc1))
                        + _bf(torch.bmm(a2.transpose(1, 2), cc2)))
            d += per_step.sum(0)
    return d_wT, d_iwT


def _carried_cotangent(ys_bar, n_real: int):
    """The replay's rows past n_real hold the carried state ys[n_real]:
    their cotangents add to that row's before the reverse sweep, which
    reads the rows up to n_real only."""
    ys_bar = ys_bar.to(torch.float32).contiguous()
    if n_real + 1 >= ys_bar.shape[0]:
        return ys_bar
    ys_bar = ys_bar.clone()
    ys_bar[n_real] += ys_bar[n_real + 1:].sum(0)
    return ys_bar


class _Replay(torch.autograd.Function):
    """The two-term split in outer mode. Forward: ``replay_fwd`` (B3).
    Backward: ``replay_bwd`` (B4), then the weight VJPs on the lanes' own
    step times: ``outer_arg_grads`` (``vjp_drift`` "gradbf16") or the exact
    ``outer_arg_grads_split2`` (``vjp_drift`` None). Gradients reach wT, iwT
    and y0; the step grid and the noise are data."""

    @staticmethod
    def forward(ctx, wT, iwT, y0, t0s, hs, i1, i10, spec):
        sc, kv, n_real = spec[:3]
        w2 = prepare_premixed_split2({"wT": wT.detach(), "iwT": iwT.detach()}, sc.fc)[0]
        w2 = {k: v.contiguous() for k, v in w2.items()}
        ys = replay_fwd(y0.detach().contiguous(), t0s, hs, i1, i10, n_real, w2, sc, kv)
        ctx.spec, ctx.w2 = spec, w2
        ctx.save_for_backward(wT, iwT, ys, t0s, hs, i10)
        return ys

    @staticmethod
    def backward(ctx, ys_bar):
        sc, kv, n_real, stride, vjp_drift = ctx.spec
        wT, iwT, ys, t0s, hs, i10 = ctx.saved_tensors
        ys_bar = _carried_cotangent(ys_bar, n_real)
        ybar, seeds = replay_bwd(ys[:-1], ys_bar[1:], t0s, hs, i10, n_real, stride,
                                 ctx.w2, sc, kv)
        pw = {"wT": wT.detach(), "iwT": iwT.detach()}
        outer = outer_arg_grads if vjp_drift == "gradbf16" else outer_arg_grads_split2
        d_wT, d_iwT = outer(ys[:n_real], seeds[:n_real], t0s[:n_real], hs[:n_real],
                            i10[:n_real], pw, sc, kv)
        return d_wT, d_iwT, ybar + ys_bar[0], None, None, None, None, None


class _Replay2(torch.autograd.Function):
    """The two-term split in kernel mode. Forward: ``replay_fwd`` (B3);
    backward: ``replay2_bwd`` (B4s), the weight gradients in the sweep.
    Gradients reach wT, iwT and y0; the step grid and the noise are data."""

    @staticmethod
    def forward(ctx, wT, iwT, y0, t0s, hs, i1, i10, spec):
        sc, kv, n_real, stride, chunk = spec
        w2 = prepare_premixed_split2({"wT": wT.detach(), "iwT": iwT.detach()}, sc.fc)[0]
        w2 = {k: v.contiguous() for k, v in w2.items()}
        ys = replay_fwd(y0.detach().contiguous(), t0s, hs, i1, i10, n_real, w2, sc, kv)
        ctx.spec, ctx.w2 = spec, w2
        ctx.save_for_backward(ys, t0s, hs, i10)
        return ys

    @staticmethod
    def backward(ctx, ys_bar):
        sc, kv, n_real, stride, chunk = ctx.spec
        ys, t0s, hs, i10 = ctx.saved_tensors
        ys_bar = _carried_cotangent(ys_bar, n_real)
        ybar, d_wT, d_iwT = replay2_bwd(ys[:-1], ys_bar[1:], t0s, hs, i10, n_real, stride, chunk,
                                        ctx.w2, sc, kv)
        return d_wT, d_iwT, ybar + ys_bar[0], None, None, None, None, None


class _Replay3(torch.autograd.Function):
    """The three-term split in kernel mode. Forward: ``replay3_fwd`` (B3t);
    backward: ``replay3_bwd`` (B4't), the weight gradients in the kernel.
    Gradients reach wT, iwT and y0; the step grid and the noise are data."""

    @staticmethod
    def forward(ctx, wT, iwT, y0, t0s, hs, i1, i10, spec):
        sc, kv, n_real, stride, chunk = spec
        pw = {"wT": wT.detach().contiguous(), "iwT": iwT.detach().contiguous()}
        ys = replay3_fwd(y0.detach().contiguous(), t0s, hs, i1, i10, n_real, pw, sc, kv)
        ctx.spec, ctx.pw = spec, pw
        ctx.save_for_backward(ys, t0s, hs, i10)
        return ys

    @staticmethod
    def backward(ctx, ys_bar):
        sc, kv, n_real, stride, chunk = ctx.spec
        ys, t0s, hs, i10 = ctx.saved_tensors
        ys_bar = _carried_cotangent(ys_bar, n_real)
        ybar, d_wT, d_iwT = replay3_bwd(ys[:-1], ys_bar[1:], t0s, hs, i10, n_real, stride, chunk,
                                        ctx.pw, sc, kv)
        return d_wT, d_iwT, ybar + ys_bar[0], None, None, None, None, None


class _Replay3Outer(torch.autograd.Function):
    """The three-term split in outer mode. Forward: ``replay3_fwd``
    (B3t-team, or B3t by ``sde3_fwd_route``); backward: ``replay3_bwd_emit``
    (B4t) for the state cotangent and each step's seed, then the weight VJPs
    on the states before each step and the seeds: ``outer_arg_grads_split3``
    (exact), or ``outer_arg_grads`` (``vjp_drift`` "gradbf16"). Gradients
    reach wT, iwT and y0; the grid and the noise are data. ``spec``'s
    ``outer`` = (t0s, hs) of the outer pass: ``outer_step_times`` on the
    uniform grid, the lanes' own (n, B) times on per-lane grids."""

    @staticmethod
    def forward(ctx, wT, iwT, y0, t0s, hs, i1, i10, spec):
        sc, kv, n_real = spec[:3]
        pw = {"wT": wT.detach().contiguous(), "iwT": iwT.detach().contiguous()}
        ys = replay3_fwd(y0.detach().contiguous(), t0s, hs, i1, i10, n_real, pw, sc, kv)
        ctx.spec, ctx.pw = spec, pw
        ctx.save_for_backward(ys, t0s, hs, i10)
        return ys

    @staticmethod
    def backward(ctx, ys_bar):
        sc, kv, n_real, stride, (t0_o, h_o), vjp_drift = ctx.spec
        ys, t0s, hs, i10 = ctx.saved_tensors
        ys_bar = _carried_cotangent(ys_bar, n_real)
        ybar, seeds = replay3_bwd_emit(ys[:-1], ys_bar[1:], t0s, hs, i10, n_real, stride, ctx.pw,
                                       sc, kv)
        outer = outer_arg_grads if vjp_drift == "gradbf16" else outer_arg_grads_split3
        d_wT, d_iwT = outer(ys[:n_real], seeds[:n_real], t0_o[:n_real], h_o[:n_real],
                            i10[:n_real], ctx.pw, sc, kv)
        return d_wT, d_iwT, ybar + ys_bar[0], None, None, None, None, None


def resolve_sde_arg_grads(pw: dict, arg_grads: str = "auto", vjp_drift: str | None = None) -> str:
    """JAX's rule for where ``sdeint_fused`` takes the weight gradients
    (``columnflow/solvers/fused.py:1192-1206``): ``"auto"`` is ``"outer"``
    when the differentiable weights hold more than 1 MiB, a substitute
    ``vjp_drift`` is given, or a weight is 1-D; else ``"kernel"``. A
    substitute applies to the outer sweep only."""
    if arg_grads not in ("auto", "kernel", "outer"):
        raise ValueError(f"unknown arg_grads mode: {arg_grads!r}")
    if arg_grads == "auto":
        big = sum(4 * v.numel() for v in pw.values()) > OUTER_ARG_BYTES
        one_d = any(v.dim() < 2 for v in pw.values())
        arg_grads = "outer" if big or vjp_drift is not None or one_d else "kernel"
    if vjp_drift is not None and arg_grads != "outer":
        raise ValueError("vjp_drift applies to the outer arg-gradient sweep only (arg_grads "
                         f"resolved to {arg_grads!r})")
    return arg_grads


def sde_tier(pw, prepare, vjp_drift, arg_grads, lanes: bool) -> str:
    """Which ported tier computes ``sdeint_fused``'s gradients:

    - "split": the three-term split in kernel mode (B3t or B3t-team, B4't or
      B4't-team), either grid;
    - "split-outer": the three-term split in outer mode (B3t or B3t-team,
      B4t, then the weight VJPs outside the sweep): on the uniform grid
      exact at the outer pass's times (``outer_arg_grads_split3``; the
      fixed-grid step from 64 columns); on per-lane grids at the lanes' own
      step times, exact (the adaptive replay's f32-exact engine from 64
      columns) or with the gradbf16 substitute (``outer_arg_grads``:
      ``--grad-bf16`` without ``--split2``);
    - "split2": the two-term split in outer mode with the gradbf16
      substitute (B3, B4 and ``outer_arg_grads`` on per-lane grids);
    - "split2-kernel": the two-term split in kernel mode without a
      substitute (B3, B4s; per-lane grids: ``--split2`` without
      ``--grad-bf16`` through 63 columns);
    - "split2-outer": the two-term split in outer mode without a substitute
      (B3, B4, then the exact ``outer_arg_grads_split2`` on the lanes' own
      step times: the same from 64 columns).

    Anything else raises naming its ROADMAP.md item."""
    if prepare not in ("split", "split2"):
        raise ValueError(f"unknown prepare {prepare!r}: use 'split' (prepare_premixed_split) or "
                         "'split2' (prepare_premixed_split2)")
    if vjp_drift not in (None, "gradbf16"):
        raise ValueError(f"unknown vjp_drift {vjp_drift!r}: use None or 'gradbf16'")
    mode = resolve_sde_arg_grads(pw, arg_grads, vjp_drift)
    if prepare == "split" and mode == "kernel":
        return "split"
    if prepare == "split" and (vjp_drift is None or lanes):
        return "split-outer"
    if prepare == "split2" and lanes:
        if vjp_drift == "gradbf16":
            return "split2"
        return "split2-kernel" if mode == "kernel" else "split2-outer"
    if prepare == "split":
        why = ("the gradbf16 substitute on the uniform grid is not ported (the JAX package's "
               "fixed-grid step never passes vjp_drift): ROADMAP.md B, the substitute on the "
               "uniform grid")
    else:
        why = ("the two-term split on the uniform grid is not ported (the JAX package's fixed-grid "
               "step takes the three-term split): ROADMAP.md B, the two-term split on the "
               "uniform grid")
    raise NotImplementedError(why)


def sdeint_fused(pw: dict, sc: SDEConsts, kv, y0, ts_steps=None, noise_pack=None,
                 bptt_every: int | None = None, n_real: int | None = None, *, ts=None,
                 prepare: str = "split2", vjp_drift: str | None = "gradbf16",
                 arg_grads: str = "auto"):
    """SRA1 of the premixed network, lane-batched: y0 (B, 3P) packs B
    lanes. Either ``ts_steps`` (B, n + 1), each lane advancing its own step
    grid row (the adaptive replay's engine), or ``ts`` (n + 1,), the uniform
    grid of every lane (the fixed-grid step; step times as the JAX kernel
    computes them, ``uniform_step_times``). ``noise_pack`` = (dw, i10),
    each (n, B) (or (n, B, 1)). ``pw`` = {"wT", "iwT"} (the differentiable
    premixed weights), ``kv`` (K, B, n_in) the knot values.

    ``prepare`` ("split": ``prepare_premixed_split``, "split2":
    ``prepare_premixed_split2``), ``vjp_drift`` (None or "gradbf16":
    ``network_drift_premixed_gradbf16`` for the outer weight gradients) and
    ``arg_grads`` as in the JAX package (``resolve_sde_arg_grads``); the
    ported tiers are ``sde_tier``'s. The defaults are the flagship's
    replay.

    ``n_real`` (per-lane grids): the leading real steps (the rest must be
    h == 0 padding with zero noise and zero cotangents), an int read on the
    host. ``bptt_every`` (in steps of this grid) truncates the reverse sweep
    where the JAX package's chunking does. Returns ys (n + 1, B, 3P);
    ys[i, b] is lane b's state at its own i-th grid time."""
    if (ts_steps is None) == (ts is None):
        raise ValueError("give either ts_steps (per-lane grids) or ts (the uniform grid)")
    B = y0.shape[0]
    if ts_steps is not None:
        ts_steps = ts_steps.to(torch.float32)
        if ts_steps.dim() != 2:
            raise NotImplementedError(
                "the per-sample variable-grid mode (1-D ts_steps) is not ported: ROADMAP.md B, "
                "B3/B4 in the per-sample variable-grid mode")
        if tuple(y0.shape[:1]) != tuple(ts_steps.shape[:1]):
            raise ValueError(f"lane-batched ts_steps rows ({ts_steps.shape[0]}) must match y0's "
                             f"leading lane axis ({y0.shape[0]})")
        n = ts_steps.shape[1] - 1
        t0s = ts_steps[:, :-1].T.contiguous()
        hs = (ts_steps[:, 1:] - ts_steps[:, :-1]).T.contiguous()
    else:
        if n_real is not None:
            raise ValueError("n_real applies to per-lane grids only")
        t0s, h = uniform_step_times(ts, tuple(y0.shape))
        t0s = t0s.to(y0.device)
        n = t0s.shape[0]
        hs = torch.full_like(t0s, h)
    tier = sde_tier(pw, prepare, vjp_drift, arg_grads, ts_steps is not None)
    dw, i10 = (torch.as_tensor(x, dtype=torch.float32, device=y0.device).reshape(n, B)
               .contiguous() for x in noise_pack)
    n_real = n if n_real is None else int(n_real)
    stride = truncation_stride(tuple(y0.shape), n, bptt_every)
    if tier in ("split", "split2-kernel"):
        spec = (sc, kv.contiguous(), n_real, stride,
                sweep_chunk(tuple(y0.shape), n, bptt_every))
        replay = _Replay3 if tier == "split" else _Replay2
        return replay.apply(pw["wT"], pw["iwT"], y0, t0s, hs, dw, i10, spec)
    if tier == "split-outer":
        if ts_steps is None:
            t0_o, h_o = outer_step_times(ts)
            t0_o = t0_o.to(y0.device)
            outer = (t0_o, torch.full_like(t0_o, h_o))
        else:  # the arrays the kernels stepped on, as the JAX package's lanes mode takes them
            outer = (t0s, hs)
        spec = (sc, kv.contiguous(), n_real, stride, outer, vjp_drift)
        return _Replay3Outer.apply(pw["wT"], pw["iwT"], y0, t0s, hs, dw, i10, spec)
    return _Replay.apply(pw["wT"], pw["iwT"], y0, t0s, hs, dw, i10,
                         (sc, kv.contiguous(), n_real, stride, vjp_drift))


# ---------------------------------------------------------------------------
# Fused adaptive dopri5
# ---------------------------------------------------------------------------


class ODESolverStats(NamedTuple):
    """The selection's counts (0-dim tensors) and the frozen grid they
    belong to, so that a caller can replay the same grid elsewhere."""

    naccept: torch.Tensor
    nreject: torch.Tensor
    success: torch.Tensor
    step_times: torch.Tensor


def round_max_steps(state_shape, max_steps: int) -> int:
    """``max_steps`` rounded up to a multiple of the replay chunk the JAX
    package derives from its VMEM budget for a float32 state of
    ``state_shape`` (``columnflow/solvers/fused.py:557-566``). The port runs
    each sweep in one launch and needs the chunk only for this: the rounded
    value bounds the selection loop and sizes ``step_times``."""
    state_bytes = 4 * int(np.prod(state_shape))
    chunk = int(max(4, min(256, (2 << 20) // (11 * state_bytes))))
    return -(-max_steps // chunk) * chunk


class _ODEReplay(torch.autograd.Function):
    """Kernel mode, the weight gradients in the sweep, on either split
    (``spec``'s split2). The f32-exact engine: forward ``ode_replay_fwd`` (B7
    or B7t-team), backward ``ode_replay_bwd`` (B8 or B8t-team). The split2
    tier: forward ``ode_replay_fwd_split2`` (B7 split2), backward
    ``ode_replay_bwd_split2`` (B8s). Gradients reach wT, iwT and y0; the
    step grid is data."""

    @staticmethod
    def forward(ctx, wT, iwT, y0, st, spec):
        sc, kv, split2 = spec
        pw = {"wT": wT.detach().contiguous(), "iwT": iwT.detach().contiguous()}
        y0 = y0.detach().contiguous()
        if split2:
            ctx.w = {k: v.contiguous() for k, v in prepare_premixed_split2(pw, sc.fc)[0].items()}
            ys, coeffs = ode_replay_fwd_split2(y0, st, ctx.w, sc, kv)
        else:
            ys, coeffs = ode_replay_fwd(y0, st, pw, sc, kv)
        ctx.spec, ctx.pw = spec, pw
        ctx.save_for_backward(ys, st)
        return coeffs

    @staticmethod
    def backward(ctx, coeffs_bar):
        sc, kv, split2 = ctx.spec
        ys, st = ctx.saved_tensors
        cobar = coeffs_bar.to(torch.float32).contiguous()
        if split2:
            ybar, d_wT, d_iwT = ode_replay_bwd_split2(ys, cobar, st, ctx.w, sc, kv)
        else:
            ybar, d_wT, d_iwT = ode_replay_bwd(ys, cobar, st, ctx.pw, sc, kv)
        return d_wT, d_iwT, ybar, None, None


# The differentiable weights' size above which ``arg_grads="auto"`` takes
# the weight gradients outside the reverse sweep (columnflow/solvers/fused.py:
# 571-574): more than 1 MiB.
OUTER_ARG_BYTES = 1 << 20


def outer_by_default(P: int, n_in: int) -> bool:
    """Whether ``arg_grads="auto"`` takes the weight gradients outside the
    reverse sweep for P populations and n_in inputs: the float32 wT (P, P)
    and iwT (n_in, P) hold more than 1 MiB."""
    return 4 * (P * P + n_in * P) > OUTER_ARG_BYTES


def resolve_arg_grads(pw: dict, arg_grads: str = "auto") -> str:
    """JAX's rule for where the weight gradients are taken: ``"auto"`` is
    ``"outer"`` when the differentiable weights hold more than 1 MiB, else
    ``"kernel"``."""
    if arg_grads not in ("auto", "kernel", "outer"):
        raise ValueError(f"unknown arg_grads mode: {arg_grads!r}")
    if arg_grads != "auto":
        return arg_grads
    return "outer" if outer_by_default(*pw["wT"].shape[:1], pw["iwT"].shape[0]) else "kernel"


# Float64 bytes of one (block, P, P) temporary of ``ode_outer_arg_grads``:
# 128 steps up to P = 1024 (the 104-column width, P = 832, keeps 128), fewer
# past that (21 at P = 2496, 312 columns), where 128 would not fit the card.
OUTER_BLOCK_BYTES = 1 << 30


def ode_outer_arg_grads(ys, ybar_steps, cobar, st, pw: dict, sc: SDEConsts, kv,
                        prepare=prepare_premixed_split2, block: int | None = None, w=None):
    """The weight gradients of the replay in outer mode (``_outer_arg_grads``,
    ``columnflow/solvers/fused.py:645-686``): for every accepted step k,
    the VJP of the replay step at (ys[k], st[k], st[k+1] - st[k]) with
    respect to wT and iwT through ``prepare`` (``prepare_premixed_split2``:
    the split2 tier; ``prepare_premixed_split``: the f32-exact engine from
    64 columns), fed the cotangent ybar_steps[k] on the step's output and
    cobar[k] on its dense rows; summed over the steps in float32. The steps
    run ``block`` at a time as one batched ``step_vjp``; each keeps its own
    bf16 accumulators, folded through the split once per step
    (``split2_fold`` / ``split3_fold``), as ``jax.vmap`` of ``jax.vjp``
    does. Only the n accepted steps are passed, so there is no padding.
    A block's temporaries are (block, P, P) float64 (0.7 GB at P = 832); the
    pass is a few hundred PyTorch launches per block whatever its size, so
    large blocks keep the launches' share small. ``block`` None: 128 steps,
    fewer where one (block, P, P) float64 temporary would pass
    ``OUTER_BLOCK_BYTES``. ``w``: ``prepare``'s split of pw, where the
    caller already holds it (the replay ran on it)."""
    if w is None:
        w = prepare({k: v.detach() for k, v in pw.items()}, sc.fc)[0]
    d_wT = torch.zeros_like(pw["wT"], dtype=torch.float32)
    d_iwT = torch.zeros_like(pw["iwT"], dtype=torch.float32)
    P = pw["wT"].shape[0]
    if block is None:
        block = max(1, min(128, OUTER_BLOCK_BYTES // (8 * P * P)))
    t0s, hs = st[:-1], st[1:] - st[:-1]
    for s in range(0, ys.shape[0], block):
        sl = slice(s, s + block)
        _, gw, giw = step_vjp(t0s[sl, None, None], hs[sl, None, None], ys[sl], ybar_steps[sl],
                              cobar[sl], w, sc, kv)
        d_wT += gw.sum(0)
        d_iwT += giw.sum(0)
    return d_wT, d_iwT


class _ODEReplayOuter(torch.autograd.Function):
    """``arg_grads="outer"`` on either split: the split2 tier (``spec``'s
    prepare ``prepare_premixed_split2``) and the f32-exact engine from 64
    columns (``prepare_premixed_split``). Forward: ``ode_replay_fwd_split2``
    or ``ode_replay_fwd`` (B7t-team there); backward: ``ode_replay_bwd_emit``
    on the same split (B8' or B8't) for the state cotangent and each step's
    output cotangent, then ``ode_outer_arg_grads`` for wT and iwT."""

    @staticmethod
    def forward(ctx, wT, iwT, y0, st, spec):
        sc, kv, prepare = spec
        pw = {"wT": wT.detach().contiguous(), "iwT": iwT.detach().contiguous()}
        w = {k: v.contiguous() for k, v in prepare(pw, sc.fc)[0].items()}
        y0 = y0.detach().contiguous()
        if "wT_lo" in w:
            ys, coeffs = ode_replay_fwd(y0, st, pw, sc, kv, w3=w)
        else:
            ys, coeffs = ode_replay_fwd_split2(y0, st, w, sc, kv)
        ctx.spec, ctx.pw, ctx.w = spec, pw, w
        ctx.save_for_backward(ys, st)
        return coeffs

    @staticmethod
    def backward(ctx, coeffs_bar):
        sc, kv, _ = ctx.spec
        ys, st = ctx.saved_tensors
        cobar = coeffs_bar.to(torch.float32).contiguous()
        ybar, ybar_steps = ode_replay_bwd_emit(ys, cobar, st, ctx.w, sc, kv)
        d_wT, d_iwT = ode_outer_arg_grads(ys, ybar_steps, cobar, st, ctx.pw, sc, kv, w=ctx.w)
        return d_wT, d_iwT, ybar, None, None


def odeint_dopri5_fused(pw: dict, sc: SDEConsts, kv, y0, ts, *, rtol: float = 1e-7,
                        atol: float = 1e-9, dt0: float | None = None, max_steps: int = 2048,
                        grid=None, return_stats: bool = False, split2: bool = False,
                        arg_grads: str = "auto"):
    """Adaptive dopri5 of the premixed column network over the batch state
    y0 (B, 3P) under one shared controller, with dense output at ``ts``:
    returns ys (len(ts), B, 3P) (and ``ODESolverStats`` with
    ``return_stats``). ``pw`` = {"wT", "iwT"} (differentiable), ``kv`` (K,
    B, n_in) the knot values. Gradients are discrete backpropagation
    through the frozen accepted steps and reach pw and y0.

    ``split2=False``: the f32-exact engine, the three-term split
    (``prepare_premixed_split``) everywhere. ``split2=True``: the JAX
    package's ``fused-split2`` tier (``columnflow/tasks/parity.py:452-484``):
    the selection keeps the three-term drift on a split taken outside the
    kernel, so the frozen grid is the exact engine's; values and gradients
    use the two-term split (``prepare_premixed_split2``). ``arg_grads``
    resolves as in the JAX package (``resolve_arg_grads``,
    ``columnflow/solvers/fused.py:569-576``): "auto" takes the weight
    gradients outside the reverse sweep ("outer") when wT and iwT hold more
    than 1 MiB (from 64 columns with 4 inputs), else inside it ("kernel").
    The exact engine runs either mode at any width: "kernel" the replay B7
    (B7t-team from 24 columns) and the sweep B8 (B8t-team from 18 columns at
    4 lanes) with the weight cotangents in it; "outer" the same replay, the
    emit-mode sweep B8't and the step-batched weight VJPs
    (``ode_outer_arg_grads``). The split2 tier: "kernel" its replay (B7
    split2) and the sweep B8s with the weight cotangents in it, "outer" the
    same replay, B8' and ``ode_outer_arg_grads`` on the two-term split.

    ``grid`` = (step_times (M+1,), naccept) skips the selection and replays
    that frozen grid (tests hand in the JAX package's grid this way)."""
    mode = resolve_arg_grads(pw, arg_grads)
    kv = kv.detach().contiguous()

    def select(cfg):
        # Both tiers select on the three-term split (the split2 tier's
        # select_func), so the frozen grid is the exact engine's.
        return ode_select(y0.detach().contiguous(),
                          {k: v.detach().contiguous() for k, v in pw.items()}, sc, kv, cfg)

    if mode == "kernel":
        def replay(st):
            return _ODEReplay.apply(pw["wT"], pw["iwT"], y0, st, (sc, kv, split2))
    else:
        prepare = prepare_premixed_split2 if split2 else prepare_premixed_split

        def replay(st):
            return _ODEReplayOuter.apply(pw["wT"], pw["iwT"], y0, st, (sc, kv, prepare))
    return _dopri5_solve(select, replay, y0, ts, rtol, atol, dt0, max_steps, grid, return_stats)


def _dopri5_solve(select, replay, y0, ts, rtol, atol, dt0, max_steps, grid, return_stats):
    """What both dopri5 engines share: the selection (``select(cfg)`` ->
    (step_times, stats)) or the given ``grid``, the one host read of
    naccept, the replay (``replay(st)`` -> coeffs (n, 5, *y0.shape), an
    autograd.Function) and the dense output at ``ts`` in PyTorch ops."""
    ts = torch.as_tensor(ts, dtype=torch.float32, device=y0.device)
    ts_host = ts.detach().cpu()
    max_steps = round_max_steps(tuple(y0.shape), max_steps)
    cfg = ODESelectConfig(float(ts_host[0]), float(ts_host[-1]), rtol, atol, dt0, max_steps)
    if grid is None:
        step_times, stats = select(cfg)
        naccept, nreject, success = stats[0], stats[1], stats[2] > 0
    else:
        step_times = torch.as_tensor(grid[0], dtype=torch.float32, device=y0.device)
        naccept = torch.as_tensor(grid[1], device=y0.device)
        nreject = torch.zeros_like(naccept)
        success = step_times[naccept.long()] >= cfg.t_end
    # The one host read of the solve: the accepted count sizes the replay,
    # so the sweeps skip the max_steps padding.
    n = max(int(naccept), 1)
    st = step_times[:n + 1].contiguous()
    coeffs = replay(st)  # (n, 5, B, S)

    # Dense output: Hairer's interpolant of the step that holds each ts.
    idx = torch.clamp(torch.searchsorted(st, ts, right=True) - 1, 0, n - 1)
    t0s = st[idx]
    hs = st[idx + 1] - t0s
    pos = hs > 0
    theta = torch.where(pos, (ts - t0s) / torch.where(pos, hs, 1.0), 0.0)
    r1, r2, r3, r4, r5 = coeffs[idx].unbind(1)
    th = theta[:, None, None]
    s1 = 1.0 - th
    ys = r1 + th * (r2 + s1 * (r3 + th * (r4 + s1 * r5)))
    ys = torch.cat([y0[None], ys[1:]], dim=0)
    if return_stats:
        return ys, ODESolverStats(naccept, nreject, success, step_times)
    return ys


# ---------------------------------------------------------------------------
# The XOR drift: fused dopri5 and the uniform-grid SDE, kernel mode
# ---------------------------------------------------------------------------


def xor_arg_grads(pf: dict, arg_grads: str = "auto", sde: bool = False) -> str:
    """JAX's ``arg_grads`` rule for the XOR rows (``columnflow/solvers/
    fused.py:571-576, 1192-1206``): "outer" when the differentiable args
    hold more than 1 MiB (or, in the SDE, one of them is 1-D), else
    "kernel". The four rows hold 192 bytes, so "auto" is "kernel"; only
    kernel mode is ported, "outer" raises."""
    if arg_grads not in ("auto", "kernel", "outer"):
        raise ValueError(f"unknown arg_grads mode: {arg_grads!r}")
    if arg_grads == "auto":
        big = sum(4 * v.numel() for v in pf.values()) > OUTER_ARG_BYTES
        arg_grads = "outer" if big or (sde and any(v.dim() < 2 for v in pf.values())) else "kernel"
    if arg_grads == "outer":
        raise NotImplementedError(
            "the XOR drift's weight gradients outside the reverse sweep (arg_grads='outer': "
            "emit mode and step-batched VJPs) are not ported: ROADMAP.md B, the XOR drift in "
            "outer mode")
    return arg_grads


class _XORODEReplay(torch.autograd.Function):
    """Forward: ``xor_replay_fwd``; backward: ``xor_replay_bwd``. Gradients
    reach the four rows and y0; the step grid is data."""

    @staticmethod
    def forward(ctx, w00, w01, w10, w11, y0, st, spec):
        sc, kv = spec
        pf = {k: v.detach().contiguous() for k, v in zip(PF_KEYS, (w00, w01, w10, w11))}
        ys, coeffs = xor_replay_fwd(y0.detach().contiguous(), st, pf, sc, kv)
        ctx.spec, ctx.pf = spec, pf
        ctx.save_for_backward(ys, st)
        return coeffs

    @staticmethod
    def backward(ctx, coeffs_bar):
        sc, kv = ctx.spec
        ys, st = ctx.saved_tensors
        ybar, rows = xor_replay_bwd(ys, coeffs_bar.to(torch.float32).contiguous(), st, ctx.pf,
                                    sc, kv)
        return (*(rows[k] for k in PF_KEYS), ybar, None, None)


def xor_odeint_dopri5_fused(pf: dict, sc: SDEConsts, kv, y0, ts, *, rtol: float = 1e-7,
                            atol: float = 1e-9, dt0: float | None = None,
                            max_steps: int = 2048, grid=None, return_stats: bool = False,
                            arg_grads: str = "auto"):
    """``odeint_dopri5_fused`` of the XOR drift (``xor_drift_batched`` with
    the knot stimulus): adaptive dopri5 over the batch state y0 (B, 72)
    under one shared controller, dense output at ``ts``; returns ys
    (len(ts), B, 72) (and ``ODESolverStats`` with ``return_stats``).
    ``pf`` = {"w00", "w01", "w10", "w11"} (differentiable, from
    ``split_xor_params``), ``sc`` = (``build_xor_fused_consts``, knot
    times), kv (K, B, 32). Gradients are discrete backpropagation through
    the frozen accepted steps, in kernel mode (``xor_arg_grads``), and
    reach pf and y0. ``grid`` = (step_times (M+1,), naccept) skips the
    selection and replays that frozen grid."""
    xor_arg_grads(pf, arg_grads)
    kv = kv.detach().contiguous()

    def select(cfg):
        return xor_select(y0.detach().contiguous(),
                          {k: v.detach().contiguous() for k, v in pf.items()}, sc, kv, cfg)

    def replay(st):
        return _XORODEReplay.apply(*(pf[k] for k in PF_KEYS), y0, st, (sc, kv))

    return _dopri5_solve(select, replay, y0, ts, rtol, atol, dt0, max_steps, grid, return_stats)


class _XORSDERollout(torch.autograd.Function):
    """Forward: ``xor_sde_fwd``; backward: ``xor_sde_bwd``. Gradients reach
    the four rows and y0; the grid and the noise are data."""

    @staticmethod
    def forward(ctx, w00, w01, w10, w11, y0, t0s, i1, i10, spec):
        sc, kv, h = spec
        pf = {k: v.detach().contiguous() for k, v in zip(PF_KEYS, (w00, w01, w10, w11))}
        ys = xor_sde_fwd(y0.detach().contiguous(), t0s, h, i1, i10, pf, sc, kv)
        ctx.spec, ctx.pf = spec, pf
        ctx.save_for_backward(ys, t0s, i10)
        return ys

    @staticmethod
    def backward(ctx, ys_bar):
        sc, kv, h = ctx.spec
        ys, t0s, i10 = ctx.saved_tensors
        ys_bar = ys_bar.to(torch.float32).contiguous()
        ybar, rows = xor_sde_bwd(ys, ys_bar, t0s, h, i10, ctx.pf, sc, kv)
        return (*(rows[k] for k in PF_KEYS), ybar + ys_bar[0], None, None, None, None)


class _XORSDEReplayLanes(torch.autograd.Function):
    """Per-lane grids. Forward: ``xor_sde_replay_fwd`` (B3xl); backward:
    ``xor_sde_replay_bwd`` (B4'xl). Gradients reach the four rows and y0;
    the grids and the noise are data."""

    @staticmethod
    def forward(ctx, w00, w01, w10, w11, y0, t0s, hs, i1, i10, spec):
        sc, kv, n_real, chunk = spec
        pf = {k: v.detach().contiguous() for k, v in zip(PF_KEYS, (w00, w01, w10, w11))}
        ys = xor_sde_replay_fwd(y0.detach().contiguous(), t0s, hs, i1, i10, n_real, pf, sc, kv)
        ctx.spec, ctx.pf = spec, pf
        ctx.save_for_backward(ys, t0s, hs, i10)
        return ys

    @staticmethod
    def backward(ctx, ys_bar):
        sc, kv, n_real, chunk = ctx.spec
        ys, t0s, hs, i10 = ctx.saved_tensors
        ys_bar = _carried_cotangent(ys_bar, n_real)
        ybar, rows = xor_sde_replay_bwd(ys, ys_bar, t0s, hs, i10, n_real, chunk, ctx.pf, sc, kv)
        return (*(rows[k] for k in PF_KEYS), ybar + ys_bar[0], None, None, None, None, None)


def xor_sdeint_fused(pf: dict, sc: SDEConsts, kv, y0, ts=None, noise_pack=None,
                     arg_grads: str = "auto", *, ts_steps=None, n_real: int | None = None):
    """``sdeint_fused(method="srk")`` of the XOR drift: SRA1 with the
    membrane-only diffusion sigma = 10, each lane driven by one scalar
    Brownian motion. Either ``ts`` (T,), the uniform grid of every lane
    (``noise_shape=(B, 1)``: the fixed-grid step), or ``ts_steps`` (B, n +
    1), each lane advancing its own step grid row (the adaptive replay's
    lanes mode; ``n_real``: the leading real steps, the rest h == 0 padding
    with zero noise). ``noise_pack`` = (i1, i10), each (n, B) or (n, B, 1)
    (from ``solvers.sde.brownian_pack(generator, ts, (B, 1))``, the
    adaptive replay's grid, or the JAX package's pack). Returns ys (n + 1,
    B, 72) with ys[0] = y0 (ys[i, b] at lane b's own i-th time); gradients
    reach pf and y0 in kernel mode (``xor_arg_grads``)."""
    xor_arg_grads(pf, arg_grads, sde=True)
    if (ts_steps is None) == (ts is None):
        raise ValueError("give either ts_steps (per-lane grids) or ts (the uniform grid)")
    B = y0.shape[0]
    rows = (pf[k] for k in PF_KEYS)
    if ts_steps is not None:
        ts_steps = ts_steps.to(torch.float32)
        if ts_steps.dim() != 2 or ts_steps.shape[0] != B:
            raise ValueError(f"ts_steps must be (B, n + 1) with B = {B} lanes, got "
                             f"{tuple(ts_steps.shape)}")
        n = ts_steps.shape[1] - 1
        t0s = ts_steps[:, :-1].T.contiguous()
        hs = (ts_steps[:, 1:] - ts_steps[:, :-1]).T.contiguous()
        i1, i10 = (torch.as_tensor(x, dtype=torch.float32, device=y0.device)
                   .reshape(n, B).contiguous() for x in noise_pack)
        spec = (sc, kv.detach().contiguous(), n if n_real is None else int(n_real),
                sweep_chunk((B, XOR_STATE_DIM), n))
        return _XORSDEReplayLanes.apply(*rows, y0, t0s, hs, i1, i10, spec)
    if n_real is not None:
        raise ValueError("n_real applies to per-lane grids only")
    t0s, h = uniform_step_times(ts, tuple(y0.shape))
    t0s = t0s.to(y0.device)
    i1, i10 = (torch.as_tensor(x, dtype=torch.float32, device=y0.device)
               .reshape(t0s.shape[0], B).contiguous() for x in noise_pack)
    return _XORSDERollout.apply(*rows, y0, t0s, i1, i10, (sc, kv.detach().contiguous(), h))


# ---------------------------------------------------------------------------
# The Hopf MLP drift: fused dopri5, kernel and outer mode
# ---------------------------------------------------------------------------


def hopf_arg_grads(params, arg_grads: str = "auto") -> str:
    """JAX's ``arg_grads`` rule for the MLP parameters (``columnflow/solvers/
    fused.py:569-576``): "outer" when they hold more than 1 MiB (the 3-512-
    512-512-2 MLP's 2.1 MB), else "kernel" (the reference MLP's 83 KB). The
    rule's "kernel" when nothing is differentiable does not arise: the
    parameters are always the drift's differentiable args. Kernel mode past
    1 MiB (B8h at such a width) is not ported and raises."""
    if arg_grads not in ("auto", "kernel", "outer"):
        raise ValueError(f"unknown arg_grads mode: {arg_grads!r}")
    big = sum(4 * layer[k].numel() for layer in params for k in PARAM_KEYS) > OUTER_ARG_BYTES
    if arg_grads == "auto":
        arg_grads = "outer" if big else "kernel"
    if arg_grads == "kernel" and big:
        raise NotImplementedError(
            "the Hopf MLP's parameter gradients inside the reverse sweep (arg_grads='kernel') "
            "past 1 MiB of parameters are not ported: ROADMAP.md B8hw")
    return arg_grads


class _HopfODEReplay(torch.autograd.Function):
    """Kernel mode. Forward: ``hopf_replay_fwd``; backward:
    ``hopf_replay_bwd``. Gradients reach y0 and the eight parameter
    tensors; the step grid and the mu table are data."""

    @staticmethod
    def forward(ctx, y0, st, mu, *leaves):
        params = [{k: v.detach().contiguous() for k, v in zip(PARAM_KEYS, leaves[i:i + 2])}
                  for i in range(0, len(leaves), 2)]
        ys, coeffs = hopf_replay_fwd(y0.detach().contiguous(), st, params, mu)
        ctx.mu, ctx.params = mu, params
        ctx.save_for_backward(ys, st)
        return coeffs

    @staticmethod
    def backward(ctx, coeffs_bar):
        ys, st = ctx.saved_tensors
        ybar, grads = hopf_replay_bwd(ys, coeffs_bar.to(torch.float32).contiguous(), st,
                                      ctx.params, ctx.mu)
        return (ybar, None, None, *(g[k] for g in grads for k in PARAM_KEYS))


class _HopfODEReplayOuter(_HopfODEReplay):
    """Outer mode (``arg_grads="outer"``). Forward: ``hopf_replay_fwd``, as
    in kernel mode; backward: ``hopf_replay_bwd_emit`` (B8ho) for the state
    cotangent and each step's output cotangent, then
    ``hopf_outer_arg_grads`` for the parameters."""

    @staticmethod
    def backward(ctx, coeffs_bar):
        ys, st = ctx.saved_tensors
        cobar = coeffs_bar.to(torch.float32).contiguous()
        ybar, ybar_steps = hopf_replay_bwd_emit(ys, cobar, st, ctx.params, ctx.mu)
        grads = hopf_outer_arg_grads(ys, ybar_steps, cobar, st, ctx.params, ctx.mu)
        return (ybar, None, None, *(g[k] for g in grads for k in PARAM_KEYS))


@torch.no_grad()
def hopf_outer_arg_grads(ys, ybar_steps, cobar, st, params, mu: MuTable,
                         block: int | None = None):
    """The MLP's parameter gradients of the replay in outer mode
    (``_outer_arg_grads``, ``columnflow/solvers/fused.py:645-686``): for
    every accepted step k, the VJP of the replay step at (ys[k], st[k],
    st[k+1] - st[k]) with respect to the eight parameter tensors, fed the
    cotangent ybar_steps[k] on the step's output and cobar[k] on its dense
    rows; summed over the steps in float32. The steps run ``block`` at a
    time as one batched ``hopf_step_vjp``, each keeping its own cotangents
    (as ``jax.vmap`` of ``jax.vjp`` does), each block's sum added to the
    total. PyTorch ops: the JAX package computes this pass in XLA, not in a
    Pallas kernel. A block's largest temporaries are the (block, B, H, H)
    float64 products of a hidden layer (67 MB a step at B = 32, H = 512);
    ``block`` None: 128 steps, fewer where one such temporary would pass
    ``OUTER_BLOCK_BYTES`` (16 at that width). Returns a list of ``{"w",
    "b"}``."""
    if block is None:
        B = ys.shape[1]
        widest = max(layer["w"].numel() for layer in params)
        block = max(1, min(128, OUTER_BLOCK_BYTES // (8 * B * widest)))
    t0s, hs = st[:-1], st[1:] - st[:-1]
    acc = torch.zeros_like(pack_params(params))
    for s in range(0, ys.shape[0], block):
        sl = slice(s, s + block)
        _, g = hopf_step_vjp(t0s[sl, None, None], hs[sl, None, None], ys[sl], ybar_steps[sl],
                             cobar[sl], params, mu)
        acc += g.sum(0)
    return unpack_params(acc, params)


def hopf_odeint_dopri5_fused(params, mu_table, dt: float, y0, ts, *, rtol: float = 1e-7,
                             atol: float = 1e-9, dt0: float | None = None,
                             max_steps: int = 2048, grid=None, return_stats: bool = False,
                             arg_grads: str = "auto"):
    """``odeint_dopri5_fused`` of the Hopf MLP drift (``hopf_mlp_drift`` with
    the one-hot blend lookup of mu, ``nondiff_args=(1,)``): adaptive dopri5
    over the batch state y0 (B, 2) under one shared controller, dense
    output at ``ts``; returns ys (len(ts), B, 2) (and ``ODESolverStats``
    with ``return_stats``). ``params``: the list of ``{"w", "b"}``
    (differentiable); ``mu_table`` (T, B) the drive on the grid dt *
    arange(T) (data). Gradients are discrete backpropagation through the
    frozen accepted steps and reach params and y0. ``arg_grads`` resolves
    as in the JAX package (``hopf_arg_grads``): "kernel" takes the
    parameter cotangents in the reverse sweep (B8h), "outer" (the default
    past 1 MiB of parameters) runs the emit-mode sweep B8ho and
    ``hopf_outer_arg_grads``. ``grid`` = (step_times (M+1,), naccept) skips
    the selection and replays that frozen grid."""
    outer = hopf_arg_grads(params, arg_grads) == "outer"
    replay_fn = _HopfODEReplayOuter if outer else _HopfODEReplay
    mu = MuTable(mu_table.detach().to(torch.float32).contiguous(), 0.0, float(dt))
    leaves = [layer[k] for layer in params for k in PARAM_KEYS]

    def select(cfg):
        return hopf_select(y0.detach().contiguous(),
                           [{k: v.detach() for k, v in layer.items()} for layer in params],
                           mu, cfg)

    def replay(st):
        return replay_fn.apply(y0, st, mu, *leaves)

    return _dopri5_solve(select, replay, y0, ts, rtol, atol, dt0, max_steps, grid, return_stats)
