"""The lane-batched variable-step SRA1 replay with its gradient (port of
``sdeint_fused`` in ``columnflow/solvers/fused.py``, the 2-D ``ts_steps``
mode with ``arg_grads="outer"``).

The port specialises it to what the parity task's adaptive path integrates:
``network_drift_premixed`` with the split2 prepare hook
(``prepare_premixed_split2``), the knot stimulus and the constant diffusion
sigma = 10, with the weight gradients taken through the bf16 substitute
``network_drift_premixed_gradbf16`` (``vjp_drift``). Forward: the replay
kernel (B3); backward: the reverse-sweep kernel (B4) for the state
cotangent and its per-step seeds, then the weight-gradient contraction over
all steps outside the kernels, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from columnflow_torch.kernels.network_sde import SIGMA, SDEConsts, replay_bwd, replay_fwd
from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.network import (
    _bf,
    network_drift_premixed_gradbf16,
    network_drift_premixed_gradbf16_vjp,
    prepare_premixed_split2,
)
from columnflow_torch.ops.arith import div
from columnflow_torch.ops.interp import interp_knots


def truncation_stride(state_shape, n_steps: int, bptt_every: int | None = None) -> int:
    """The backward sweep zeroes the state cotangent after every step k
    with k % stride == 0 (0: never). JAX zeroes it at the start of every
    kc-th chunk, the remainder chunk included, i.e. at multiples of
    chunk * kc, with the chunk of its VMEM heuristic for a float32 state of
    ``state_shape`` (``columnflow/solvers/fused.py:1213-1235``). The port
    runs each sweep in one launch and needs the chunk only for this."""
    if bptt_every is None:
        return 0
    state_bytes = 4 * int(np.prod(state_shape))
    floor = 4 if state_bytes > (32 << 10) else 16
    chunk = int(max(floor, min(1024, (2 << 20) // (6 * state_bytes))))
    chunk = min(chunk, max(1, bptt_every), n_steps)
    return chunk * max(1, round(bptt_every / chunk))


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


class _Replay(torch.autograd.Function):
    """Forward: ``replay_fwd`` (B3). Backward: ``replay_bwd`` (B4), then
    ``outer_arg_grads``. Gradients reach wT, iwT and y0; the step grid and
    the noise are data."""

    @staticmethod
    def forward(ctx, wT, iwT, y0, t0s, hs, i1, i10, spec):
        sc, kv, n_real, stride = spec
        w2 = prepare_premixed_split2({"wT": wT.detach(), "iwT": iwT.detach()}, sc.fc)[0]
        w2 = {k: v.contiguous() for k, v in w2.items()}
        ys = replay_fwd(y0.detach().contiguous(), t0s, hs, i1, i10, n_real, w2, sc, kv)
        ctx.spec, ctx.w2 = spec, w2
        ctx.save_for_backward(wT, iwT, ys, t0s, hs, i10)
        return ys

    @staticmethod
    def backward(ctx, ys_bar):
        sc, kv, n_real, stride = ctx.spec
        wT, iwT, ys, t0s, hs, i10 = ctx.saved_tensors
        ys_bar = ys_bar.to(torch.float32).contiguous()
        ybar, seeds = replay_bwd(ys[:-1], ys_bar[1:], t0s, hs, i10, n_real, stride,
                                 ctx.w2, sc, kv)
        pw = {"wT": wT.detach(), "iwT": iwT.detach()}
        d_wT, d_iwT = outer_arg_grads(ys[:n_real], seeds[:n_real], t0s[:n_real],
                                      hs[:n_real], i10[:n_real], pw, sc, kv)
        return d_wT, d_iwT, ybar + ys_bar[0], None, None, None, None, None


def sdeint_fused(pw: dict, sc: SDEConsts, kv, y0, ts_steps, noise_pack,
                 bptt_every: int | None = None, n_real: int | None = None):
    """Lane-batched variable-step SRA1: y0 (B, 3P) packs B lanes, each
    advancing its own step grid row of ``ts_steps`` (B, n + 1);
    ``noise_pack`` = (dw, i10), each (n, B). ``pw`` = {"wT", "iwT"} (the
    differentiable premixed weights), ``kv`` (K, B, n_in) the knot values.
    ``n_real``: the leading real steps (the rest must be h == 0 padding
    with zero noise and zero cotangents), an int read on the host.
    ``bptt_every`` (in steps of this grid) truncates the reverse sweep where
    the JAX package's chunking does. Returns ys (n + 1, B, 3P); ys[i, b]
    is lane b's state at its own ts_steps[b, i]."""
    ts_steps = ts_steps.to(torch.float32)
    B = ts_steps.shape[0]
    if tuple(y0.shape[:1]) != (B,):
        raise ValueError(f"lane-batched ts_steps rows ({B}) must match y0's "
                         f"leading lane axis ({y0.shape[0]})")
    n = ts_steps.shape[1] - 1
    dw, i10 = (x.to(torch.float32).contiguous() for x in noise_pack)
    t0s = ts_steps[:, :-1].T.contiguous()
    hs = (ts_steps[:, 1:] - ts_steps[:, :-1]).T.contiguous()
    stride = truncation_stride(tuple(y0.shape), n, bptt_every)
    spec = (sc, kv.contiguous(), n if n_real is None else int(n_real), stride)
    return _Replay.apply(pw["wT"], pw["iwT"], y0, t0s, hs, dw, i10, spec)
