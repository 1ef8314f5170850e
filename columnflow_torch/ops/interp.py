"""Stimulus lookup (port of ``interp_at``, ``interp_knots`` and
``step_table_knots`` in ``columnflow/ops/interp.py``)."""

from __future__ import annotations

import torch

from columnflow_torch.ops.arith import div


def interp_at(x, t0, dt, fp):
    """Linear interpolation of fp (shape (T, ...)) at scalar x on the uniform
    grid t0 + dt*arange(T), clamped to the table's range; O(1) index."""
    T = fp.shape[0]
    x = torch.as_tensor(x, dtype=fp.dtype, device=fp.device)
    pos = torch.clamp((x - t0) / dt, 0.0, T - 1.0)
    idx = torch.clamp(torch.floor(pos).to(torch.int64), 0, T - 2)
    frac = pos - idx
    y0 = fp[idx]
    y1 = fp[idx + 1]
    frac = torch.reshape(frac, frac.shape + (1,) * (fp.ndim - 1))
    return y0 + frac * (y1 - y0)


def knot_constants(knot_ts):
    """Per segment k = 1..K-1 the float32 constants the interpolation
    computes with: the start time t_{k-1} and the span t_k - t_{k-1}, each a
    Python-float expression rounded to float32 once, as the JAX package's
    weak-typed floats are."""
    c0 = [float(torch.tensor(float(knot_ts[k - 1]), dtype=torch.float32))
          for k in range(1, len(knot_ts))]
    span = [float(torch.tensor(float(knot_ts[k]) - float(knot_ts[k - 1]),
                               dtype=torch.float32))
            for k in range(1, len(knot_ts))]
    return c0, span


def interp_knots(t, knot_ts, knot_vals):
    """Piecewise-linear interpolation through K static knots, in the
    telescoped form vals[0] + sum_k clip((t - t_{k-1}) / (t_k - t_{k-1}),
    0, 1) * (vals[k] - vals[k-1]). ``knot_ts``: K host floats (ascending);
    ``knot_vals``: (K, ...) values; ``t`` broadcasts against vals[0]."""
    t = torch.as_tensor(t, dtype=knot_vals.dtype, device=knot_vals.device)
    out = knot_vals[0]
    for c0, span, k in zip(*knot_constants(knot_ts), range(1, len(knot_ts))):
        frac = torch.clamp(div(t - c0, span), 0.0, 1.0)
        out = out + frac * (knot_vals[k] - knot_vals[k - 1])
    return out


def step_table_knots(time_steps: int, dt: float, off_vals, on_vals):
    """Knots reproducing ``interp_at`` on a half-off / half-on step table:
    off until row T//2 - 1, a one-step ramp, then on. Returns
    (knot_ts (4,) host floats, knot_vals (4, ...))."""
    hl = time_steps // 2
    knot_ts = (0.0, (hl - 1) * dt, hl * dt, (time_steps - 1) * dt)
    vals = torch.stack([off_vals, off_vals, on_vals, on_vals])
    return knot_ts, vals
