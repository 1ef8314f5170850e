"""Stimulus lookup on a uniform time grid (port of ``interp_at`` in
``columnflow/ops/interp.py``)."""

from __future__ import annotations

import torch


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
