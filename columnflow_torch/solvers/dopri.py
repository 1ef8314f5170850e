"""Adaptive Dormand-Prince 4(5) forward solves with one controller per lane
(port of the forward-only part of ``columnflow/solvers/dopri.py``:
``_adaptive_pass`` then ``_replay_pass``, as ``jax.vmap`` of ``odeint(...,
method="dopri5", adjoint="none")`` runs them).

Pure PyTorch: every lane steps together, each with its own time, step size,
accept decision and accepted step times; a lane that has reached the end
(or its step budget) is masked, as ``vmap`` of a ``while_loop`` behaves.
The accepted grid is then re-stepped (the replay, with h = t_{k+1} - t_k)
and the outputs at ``ts`` come from Hairer's CONTD5 interpolant of the step
that holds each of them. No gradients: the dataset's ground truth is all
that calls it.

Only what the Hopf dataset runs is ported: dopri5, the I controller,
Hairer's initial step, the RMS error norm over each lane's state, no step
or jump times. Any other option raises ``NotImplementedError`` naming
ROADMAP.md A7.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from columnflow_torch.solvers import rk

_SAFETY, _IFACTOR, _DFACTOR, _ORDER = 0.9, 10.0, 0.2, 5


class LaneStats(NamedTuple):
    """Per-lane solver statistics (each (N,))."""

    naccept: torch.Tensor
    nreject: torch.Tensor
    success: torch.Tensor


def _rms(x):
    """RMS over each lane's state: x (N, ...) -> (N,)."""
    return torch.sqrt(torch.mean(torch.square(x.flatten(1)), dim=1))


def _col(v, y):
    """A per-lane (N,) value broadcast against y (N, ...)."""
    return v.reshape(v.shape + (1,) * (y.dim() - 1))


def _step(f, t, y, h, f0):
    """One dopri5 step of every lane, in the JAX package's unfused form:
    Y_i = y + h sum_j a_ij k_j, y1 = y + h sum_j b_j k_j; returns (y1,
    ks)."""
    hc = _col(h, y)
    ks = [f0]
    for i in range(1, rk.N_STAGES):
        incr = sum(a * ks[j] for j, a in enumerate(rk.A[i]))
        ks.append(f(t + rk.C[i] * h, y + hc * incr))
    y1 = y + hc * sum(b * k for b, k in zip(rk.B, ks))
    return y1, ks


def _initial_step(f, t0, y0, f0, rtol, atol):
    """Hairer's starting step per lane (``_initial_step_size``)."""
    scale = atol + rtol * y0.abs()
    d0, d1 = _rms(y0 / scale), _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    f1 = f(t0 + h0, y0 + _col(h0, y0) * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), torch.clamp_min(h0 * 1e-3, 1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1.0 / _ORDER))
    return torch.minimum(100.0 * h0, h1)


def _next_step(h, ratio):
    factor = torch.clamp(_SAFETY * ratio ** (-1.0 / _ORDER), _DFACTOR, _IFACTOR)
    return h * torch.where(ratio <= 0.0, torch.full_like(factor, _IFACTOR), factor)


def _dense_coeffs(y0, y1, h, ks):
    """Hairer's CONTD5 rows (5, N, ...) of one step of every lane."""
    hc = _col(h, y0)
    dy = y1 - y0
    r3 = hc * ks[0] - dy
    r4 = dy - hc * ks[-1] - r3
    r5 = hc * sum(d * k for d, k in zip(rk.DOPRI5_DENSE_D, ks))
    return torch.stack([y0, dy, r3, r4, r5])


@torch.no_grad()
def odeint_dopri5_lanes(f, y0, ts, *, rtol: float = 1e-7, atol: float = 1e-9,
                        max_steps: int = 4096, method: str = "dopri5",
                        controller: str = "i", dt0=None, return_stats: bool = False):
    """Solve dy/dt = f(t, y) for every lane of y0 (N, ...) with its own
    adaptive controller, forward only; ``f`` maps (t (N,), y (N, ...)) to
    (N, ...). Returns ys (len(ts), N, ...) with ys[0] = y0 (and
    ``LaneStats`` with ``return_stats``)."""
    if method != "dopri5" or controller != "i" or dt0 is not None:
        raise NotImplementedError(
            f"method={method!r}, controller={controller!r}, dt0={dt0!r}: only dopri5 with the "
            "I controller and Hairer's initial step is ported (ROADMAP.md A7: the other "
            "tableaus, controllers and options of solvers/dopri.py)")
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    N, dev = y0.shape[0], y0.device
    t_start, t_end = ts[0], ts[-1]
    M = max_steps

    t = t_start.expand(N).clone()
    y, f0 = y0, f(t, y0)
    h = torch.minimum(_initial_step(f, t, y0, f0, rtol, atol), t_end - t_start)
    st = torch.full((N, M + 1), float(t_end), dtype=y0.dtype, device=dev)
    st[:, 0] = t_start
    na = torch.zeros(N, dtype=torch.int64, device=dev)
    nr = torch.zeros_like(na)
    lanes = torch.arange(N, device=dev)
    while True:
        active = (t < t_end) & (na < M) & (nr < 4 * M + 64)
        if not bool(active.any()):
            break
        h = torch.minimum(h, t_end - t)
        y1, ks = _step(f, t, y, h, f0)
        err = _col(h, y) * sum(e * k for e, k in zip(rk.B_ERR, ks))
        ratio = _rms(err / (atol + rtol * torch.maximum(y.abs(), y1.abs())))
        accept = (ratio <= 1.0) & active
        t = torch.where(accept, t + h, t)
        y = torch.where(_col(accept, y), y1, y)
        f0 = torch.where(_col(accept, y), ks[-1], f0)
        na = na + accept.long()
        nr = nr + (active & ~accept).long()
        st[lanes[accept], na[accept]] = t[accept]
        h = torch.where(active, _next_step(h, ratio), h)

    # The replay over the frozen grid (h = 0 past a lane's last step), its
    # dense rows kept for the interpolation.
    n = max(int(na.max()), 1)
    coeffs, yk = [], y0
    fk = f(st[:, 0], yk)
    for k in range(n):
        hk = st[:, k + 1] - st[:, k]
        y1, ks = _step(f, st[:, k], yk, hk, fk)
        coeffs.append(_dense_coeffs(yk, y1, hk, ks))
        yk, fk = y1, ks[-1]
    coeffs = torch.stack(coeffs)  # (n, 5, N, ...)

    idx = torch.searchsorted(st[:, :n + 1].contiguous(), ts.expand(N, -1).contiguous(),
                             right=True) - 1
    idx = torch.minimum(torch.clamp_min(idx, 0), torch.clamp_min(na[:, None] - 1, 0))  # (N, T)
    t0s = torch.gather(st, 1, idx)
    hs = torch.gather(st, 1, idx + 1) - t0s
    pos = hs > 0
    theta = torch.where(pos, (ts[None] - t0s) / torch.where(pos, hs, torch.ones_like(hs)),
                        torch.zeros_like(hs)).T  # (T, N)
    rows = coeffs[idx.T, :, lanes[None, :]]  # (T, N, 5, ...)
    r1, r2, r3, r4, r5 = rows.unbind(2)
    th = theta.reshape(theta.shape + (1,) * (y0.dim() - 1))
    s1 = 1.0 - th
    ys = r1 + th * (r2 + s1 * (r3 + th * (r4 + s1 * r5)))
    ys[0] = y0
    if return_stats:
        return ys, LaneStats(na, nr, t >= t_end)
    return ys
