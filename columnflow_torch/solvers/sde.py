"""Fixed-step stochastic Runge-Kutta for additive noise (the subset of
``columnflow/solvers/sde.py`` the WTA task runs).

``sdeint(..., method="srk", additive=True, noise="scalar")`` is Rossler's
SRA1 on the output grid ``ts``, one step per interval, written in plain
torch and differentiated by autograd (backprop through every solver step).

Lanes: the JAX package integrates one trajectory and ``vmap``s over samples.
Here the leading axes of ``y0`` are independent lanes written out: y0 has
shape (*lanes, n), and "scalar" noise is one Brownian motion per lane, so
the increments have shape (T-1, *lanes) — ``vmap(sdeint)`` in one call.
"""

from __future__ import annotations

from typing import Callable

import torch


def brownian_pack(generator: torch.Generator, ts, noise_shape, dtype=torch.float32):
    """Per-step stochastic integrals for strong-1.5 SRK schemes.

    Returns (hs, I1, I10, I11, I111), each with leading axis = num steps:
        I1   = dW                 ~ N(0, h)
        I10  = int_t^t+h (W_s - W_t) ds = h*(dW/2 + sqrt(h/12) Z), Z indep
        I11  = (dW^2 - h)/2
        I111 = (dW^3 - 3h dW)/6
    The normals come from ``generator`` on its own device.
    """
    noise_shape = tuple(noise_shape)
    n = ts.shape[0] - 1
    hs = (ts[1:] - ts[:-1]).to(dtype)
    hs_b = torch.reshape(hs, (n,) + (1,) * len(noise_shape))
    z_w = torch.randn((n,) + noise_shape, generator=generator, dtype=dtype,
                      device=generator.device).to(ts.device)
    z_h = torch.randn((n,) + noise_shape, generator=generator, dtype=dtype,
                      device=generator.device).to(ts.device)
    i1 = torch.sqrt(hs_b) * z_w
    i10 = hs_b * (0.5 * i1 + torch.sqrt(hs_b / 12.0) * z_h)
    i11 = 0.5 * (i1 * i1 - hs_b)
    i111 = (i1 * i1 * i1 - 3.0 * hs_b * i1) / 6.0
    return hs, i1, i10, i11, i111


def _sra1_step(drift, diffusion, t, y, h, i1, i10, args):
    """One SRA1 step (2 drift + 2 diffusion evaluations), additive noise.
    h == 0 safe (an exact no-op). ``i1``/``i10`` have the lane shape."""
    i10_h = (i10 / torch.where(h > 0, h, 1.0)).unsqueeze(-1)
    i1 = i1.unsqueeze(-1)
    g_end = diffusion(t + h, y, *args)
    g_start = diffusion(t, y, *args)
    f1 = drift(t, y, *args)
    h2 = y + 0.75 * h * f1 + 1.5 * i10_h * g_end
    f2 = drift(t + 0.75 * h, h2, *args)
    return (
        y + h * (f1 / 3.0 + 2.0 * f2 / 3.0)
        + (i1 - i10_h) * g_end + i10_h * g_start
    )


def sdeint(
    drift: Callable,
    diffusion: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    generator: torch.Generator | None = None,
    *args,
    method: str = "srk",
    noise: str = "scalar",
    additive: bool = False,
    noise_pack=None,
):
    """Integrate dy = drift dt + diffusion dW on the grid ``ts`` with SRA1.

    Args:
        drift, diffusion: ``f(t, y, *args)``; diffusion returns y's shape.
        y0: (*lanes, n) initial state.
        ts: (T,) increasing times; one solver step per interval.
        generator: draws the Brownian pack when ``noise_pack`` is None.
        noise_pack: precomputed (i1, i10, i11, i111), each (T-1, *lanes);
            SRA1 reads i1 and i10 only.

    Only ``method="srk"`` with ``additive=True`` and ``noise="scalar"`` is
    ported; anything else raises ``NotImplementedError``.

    Returns ys with shape (T, *lanes, n); ys[0] == y0.
    """
    if method != "srk" or not additive or noise != "scalar":
        raise NotImplementedError(
            f"columnflow_torch.sdeint ports SRA1 only (method='srk', "
            f"additive=True, noise='scalar'); got method={method!r}, "
            f"additive={additive}, noise={noise!r}")
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    if noise_pack is None:
        if generator is None:
            raise ValueError("sdeint needs a generator or a noise_pack")
        hs, i1, i10, _, _ = brownian_pack(generator, ts, y0.shape[:-1], y0.dtype)
    else:
        hs = ts[1:] - ts[:-1]
        i1, i10 = noise_pack[0], noise_pack[1]
    ys = [y0]
    y = y0
    for k in range(ts.shape[0] - 1):
        y = _sra1_step(drift, diffusion, ts[k], y, hs[k], i1[k], i10[k], args)
        ys.append(y)
    return torch.stack(ys)
