"""The XOR network's fixed-grid SDE kernels: SRA1 on the uniform grid and
its reverse sweep in kernel mode (ports of ``_make_sde_chunk_kernel`` in
its uniform-grid mode and ``_make_sde_bwd_chunk_kernel`` with the argument
cotangents in the kernel, ``columnflow/solvers/fused.py``, traced there
with ``xor_drift_batched`` and the membrane-only diffusion sigma = 10).

    wrapper       kernel            plain version         replaces (columnflow/solvers/fused.py)
    xor_sde_fwd   cf_xor_sde_fwd    _xor_sde_fwd_plain    _make_sde_chunk_kernel, uniform grid (B3u)
    xor_sde_bwd   cf_xor_sde_bwd    _xor_sde_bwd_plain    _make_sde_bwd_chunk_kernel, kernel mode (B4')

The plain versions step with ``solvers.sde._sra1_step``; each lane's scalar
Brownian integrals (i1, i10) drive its 72 components, the diffusion being
10 on the membrane block and 0 elsewhere. The step times t0s come from
``solvers.fused.uniform_step_times`` (the JAX kernel's own float32
arithmetic). The reverse sweep recomputes f1 and the second stage's state
from the stored trajectory and returns the four ff rows' cotangents: each
drift VJP's contracted over the batch, the step's two added, the steps'
sums added to the accumulators from the last step back.

The wrappers take the plain version for tensors on the CPU; for CUDA
tensors they launch the kernel or raise. ``LAUNCHES`` counts kernel
launches (the plain versions count nothing).
"""

from __future__ import annotations

import torch

from columnflow_torch.kernels.network_sde import SDEConsts, _check, _lib, _on_cuda, _stream
from columnflow_torch.kernels.xor_ode import (
    _F32,
    unpack_rows,
    xor_args,
    xor_named,
    xor_ode_drift,
    xor_ode_drift_vjp,
)
from columnflow_torch.models.xor import PF_KEYS, XOR_STATE_DIM, xor_diffusion
from columnflow_torch.ops.arith import div
from columnflow_torch.solvers.sde import _sra1_step

LAUNCHES = {"xor_sde_fwd": 0, "xor_sde_bwd": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


@torch.no_grad()
def _xor_sde_fwd_plain(y0, t0s, h: float, i1, i10, pf, sc, kv):
    """ys (n + 1, B, 72): ys[0] = y0, ys[k + 1] after step k."""
    drift = lambda t, y: xor_ode_drift(t, y, pf, sc, kv)  # noqa: E731
    hh = torch.tensor(h, dtype=_F32, device=y0.device)
    ys, y = [y0], y0
    for k in range(t0s.shape[0]):
        y = _sra1_step(drift, xor_diffusion, t0s[k], y, hh, i1[k], i10[k], ())
        ys.append(y)
    return torch.stack(ys)


def xor_sde_step_vjp(t0, h, y, i10, c, pf, sc: SDEConsts, kv):
    """The VJP of one SRA1 step at (t0, h, y) with i10 (B,) for the
    cotangent c of its output: (state cotangent, the four rows' cotangents
    of the step). f2's cotangent is 2 (h c / 3), f1's h c / 3 plus 0.75 h
    times the second stage state's cotangent."""
    i10_h = (i10 / torch.where(h > 0, h, 1.0))[:, None]
    f1 = xor_ode_drift(t0, y, pf, sc, kv)
    h2 = y + (0.75 * h) * f1 + (1.5 * i10_h) * xor_diffusion(t0, y)
    c3 = div(h * c, 3.0)
    c_h2, rows2 = xor_ode_drift_vjp(t0 + 0.75 * h, h2, c3 * 2.0, pf, sc, kv)
    c_y, rows1 = xor_ode_drift_vjp(t0, y, c3 + (0.75 * h) * c_h2, pf, sc, kv)
    return (c + c_h2) + c_y, {k: rows2[k] + rows1[k] for k in PF_KEYS}


@torch.no_grad()
def _xor_sde_bwd_plain(ys, ysbar, t0s, h: float, i10, pf, sc, kv):
    """The reverse sweep over steps n-1..0 with the seed ybar + ysbar[k + 1]
    on step k's output: (the state cotangent before step 0, without
    ysbar[0]; the four rows' cotangents)."""
    hh = torch.tensor(h, dtype=_F32, device=ys.device)
    ybar = torch.zeros_like(ys[0])
    acc = {k: torch.zeros_like(pf[k]) for k in PF_KEYS}
    for k in range(t0s.shape[0] - 1, -1, -1):
        ybar, rows = xor_sde_step_vjp(t0s[k], hh, ys[k], i10[k], ybar + ysbar[k + 1], pf, sc, kv)
        acc = {key: acc[key] + rows[key] for key in PF_KEYS}
    return ybar, acc


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on CUDA, anything else raises
# ---------------------------------------------------------------------------


def _grid_named(t0s, i10, B):
    n = t0s.shape[0]
    return {"t0s": (t0s, _F32, (n,)), "i10": (i10, _F32, (n, B))}


def xor_sde_fwd(y0, t0s, h: float, i1, i10, pf, sc: SDEConsts, kv):
    """SRA1 on the uniform grid: y0 (B, 72), t0s (n,) the step times, h the
    step (a float32 value), i1 and i10 (n, B) each lane's Brownian
    integrals. Returns ys (n + 1, B, 72)."""
    B, n = y0.shape[0], t0s.shape[0]
    named = {**xor_named(B, pf, sc, kv), **_grid_named(t0s, i10, B),
             "y0": (y0, _F32, (B, XOR_STATE_DIM)), "i1": (i1, _F32, (n, B))}
    if not _on_cuda(y0, named):
        return _xor_sde_fwd_plain(y0, t0s, h, i1, i10, pf, sc, kv)
    ys = torch.empty((n + 1, B, XOR_STATE_DIM), dtype=_F32, device=y0.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    _check(_lib().cf_xor_sde_fwd(*dims, hc_p, n, h, *ptrs, t0s.data_ptr(), i1.data_ptr(),
                                 i10.data_ptr(), y0.data_ptr(), ys.data_ptr(), _stream(y0)),
           "xor_sde_fwd")
    LAUNCHES["xor_sde_fwd"] += 1
    return ys


def xor_sde_bwd(ys, ysbar, t0s, h: float, i10, pf, sc: SDEConsts, kv):
    """The kernel-mode reverse sweep: ys (n + 1, B, 72) the trajectory,
    ysbar (n + 1, B, 72) its cotangent. Returns (the state cotangent before
    step 0 without ysbar[0], the four rows' cotangents)."""
    n, B = t0s.shape[0], ys.shape[1]
    named = {**xor_named(B, pf, sc, kv), **_grid_named(t0s, i10, B),
             "ys": (ys, _F32, (n + 1, B, XOR_STATE_DIM)),
             "ysbar": (ysbar, _F32, (n + 1, B, XOR_STATE_DIM))}
    if not _on_cuda(ys, named):
        return _xor_sde_bwd_plain(ys, ysbar, t0s, h, i10, pf, sc, kv)
    ybar = torch.empty((B, XOR_STATE_DIM), dtype=_F32, device=ys.device)
    drows = torch.empty(48, dtype=_F32, device=ys.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    _check(_lib().cf_xor_sde_bwd(*dims, hc_p, n, h, *ptrs, t0s.data_ptr(), i10.data_ptr(),
                                 ys.data_ptr(), ysbar.data_ptr(), ybar.data_ptr(),
                                 drows.data_ptr(), _stream(ys)), "xor_sde_bwd")
    LAUNCHES["xor_sde_bwd"] += 1
    return ybar, unpack_rows(drows)
