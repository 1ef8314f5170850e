"""The XOR network's SDE kernels: the fixed-grid step (SRA1 on the uniform
grid and its reverse sweep in kernel mode) and the adaptive step (each
lane's step-size selection, the lane-batched replay over the frozen grids
and its reverse sweep in kernel mode). Ports of the Pallas kernels of
``columnflow/solvers/fused.py`` and ``sde_adaptive.py`` traced with
``xor_drift_batched`` and the membrane-only diffusion sigma = 10, and of the
XLA selection loop ``_adaptive_pass`` as a kernel.

    wrapper             kernel                 plain version             replaces (columnflow/solvers/)
    xor_sde_fwd         cf_xor_sde_fwd         _xor_sde_fwd_plain        fused.py _make_sde_chunk_kernel, uniform grid (B3u)
    xor_sde_bwd         cf_xor_sde_bwd         _xor_sde_bwd_plain        fused.py _make_sde_bwd_chunk_kernel, kernel mode (B4')
    xor_sde_select      cf_xor_sde_select      _xor_select_plain         sde_adaptive.py _make_sde_adaptive_kernel (B5x, krng
                                                                         tree), and the XLA selection _adaptive_pass
                                                                         (jax.random tree)
    xor_sde_attempt     cf_xor_sde_attempt     _xor_attempt_plain        one iteration of that loop's body
    xor_sde_replay_fwd  cf_xor_sde_replay_fwd  _xor_replay_fwd_plain     fused.py _make_sde_chunk_kernel, lanes (B3xl)
    xor_sde_replay_bwd  cf_xor_sde_replay_bwd  _xor_replay_bwd_plain     fused.py _make_sde_bwd_chunk_kernel, kernel mode,
                                                                         lanes (B4'xl)

The fixed-grid plain versions step with ``solvers.sde._sra1_step``; each
lane's scalar Brownian integrals (i1, i10) drive its 72 components, the
diffusion being 10 on the membrane block and 0 elsewhere. The step times
t0s come from ``solvers.fused.uniform_step_times`` (the JAX kernel's own
float32 arithmetic). The reverse sweeps recompute f1 and the second stage's
state from the stored trajectory and return the four ff rows' cotangents:
each drift VJP's contracted over the batch, the step's two added, the
steps' sums added to the accumulators from the last step back (on the
lanes' grids chunk by chunk, as the JAX kernel's chunks add them).

The selection's plain version is the network's loop
(``kernels.network_sde.select_pass``'s ``select_plain``/``attempt_plain``)
on the XOR drift, the float32 ``xor_drift_batched`` with each lane's knot
values; the lanes' replay is ``sra1_replay_plain`` on it, each lane at its
own step times (h == 0 padding steps are exact no-ops).

The wrappers take the plain version for tensors on the CPU; for CUDA
tensors they launch the kernel or raise. ``LAUNCHES`` counts kernel
launches (the plain versions count nothing).
"""

from __future__ import annotations

import torch

from columnflow_torch.kernels.network_sde import (
    TREES,
    Attempt,
    SDEConsts,
    SelectConfig,
    _check,
    _lib,
    _on_cuda,
    _stream,
    _words32,
    attempt_plain,
    select_plain,
    sra1_replay_plain,
)
from columnflow_torch.kernels.network_sde import _select_host as _sde_select_host
from columnflow_torch.kernels.xor_ode import (
    _F32,
    _f,
    unpack_rows,
    xor_args,
    xor_named,
    xor_ode_drift,
    xor_ode_drift_vjp,
)
from columnflow_torch.models.xor import PF_KEYS, XOR_STATE_DIM, xor_diffusion
from columnflow_torch.ops.arith import div
from columnflow_torch.solvers.sde import _sra1_step

LAUNCHES = {"xor_sde_fwd": 0, "xor_sde_bwd": 0, "xor_sde_select": 0, "xor_sde_attempt": 0,
            "xor_sde_replay_fwd": 0, "xor_sde_replay_bwd": 0}
_I64 = torch.int64


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
    """The VJP of one SRA1 step at (t0, h, y) with i10 (B,) (t0 and h
    scalars) or (B, 1) (t0 and h (B, 1), each lane's own step) for the
    cotangent c of its output: (state cotangent, the four rows' cotangents
    of the step). f2's cotangent is 2 (h c / 3), f1's h c / 3 plus 0.75 h
    times the second stage state's cotangent."""
    i10_h = (i10 / torch.where(h > 0, h, 1.0)).reshape(-1, 1)
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



def _xor_attempt_plain(t1, y1, h, err_prev, w_t1, words, pf, sc, kv, cfg: SelectConfig) -> Attempt:
    return attempt_plain(_f(pf, sc, kv), xor_diffusion, t1, y1, h, err_prev, w_t1, words, cfg)


def _xor_select_plain(y0, words, pf, sc, kv, cfg: SelectConfig):
    return select_plain(_f(pf, sc, kv), xor_diffusion, y0, words, cfg)


@torch.no_grad()
def _xor_replay_fwd_plain(y0, t0s, hs, i1, i10, n_real, pf, sc, kv):
    """ys (n + 1, B, 72) over each lane's grid (t0s, hs (n, B))."""
    return sra1_replay_plain(_f(pf, sc, kv), xor_diffusion(None, y0), y0, t0s, hs, i1, i10,
                             n_real)


@torch.no_grad()
def _xor_replay_bwd_plain(ys, ysbar, t0s, hs, i10, n_real, chunk, pf, sc, kv):
    """The reverse sweep over steps n_real-1..0 of each lane's grid with the
    seed ybar + ysbar[k + 1] on step k's output: (the state cotangent
    before step 0, without ysbar[0]; the four rows' cotangents). The steps'
    rows add in float32 within each chunk of ``chunk`` steps, and each
    chunk's sum adds to the total after its first step (k % chunk == 0)."""
    ybar = torch.zeros_like(ys[0])
    acc = {k: torch.zeros_like(pf[k]) for k in PF_KEYS}
    part = dict(acc)
    for k in range(n_real - 1, -1, -1):
        ybar, rows = xor_sde_step_vjp(t0s[k, :, None], hs[k, :, None], ys[k], i10[k, :, None],
                                      ybar + ysbar[k + 1], pf, sc, kv)
        part = {key: part[key] + rows[key] for key in PF_KEYS}
        if k % chunk == 0:
            acc = {key: acc[key] + part[key] for key in PF_KEYS}
            part = {key: torch.zeros_like(pf[key]) for key in PF_KEYS}
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


def _select_named(pf, sc, kv, B, cfg: SelectConfig):
    if cfg.brownian not in TREES:
        raise ValueError(f"unknown brownian backend {cfg.brownian!r}")
    if cfg.drift != "f32":
        raise ValueError(f"the XOR selection runs on the float32 drift, got drift {cfg.drift!r}")
    return xor_named(B, pf, sc, kv)


def xor_sde_select(y0, words, pf, sc: SDEConsts, kv, cfg: SelectConfig):
    """The step-size selection of every lane on the XOR drift: y0 (B, 72),
    words (B, 4) (k0, k1, j0, j1 as int64: the tree's key and the
    space-time integrals' key of ``cfg.brownian``), kv (K, B, 32) each
    lane's knot values. Returns (step_times (B, M+1), naccept, nreject (B,)
    int32, success (B,) bool). One block per lane on the card."""
    B = y0.shape[0]
    named = {**_select_named(pf, sc, kv, B, cfg), "y0": (y0, _F32, (B, XOR_STATE_DIM)),
             "words": (words, _I64, (B, 4))}
    if not _on_cuda(y0, named):
        return _xor_select_plain(y0, words, pf, sc, kv, cfg)
    st = torch.empty((B, cfg.max_steps + 1), dtype=_F32, device=y0.device)
    stats = torch.empty((B, 3), dtype=torch.int32, device=y0.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    keep_s, _, hs_p = _sde_select_host(sc, cfg)
    w32 = _words32(words)
    _check(_lib().cf_xor_sde_select(*dims, hc_p, hs_p, cfg.max_steps, cfg.depth,
                                    TREES[cfg.brownian], *ptrs, w32.data_ptr(), y0.data_ptr(),
                                    st.data_ptr(), stats.data_ptr(), _stream(y0)),
           "xor_sde_select")
    LAUNCHES["xor_sde_select"] += 1
    return st, stats[:, 0], stats[:, 1], stats[:, 2] > 0


def xor_sde_attempt(t1, y1, h, err_prev, w_t1, words, pf, sc: SDEConsts, kv,
                    cfg: SelectConfig) -> Attempt:
    """One controller attempt for each of N records (t1, h, err_prev, w_t1
    (N, 1); y1 (N, 72); kv (K, N, 32): record r takes lane r's knot
    values): the body of the selection kernel."""
    N = y1.shape[0]
    named = {**_select_named(pf, sc, kv, N, cfg), "y1": (y1, _F32, (N, XOR_STATE_DIM)),
             "t1": (t1, _F32, (N, 1)), "h": (h, _F32, (N, 1)),
             "err_prev": (err_prev, _F32, (N, 1)), "w_t1": (w_t1, _F32, (N, 1)),
             "words": (words, _I64, (N, 4))}
    if not _on_cuda(y1, named):
        return _xor_attempt_plain(t1, y1, h, err_prev, w_t1, words, pf, sc, kv, cfg)
    y_new = torch.empty_like(y1)
    rec = torch.empty((N, 6), dtype=_F32, device=y1.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    keep_s, _, hs_p = _sde_select_host(sc, cfg)
    w32 = _words32(words)
    _check(_lib().cf_xor_sde_attempt(*dims, hc_p, hs_p, cfg.depth, TREES[cfg.brownian], *ptrs,
                                     w32.data_ptr(), t1.data_ptr(), y1.data_ptr(), h.data_ptr(),
                                     err_prev.data_ptr(), w_t1.data_ptr(), y_new.data_ptr(),
                                     rec.data_ptr(), _stream(y1)), "xor_sde_attempt")
    LAUNCHES["xor_sde_attempt"] += 1
    col = [rec[:, i:i + 1] for i in range(6)]
    return Attempt(y_new, col[0], col[1] > 0, col[2], col[3], col[4],
                   torch.clamp_min(col[0], 1e-10), col[5])


def _lanes_named(t0s, hs, i10, n_real, B):
    n = t0s.shape[0]
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real must lie in [0, {n}], got {n_real}")
    return {"t0s": (t0s, _F32, (n, B)), "hs": (hs, _F32, (n, B)), "i10": (i10, _F32, (n, B))}


def xor_sde_replay_fwd(y0, t0s, hs, i1, i10, n_real: int, pf, sc: SDEConsts, kv):
    """SRA1 over each lane's frozen grid: y0 (B, 72); t0s, hs, i1, i10
    (n, B) each lane's step times, sizes and Brownian integrals; the first
    ``n_real`` steps are integrated, the rest are h == 0 padding. Returns ys
    (n + 1, B, 72); rows past n_real hold the carried state."""
    B, n = y0.shape[0], t0s.shape[0]
    named = {**xor_named(B, pf, sc, kv), **_lanes_named(t0s, hs, i10, n_real, B),
             "y0": (y0, _F32, (B, XOR_STATE_DIM)), "i1": (i1, _F32, (n, B))}
    if not _on_cuda(y0, named):
        return _xor_replay_fwd_plain(y0, t0s, hs, i1, i10, n_real, pf, sc, kv)
    ys = torch.empty((n + 1, B, XOR_STATE_DIM), dtype=_F32, device=y0.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    _check(_lib().cf_xor_sde_replay_fwd(*dims, hc_p, n, int(n_real), *ptrs, t0s.data_ptr(),
                                        hs.data_ptr(), i1.data_ptr(), i10.data_ptr(),
                                        y0.data_ptr(), ys.data_ptr(), _stream(y0)),
           "xor_sde_replay_fwd")
    LAUNCHES["xor_sde_replay_fwd"] += 1
    return ys


def xor_sde_replay_bwd(ys, ysbar, t0s, hs, i10, n_real: int, chunk: int, pf, sc: SDEConsts, kv):
    """The kernel-mode reverse sweep of ``xor_sde_replay_fwd``: ys (n + 1,
    B, 72) the trajectory, ysbar (n + 1, B, 72) its cotangent (rows past
    n_real are not read). ``chunk``: the steps whose rows' cotangents the
    JAX kernel sums before adding them to the total. Returns (the state
    cotangent before step 0 without ysbar[0], the four rows' cotangents)."""
    n, B = t0s.shape[0], ys.shape[1]
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    named = {**xor_named(B, pf, sc, kv), **_lanes_named(t0s, hs, i10, n_real, B),
             "ys": (ys, _F32, (n + 1, B, XOR_STATE_DIM)),
             "ysbar": (ysbar, _F32, (n + 1, B, XOR_STATE_DIM))}
    if not _on_cuda(ys, named):
        return _xor_replay_bwd_plain(ys, ysbar, t0s, hs, i10, n_real, chunk, pf, sc, kv)
    ybar = torch.empty((B, XOR_STATE_DIM), dtype=_F32, device=ys.device)
    drows = torch.empty(48, dtype=_F32, device=ys.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    _check(_lib().cf_xor_sde_replay_bwd(*dims, hc_p, n, int(n_real), int(chunk), *ptrs,
                                        t0s.data_ptr(), hs.data_ptr(), i10.data_ptr(),
                                        ys.data_ptr(), ysbar.data_ptr(), ybar.data_ptr(),
                                        drows.data_ptr(), _stream(ys)), "xor_sde_replay_bwd")
    LAUNCHES["xor_sde_replay_bwd"] += 1
    return ybar, unpack_rows(drows)
