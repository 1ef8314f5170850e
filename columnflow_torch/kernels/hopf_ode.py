"""The Hopf MLP drift's dopri5 kernels: adaptive step-size selection, the
dense-output replay over the frozen grid, and its reverse sweep in kernel
mode (ports of the three Pallas kernels of ``odeint_dopri5_fused`` in
``columnflow/solvers/fused.py``, traced there with ``hopf_mlp_drift`` and
``interp_at_onehot``).

Each kernel is CUDA C++ in ``csrc/hopf_ode.cu`` (built by ``_build``) with a
plain PyTorch version beside it that repeats its arithmetic:

    wrapper           kernel               plain version            replaces (columnflow/solvers/fused.py)
    hopf_select       cf_hopf_select       _hopf_select_plain       _make_adaptive_kernel (B6h)
    hopf_attempt      cf_hopf_attempt      _hopf_attempt_plain      one iteration of that kernel's body
    hopf_replay_fwd   cf_hopf_replay_fwd   _hopf_replay_fwd_plain   _make_replay_chunk_kernel (B7h)
    hopf_replay_bwd   cf_hopf_replay_bwd   _hopf_replay_bwd_plain   _make_bwd_chunk_kernel, kernel mode (B8h)

The plain versions are the network engine's (``kernels.network_ode``
``select_plain``, ``attempt_plain``, ``replay_fwd_plain``, ``rk_step_vjp``)
on ``models.hopf.hopf_mlp_drift`` with the one-hot blend lookup of mu
(``ops.interp.interp_at_onehot``) and the hand-written VJP
``hopf_mlp_drift_vjp``. One controller steers the whole (B, 2) batch state,
as in the JAX package. The reverse sweep returns the eight parameter
tensors' cotangents: each drift VJP's contracted over the lanes, the seven
of a step added from stage 6 down, the steps' sums added to the
accumulators step by step, from the last step back.

The kernels hold the reference width only: the MLP 3 -> 100 -> 100 -> 100
-> 2 (``models.hopf.MLP_SIZES``) and 1 to 32 lanes in one block. The
wrappers take the plain version for tensors on the CPU (any width); for
CUDA tensors they launch the kernel or raise. ``LAUNCHES`` counts kernel
launches (the plain versions count nothing).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from columnflow_torch.kernels.network_ode import (
    ODEAttempt,
    ODESelectConfig,
    attempt_plain,
    replay_fwd_plain,
    rk_step_vjp,
    select_plain,
)
from columnflow_torch.kernels.network_sde import _check, _host_floats, _lib, _on_cuda, _stream
from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.hopf import MLP_SIZES, PARAM_KEYS, hopf_mlp_drift, hopf_mlp_drift_vjp
from columnflow_torch.ops.interp import interp_at_onehot

LAUNCHES = {"hopf_select": 0, "hopf_attempt": 0, "hopf_replay_fwd": 0, "hopf_replay_bwd": 0}
MAX_LANES = 32  # one block holds the batch

_F32 = torch.float32


class MuTable(NamedTuple):
    """The drift's data: mu (T, B) on the uniform grid t0 + dt * arange(T)
    (host floats, as the JAX package bakes them into its kernels)."""

    table: torch.Tensor
    t0: float
    dt: float


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def hopf_ode_drift(t, y, params, mu: MuTable):
    """The drift of every Hopf kernel: y (B, 2), mu's table (T, B)."""
    return hopf_mlp_drift(t, y, params, Stimulus(mu.t0, mu.dt, mu.table),
                          interp_fn=interp_at_onehot)


def hopf_ode_drift_vjp(t, y, ct, params, mu: MuTable):
    """``hopf_mlp_drift_vjp`` with the one-hot blend lookup."""
    return hopf_mlp_drift_vjp(t, y, ct, params, Stimulus(mu.t0, mu.dt, mu.table),
                              interp_fn=interp_at_onehot)


def pack_params(params) -> torch.Tensor:
    """The parameters as one float32 vector, layer by layer, w then b."""
    return torch.cat([layer[k].reshape(-1) for layer in params for k in PARAM_KEYS])


def unpack_params(flat, like) -> list:
    """A vector in ``pack_params``' order -> a list of ``{"w", "b"}`` shaped
    as ``like``."""
    out, o = [], 0
    for layer in like:
        d = {}
        for k in PARAM_KEYS:
            n = layer[k].numel()
            d[k] = flat[o:o + n].reshape(layer[k].shape)
            o += n
        out.append(d)
    return out


def _f(params, mu):
    return lambda t, y: hopf_ode_drift(t, y, params, mu)


def _hopf_attempt_plain(t, y, f0, h, params, mu, cfg: ODESelectConfig) -> ODEAttempt:
    return attempt_plain(_f(params, mu), t, y, f0, h, cfg)


def _hopf_select_plain(y0, params, mu, cfg: ODESelectConfig):
    return select_plain(_f(params, mu), y0, cfg)


def _hopf_replay_fwd_plain(y0, st, params, mu):
    return replay_fwd_plain(_f(params, mu), y0, st)


def hopf_step_vjp(t0, h, y, ybar, cbar, params, mu: MuTable):
    """The VJP of one replay step at (t0, h, y) for the cotangents ybar on
    y1 and cbar (5, B, 2) on its dense rows: (state cotangent, the step's
    parameter cotangents as one ``pack_params`` vector)."""
    acc = [None]

    def drift_vjp(t, Y, kb):
        g, grads = hopf_ode_drift_vjp(t, Y, kb, params, mu)
        flat = pack_params(grads)
        acc[0] = flat if acc[0] is None else acc[0] + flat
        return g

    return rk_step_vjp(_f(params, mu), drift_vjp, t0, h, y, ybar, cbar), acc[0]


@torch.no_grad()
def _hopf_replay_bwd_plain(ys, cobar, st, params, mu):
    """The reverse sweep over steps n-1..0: (ybar0 (B, 2), the parameters'
    cotangents summed over the steps in float32)."""
    ybar = cobar.new_zeros(tuple(cobar.shape[2:]))
    acc = torch.zeros_like(pack_params(params))
    for k in range(ys.shape[0] - 1, -1, -1):
        ybar, g = hopf_step_vjp(st[k], st[k + 1] - st[k], ys[k], ybar, cobar[k], params, mu)
        acc = acc + g
    return ybar, unpack_params(acc, params)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on CUDA, anything else raises
# ---------------------------------------------------------------------------


def _named(B: int, flat, mu: MuTable) -> dict:
    """The contract of what every Hopf kernel reads besides its states."""
    return {"params": (flat, _F32, (flat.numel(),)),
            "mu": (mu.table, _F32, (mu.table.shape[0], B))}


def _state(y, name="y"):
    return {name: (y, _F32, (y.shape[0], 2))}


def _kernel_ready(params, B: int):
    """Raise unless the kernels hold this width and batch."""
    sizes = (params[0]["w"].shape[1],) + tuple(layer["w"].shape[0] for layer in params)
    if sizes != MLP_SIZES:
        raise ValueError(f"the Hopf kernels hold the MLP {MLP_SIZES}, got {sizes}")
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"the Hopf kernels hold 1 to {MAX_LANES} lanes in one block, got {B}")


def _args(B, params, mu: MuTable):
    """(flat params, (B, T), host floats (kept alive by the caller until the
    launch returns) and their pointer)."""
    flat = pack_params(params).contiguous()
    hc, hc_p = _host_floats([mu.t0, mu.dt])
    return flat, (B, mu.table.shape[0]), hc, hc_p


def _select_floats(cfg: ODESelectConfig):
    return _host_floats([cfg.t_start, cfg.t_end, cfg.rtol, cfg.atol,
                         0.0 if cfg.dt0 is None else cfg.dt0, cfg.t_end - cfg.t_start])


def hopf_select(y0, params, mu: MuTable, cfg: ODESelectConfig):
    """The step-size selection for the batch state y0 (B, 2) under one
    controller. Returns (step_times (M+1,) float32, stats (3,) int32 =
    naccept, nreject, success)."""
    B = y0.shape[0]
    flat, dims, hc, hc_p = _args(B, params, mu)
    if not _on_cuda(y0, {**_named(B, flat, mu), **_state(y0)}):
        return _hopf_select_plain(y0, params, mu, cfg)
    _kernel_ready(params, B)
    st = torch.empty(cfg.max_steps + 1, dtype=_F32, device=y0.device)
    stats = torch.empty(3, dtype=torch.int32, device=y0.device)
    hs, hs_p = _select_floats(cfg)
    _check(_lib().cf_hopf_select(*dims, hc_p, hs_p, int(cfg.dt0 is None), cfg.max_steps,
                                 flat.data_ptr(), mu.table.data_ptr(), y0.data_ptr(),
                                 st.data_ptr(), stats.data_ptr(), _stream(y0)), "hopf_select")
    LAUNCHES["hopf_select"] += 1
    return st, stats


def hopf_attempt(t, y, f0, h, params, mu: MuTable, cfg: ODESelectConfig) -> ODEAttempt:
    """One controller attempt (the body of the selection kernel) from the
    0-dim tensors t, h and the batch state y with f0 = f(t, y)."""
    B = y.shape[0]
    flat, dims, hc, hc_p = _args(B, params, mu)
    named = {**_named(B, flat, mu), **_state(y), **_state(f0, "f0"),
             "t": (t, _F32, ()), "h": (h, _F32, ())}
    if not _on_cuda(y, named):
        return _hopf_attempt_plain(t, y, f0, h, params, mu, cfg)
    _kernel_ready(params, B)
    y1, f1 = torch.empty_like(y), torch.empty_like(y)
    rec = torch.empty(3, dtype=_F32, device=y.device)
    hs, hs_p = _select_floats(cfg)
    _check(_lib().cf_hopf_attempt(*dims, hc_p, hs_p, flat.data_ptr(), mu.table.data_ptr(),
                                  t.data_ptr(), h.data_ptr(), y.data_ptr(), f0.data_ptr(),
                                  y1.data_ptr(), f1.data_ptr(), rec.data_ptr(), _stream(y)),
           "hopf_attempt")
    LAUNCHES["hopf_attempt"] += 1
    return ODEAttempt(y1, f1, rec[0], rec[1], rec[2])


def hopf_replay_fwd(y0, st, params, mu: MuTable):
    """The replay of the frozen grid st (n + 1,) from y0 (B, 2): (ys (n, B,
    2) the step-start states, coeffs (n, 5, B, 2) the dense rows)."""
    n, B = st.shape[0] - 1, y0.shape[0]
    flat, dims, hc, hc_p = _args(B, params, mu)
    if not _on_cuda(y0, {**_named(B, flat, mu), **_state(y0), "st": (st, _F32, (n + 1,))}):
        return _hopf_replay_fwd_plain(y0, st, params, mu)
    _kernel_ready(params, B)
    ys = torch.empty((n, B, 2), dtype=_F32, device=y0.device)
    coeffs = torch.empty((n, 5, B, 2), dtype=_F32, device=y0.device)
    _check(_lib().cf_hopf_replay_fwd(*dims, hc_p, n, flat.data_ptr(), mu.table.data_ptr(),
                                     st.data_ptr(), y0.data_ptr(), ys.data_ptr(),
                                     coeffs.data_ptr(), _stream(y0)), "hopf_replay_fwd")
    LAUNCHES["hopf_replay_fwd"] += 1
    return ys, coeffs


def hopf_replay_bwd(ys, cobar, st, params, mu: MuTable):
    """The kernel-mode reverse sweep: ys (n, B, 2) the step-start states,
    cobar (n, 5, B, 2) the cotangents of the dense rows. Returns (ybar0 (B,
    2), the parameters' cotangents as a list of ``{"w", "b"}``)."""
    n, B, _ = ys.shape
    flat, dims, hc, hc_p = _args(B, params, mu)
    named = {**_named(B, flat, mu), "ys": (ys, _F32, (n, B, 2)),
             "cobar": (cobar, _F32, (n, 5, B, 2)), "st": (st, _F32, (n + 1,))}
    if not _on_cuda(ys, named):
        return _hopf_replay_bwd_plain(ys, cobar, st, params, mu)
    _kernel_ready(params, B)
    ybar = torch.empty((B, 2), dtype=_F32, device=ys.device)
    dflat = torch.empty_like(flat)
    work = torch.empty_like(flat)  # the step's sum, each entry owned by one thread
    _check(_lib().cf_hopf_replay_bwd(*dims, hc_p, n, flat.data_ptr(), mu.table.data_ptr(),
                                     st.data_ptr(), ys.data_ptr(), cobar.data_ptr(),
                                     ybar.data_ptr(), dflat.data_ptr(), work.data_ptr(),
                                     _stream(ys)), "hopf_replay_bwd")
    LAUNCHES["hopf_replay_bwd"] += 1
    return ybar, unpack_params(dflat, params)
