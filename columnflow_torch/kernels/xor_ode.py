"""The XOR network's dopri5 kernels: adaptive step-size selection, the
dense-output replay over the frozen grid, and its reverse sweep in kernel
mode (ports of the three Pallas kernels of ``odeint_dopri5_fused`` in
``columnflow/solvers/fused.py``, traced there with ``xor_drift_batched``).

Each kernel is CUDA C++ in ``csrc/xor_ode.cu`` (built by ``_build``) with a
plain PyTorch version beside it that repeats its arithmetic:

    wrapper          kernel              plain version           replaces (columnflow/solvers/fused.py)
    xor_select       cf_xor_select       _xor_select_plain       _make_adaptive_kernel (B6x)
    xor_attempt      cf_xor_attempt      _xor_attempt_plain      one iteration of that kernel's body
    xor_replay_fwd   cf_xor_replay_fwd   _xor_replay_fwd_plain   _make_replay_chunk_kernel (B7x)
    xor_replay_bwd   cf_xor_replay_bwd   _xor_replay_bwd_plain   _make_bwd_chunk_kernel, kernel mode (B8x)

The plain versions are the network engine's (``kernels.network_ode``
``select_plain``, ``attempt_plain``, ``replay_fwd_plain``, ``rk_step_vjp``)
on the XOR drift ``models.xor.xor_drift_batched`` with its knot stimulus
and the hand-written VJP ``xor_drift_batched_vjp``. One controller steers
the whole (B, 72) batch state, as in the JAX package. The reverse sweep
returns the four ff rows' cotangents: each drift VJP's contracted over the
batch, the seven of a step added from stage 6 down, the steps' sums added
to the accumulators step by step, from the last step back.

The wrappers take the plain version for tensors on the CPU; for CUDA
tensors they launch the kernel or raise. ``LAUNCHES`` counts kernel
launches (the plain versions count nothing).
"""

from __future__ import annotations

import torch

from columnflow_torch.kernels.network_ode import (
    ODEAttempt,
    ODESelectConfig,
    _select_host,
    attempt_plain,
    replay_fwd_plain,
    rk_step_vjp,
    select_plain,
)
from columnflow_torch.kernels.network_sde import (
    SDEConsts,
    _check,
    _drift_host_consts,
    _host_floats,
    _knots,
    _lib,
    _on_cuda,
    _stream,
)
from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.xor import (
    NUM_POPS,
    PF_KEYS,
    XOR_STATE_DIM,
    xor_drift_batched,
    xor_drift_batched_vjp,
)

LAUNCHES = {"xor_select": 0, "xor_attempt": 0, "xor_replay_fwd": 0, "xor_replay_bwd": 0}
MAX_LANES = 32  # one block holds the batch: a thread per (lane, population)

_F32 = torch.float32
_ROW_WIDTH = {"w00": 16, "w01": 16, "w10": 8, "w11": 8}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def xor_ode_drift(t, y, pf, sc: SDEConsts, kv):
    """The drift of every XOR kernel: y (B, 72), kv (K, B, 32) the knot
    values of the flattened stimulus slots, ``sc`` = (fc of
    ``build_xor_fused_consts``, knot times)."""
    return xor_drift_batched(t, y, pf, sc.fc, Stimulus(0.0, 0.0, kv), interp_fn=_knots(sc.knot_ts))


def xor_ode_drift_vjp(t, y, ct, pf, sc: SDEConsts, kv):
    """``xor_drift_batched_vjp`` with the knot stimulus."""
    return xor_drift_batched_vjp(t, y, ct, pf, sc.fc, Stimulus(0.0, 0.0, kv),
                                 interp_fn=_knots(sc.knot_ts))


def _f(pf, sc, kv):
    return lambda t, y: xor_ode_drift(t, y, pf, sc, kv)


def _xor_attempt_plain(t, y, f0, h, pf, sc, kv, cfg: ODESelectConfig) -> ODEAttempt:
    return attempt_plain(_f(pf, sc, kv), t, y, f0, h, cfg)


def _xor_select_plain(y0, pf, sc, kv, cfg: ODESelectConfig):
    return select_plain(_f(pf, sc, kv), y0, cfg)


def _xor_replay_fwd_plain(y0, st, pf, sc, kv):
    return replay_fwd_plain(_f(pf, sc, kv), y0, st)


def xor_step_vjp(t0, h, y, ybar, cbar, pf, sc: SDEConsts, kv):
    """The VJP of one replay step at (t0, h, y) for the cotangents ybar on
    y1 and cbar (5, B, 72) on its dense rows: (state cotangent, the four ff
    rows' cotangents of the step)."""
    acc = {}

    def drift_vjp(t, Y, kb):
        g, rows = xor_ode_drift_vjp(t, Y, kb, pf, sc, kv)
        for k in PF_KEYS:
            acc[k] = rows[k] if k not in acc else acc[k] + rows[k]
        return g

    return rk_step_vjp(_f(pf, sc, kv), drift_vjp, t0, h, y, ybar, cbar), acc


@torch.no_grad()
def _xor_replay_bwd_plain(ys, cobar, st, pf, sc, kv):
    """The reverse sweep over steps n-1..0: (ybar0 (B, 72), the four rows'
    cotangents summed over the steps in float32)."""
    ybar = cobar.new_zeros(tuple(cobar.shape[2:]))
    acc = {k: torch.zeros_like(pf[k]) for k in PF_KEYS}
    for k in range(ys.shape[0] - 1, -1, -1):
        ybar, rows = xor_step_vjp(st[k], st[k + 1] - st[k], ys[k], ybar, cobar[k], pf, sc, kv)
        acc = {key: acc[key] + rows[key] for key in PF_KEYS}
    return ybar, acc


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on CUDA, anything else raises
# ---------------------------------------------------------------------------


def xor_named(B: int, pf, sc: SDEConsts, kv) -> dict:
    """The contract of what every XOR kernel reads besides its states, for
    B lanes: the four rows, the drift constants and the knot values."""
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"the XOR kernels hold 1 to {MAX_LANES} lanes in one block, got {B}")
    fc = sc.fc
    return {**{k: (pf[k], _F32, (1, w)) for k, w in _ROW_WIDTH.items()},
            "w24": (fc["w24"], _F32, (NUM_POPS, NUM_POPS)), "bg24": (fc["bg24"], _F32, (NUM_POPS,)),
            "adapt": (fc["adapt"], _F32, (NUM_POPS,)), "kv": (kv, _F32, (kv.shape[0], B, 32))}


def _state(y):
    return (y, _F32, (y.shape[0], XOR_STATE_DIM))


def xor_args(sc: SDEConsts, pf, kv):
    """(B, K), the host constants (kept alive by the caller until the launch
    returns) and the pointers every XOR kernel takes: the packed constants
    (w24, bg24, adapt), the packed rows (w00, w01, w10, w11) and the knot
    values."""
    fc = sc.fc
    consts = torch.cat([fc["w24"].reshape(-1), fc["bg24"], fc["adapt"]])
    rows = torch.cat([pf[k].reshape(-1) for k in PF_KEYS])
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    return (kv.shape[1], kv.shape[0]), (hc, consts, rows), hc_p, (
        consts.data_ptr(), rows.data_ptr(), kv.data_ptr())


def unpack_rows(d):
    """The (48,) row cotangents a kernel writes -> the four rows' dict."""
    out, o = {}, 0
    for k, w in _ROW_WIDTH.items():
        out[k] = d[o:o + w].reshape(1, w)
        o += w
    return out


def xor_select(y0, pf, sc: SDEConsts, kv, cfg: ODESelectConfig):
    """The step-size selection for the batch state y0 (B, 72) under one
    controller. Returns (step_times (M+1,) float32, stats (3,) int32 =
    naccept, nreject, success)."""
    if not _on_cuda(y0, {**xor_named(y0.shape[0], pf, sc, kv), "y0": _state(y0)}):
        return _xor_select_plain(y0, pf, sc, kv, cfg)
    st = torch.empty(cfg.max_steps + 1, dtype=_F32, device=y0.device)
    stats = torch.empty(3, dtype=torch.int32, device=y0.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    keep_s, _, hs_p = _select_host(sc, cfg)
    _check(_lib().cf_xor_select(*dims, hc_p, hs_p, int(cfg.dt0 is None), cfg.max_steps, *ptrs,
                                y0.data_ptr(), st.data_ptr(), stats.data_ptr(), _stream(y0)),
           "xor_select")
    LAUNCHES["xor_select"] += 1
    return st, stats


def xor_attempt(t, y, f0, h, pf, sc: SDEConsts, kv, cfg: ODESelectConfig) -> ODEAttempt:
    """One controller attempt (the body of the selection kernel) from the
    0-dim tensors t, h and the batch state y with f0 = f(t, y)."""
    named = {**xor_named(y.shape[0], pf, sc, kv), "y": _state(y), "f0": _state(f0),
             "t": (t, _F32, ()), "h": (h, _F32, ())}
    if not _on_cuda(y, named):
        return _xor_attempt_plain(t, y, f0, h, pf, sc, kv, cfg)
    y1, f1 = torch.empty_like(y), torch.empty_like(y)
    rec = torch.empty(3, dtype=_F32, device=y.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    keep_s, _, hs_p = _select_host(sc, cfg)
    _check(_lib().cf_xor_attempt(*dims, hc_p, hs_p, *ptrs, t.data_ptr(), h.data_ptr(),
                                 y.data_ptr(), f0.data_ptr(), y1.data_ptr(), f1.data_ptr(),
                                 rec.data_ptr(), _stream(y)), "xor_attempt")
    LAUNCHES["xor_attempt"] += 1
    return ODEAttempt(y1, f1, rec[0], rec[1], rec[2])


def xor_replay_fwd(y0, st, pf, sc: SDEConsts, kv):
    """The replay of the frozen grid st (n + 1,) from y0 (B, 72): (ys (n,
    B, 72) the step-start states, coeffs (n, 5, B, 72) the dense rows)."""
    n = st.shape[0] - 1
    if not _on_cuda(y0, {**xor_named(y0.shape[0], pf, sc, kv), "y0": _state(y0),
                         "st": (st, _F32, (n + 1,))}):
        return _xor_replay_fwd_plain(y0, st, pf, sc, kv)
    B, S = y0.shape
    ys = torch.empty((n, B, S), dtype=_F32, device=y0.device)
    coeffs = torch.empty((n, 5, B, S), dtype=_F32, device=y0.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    _check(_lib().cf_xor_replay_fwd(*dims, hc_p, n, *ptrs, st.data_ptr(), y0.data_ptr(),
                                    ys.data_ptr(), coeffs.data_ptr(), _stream(y0)),
           "xor_replay_fwd")
    LAUNCHES["xor_replay_fwd"] += 1
    return ys, coeffs


def xor_replay_bwd(ys, cobar, st, pf, sc: SDEConsts, kv):
    """The kernel-mode reverse sweep: ys (n, B, 72) the step-start states,
    cobar (n, 5, B, 72) the cotangents of the dense rows. Returns (ybar0
    (B, 72), the four rows' cotangents)."""
    n, B, S = ys.shape
    named = {**xor_named(B, pf, sc, kv), "ys": (ys, _F32, (n, B, XOR_STATE_DIM)),
             "cobar": (cobar, _F32, (n, 5, B, XOR_STATE_DIM)),
             "st": (st, _F32, (n + 1,))}
    if not _on_cuda(ys, named):
        return _xor_replay_bwd_plain(ys, cobar, st, pf, sc, kv)
    ybar = torch.empty((B, S), dtype=_F32, device=ys.device)
    drows = torch.empty(48, dtype=_F32, device=ys.device)
    dims, keep, hc_p, ptrs = xor_args(sc, pf, kv)
    _check(_lib().cf_xor_replay_bwd(*dims, hc_p, n, *ptrs, st.data_ptr(), ys.data_ptr(),
                                    cobar.data_ptr(), ybar.data_ptr(), drows.data_ptr(),
                                    _stream(ys)), "xor_replay_bwd")
    LAUNCHES["xor_replay_bwd"] += 1
    return ybar, unpack_rows(drows)
