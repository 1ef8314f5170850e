"""The column-network SDE kernels: adaptive step-size selection, the replay
over the frozen step grids, and its reverse sweep (ports of the Pallas
kernels B5, B3 and B4 of ``columnflow/solvers``).

Each kernel is CUDA C++ in ``csrc/network_sde.cu`` (built by ``_build``)
with a plain PyTorch version beside it that repeats its arithmetic:

    wrapper         kernel              plain version      replaces (columnflow/solvers/)
    select_pass     cf_sde_select       _select_plain      sde_adaptive.py _make_sde_adaptive_kernel (B5)
    select_attempt  cf_sde_attempt      _attempt_plain     one iteration of that kernel's body
    replay_fwd      cf_sde_replay_fwd   _replay_fwd_plain  fused.py _make_sde_chunk_kernel, lanes (B3)
    replay_bwd      cf_sde_replay_bwd   _replay_bwd_plain  fused.py _make_sde_bwd_chunk_kernel, emit (B4)

The JAX kernels trace any drift. These compute the parity task's drift:
``network_drift_premixed`` with the knot stimulus and the constant
diffusion sigma = 10; the selection with the bf16 weights of
``premix_select16``, the replay and its reverse sweep with the two-term
split of ``prepare_premixed_split2``. Lanes are independent: each kernel
runs one thread block per lane.

The wrappers take the plain version for tensors on the CPU; for CUDA
tensors they launch the kernel or raise. ``LAUNCHES`` counts kernel
launches (the plain versions count nothing).

The JAX kernels cut the horizon into chunks only because the trajectory had
to fit the TPU's VMEM; device memory holds the whole (n + 1, B, 3P)
replay, so each sweep here is one launch. Truncated BPTT still zeroes the
cotangent at the step indices JAX's chunking gives (``stride``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.network import (
    NETWORK_NOISE_STD,
    network_drift_premixed,
    network_drift_premixed_select16,
    network_drift_premixed_split2_vjp,
)
from columnflow_torch.ops.arith import div
from columnflow_torch.ops.interp import interp_knots, knot_constants
from columnflow_torch.solvers.krng import KernelBrownianTree, interval_normal

SIGMA = NETWORK_NOISE_STD
# The controller (``columnflow/solvers/sde_adaptive.py``): factor = safety *
# err^(-PI_A q) * err_prev^(PI_B q) on accept, safety * err^(-q) on reject,
# clipped to [DFACTOR, IFACTOR]; q = 1/2 for SRA1. The CUDA kernel holds the
# same numbers as literals.
_SAFETY, _IFACTOR, _DFACTOR = 0.9, 5.0, 0.2
_PI_A, _PI_B, _ERR_EXP = 0.5, 0.25, 0.5
LAUNCHES = {"sde_select": 0, "sde_attempt": 0, "sde_replay_fwd": 0, "sde_replay_bwd": 0}

_F32, _BF16, _I64 = torch.float32, torch.bfloat16, torch.int64


class SDEConsts(NamedTuple):
    """What the drift reads besides state, weights and knot values:
    ``fc`` from ``build_network_fused_consts`` and the K knot times."""

    fc: dict
    knot_ts: tuple


class SelectConfig(NamedTuple):
    """The selection's settings, as the JAX kernel bakes them in."""

    t_start: float
    t_end: float
    rtol: float = 1e-3
    atol: float = 1e-3
    h0: float = 0.0
    max_steps: int = 16384
    depth: int = 20
    dt_min: float = 0.0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _knots(knot_ts):
    return lambda t, t0, dt, v: interp_knots(t, knot_ts, v)


def drift_split2(t, y, w2, sc: SDEConsts, kv):
    """The replay drift: y (B, 3P), t (B, 1), kv (K, B, n_in)."""
    return network_drift_premixed(t, y, w2, sc.fc, Stimulus(0.0, 0.0, kv),
                                  interp_fn=_knots(sc.knot_ts))


def drift_select16(t, y, w16, sc: SDEConsts, kv):
    """The selection drift (bf16 weights)."""
    return network_drift_premixed_select16(t, y, w16, sc.fc, Stimulus(0.0, 0.0, kv),
                                           interp_fn=_knots(sc.knot_ts))


def sra1_step(drift, t0, h, y, dw, i10, sigma: float = SIGMA):
    """Roessler SRA1 for constant diffusion ``sigma``, h == 0 safe (padding
    steps carry h = dw = i10 = 0 and are exact no-ops). t0, h, dw, i10 per
    lane (B, 1)."""
    i10_h = i10 / torch.where(h > 0, h, 1.0)
    f1 = drift(t0, y)
    h2 = y + (0.75 * h) * f1 + (1.5 * i10_h) * sigma
    f2 = drift(t0 + 0.75 * h, h2)
    return y + h * (div(f1, 3.0) + div(2.0 * f2, 3.0)) + (dw - i10_h) * sigma + i10_h * sigma


def step_vjp_split2(t0, h, y, i10, c, w2, sc: SDEConsts, kv, sigma: float = SIGMA):
    """State cotangent of one replay step (``sra1_step`` with the split2
    drift) for the cotangent c of its output."""
    drift = lambda t, x: drift_split2(t, x, w2, sc, kv)  # noqa: E731
    i10_h = i10 / torch.where(h > 0, h, 1.0)
    h2 = y + (0.75 * h) * drift(t0, y) + (1.5 * i10_h) * sigma
    c3 = div(h * c, 3.0)
    c_h2 = network_drift_premixed_split2_vjp(h2, c3 * 2.0, w2, sc.fc)
    c_y = network_drift_premixed_split2_vjp(y, c3 + (0.75 * h) * c_h2, w2, sc.fc)
    return (c + c_h2) + c_y


def _replay_fwd_plain(y0, t0s, hs, i1, i10, n_real, w2, sc, kv):
    """ys (n + 1, B, 3P): ys[0] = y0, ys[k + 1] after step k; rows past
    n_real hold the carried state."""
    n = t0s.shape[0]
    ys = torch.empty((n + 1,) + tuple(y0.shape), dtype=_F32, device=y0.device)
    ys[0] = y = y0
    drift = lambda t, x: drift_split2(t, x, w2, sc, kv)  # noqa: E731
    for k in range(n_real):
        y = sra1_step(drift, t0s[k, :, None], hs[k, :, None], y, i1[k, :, None],
                      i10[k, :, None])
        ys[k + 1] = y
    ys[n_real + 1:] = y
    return ys


def _replay_bwd_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, w2, sc, kv):
    """Reverse sweep over steps n_real-1..0: returns (ybar, seeds), seeds[k]
    = the total cotangent on step k's output; the carry is zeroed after
    every step k with k % stride == 0 (stride 0: never)."""
    ybar = torch.zeros_like(ys_prev[0])
    seeds = torch.zeros_like(ys_prev)
    for k in range(n_real - 1, -1, -1):
        c = ybar + ysbar[k]
        seeds[k] = c
        ybar = step_vjp_split2(t0s[k, :, None], hs[k, :, None], ys_prev[k],
                               i10[k, :, None], c, w2, sc, kv)
        if stride and k % stride == 0:
            ybar = torch.zeros_like(ybar)
    return ybar, seeds


def _tree(words, cfg: SelectConfig):
    return KernelBrownianTree(cfg.t_start, cfg.t_end, words[:, 0:1], words[:, 1:2],
                              depth=cfg.depth)


class Attempt(NamedTuple):
    y_new: torch.Tensor  # (B, 3P) the two-half-step solution
    err: torch.Tensor  # (B, 1) scaled RMS error
    accept: torch.Tensor  # (B, 1) bool
    h: torch.Tensor  # (B, 1) the step used
    h_next: torch.Tensor  # (B, 1)
    t_new: torch.Tensor  # (B, 1)
    err_c: torch.Tensor  # (B, 1) max(err, 1e-10), the PI memory if accepted
    w1: torch.Tensor  # (B, 1) W(t + h)


@torch.no_grad()
def _attempt_plain(t1, y1, h, err_prev, w_t1, words, w16, sc, kv, cfg: SelectConfig):
    """One controller attempt per lane (t1, h, err_prev, w_t1 (B, 1)):
    step doubling with three SRA1 steps on the tree's Brownian data, the
    RMS error, the PI controller with exp(p log x) powers."""
    h = torch.minimum(h, cfg.t_end - t1)
    h = (t1 + h) - t1  # the representable difference
    tm, te, hh = t1 + 0.5 * h, t1 + h, 0.5 * h
    w = _tree(words, cfg).evaluate(torch.cat([tm, te], dim=1))
    wm, w1 = w[:, 0:1], w[:, 1:2]
    j0, j1 = words[:, 2:3], words[:, 3:4]
    za = interval_normal(j0, j1, t1, tm, cfg.t_start, cfg.t_end)
    zb = interval_normal(j0, j1, tm, te, cfg.t_start, cfg.t_end)
    dw_a, dw_b = wm - w_t1, w1 - wm
    sq = torch.sqrt(div(hh, 12.0))
    i10_a = hh * (0.5 * dw_a + sq * za)
    i10_b = hh * (0.5 * dw_b + sq * zb)
    i10_f = i10_a + i10_b + hh * dw_a
    drift = lambda t, x: drift_select16(t, x, w16, sc, kv)  # noqa: E731
    y_full = sra1_step(drift, t1, h, y1, dw_a + dw_b, i10_f)
    y_half = sra1_step(drift, t1, 0.5 * h, y1, dw_a, i10_a)
    y_half2 = sra1_step(drift, t1 + 0.5 * h, 0.5 * h, y_half, dw_b, i10_b)
    q = (y_half2 - y_full) / (cfg.atol + cfg.rtol * torch.maximum(y1.abs(), y_half2.abs()))
    err = torch.sqrt(div((q * q).double().sum(-1, keepdim=True).float(), y1.shape[-1]))
    accept = (err <= 1.0) | (h <= cfg.dt_min)
    err_c = torch.clamp_min(err, 1e-10)
    log_err = torch.log(err_c)
    fac_i = _SAFETY * torch.exp(-_ERR_EXP * log_err)
    fac_acc = ((_SAFETY * torch.exp((-_PI_A * _ERR_EXP) * log_err))
               * torch.exp((_PI_B * _ERR_EXP) * torch.log(err_prev)))
    factor = torch.where(accept, fac_acc, fac_i)
    factor = torch.where(err <= 0.0, _IFACTOR, torch.clamp(factor, _DFACTOR, _IFACTOR))
    return Attempt(y_half2, err, accept, h, torch.clamp_min(h * factor, cfg.dt_min),
                   torch.where(accept, t1 + h, t1), err_c, w1)


@torch.no_grad()
def _select_plain(y0, words, w16, sc, kv, cfg: SelectConfig):
    """The selection loop, vectorised over lanes with per-lane masks:
    returns (step_times (B, M+1), naccept, nreject, success)."""
    B, dev = y0.shape[0], y0.device
    M = cfg.max_steps
    st = torch.full((B, M + 1), cfg.t_end, dtype=_F32, device=dev)
    st[:, 0] = cfg.t_start
    t1 = torch.full((B, 1), cfg.t_start, dtype=_F32, device=dev)
    h = torch.full((B, 1), cfg.h0, dtype=_F32, device=dev)
    err_prev = torch.ones((B, 1), dtype=_F32, device=dev)
    na = torch.zeros(B, dtype=_I64, device=dev)
    nr = torch.zeros(B, dtype=_I64, device=dev)
    y1 = y0
    w_t1 = _tree(words, cfg).evaluate(t1)
    lanes = torch.arange(B, device=dev)
    while True:
        active = (t1[:, 0] < cfg.t_end) & (na + nr < M)
        if not bool(active.any()):
            break
        a = _attempt_plain(t1, y1, h, err_prev, w_t1, words, w16, sc, kv, cfg)
        act = active[:, None]
        acc = a.accept & act
        na = na + acc[:, 0]
        nr = nr + (act & ~a.accept)[:, 0]
        st[lanes[active], na[active]] = a.t_new[active, 0]
        y1 = torch.where(acc, a.y_new, y1)
        err_prev = torch.where(acc, a.err_c, err_prev)
        w_t1 = torch.where(acc, a.w1, w_t1)
        h = torch.where(act, a.h_next, h)
        t1 = torch.where(act, a.t_new, t1)
    return st, na.to(torch.int32), nr.to(torch.int32), t1[:, 0] >= cfg.t_end


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on CUDA, anything else raises
# ---------------------------------------------------------------------------


def _on_cuda(ref: torch.Tensor, named: dict) -> bool:
    """Check every tensor against the wrapper's contract (name -> (tensor,
    dtype, shape)) and say whether the kernel (CUDA) or the plain version
    (CPU) computes it."""
    if ref.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {ref.device}")
    for name, (t, dtype, shape) in named.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return ref.device.type == "cuda"


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _host_floats(values):
    arr = (ctypes.c_float * len(values))(*values)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _drift_host_consts(sc: SDEConsts):
    c0, span = knot_constants(sc.knot_ts)
    fc = sc.fc
    return [fc["tau_syn"], fc["tau_mem"], fc["tau_adapt"], fc["resistance"], SIGMA] + c0 + span


def _words32(words):
    """uint32 words held in int64 -> the same bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32).contiguous()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib():
    from columnflow_torch.kernels._build import library

    return library()


def _drift_named(sc, kv, B, P):
    K, n_in = kv.shape[0], kv.shape[2]
    return {"bg": (sc.fc["bg"], _F32, (P,)), "adapt": (sc.fc["adapt"], _F32, (P,)),
            "kv": (kv, _F32, (K, B, n_in))}


def _select_host(sc: SDEConsts, cfg: SelectConfig):
    """The host-side float arrays of a selection launch (kept alive by the
    caller until the launch returns) and their pointers."""
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    hs, hs_p = _host_floats([cfg.t_start, cfg.t_end, cfg.rtol, cfg.atol, cfg.h0, cfg.dt_min])
    return (hc, hs), hc_p, hs_p


def select_pass(y0, words, w16, sc: SDEConsts, kv, cfg: SelectConfig):
    """The step-size selection of every lane: y0 (B, 3P), words (B, 4)
    (k0, k1, j0, j1 as int64), w16 from ``premix_select16``, kv (K, B,
    n_in). Returns (step_times (B, M+1), naccept, nreject (B,) int32,
    success (B,) bool)."""
    B, S = y0.shape
    P = S // 3
    named = {"y0": (y0, _F32, (B, S)), "words": (words, _I64, (B, 4)),
             "wT16": (w16["wT16"], _BF16, (P, P)),
             "iwT16": (w16["iwT16"], _BF16, (kv.shape[2], P)),
             **_drift_named(sc, kv, B, P)}
    if not _on_cuda(y0, named):
        return _select_plain(y0, words, w16, sc, kv, cfg)
    st = torch.empty((B, cfg.max_steps + 1), dtype=_F32, device=y0.device)
    stats = torch.empty((B, 3), dtype=torch.int32, device=y0.device)
    keep, hc_p, hs_p = _select_host(sc, cfg)
    w32 = _words32(words)
    _check(_lib().cf_sde_select(
        B, P, kv.shape[2], kv.shape[0], hc_p, hs_p, cfg.max_steps, cfg.depth,
        sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), w16["wT16"].data_ptr(),
        w16["iwT16"].data_ptr(), kv.data_ptr(), w32.data_ptr(), y0.data_ptr(), st.data_ptr(),
        stats.data_ptr(), _stream(y0)), "sde_select")
    LAUNCHES["sde_select"] += 1
    return st, stats[:, 0], stats[:, 1], stats[:, 2] > 0


def select_attempt(t1, y1, h, err_prev, w_t1, words, w16, sc: SDEConsts, kv,
                   cfg: SelectConfig) -> Attempt:
    """One controller attempt for each of N records (t1, h, err_prev, w_t1
    (N, 1); y1 (N, 3P)): the body of the selection kernel."""
    N, S = y1.shape
    P = S // 3
    named = {"y1": (y1, _F32, (N, S)), "t1": (t1, _F32, (N, 1)), "h": (h, _F32, (N, 1)),
             "err_prev": (err_prev, _F32, (N, 1)), "w_t1": (w_t1, _F32, (N, 1)),
             "words": (words, _I64, (N, 4)), "wT16": (w16["wT16"], _BF16, (P, P)),
             "iwT16": (w16["iwT16"], _BF16, (kv.shape[2], P)), **_drift_named(sc, kv, N, P)}
    if not _on_cuda(y1, named):
        return _attempt_plain(t1, y1, h, err_prev, w_t1, words, w16, sc, kv, cfg)
    y_new = torch.empty_like(y1)
    rec = torch.empty((N, 6), dtype=_F32, device=y1.device)
    keep, hc_p, hs_p = _select_host(sc, cfg)
    w32 = _words32(words)
    _check(_lib().cf_sde_attempt(
        N, P, kv.shape[2], kv.shape[0], hc_p, hs_p, cfg.depth, sc.fc["bg"].data_ptr(),
        sc.fc["adapt"].data_ptr(), w16["wT16"].data_ptr(), w16["iwT16"].data_ptr(),
        kv.data_ptr(), w32.data_ptr(), t1.data_ptr(), y1.data_ptr(), h.data_ptr(),
        err_prev.data_ptr(), w_t1.data_ptr(), y_new.data_ptr(), rec.data_ptr(),
        _stream(y1)), "sde_attempt")
    LAUNCHES["sde_attempt"] += 1
    col = [rec[:, i:i + 1] for i in range(6)]
    err_c = torch.clamp_min(col[0], 1e-10)
    return Attempt(y_new, col[0], col[1] > 0, col[2], col[3], col[4], err_c, col[5])


def _replay_named(t0s, hs, i10, w2, sc, kv, B, P, n_real):
    n = t0s.shape[0]
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real must lie in [0, {n}], got {n_real}")
    return {"t0s": (t0s, _F32, (n, B)), "hs": (hs, _F32, (n, B)),
            "i10": (i10, _F32, (n, B)), "wT_hi": (w2["wT_hi"], _BF16, (P, P)),
            "wT_mid": (w2["wT_mid"], _BF16, (P, P)),
            "iwT": (w2["iwT"], _F32, (kv.shape[2], P)), **_drift_named(sc, kv, B, P)}


def replay_fwd(y0, t0s, hs, i1, i10, n_real: int, w2, sc: SDEConsts, kv):
    """SRA1 over each lane's frozen grid: y0 (B, 3P); t0s, hs, i1, i10
    (n, B); the first ``n_real`` steps are integrated, the rest are h == 0
    padding. w2 from ``prepare_premixed_split2``. Returns ys (n + 1, B, 3P)."""
    B, S = y0.shape
    P, n = S // 3, t0s.shape[0]
    named = {"y0": (y0, _F32, (B, S)), "i1": (i1, _F32, (n, B)),
             **_replay_named(t0s, hs, i10, w2, sc, kv, B, P, n_real)}
    if not _on_cuda(y0, named):
        return _replay_fwd_plain(y0, t0s, hs, i1, i10, n_real, w2, sc, kv)
    ys = torch.empty((n + 1, B, S), dtype=_F32, device=y0.device)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    _check(_lib().cf_sde_replay_fwd(
        B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), sc.fc["bg"].data_ptr(),
        sc.fc["adapt"].data_ptr(), w2["wT_hi"].data_ptr(), w2["wT_mid"].data_ptr(),
        w2["iwT"].data_ptr(), kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i1.data_ptr(),
        i10.data_ptr(), y0.data_ptr(), ys.data_ptr(), _stream(y0)), "sde_replay_fwd")
    LAUNCHES["sde_replay_fwd"] += 1
    return ys


def replay_bwd(ys_prev, ysbar, t0s, hs, i10, n_real: int, stride, w2, sc: SDEConsts, kv):
    """The reverse sweep of the state cotangent: ys_prev (n, B, 3P) the
    states before each step, ysbar (n, B, 3P) the direct cotangents on each
    step's output. Returns (ybar (B, 3P), seeds (n, B, 3P))."""
    n, B, S = ys_prev.shape
    P = S // 3
    named = {"ys_prev": (ys_prev, _F32, (n, B, S)), "ysbar": (ysbar, _F32, (n, B, S)),
             **_replay_named(t0s, hs, i10, w2, sc, kv, B, P, n_real)}
    if not _on_cuda(ys_prev, named):
        return _replay_bwd_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, w2, sc, kv)
    ybar = torch.empty((B, S), dtype=_F32, device=ys_prev.device)
    seeds = torch.empty_like(ys_prev)
    w_hiT, w_midT = w2["wT_hi"].T.contiguous(), w2["wT_mid"].T.contiguous()
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    _check(_lib().cf_sde_replay_bwd(
        B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), int(stride or 0),
        sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), w2["wT_hi"].data_ptr(),
        w2["wT_mid"].data_ptr(), w_hiT.data_ptr(), w_midT.data_ptr(), w2["iwT"].data_ptr(),
        kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i10.data_ptr(), ys_prev.data_ptr(),
        ysbar.data_ptr(), ybar.data_ptr(), seeds.data_ptr(), _stream(ys_prev)),
        "sde_replay_bwd")
    LAUNCHES["sde_replay_bwd"] += 1
    return ybar, seeds
