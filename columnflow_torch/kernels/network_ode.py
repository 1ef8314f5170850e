"""The column-network dopri5 kernels: adaptive step-size selection, the
dense-output replay over the frozen grid, and its reverse sweep (ports of
the three Pallas kernels of ``odeint_dopri5_fused`` in
``columnflow/solvers/fused.py``).

Each kernel is CUDA C++ in ``csrc/network_ode.cu``, or, for the cluster
teams of B6, B8' and B8't (``csrc/ode_team.cuh``), ``csrc/ode_select_team.cu``
and ``csrc/ode_emit_team.cu`` (built by ``_build``), with a plain PyTorch
version beside it that repeats its arithmetic:

    wrapper               kernel                     plain version               replaces (columnflow/solvers/fused.py)
    ode_select            cf_ode_select              _ode_select_plain           _make_adaptive_kernel (B6;
                          (cf_ode_select_team8)                                  route "team8": the yardstick)
    ode_attempt           cf_ode_attempt             _ode_attempt_plain          one iteration of that kernel's body
    ode_replay_fwd        cf_ode_replay_fwd          _ode_replay_fwd_plain       _make_replay_chunk_kernel (B7;
                          (cf_ode_replay_fwd_team)                               as a team, B7t-team: ``ode_fwd_route``)
    ode_replay_bwd        cf_ode_replay_bwd          _ode_replay_bwd_plain       _make_bwd_chunk_kernel, kernel mode (B8;
                          (cf_ode_replay_bwd_team)                               as a team, B8t-team: ``ode_bwd_route``)
    ode_replay_fwd_split2 cf_ode_replay_fwd_split2   _ode_replay_fwd_plain       _make_replay_chunk_kernel, split2
    ode_replay_bwd_split2 cf_ode_replay_bwd_split2   _ode_replay_bwd_plain       _make_bwd_chunk_kernel, kernel mode,
                                                                                 split2 (B8s, a team)
    ode_replay_bwd_emit   cf_ode_replay_bwd_emit     _ode_replay_bwd_emit_plain  _make_bwd_chunk_kernel, emit mode
                          (split2: B8'), cf_ode_replay_bwd_emit_split3 (three-term split: B8't);
                          route "team8": cf_ode_replay_bwd_emit[_split3]_team8

The JAX kernels trace any drift. These compute the parity task's
deterministic drift: ``network_drift_premixed`` with the knot stimulus and a
bf16 split of the recurrent matrix. The selection runs on the three-term
split (``prepare_premixed_split``) in both tiers: the f32-exact engine's
drift, and the split2 tier's ``select_func`` on ``select_args``; its wrapper
takes the split with PyTorch ops (the values the JAX kernel's prepare hook
computes inside). ``ode_replay_fwd`` and ``ode_replay_bwd`` are the exact
engine's replay and kernel-mode sweep: at the reference width they split the
float32 ``wT`` themselves into shared memory, and the sweep runs the batch
in one block (its weight cotangents are contracted over the batch before
they are rounded to bf16). ``ode_replay_fwd_split2`` is the ``fused-split2``
tier's replay, on the two-term split (``prepare_premixed_split2``), and
``ode_replay_bwd_split2`` its kernel-mode sweep (B8s: the weight gradients
in the sweep where the JAX package takes them there, through 63 columns at
4 inputs), B8t-team's team kernel on the two-term split.
``ode_replay_bwd_emit`` is the emit mode on either split: the state
cotangent alone, with each step's output cotangent written out for the
weight gradients outside the kernels (``solvers.fused.ode_outer_arg_grads``):
the split2 tier at every width, the exact engine where its weights hold more
than 1 MiB (from 64 columns with 4 inputs).

Where a step does not fit one block (the replay's three-term weights from 24
columns, the sweep's batch and weights from 18 columns at 4 lanes; at P =
832 the three-term weights alone are 4.15 MB), the kernels spread each
drift evaluation over a team of blocks (one thread-block cluster). The
replays and the kernel-mode sweep (B7t-team, B8t-team, B8s) keep the
weights in global memory (L2), a team of 8 blocks per lane or for the
batch. The selection (B6: one team for the batch, since one controller
steers the whole (B, 3P) state) and the emit-mode sweep (B8', B8't: one
team per lane) are clusters of 16 (or 8) blocks, each block holding its
columns of the split in shared memory (csrc/ode_team.cuh,
``ode_team_plan``, ``ode_team_pack``): resident at 13 and 32 columns,
streamed through a ring of tiles at 104 and 312; ``route="team8"`` runs the
8-block team they replaced (the yardstick; ``ode_team_route`` picks it only
for shapes the plan does not take: 8 or more lanes at 312 columns). Which
kernel runs is decided by shape before the launch (``ode_fwd_route``,
``ode_bwd_route``, ``ode_team_route``).

The wrappers take the plain version for tensors on the CPU; for CUDA tensors
they launch the kernel or raise. ``LAUNCHES`` counts kernel launches (the
plain versions count nothing).

The JAX kernels cut the step sequence into chunks only because a chunk's
rows had to fit the TPU's VMEM; device memory holds the whole replay, so
each sweep here is one launch over the accepted steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from columnflow_torch.kernels.network_sde import (
    _MAX_INPUTS,
    _MAX_KNOTS,
    _T2_MAX_STAGES,
    _T2_MIN_TILE_ROWS,
    _THREADS,
    SMEM_BLOCK_BYTES,
    SDEConsts,
    _align16,
    _check,
    _drift_host_consts,
    _drift_named,
    _host_floats,
    _knots,
    _lib,
    _on_cuda,
    _stream,
)
from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.network import (
    network_drift_premixed,
    network_drift_premixed_split2_vjp,
    network_drift_premixed_split2_weight_vjp,
    network_drift_premixed_split3_vjp,
    network_drift_premixed_split_vjp,
    prepare_premixed_split,
    split2_fold,
    split3_fold,
)
from columnflow_torch.ops.arith import div
from columnflow_torch.solvers import rk

# The I controller of ``columnflow/solvers/fused.py``: factor = safety *
# ratio^(-1/order), clipped to [DFACTOR, IFACTOR]. The CUDA kernel holds the
# same numbers as literals.
_SAFETY, _IFACTOR, _DFACTOR, _ORDER = 0.9, 10.0, 0.2, 5
LAUNCHES = {"ode_select": 0, "ode_attempt": 0, "ode_replay_fwd": 0, "ode_replay_bwd": 0,
            "ode_replay_fwd_split2": 0, "ode_replay_bwd_emit": 0, "ode_replay_fwd_team": 0,
            "ode_replay_bwd_team": 0, "ode_replay_bwd_emit_split3": 0, "ode_replay_bwd_split2": 0,
            "ode_select_team8": 0, "ode_attempt_team8": 0, "ode_replay_bwd_emit_team8": 0,
            "ode_replay_bwd_emit_split3_team8": 0}

_F32, _BF16 = torch.float32, torch.bfloat16


class ODESelectConfig(NamedTuple):
    """The selection's settings, as the JAX kernel bakes them in.
    ``max_steps`` is already rounded up (``solvers.fused.round_max_steps``)."""

    t_start: float
    t_end: float
    rtol: float = 1e-7
    atol: float = 1e-9
    dt0: float | None = None
    max_steps: int = 2048


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _w3(pw, sc: SDEConsts):
    return prepare_premixed_split({k: v.detach() for k, v in pw.items()}, sc.fc)[0]


def ode_drift(t, y, w, sc: SDEConsts, kv):
    """The drift of every dopri5 kernel: y (B, 3P), t a scalar shared by the
    batch (or (n, 1, 1) for n batched steps), kv (K, B, n_in). ``w`` holds
    the three-term split of wT (``prepare_premixed_split``) or the two-term
    one (``prepare_premixed_split2``); ``network_drift_premixed`` takes the
    matching product."""
    return network_drift_premixed(t, y, w, sc.fc, Stimulus(0.0, 0.0, kv),
                                  interp_fn=_knots(sc.knot_ts))


def _combine(y, h, weights, ks):
    """y + sum_j (h w_j) k_j over the nonzero w_j, left to right; from the
    first term alone when y is None."""
    out = y
    for w, k in zip(weights, ks):
        if w != 0.0:
            term = (h * w) * k
            out = term if out is None else out + term
    return out


def rk_step(f, t, y, h, f0):
    """One dopri5 step with stage 0 given: (y1, [k0..k6], [Y0..Y6]); the
    stages are unrolled with scalar coefficients as in ``_rk_step_u``."""
    ks, Ys = [f0], [y]
    for i in range(1, rk.N_STAGES):
        Ys.append(_combine(y, h, rk.A[i], ks))
        ks.append(f(t + rk.C[i] * h, Ys[i]))
    return _combine(y, h, rk.B, ks), ks, Ys


def dense_coeffs(y0, y1, h, ks):
    """Hairer's CONTD5 rows (r1..r5) of one step."""
    dy = y1 - y0
    r3 = h * ks[0] - dy
    return y0, dy, r3, dy - h * ks[-1] - r3, _combine(None, h, rk.DOPRI5_DENSE_D, ks)


def step_with_coeffs(f, t0, h, y):
    """The replay step: recompute stage 0, step, (y1, coeffs (5, B, 3P))."""
    y1, ks, _ = rk_step(f, t0, y, h, f(t0, y))
    return y1, torch.stack(dense_coeffs(y, y1, h, ks))


def _rms(x):
    """Root mean square over the whole batch state: the squares summed in
    float64 and rounded to float32 once."""
    return torch.sqrt(div((x * x).double().sum().to(x.dtype), x.numel()))


def _pow(x, p: float):
    return torch.exp(p * torch.log(x))


def _rdiv(c: float, x):
    """c / x as a division (PyTorch computes number / tensor through the
    tensor's reciprocal)."""
    return torch.full_like(x, c) / x


def _next_step_size(h, ratio):
    return h * torch.clamp(_SAFETY * _pow(ratio, -1.0 / _ORDER), _DFACTOR, _IFACTOR)


def initial_step_size(f, t0, y0, f0, rtol, atol):
    """Hairer's starting step, as ``_initial_step_size_k``."""
    scale = atol + rtol * y0.abs()
    d0, d1 = _rms(y0 / scale), _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    f1 = f(t0 + h0, y0 + h0 * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), torch.clamp_min(h0 * 1e-3, 1e-6),
                     _pow(_rdiv(0.01, torch.maximum(d1, d2)), 1.0 / _ORDER))
    return torch.minimum(100.0 * h0, h1)


class ODEAttempt(NamedTuple):
    y1: torch.Tensor      # (B, 3P) the fifth-order solution
    f1: torch.Tensor      # (B, 3P) its derivative (the next step's stage 0)
    ratio: torch.Tensor   # () the error ratio over the whole batch state
    h: torch.Tensor       # () the step used
    h_next: torch.Tensor  # ()


@torch.no_grad()
def attempt_plain(f, t, y, f0, h, cfg: ODESelectConfig) -> ODEAttempt:
    """One controller attempt of the drift f from (t, y, f0 = f(t, y)) with
    the proposed step h (scalars as 0-dim tensors)."""
    h = torch.minimum(h, cfg.t_end - t)
    y1, ks, _ = rk_step(f, t, y, h, f0)
    err = _combine(None, h, rk.B_ERR, ks)
    ratio = _rms(err / (cfg.atol + cfg.rtol * torch.maximum(y.abs(), y1.abs())))
    return ODEAttempt(y1, ks[-1], ratio, h, _next_step_size(h, ratio))


@torch.no_grad()
def select_plain(f, y0, cfg: ODESelectConfig):
    """The selection loop of the drift f from y0: (step_times (M+1,),
    stats (3,) int32 = naccept, nreject, success). The accept decision is
    read on the host once per attempt."""
    dev, M = y0.device, cfg.max_steps
    st = torch.full((M + 1,), cfg.t_end, dtype=_F32, device=dev)
    st[0] = cfg.t_start
    t = torch.tensor(cfg.t_start, dtype=_F32, device=dev)
    y, f0 = y0, f(t, y0)
    if cfg.dt0 is None:
        h = initial_step_size(f, t, y0, f0, cfg.rtol, cfg.atol)
    else:
        h = torch.tensor(cfg.dt0, dtype=_F32, device=dev)
    h = torch.clamp_max(h, cfg.t_end - cfg.t_start)
    na = nr = 0
    while bool(t < cfg.t_end) and na < M and nr < 4 * M + 64:
        a = attempt_plain(f, t, y, f0, h, cfg)
        if bool(a.ratio <= 1.0):
            t, y, f0, na = t + a.h, a.y1, a.f1, na + 1
        else:
            nr += 1
        st[na] = t
        h = a.h_next
    stats = torch.tensor([na, nr, int(bool(t >= cfg.t_end))], dtype=torch.int32, device=dev)
    return st, stats


def _network_f(w3, sc, kv):
    return lambda t_, y_: ode_drift(t_, y_, w3, sc, kv)


def _ode_attempt_plain(t, y, f0, h, w3, sc, kv, cfg: ODESelectConfig) -> ODEAttempt:
    """One controller attempt of the network drift."""
    return attempt_plain(_network_f(w3, sc, kv), t, y, f0, h, cfg)


def _ode_select_plain(y0, w3, sc, kv, cfg: ODESelectConfig):
    """The selection loop of the network drift."""
    return select_plain(_network_f(w3, sc, kv), y0, cfg)


def replay_fwd_plain(f, y0, st):
    """The replay of the drift f over the n = len(st) - 1 frozen steps:
    (ys (n, B, S) the step-start states, coeffs (n, 5, B, S))."""
    n = st.shape[0] - 1
    ys, coeffs, y = [], [], y0
    for k in range(n):
        ys.append(y)
        y, co = step_with_coeffs(f, st[k], st[k + 1] - st[k], y)
        coeffs.append(co)
    if n == 0:
        return y0.new_zeros((0,) + tuple(y0.shape)), y0.new_zeros((0, 5) + tuple(y0.shape))
    return torch.stack(ys), torch.stack(coeffs)


def _ode_replay_fwd_plain(y0, st, w3, sc, kv):
    """The replay of the network drift."""
    return replay_fwd_plain(_network_f(w3, sc, kv), y0, st)


def rk_step_vjp(f, vjp, t0, h, y, ybar, cbar):
    """The VJP of ``step_with_coeffs`` of the drift f at (t0, h, y) for the
    cotangents ybar on y1 and cbar (5, B, S) on the coefficient rows: the
    state cotangent. The stages are rebuilt from y, then ``vjp(t, Y_i,
    kbar_i)``, the drift's VJP at stage i, runs from stage 6 down (the
    caller's closure takes any weight cotangents)."""
    _, _, Ys = rk_step(f, t0, y, h, f(t0, y))
    c1, c2, c3, c4, c5 = cbar.unbind(-3)
    r3bar = c3 - c4
    dybar = (c2 + c4) - r3bar
    y1bar = ybar + dybar
    kbar = [(h * d) * c5 if d != 0.0 else None for d in rk.DOPRI5_DENSE_D]
    kbar[6] = kbar[6] - h * c4
    kbar[0] = kbar[0] + h * r3bar
    for j, b in enumerate(rk.B):
        if b != 0.0:
            kbar[j] = kbar[j] + (h * b) * y1bar
    ysum = (c1 - dybar) + y1bar
    for i in range(rk.N_STAGES - 1, -1, -1):
        g = vjp(t0 + rk.C[i] * h if i else t0, Ys[i], kbar[i])
        ysum = ysum + g
        for j, a in enumerate(rk.A[i]):
            if a != 0.0:
                kbar[j] = (h * a) * g if kbar[j] is None else kbar[j] + (h * a) * g
    return ysum


def step_vjp(t0, h, y, ybar, cbar, w, sc: SDEConsts, kv, weights: bool = True):
    """The hand-written VJP of ``step_with_coeffs`` of the network drift
    (``rk_step_vjp``): (state cotangent, d wT, d iwT), or the state
    cotangent alone with ``weights=False``. ``w`` is the three-term split
    (kernel mode) or the two-term one (``prepare_premixed_split2``). The
    seven drift VJPs' weight cotangents add in bf16 within the step and fold
    through the split once. Leading axes before (B, 3P) batch separate steps
    (t0 and h then carry them as (n, 1, 1)); each step keeps its own
    accumulators."""
    f = _network_f(w, sc, kv)
    if not weights:
        state_vjp = (network_drift_premixed_split3_vjp if "wT_lo" in w
                     else network_drift_premixed_split2_vjp)
        return rk_step_vjp(f, lambda t, Y, kb: state_vjp(Y, kb, w, sc.fc), t0, h, y, ybar, cbar)
    if "wT_lo" in w:
        vjp, fold = network_drift_premixed_split_vjp, split3_fold
    else:
        vjp, fold = network_drift_premixed_split2_weight_vjp, split2_fold
    stim, interp = Stimulus(0.0, 0.0, kv), _knots(sc.knot_ts)
    acc = [None, None]  # the bf16 accumulators of wT, d iwT

    def drift_vjp(t, Y, kb):
        g, acc[0], giw = vjp(t, Y, kb, w, sc.fc, stim, interp, acc[0])
        acc[1] = giw if acc[1] is None else acc[1] + giw
        return g

    ysum = rk_step_vjp(f, drift_vjp, t0, h, y, ybar, cbar)
    return ysum, fold(acc[0]), acc[1]


@torch.no_grad()
def _ode_replay_bwd_plain(ys, cobar, st, w3, sc, kv):
    """The reverse sweep over steps n-1..0: (ybar0 (B, 3P), d wT (P, P),
    d iwT (n_in, P)); the weight cotangents add across steps in float32."""
    n = ys.shape[0]
    ybar = torch.zeros_like(cobar[0, 0]) if n else cobar.new_zeros(tuple(cobar.shape[2:]))
    P, n_in = ybar.shape[-1] // 3, kv.shape[2]
    d_wT, d_iwT = ybar.new_zeros((P, P)), ybar.new_zeros((n_in, P))
    for k in range(n - 1, -1, -1):
        ybar, gw, giw = step_vjp(st[k], st[k + 1] - st[k], ys[k], ybar, cobar[k], w3, sc, kv)
        d_wT, d_iwT = d_wT + gw, d_iwT + giw
    return ybar, d_wT, d_iwT


@torch.no_grad()
def _ode_replay_bwd_emit_plain(ys, cobar, st, w, sc, kv):
    """The emit-mode reverse sweep over steps n-1..0, the state cotangent
    alone: (ybar0 (B, 3P), ybar_steps (n, B, 3P)); ybar_steps[k] is the
    cotangent on step k's output that the later steps send back, written
    before step k's VJP. ``w``: the three-term split or the two-term one."""
    n = ys.shape[0]
    ybar = cobar.new_zeros(tuple(cobar.shape[2:]))
    ybar_steps = torch.empty_like(ys)
    for k in range(n - 1, -1, -1):
        ybar_steps[k] = ybar
        ybar = step_vjp(st[k], st[k + 1] - st[k], ys[k], ybar, cobar[k], w, sc, kv,
                        weights=False)
    return ybar, ybar_steps


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on CUDA, anything else raises
# ---------------------------------------------------------------------------


def _named(y0, pw, sc, kv):
    B, S = y0.shape
    P = S // 3
    return {"y0": (y0, _F32, (B, S)), "wT": (pw["wT"], _F32, (P, P)),
            "iwT": (pw["iwT"], _F32, (kv.shape[2], P)), **_drift_named(sc, kv, B, P)}


def _select_host(sc: SDEConsts, cfg: ODESelectConfig):
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    hs, hs_p = _host_floats([cfg.t_start, cfg.t_end, cfg.rtol, cfg.atol,
                             0.0 if cfg.dt0 is None else cfg.dt0, cfg.t_end - cfg.t_start])
    return (hc, hs), hc_p, hs_p


def _net_args(y, pw, sc, kv):
    B, S = y.shape[-2:]
    return (B, S // 3, kv.shape[2], kv.shape[0]), (
        sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), pw["wT"].data_ptr(),
        pw["iwT"].data_ptr(), kv.data_ptr())


def _replay_named(st, n):
    return {"step_times": (st, _F32, (n + 1,))}


def ode_block_bytes(P: int, n_in: int, B: int, sweep: bool) -> int:
    """Shared memory that the one-block replay (B7, ``sweep`` False: one lane
    per block) or kernel-mode sweep (B8, ``sweep`` True: the batch of B
    lanes in one block) asks for at (P, n_in): ``setup_floats`` of
    csrc/split3_drift.cuh (the three-term weights, iwT and the drift's
    scratch), ten (3P) state vectors per lane for the replay, sixteen and
    the step's (n_in, P) iwT sum for the sweep. The library computes the
    same count (``cf_ode_block_bytes``, ``block_bytes`` in
    csrc/network_ode.cu); the card's tests hold the two equal."""
    nb, vectors, extra = (B, 16, n_in * P) if sweep else (1, 10, 0)
    floats = ((3 * P * P + 1) // 2 + n_in * P + 5 * nb * P + nb * _MAX_INPUTS + 1
              + 2 * (_THREADS // 32) + vectors * nb * 3 * P + extra)
    return 4 * floats


def ode_fwd_route(P: int, n_in: int) -> str:
    """Which kernel computes ``ode_replay_fwd`` on the card, by shape alone:
    "block" (B7, ``cf_ode_replay_fwd``, one block per lane) where its
    ``ode_block_bytes`` fit the 232,448 bytes of shared memory a block can
    use, else "team" (B7t-team, ``cf_ode_replay_fwd_team``: a team of 8
    blocks per lane, the weights streamed from L2). With 4 inputs that is
    "block" through 23 columns (P = 184) and "team" from 24."""
    return "block" if ode_block_bytes(P, n_in, 1, False) <= SMEM_BLOCK_BYTES else "team"


def ode_bwd_route(P: int, n_in: int, B: int, terms: int = 3) -> str:
    """Which kernel computes the kernel-mode sweep on the card, by shape
    alone. On the three-term split (``terms`` 3, ``ode_replay_bwd``): "block"
    (B8, ``cf_ode_replay_bwd``, the batch in one block) where its
    ``ode_block_bytes`` fit the 232,448 bytes of shared memory a block can
    use, else "team" (B8t-team, ``cf_ode_replay_bwd_team``: the batch on
    one team of 8 blocks, the weights streamed from L2). With 4 inputs and
    4 lanes that is "block" through 17 columns (P = 136) and "team" from 18;
    fewer lanes move the edge up, more move it down (16 lanes take the team
    at 13 columns). On the two-term split (``terms`` 2,
    ``ode_replay_bwd_split2``) always "team" (B8s): there is no one-block
    two-term sweep, and the team runs at any P that is a multiple of 8 (13
    columns: 13 populations per block)."""
    if terms not in (2, 3):
        raise ValueError(f"terms must be 2 or 3, got {terms}")
    if terms == 2:
        return "team"
    return "block" if ode_block_bytes(P, n_in, B, True) <= SMEM_BLOCK_BYTES else "team"


def ode_replay_fwd(y0, st, pw, sc: SDEConsts, kv, w3=None):
    """The replay of the frozen grid st (n + 1,) from y0 (B, 3P) on the
    three-term split of pw = {"wT", "iwT"} (float32): returns (ys (n, B,
    3P) the step-start states, coeffs (n, 5, B, 3P) the dense-output rows of
    every step). On the card B7 or B7t-team, as ``ode_fwd_route`` decides
    by shape before the launch. ``w3``: that split (contiguous), where the
    caller already holds it; B7 splits wT itself."""
    n = st.shape[0] - 1
    if not _on_cuda(y0, {**_named(y0, pw, sc, kv), **_replay_named(st, n)}):
        return _ode_replay_fwd_plain(y0, st, _w3(pw, sc) if w3 is None else w3, sc, kv)
    B, S = y0.shape
    ys = torch.empty((n, B, S), dtype=_F32, device=y0.device)
    coeffs = torch.empty((n, 5, B, S), dtype=_F32, device=y0.device)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    dims, ptrs = _net_args(y0, pw, sc, kv)
    if ode_fwd_route(S // 3, kv.shape[2]) == "block":
        _check(_lib().cf_ode_replay_fwd(*dims, hc_p, n, *ptrs, st.data_ptr(), y0.data_ptr(),
                                        ys.data_ptr(), coeffs.data_ptr(), _stream(y0)),
               "ode_replay_fwd")
        LAUNCHES["ode_replay_fwd"] += 1
        return ys, coeffs
    w3 = _w3_cuda(pw, sc) if w3 is None else w3
    scratch = torch.empty(10 * B * S, dtype=_F32, device=y0.device)
    bg, adapt, kvp = _consts(sc, kv)
    _check(_lib().cf_ode_replay_fwd_team(*dims, hc_p, n, bg, adapt, *_w_ptrs(w3, _W3), kvp,
                                         st.data_ptr(), y0.data_ptr(), scratch.data_ptr(),
                                         ys.data_ptr(), coeffs.data_ptr(), _stream(y0)),
           "ode_replay_fwd_team")
    LAUNCHES["ode_replay_fwd_team"] += 1
    return ys, coeffs


def _terms_and_transposes(w, terms):
    """The bf16 terms of a split and their transposes, contiguous, in the
    order the team sweeps take them: terms..., transposes..."""
    ws = tuple(w[k].contiguous() for k in terms)
    return ws + tuple(t.T.contiguous() for t in ws)


def ode_replay_bwd(ys, cobar, st, pw, sc: SDEConsts, kv):
    """The reverse sweep: ys (n, B, 3P) the step-start states, cobar (n, 5,
    B, 3P) the cotangents of the dense-output rows. Returns (ybar0 (B, 3P),
    d wT (P, P), d iwT (n_in, P)). On the card B8 or B8t-team, as
    ``ode_bwd_route`` decides by shape before the launch."""
    n, B, S = ys.shape
    P, n_in = S // 3, kv.shape[2]
    named = {"ys": (ys, _F32, (n, B, S)), "cobar": (cobar, _F32, (n, 5, B, S)),
             "wT": (pw["wT"], _F32, (P, P)), "iwT": (pw["iwT"], _F32, (n_in, P)),
             **_drift_named(sc, kv, B, P), **_replay_named(st, n)}
    if not _on_cuda(ys, named):
        return _ode_replay_bwd_plain(ys, cobar, st, _w3(pw, sc), sc, kv)
    dev = ys.device
    ybar = torch.empty((B, S), dtype=_F32, device=dev)
    d_wT = torch.empty((P, P), dtype=_F32, device=dev)
    d_iwT = torch.empty((n_in, P), dtype=_F32, device=dev)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    dims, ptrs = _net_args(ys, pw, sc, kv)
    if ode_bwd_route(P, n_in, B) == "block":
        work = torch.empty((3, P, P), dtype=_F32, device=dev)  # the step's bf16 accumulators
        _check(_lib().cf_ode_replay_bwd(*dims, hc_p, n, *ptrs, st.data_ptr(), ys.data_ptr(),
                                        cobar.data_ptr(), ybar.data_ptr(), d_wT.data_ptr(),
                                        d_iwT.data_ptr(), work.data_ptr(), _stream(ys)),
               "ode_replay_bwd")
        LAUNCHES["ode_replay_bwd"] += 1
        return ybar, d_wT, d_iwT
    w3 = _w3_cuda(pw, sc)
    scratch = torch.empty((16, B, S), dtype=_F32, device=dev)
    work = torch.empty((3 * P + n_in, P), dtype=_F32, device=dev)  # and the step's iwT sum
    bg, adapt, kvp = _consts(sc, kv)
    _check(_lib().cf_ode_replay_bwd_team(
        *dims, hc_p, n, bg, adapt, *(t.data_ptr() for t in _terms_and_transposes(w3, _W3)),
        w3["iwT"].data_ptr(), kvp, st.data_ptr(), ys.data_ptr(), cobar.data_ptr(),
        scratch.data_ptr(), ybar.data_ptr(), d_wT.data_ptr(), d_iwT.data_ptr(), work.data_ptr(),
        _stream(ys)), "ode_replay_bwd_team")
    LAUNCHES["ode_replay_bwd_team"] += 1
    return ybar, d_wT, d_iwT


# ---------------------------------------------------------------------------
# Team kernels: the selection (both tiers) and the split2 tier's replay and
# sweep; the weights stream from L2, each lane (the selection: the batch)
# spread over a cluster of blocks
# ---------------------------------------------------------------------------


def _split_named(w, P, n_in, terms):
    return {**{k: (w[k], _BF16, (P, P)) for k in terms}, "iwT": (w["iwT"], _F32, (n_in, P))}


def _w_ptrs(w, terms):
    return tuple(w[k].data_ptr() for k in terms) + (w["iwT"].data_ptr(),)


_W3, _W2 = ("wT_hi", "wT_mid", "wT_lo"), ("wT_hi", "wT_mid")


def _consts(sc, kv):
    return sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), kv.data_ptr()


def _w3_cuda(pw, sc: SDEConsts):
    """The three-term split the selection kernel reads from global memory,
    taken outside the kernel with the PyTorch ops of ``split_f32`` (the same
    values the JAX kernel's in-kernel prepare hook, or the split2 tier's
    ``select_args``, hold)."""
    return {k: v.contiguous() for k, v in _w3(pw, sc).items()}


# ---------------------------------------------------------------------------
# The cluster teams of B6, B8' and B8't (csrc/ode_team.cuh)
# ---------------------------------------------------------------------------

ODE_TEAM_ROUTES = ("resident", "streamed", "team8")
_T3_MAX_ITEMS = 2  # csrc/ode_team.cuh kT3MaxItems


class ODETeamPlan(NamedTuple):
    """The shape of a B6 or B8'/B8't team at P populations (csrc/ode_team.cuh
    ``plan3``, which ``cf_ode_team_plan`` reports)."""

    C: int        # blocks per team: the cluster size
    nc: int       # populations each block owns
    NT: int       # terms of the split
    NB: int       # lanes the team holds (the selection: the batch; the sweep: 1)
    LB: int       # forward products: lanes per thread (the sweep 1, the selection 4; 2
                  # where a thread owns two items)
    G: int        # lane groups
    gw: int       # exchange words of a lane group at one row (even)
    xs: int       # exchange words of a row
    L: int        # forward products: lanes per (group, column)
    Lv: int       # VJP products: lanes per row (32 / L)
    rw: int       # 32-bit words of a packed row: NT nc bf16, then pad (max(1, Lv / 2) times odd)
    ipt: int      # owned (lane, population) items per thread
    slots: int    # exchange slots: 2 (double buffered) or 1
    stream: bool  # the slice streams through a ring of tiles (else it stays resident)
    R: int        # rows per tile (resident: P)
    T: int        # tiles per product pass
    S: int        # stages of the ring (resident: 1)
    fits: bool    # False: this design takes no such team (the route is "team8")
    slot: int     # bytes of an exchange slot
    fixed: int    # shared-memory bytes before the weights
    bytes: int    # shared-memory bytes of a block


def _t3_fixed(C, nc, NB, n_in, slot, slots):
    return (slots * slot + _align16(4 * NB * nc) + _align16(8 * nc) + _align16(8 * NB * n_in)
            + _align16(4 * _MAX_KNOTS * NB * n_in) + _align16(4 * (n_in + 2) * nc)
            + _align16(8 * (_THREADS // 32 + 2 * C)) + _align16(8 * (1 + 2 * _T2_MAX_STAGES)))


def ode_team_plan(P: int, n_in: int, NB: int, NT: int, sweep: bool,
                  stream: bool = False) -> ODETeamPlan:
    """The team shape of the selection (``sweep`` False: NB lanes, three
    terms) or the emit-mode sweep (``sweep`` True: one lane, NT terms) at P
    populations and n_in inputs: a cluster of 16 blocks where 16 divides P,
    else 8; block r owns populations [r nc, (r + 1) nc) of every lane and
    keeps the columns [r nc, (r + 1) nc) of the NT bf16 terms in shared
    memory: a (P, rw) slice of words, resident where it and two exchange
    slots fit the 232,448 bytes a block can use (the selection through 32
    columns, the sweeps through 63 and the two-term one at 104), else (or
    with ``stream``) streamed in tiles of R rows through S stages; one exchange slot where two leave no room for two stages (16
    lanes at 104 columns). ``fits`` is False where no tiling fits or a
    thread would own more than two (lane, population) items (16 lanes at
    312 columns): the route is then "team8"."""
    if P <= 0 or P % 8:
        raise ValueError(f"P must be a positive multiple of 8, got {P}")
    if not 0 <= n_in <= _MAX_INPUTS:
        raise ValueError(f"n_in must lie in [0, {_MAX_INPUTS}], got {n_in}")
    if NT not in (2, 3) or NB < 1 or (sweep and NB != 1):
        raise ValueError(f"no team takes NT={NT}, NB={NB}, sweep={sweep}")
    C = 16 if P % 16 == 0 else 8
    nc = P // C
    ipt = -(-NB * nc // _THREADS)
    LB = 1 if sweep else (4 if ipt == 1 else 2)
    G = -(-NB // LB)
    gw = -(-LB * NT // 2) * 2
    xs = G * gw
    L = 32
    while L > 1 and G * nc * L > _THREADS:
        L //= 2
    Lv = 32 // L
    v = max(1, Lv // 2)
    rw = -(-(-(-NT * nc // 2)) // v) * v
    if (rw // v) % 2 == 0:
        rw += v
    slot = _align16(max(4 * P * xs, 8 * NT * P if sweep else 0))
    row = 4 * rw
    fits = ipt <= _T3_MAX_ITEMS
    head = (C, nc, NT, NB, LB, G, gw, xs, L, Lv, rw, ipt)
    f2 = _t3_fixed(C, nc, NB, n_in, slot, 2)
    if not stream and f2 + row * P <= SMEM_BLOCK_BYTES:
        return ODETeamPlan(*head, 2, False, P, 1, 1, fits, slot, f2, f2 + row * P)
    # Streamed: the first tile height from r0 down that leaves two stages.
    r0, rmin = max(16 * L, _T2_MIN_TILE_ROWS), max(L, 8)
    for slots in (2, 1):
        f = _t3_fixed(C, nc, NB, n_in, slot, slots)
        room = max(SMEM_BLOCK_BYTES - f, 0)
        R = r0
        while R >= rmin:
            T = -(-P // R)
            S = min(_T2_MAX_STAGES, room // (row * R), T)
            if S >= min(T, 2):
                return ODETeamPlan(*head, slots, True, R, T, S, fits, slot, f, f + row * R * S)
            R //= 2
    f1 = _t3_fixed(C, nc, NB, n_in, slot, 1)
    return ODETeamPlan(*head, 1, True, P, 1, 0, False, slot, f1, f1)


def ode_team_route(P: int, n_in: int, NB: int, NT: int, sweep: bool) -> str:
    """How the selection (``sweep`` False, NB lanes) or the emit-mode sweep
    runs on the card, by shape alone: "resident" or "streamed" (the cluster
    teams, as ``ode_team_plan`` holds the weights) where the plan fits, else
    "team8" (the 8-block team kernel that reads the weights from L2). With
    4 inputs the selection is "resident" at 13 and 32 columns, "streamed"
    at 63, 104 (4 or 16 lanes) and 312 (4 lanes), "team8" for 8 or more
    lanes at 312; the sweeps are "resident" through 63 columns and at 104
    on two terms, else "streamed"."""
    p = ode_team_plan(P, n_in, NB, NT, sweep)
    return "team8" if not p.fits else ("streamed" if p.stream else "resident")


def ode_team_pack(w, P: int, plan: ODETeamPlan) -> torch.Tensor:
    """The NT bf16 terms of a split of wT packed per block, (C, P, rw) int32
    words of two bf16 each: row k of block r holds W_hi[k, r nc:(r+1) nc],
    then W_mid's (then W_lo's), then zero pad."""
    C, nc = plan.C, plan.nc
    names = _W3 if plan.NT == 3 else _W2
    pk = torch.zeros((C, P, 2 * plan.rw), dtype=_BF16, device=w[names[0]].device)
    for t, name in enumerate(names):
        pk[:, :, t * nc:(t + 1) * nc] = w[name].view(P, C, nc).transpose(0, 1)
    return pk.view(torch.int32)


def _check_ode_route(route):
    if route is not None and route not in ODE_TEAM_ROUTES:
        raise ValueError(f"route must be one of {ODE_TEAM_ROUTES}, got {route!r}")


def _team3(route, P, n_in, NB, NT, sweep):
    """(route, plan) of a launch on the card: ``route`` or the shape's
    default; the plan None for "team8". Raises where the team asked for
    does not take the shape."""
    route = route or ode_team_route(P, n_in, NB, NT, sweep)
    if route == "team8":
        return route, None
    plan = ode_team_plan(P, n_in, NB, NT, sweep, stream=route == "streamed")
    if not plan.fits or (route == "resident" and plan.stream):
        raise ValueError(f"no {route} team takes P={P} with {NB} lanes and {NT} terms "
                         f"({'streamed' if plan.fits else 'team8'} does)")
    return route, plan


def ode_select(y0, pw, sc: SDEConsts, kv, cfg: ODESelectConfig, route=None):
    """The step-size selection for the batch state y0 (B, 3P) under one
    controller, on the three-term split of ``pw`` = {"wT" (P, P), "iwT"
    (n_in, P)} float32: the f32-exact engine's selection and the split2
    tier's (``select_func`` on ``prepare_premixed_split``). kv (K, B, n_in).
    Returns (step_times (M+1,) float32, stats (3,) int32 = naccept, nreject,
    success). On the card B6, one cluster team for the batch; ``route``
    (default ``ode_team_route``): "resident", "streamed", or "team8", the
    8-block team that reads the weights from L2 (a yardstick, and the shapes
    the teams do not take)."""
    _check_ode_route(route)
    if not _on_cuda(y0, _named(y0, pw, sc, kv)):
        return _ode_select_plain(y0, _w3(pw, sc), sc, kv, cfg)
    B, S = y0.shape
    P, n_in, K = S // 3, kv.shape[2], kv.shape[0]
    route, plan = _team3(route, P, n_in, B, 3, False)
    dev = y0.device
    st = torch.empty(cfg.max_steps + 1, dtype=_F32, device=dev)
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    w3 = _w3_cuda(pw, sc)
    keep, hc_p, hs_p = _select_host(sc, cfg)
    bg, adapt, kvp = _consts(sc, kv)
    head = (B, P, n_in, K, hc_p, hs_p, int(cfg.dt0 is None), cfg.max_steps)
    if route == "team8":
        scratch = torch.empty(10 * B * S, dtype=_F32, device=dev)
        _check(_lib().cf_ode_select_team8(*head, bg, adapt, *_w_ptrs(w3, _W3), kvp,
                                          y0.data_ptr(), scratch.data_ptr(), st.data_ptr(),
                                          stats.data_ptr(), _stream(y0)), "ode_select_team8")
        LAUNCHES["ode_select_team8"] += 1
        return st, stats
    wpk = ode_team_pack(w3, P, plan)
    _check(_lib().cf_ode_select(*head, int(plan.stream), bg, adapt, wpk.data_ptr(),
                                w3["iwT"].data_ptr(), kvp, y0.data_ptr(), st.data_ptr(),
                                stats.data_ptr(), _stream(y0)), "ode_select")
    LAUNCHES["ode_select"] += 1
    return st, stats


def ode_attempt(t, y, f0, h, pw, sc: SDEConsts, kv, cfg: ODESelectConfig,
                route=None) -> ODEAttempt:
    """One controller attempt (the body of the selection kernel) from the
    0-dim tensors t, h and the batch state y with f0 = f(t, y); ``route`` as
    ``ode_select``'s."""
    _check_ode_route(route)
    named = {**_named(y, pw, sc, kv), "f0": (f0, _F32, tuple(y.shape)),
             "t": (t, _F32, ()), "h": (h, _F32, ())}
    if not _on_cuda(y, named):
        return _ode_attempt_plain(t, y, f0, h, _w3(pw, sc), sc, kv, cfg)
    B, S = y.shape
    P, n_in, K = S // 3, kv.shape[2], kv.shape[0]
    route, plan = _team3(route, P, n_in, B, 3, False)
    y1, f1 = torch.empty_like(y), torch.empty_like(y)
    rec = torch.empty(3, dtype=_F32, device=y.device)
    w3 = _w3_cuda(pw, sc)
    keep, hc_p, hs_p = _select_host(sc, cfg)
    bg, adapt, kvp = _consts(sc, kv)
    tail = (t.data_ptr(), h.data_ptr(), y.data_ptr(), f0.data_ptr())
    outs = (y1.data_ptr(), f1.data_ptr(), rec.data_ptr(), _stream(y))
    if route == "team8":
        scratch = torch.empty(10 * B * S, dtype=_F32, device=y.device)
        _check(_lib().cf_ode_attempt_team8(B, P, n_in, K, hc_p, hs_p, bg, adapt,
                                           *_w_ptrs(w3, _W3), kvp, *tail, scratch.data_ptr(),
                                           *outs), "ode_attempt_team8")
        LAUNCHES["ode_attempt_team8"] += 1
    else:
        wpk = ode_team_pack(w3, P, plan)
        _check(_lib().cf_ode_attempt(B, P, n_in, K, hc_p, hs_p, int(plan.stream), bg, adapt,
                                     wpk.data_ptr(), w3["iwT"].data_ptr(), kvp, *tail, *outs),
               "ode_attempt")
        LAUNCHES["ode_attempt"] += 1
    return ODEAttempt(y1, f1, rec[0], rec[1], rec[2])


def ode_replay_fwd_split2(y0, st, w2, sc: SDEConsts, kv):
    """The replay of the frozen grid st (n + 1,) from y0 (B, 3P) with the
    two-term split (``prepare_premixed_split2`` output): (ys (n, B, 3P) the
    step-start states, coeffs (n, 5, B, 3P) the dense-output rows)."""
    B, S = y0.shape
    P, n_in, K, n = S // 3, kv.shape[2], kv.shape[0], st.shape[0] - 1
    named = {"y0": (y0, _F32, (B, S)), **_split_named(w2, P, n_in, _W2),
             **_drift_named(sc, kv, B, P), **_replay_named(st, n)}
    if not _on_cuda(y0, named):
        return _ode_replay_fwd_plain(y0, st, w2, sc, kv)
    dev = y0.device
    ys = torch.empty((n, B, S), dtype=_F32, device=dev)
    coeffs = torch.empty((n, 5, B, S), dtype=_F32, device=dev)
    scratch = torch.empty(10 * B * S, dtype=_F32, device=dev)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    bg, adapt, kvp = _consts(sc, kv)
    _check(_lib().cf_ode_replay_fwd_split2(B, P, n_in, K, hc_p, n, bg, adapt, *_w_ptrs(w2, _W2),
                                           kvp, st.data_ptr(), y0.data_ptr(),
                                           scratch.data_ptr(), ys.data_ptr(), coeffs.data_ptr(),
                                           _stream(y0)), "ode_replay_fwd_split2")
    LAUNCHES["ode_replay_fwd_split2"] += 1
    return ys, coeffs


def ode_replay_bwd_emit(ys, cobar, st, w, sc: SDEConsts, kv, route=None):
    """The emit-mode reverse sweep of the replay: ys (n, B, 3P) the
    step-start states, cobar (n, 5, B, 3P) the cotangents of the dense
    rows, ``w`` the split the replay ran on: the three-term one
    (``prepare_premixed_split``, B8't: the f32-exact engine in outer mode)
    or the two-term one (``prepare_premixed_split2``, B8': the split2
    tier). Returns (ybar0 (B, 3P), ybar_steps (n, B, 3P)), ybar_steps[k]
    the cotangent on step k's output from the later steps. On the card a
    cluster team per lane; ``route`` as ``ode_select``'s."""
    _check_ode_route(route)
    n, B, S = ys.shape
    P, n_in, K = S // 3, kv.shape[2], kv.shape[0]
    split3 = "wT_lo" in w
    terms = _W3 if split3 else _W2
    named = {"ys": (ys, _F32, (n, B, S)), "cobar": (cobar, _F32, (n, 5, B, S)),
             **_split_named(w, P, n_in, terms), **_drift_named(sc, kv, B, P),
             **_replay_named(st, n)}
    if not _on_cuda(ys, named):
        return _ode_replay_bwd_emit_plain(ys, cobar, st, w, sc, kv)
    route, plan = _team3(route, P, n_in, 1, len(terms), True)
    dev = ys.device
    ybar = torch.empty((B, S), dtype=_F32, device=dev)
    ybar_steps = torch.empty_like(ys)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    bg, adapt, kvp = _consts(sc, kv)
    name = "ode_replay_bwd_emit_split3" if split3 else "ode_replay_bwd_emit"
    data = (w["iwT"].data_ptr(), kvp, st.data_ptr(), ys.data_ptr(), cobar.data_ptr())
    outs = (ybar.data_ptr(), ybar_steps.data_ptr(), _stream(ys))
    if route == "team8":
        scratch = torch.empty(16 * B * S, dtype=_F32, device=dev)
        _check(getattr(_lib(), f"cf_{name}_team8")(
            B, P, n_in, K, hc_p, n, bg, adapt,
            *(t.data_ptr() for t in _terms_and_transposes(w, terms)), *data,
            scratch.data_ptr(), *outs), f"{name}_team8")
        LAUNCHES[f"{name}_team8"] += 1
        return ybar, ybar_steps
    wpk = ode_team_pack(w, P, plan)
    _check(getattr(_lib(), "cf_" + name)(B, P, n_in, K, hc_p, n, int(plan.stream), bg, adapt,
                                         wpk.data_ptr(), *data, *outs), name)
    LAUNCHES[name] += 1
    return ybar, ybar_steps


def ode_replay_bwd_split2(ys, cobar, st, w2, sc: SDEConsts, kv):
    """The kernel-mode reverse sweep of the split2 replay
    (``ode_replay_fwd_split2``): ys (n, B, 3P) the step-start states, cobar
    (n, 5, B, 3P) the cotangents of the dense rows, ``w2`` the two-term
    split (``prepare_premixed_split2``). Returns (ybar0 (B, 3P), d wT (P, P),
    d iwT (n_in, P)): each step's seven drift VJPs add their weight
    cotangents, contracted over the batch and rounded to bf16, into the
    step's two bf16 accumulators, folded once per step (``split2_fold``)
    and summed over the steps in float32. On the card B8s, one team of 8
    blocks for the batch (``ode_bwd_route`` with two terms)."""
    n, B, S = ys.shape
    P, n_in, K = S // 3, kv.shape[2], kv.shape[0]
    named = {"ys": (ys, _F32, (n, B, S)), "cobar": (cobar, _F32, (n, 5, B, S)),
             **_split_named(w2, P, n_in, _W2), **_drift_named(sc, kv, B, P),
             **_replay_named(st, n)}
    if not _on_cuda(ys, named):
        return _ode_replay_bwd_plain(ys, cobar, st, w2, sc, kv)
    dev = ys.device
    ybar = torch.empty((B, S), dtype=_F32, device=dev)
    d_wT = torch.empty((P, P), dtype=_F32, device=dev)
    d_iwT = torch.empty((n_in, P), dtype=_F32, device=dev)
    scratch = torch.empty((16, B, S), dtype=_F32, device=dev)
    work = torch.empty((2 * P + n_in, P), dtype=_F32, device=dev)  # hi, mid and the iwT sum
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    bg, adapt, kvp = _consts(sc, kv)
    _check(_lib().cf_ode_replay_bwd_split2(
        B, P, n_in, K, hc_p, n, bg, adapt, *(t.data_ptr() for t in _terms_and_transposes(w2, _W2)),
        w2["iwT"].data_ptr(), kvp, st.data_ptr(), ys.data_ptr(), cobar.data_ptr(),
        scratch.data_ptr(), ybar.data_ptr(), d_wT.data_ptr(), d_iwT.data_ptr(), work.data_ptr(),
        _stream(ys)), "ode_replay_bwd_split2")
    LAUNCHES["ode_replay_bwd_split2"] += 1
    return ybar, d_wT, d_iwT
