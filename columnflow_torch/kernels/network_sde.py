"""The column-network SDE kernels: adaptive step-size selection, the replay
over the frozen step grids, and its reverse sweep (ports of the Pallas
kernels B5, B3 and B4 of ``columnflow/solvers``, and of the XLA selection
loop ``_adaptive_pass`` as a kernel).

Each kernel is CUDA C++ in ``csrc/network_sde.cu`` or, for the
selection's cluster teams, ``csrc/sde_select_team.cu`` (built by
``_build``) with a plain PyTorch version beside it that repeats its
arithmetic:

    wrapper         kernel              plain version      replaces (columnflow/solvers/)
    select_pass     cf_sde_select_team  _select_plain      sde_adaptive.py _make_sde_adaptive_kernel (B5;
                    (cf_sde_select)                        on the three-term split, B5t), and the
                                                           XLA selection _adaptive_pass (a cluster
                                                           team per lane: ``sde_select_route``;
                                                           route "block": the one-block kernel)
    select_attempt  cf_sde_attempt_team _attempt_plain     one iteration of that loop's body
                    (cf_sde_attempt)
    replay_fwd      cf_sde_replay_fwd   _replay_fwd_plain  fused.py _make_sde_chunk_kernel, lanes (B3;
                                                           a cluster team per lane: ``sde2_replay_plan``)
    replay_bwd      cf_sde_replay_bwd   _replay_bwd_plain  fused.py _make_sde_bwd_chunk_kernel, emit (B4;
                                                           the same teams)
    replay3_fwd     cf_sde3_fwd         _replay3_fwd_plain _make_sde_chunk_kernel on the three-term
                    (cf_sde3_fwd_team)                     split, lanes or uniform grid (B3t; as a
                                                           team, B3t-team: ``sde3_fwd_route``)
    replay3_bwd     cf_sde3_bwd         _replay3_bwd_plain _make_sde_bwd_chunk_kernel, kernel mode,
                    (cf_sde3_bwd_team)                     three-term split (B4't; as a team,
                                                           B4't-team: ``sde3_bwd_route``)
    replay3_bwd_emit
                    cf_sde3_bwd_emit    _replay3_bwd_emit_plain
                                                           the same body, emit mode, three-term
                                                           split (B4t)
    replay2_bwd     cf_sde2_bwd         _replay2_bwd_plain _make_sde_bwd_chunk_kernel, kernel mode,
                                                           two-term split (B4s, B4't-team's team
                                                           kernel)

The JAX kernels trace any drift. These compute the parity task's drift:
``network_drift_premixed`` with the knot stimulus and the constant
diffusion sigma = 10. The selection (``SelectConfig``) draws from the krng
tree (``brownian="kernel"``, the JAX package's in-kernel pass) or from the
``jax.random`` tree (``brownian="jax"``, its XLA pass), on the bf16 weights
of ``premix_select16`` (``drift="select16"``), the float32 ones
(``drift="f32"``) or, in the in-kernel pass, the three-term split of
``prepare_premixed_split`` (``drift="split3"``, ``select_weights_split3``).
The split2 replay, its emit-mode sweep and its kernel-mode sweep (B4s, the
weight cotangents in the sweep) run on the
two-term split of ``prepare_premixed_split2``; the three-term ones on
``prepare_premixed_split``, with the weight cotangents in the sweep (kernel
mode) or outside it (emit mode: the state cotangent and each step's seed).
The selection and the split2 replay and its emit-mode sweep run each lane
on a cluster of 8 or 16 blocks, each block holding its columns of the
weights in shared memory (``sde_select_pack``, ``sde2_pack``: the
wrapper packs them per block on every call; streamed through a ring of
tiles where they do not fit, ``sde2_replay_route``). The
three-term kernel-mode reverse sweep holds the batch in one block, because
jax.vjp contracts each weight cotangent over the lanes before rounding it
to bf16, or, where the batch and the weights do not fit a block (from ~20
columns at 4 lanes), in one team of 8 blocks, each forming the weight
cotangents of its own output columns. Where the three-term weights do not
fit a block (from ~24 columns), the forward and the emit-mode sweep run
each lane on a team of 8 blocks with the weights in L2.

The selection's plain loop (``select_plain``, ``attempt_plain``) takes the
drift and the diffusion as callables: ``kernels.xor_sde`` runs the same
loop on the XOR drift, and both selection kernels share their trees and
controller (``csrc/sde_select.cuh``).

The wrappers take the plain version for tensors on the CPU; for CUDA
tensors they launch the kernel or raise. ``LAUNCHES`` counts kernel
launches (the plain versions count nothing).

The JAX kernels cut the horizon into chunks only because the trajectory had
to fit the TPU's VMEM; device memory holds the whole (n + 1, B, 3P)
replay, so each sweep here is one launch. Truncated BPTT still zeroes the
cotangent at the step indices JAX's chunking gives (``stride``), and the
three-term sweep sums the weight cotangents chunk by chunk as JAX does
(``chunk``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.network import (
    NETWORK_NOISE_STD,
    network_drift_premixed,
    network_drift_premixed_select16,
    network_drift_premixed_split2_vjp,
    network_drift_premixed_split2_weight_vjp,
    network_drift_premixed_split_vjp,
    prepare_premixed_split,
    split2_fold,
    split3_fold,
)
from columnflow_torch.ops.arith import div
from columnflow_torch.ops.interp import interp_knots, knot_constants
from columnflow_torch.solvers import brownian as brownian_paths
from columnflow_torch.solvers.krng import KernelBrownianTree, interval_normal

SIGMA = NETWORK_NOISE_STD
# The controller (``columnflow/solvers/sde_adaptive.py``): factor = safety *
# err^(-PI_A q) * err_prev^(PI_B q) on accept, safety * err^(-q) on reject,
# clipped to [DFACTOR, IFACTOR]; q = 1/2 for SRA1. The CUDA kernel holds the
# same numbers as literals.
_SAFETY, _IFACTOR, _DFACTOR = 0.9, 5.0, 0.2
_PI_A, _PI_B, _ERR_EXP = 0.5, 0.25, 0.5
LAUNCHES = {"sde_select": 0, "sde_attempt": 0, "sde_select_block": 0, "sde_attempt_block": 0,
            "sde_replay_fwd": 0, "sde_replay_bwd": 0,
            "sde3_fwd": 0, "sde3_bwd": 0, "sde3_fwd_team": 0, "sde3_bwd_emit": 0,
            "sde3_bwd_team": 0, "sde2_bwd": 0, "sde2_fwd_team8": 0, "sde2_bwd_team8": 0}
# What a thread block can hold (sm_90: 227 KB of shared memory), and the
# kernels' layout constants (csrc/network_drift.cuh kThreads, kMaxInputs).
SMEM_BLOCK_BYTES = 232448
_THREADS, _MAX_INPUTS, _MAX_KNOTS, _MAX_DEPTH = 512, 16, 8, 31
# The kernels' codes of the two trees and of the selection drifts.
TREES = {"kernel": 0, "jax": 1}
SELECT_DRIFTS = {"select16": 0, "f32": 2, "split3": 3}

_F32, _BF16, _I64 = torch.float32, torch.bfloat16, torch.int64


class SDEConsts(NamedTuple):
    """What the drift reads besides state, weights and knot values:
    ``fc`` from ``build_network_fused_consts`` and the K knot times."""

    fc: dict
    knot_ts: tuple


class SelectConfig(NamedTuple):
    """The selection's settings, as the JAX kernel bakes them in, and its
    Brownian tree ("kernel": krng, "jax": jax.random) and drift
    ("select16": bf16 weights, "f32")."""

    t_start: float
    t_end: float
    rtol: float = 1e-3
    atol: float = 1e-3
    h0: float = 0.0
    max_steps: int = 16384
    depth: int = 20
    dt_min: float = 0.0
    brownian: str = "kernel"
    drift: str = "select16"


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _knots(knot_ts):
    return lambda t, t0, dt, v: interp_knots(t, knot_ts, v)


def drift_premixed(t, y, pw, sc: SDEConsts, kv):
    """The drift on premixed weights in any of their formats: y (B, 3P),
    t (B, 1) or a scalar, kv (K, B, n_in). ``pw`` = {"wT", "iwT"} float32
    (the f32 selection drift), or the output of ``prepare_premixed_split``
    (the three-term replay) or ``prepare_premixed_split2`` (split2)."""
    return network_drift_premixed(t, y, pw, sc.fc, Stimulus(0.0, 0.0, kv),
                                  interp_fn=_knots(sc.knot_ts))


def drift_select16(t, y, w16, sc: SDEConsts, kv):
    """The selection drift (bf16 weights)."""
    return network_drift_premixed_select16(t, y, w16, sc.fc, Stimulus(0.0, 0.0, kv),
                                           interp_fn=_knots(sc.knot_ts))


def sra1_step(drift, t0, h, y, dw, i10, sigma=SIGMA):
    """Roessler SRA1 for the additive diffusion ``sigma`` (a number, or a
    tensor that broadcasts against y), h == 0 safe (padding steps carry h =
    dw = i10 = 0 and are exact no-ops). t0, h, dw, i10 per lane (B, 1)."""
    i10_h = i10 / torch.where(h > 0, h, 1.0)
    f1 = drift(t0, y)
    h2 = y + (0.75 * h) * f1 + (1.5 * i10_h) * sigma
    f2 = drift(t0 + 0.75 * h, h2)
    return y + h * (div(f1, 3.0) + div(2.0 * f2, 3.0)) + (dw - i10_h) * sigma + i10_h * sigma


def step_vjp_split2(t0, h, y, i10, c, w2, sc: SDEConsts, kv, sigma: float = SIGMA,
                    weights: bool = False):
    """State cotangent of one replay step (``sra1_step`` with the split2
    drift) for the cotangent c of its output. With ``weights``: (state
    cotangent, the step's d wT, its d iwT), as ``step_vjp_split3`` takes
    them on the three-term split: the second stage's drift is met first and
    its weight cotangents open the step's two bf16 accumulators
    (``split2_accumulate``), the first stage's add to them, one fold
    (``split2_fold``); d iwT in float32. The state cotangent is the same
    either way."""
    i10_h = i10 / torch.where(h > 0, h, 1.0)
    h2 = y + (0.75 * h) * drift_premixed(t0, y, w2, sc, kv) + (1.5 * i10_h) * sigma
    c3 = div(h * c, 3.0)
    if not weights:
        c_h2 = network_drift_premixed_split2_vjp(h2, c3 * 2.0, w2, sc.fc)
        c_y = network_drift_premixed_split2_vjp(y, c3 + (0.75 * h) * c_h2, w2, sc.fc)
        return (c + c_h2) + c_y
    stim = Stimulus(0.0, 0.0, kv)
    interp = _knots(sc.knot_ts)
    c_h2, acc, d_iw2 = network_drift_premixed_split2_weight_vjp(
        t0 + 0.75 * h, h2, c3 * 2.0, w2, sc.fc, stim, interp_fn=interp)
    c_y, acc, d_iw1 = network_drift_premixed_split2_weight_vjp(
        t0, y, c3 + (0.75 * h) * c_h2, w2, sc.fc, stim, interp_fn=interp, acc=acc)
    return (c + c_h2) + c_y, split2_fold(acc), d_iw2 + d_iw1


def step_vjp_split3(t0, h, y, i10, c, w3, sc: SDEConsts, kv, sigma: float = SIGMA):
    """The VJP of one three-term replay step for the cotangent c of its
    output: (state cotangent, the step's d wT, its d iwT). The second
    stage's drift is met first: its weight cotangents open the step's bf16
    accumulators, the first stage's add to them, and they fold through the
    split once (``split3_fold``), as ``jax.vjp`` of the step does."""
    stim = Stimulus(0.0, 0.0, kv)
    interp = _knots(sc.knot_ts)
    i10_h = i10 / torch.where(h > 0, h, 1.0)
    h2 = y + (0.75 * h) * drift_premixed(t0, y, w3, sc, kv) + (1.5 * i10_h) * sigma
    c3 = div(h * c, 3.0)
    c_h2, acc, d_iw2 = network_drift_premixed_split_vjp(t0 + 0.75 * h, h2, c3 * 2.0, w3, sc.fc,
                                                        stim, interp_fn=interp)
    c_y, acc, d_iw1 = network_drift_premixed_split_vjp(t0, y, c3 + (0.75 * h) * c_h2, w3, sc.fc,
                                                       stim, interp_fn=interp, acc=acc)
    return (c + c_h2) + c_y, split3_fold(acc), d_iw2 + d_iw1


def _lane_times(t0s, hs, k, B):
    """Step k's (t0, h) per lane, (B, 1): a row of (n, B) per-lane times,
    or the uniform grid's (n,) times for every lane."""
    if t0s.dim() == 1:
        return t0s[k].expand(B, 1), hs[k].expand(B, 1)
    return t0s[k, :, None], hs[k, :, None]


def sra1_replay_plain(drift, sigma, y0, t0s, hs, i1, i10, n_real):
    """SRA1 over each lane's grid for ``drift(t, y)`` (t (B, 1)) and the
    additive diffusion ``sigma`` (a number, or a tensor that broadcasts
    against the state): ys (n + 1, B, S), ys[0] = y0, ys[k + 1] after step
    k; rows past n_real hold the carried state. t0s, hs (n, B) or (n,)."""
    n, B = t0s.shape[0], y0.shape[0]
    ys = torch.empty((n + 1,) + tuple(y0.shape), dtype=_F32, device=y0.device)
    ys[0] = y = y0
    for k in range(n_real):
        t0, h = _lane_times(t0s, hs, k, B)
        y = sra1_step(drift, t0, h, y, i1[k, :, None], i10[k, :, None], sigma)
        ys[k + 1] = y
    ys[n_real + 1:] = y
    return ys


def _replay_fwd_plain(y0, t0s, hs, i1, i10, n_real, w, sc, kv):
    """``sra1_replay_plain`` of the network drift, ``w`` in a replay format
    of ``drift_premixed`` (split2, or the three-term split)."""
    return sra1_replay_plain(lambda t, x: drift_premixed(t, x, w, sc, kv), SIGMA, y0, t0s, hs,
                             i1, i10, n_real)


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


def _replay3_fwd_plain(y0, t0s, hs, i1, i10, n_real, pw, sc, kv):
    """B3t's plain version: ``_replay_fwd_plain`` on the three-term split of
    pw = {"wT", "iwT"} (float32)."""
    w3 = prepare_premixed_split(pw, sc.fc)[0]
    return _replay_fwd_plain(y0, t0s, hs, i1, i10, n_real, w3, sc, kv)


@torch.no_grad()
def _replay3_bwd_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, chunk, pw, sc, kv):
    """B4't's plain version, over steps n_real-1..0 with the seed ybar +
    ysbar[k] on step k's output: (ybar, d wT, d iwT). The carry is zeroed
    after every step k with k % stride == 0; the steps' weight cotangents
    add in float32 within each chunk of ``chunk`` steps, and the chunk sums
    are added after the chunk's first step (k % chunk == 0)."""
    w3 = prepare_premixed_split(pw, sc.fc)[0]
    B = ys_prev.shape[1]
    ybar = torch.zeros_like(ys_prev[0])
    d = [torch.zeros_like(pw["wT"]), torch.zeros_like(pw["iwT"])]
    part = [torch.zeros_like(pw["wT"]), torch.zeros_like(pw["iwT"])]
    for k in range(n_real - 1, -1, -1):
        t0, h = _lane_times(t0s, hs, k, B)
        ybar, g_w, g_iw = step_vjp_split3(t0, h, ys_prev[k], i10[k, :, None], ybar + ysbar[k],
                                          w3, sc, kv)
        if stride and k % stride == 0:
            ybar = torch.zeros_like(ybar)
        part = [part[0] + g_w, part[1] + g_iw]
        if k % chunk == 0:
            d = [d[0] + part[0], d[1] + part[1]]
            part = [torch.zeros_like(p) for p in part]
    return ybar, d[0], d[1]


@torch.no_grad()
def _replay2_bwd_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, chunk, w2, sc, kv):
    """B4s's plain version: ``_replay3_bwd_plain`` on the two-term split
    ``w2`` (``prepare_premixed_split2``), each step through
    ``step_vjp_split2(..., weights=True)``: (ybar, d wT, d iwT)."""
    B, P = ys_prev.shape[1], ys_prev.shape[2] // 3
    ybar = torch.zeros_like(ys_prev[0])
    d = [ybar.new_zeros((P, P)), ybar.new_zeros((kv.shape[2], P))]
    part = [torch.zeros_like(x) for x in d]
    for k in range(n_real - 1, -1, -1):
        t0, h = _lane_times(t0s, hs, k, B)
        ybar, g_w, g_iw = step_vjp_split2(t0, h, ys_prev[k], i10[k, :, None], ybar + ysbar[k],
                                          w2, sc, kv, weights=True)
        if stride and k % stride == 0:
            ybar = torch.zeros_like(ybar)
        part = [part[0] + g_w, part[1] + g_iw]
        if k % chunk == 0:
            d = [d[0] + part[0], d[1] + part[1]]
            part = [torch.zeros_like(p) for p in part]
    return ybar, d[0], d[1]


@torch.no_grad()
def _replay3_bwd_emit_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, pw, sc, kv):
    """B4t's plain version, over steps n_real-1..0: (ybar, seeds), seeds[k]
    = ybar + ysbar[k], the total cotangent on step k's output; the state
    output of ``step_vjp_split3`` carries the sweep (its weight cotangents
    are dropped), zeroed after every step k with k % stride == 0. Rows past
    n_real are zero."""
    w3 = prepare_premixed_split(pw, sc.fc)[0]
    B = ys_prev.shape[1]
    ybar = torch.zeros_like(ys_prev[0])
    seeds = torch.zeros_like(ys_prev)
    for k in range(n_real - 1, -1, -1):
        t0, h = _lane_times(t0s, hs, k, B)
        c = ybar + ysbar[k]
        seeds[k] = c
        ybar = step_vjp_split3(t0, h, ys_prev[k], i10[k, :, None], c, w3, sc, kv)[0]
        if stride and k % stride == 0:
            ybar = torch.zeros_like(ybar)
    return ybar, seeds


def lane_noise(words, t_start, t_end, depth, brownian: str = "kernel"):
    """(tree, i10_draw) of lanes with key words (B, 4) (k0, k1, j0, j1):
    the krng tree and interval normals (``brownian="kernel"``) or the
    ``jax.random`` ones (``"jax"``) on [t_start, t_end]. ``tree.evaluate``
    and ``i10_draw`` take (B, k) times."""
    if brownian == "jax":
        t0, t1 = (torch.tensor(t, dtype=_F32, device=words.device) for t in (t_start, t_end))
        tree = brownian_paths.VirtualBrownianTree(t0, t1, words[:, None, 0:2], depth=depth)
        key = words[:, None, 2:4]
        return tree, lambda ta, tb: brownian_paths.interval_normal(key, ta, tb)
    if brownian != "kernel":
        raise ValueError(f"unknown brownian backend: {brownian!r}")
    tree = KernelBrownianTree(t_start, t_end, words[:, 0:1], words[:, 1:2], depth=depth)
    return tree, lambda ta, tb: interval_normal(words[:, 2:3], words[:, 3:4], ta, tb, t_start,
                                                t_end)


def _tree(words, cfg: SelectConfig):
    """The lanes' Brownian trees of ``cfg``'s backend."""
    return lane_noise(words, cfg.t_start, cfg.t_end, cfg.depth, cfg.brownian)[0]


def select_weights_split3(pw, sc: SDEConsts) -> dict:
    """The selection weights of ``drift="split3"``: the bf16 terms of
    ``prepare_premixed_split`` as one contiguous (3, P, P) tensor ``w3``
    (hi, mid, lo; the kernel reads them through one pointer), the plain
    drift's ``wT_hi``/``wT_mid``/``wT_lo`` views of it, and iwT (float32)."""
    w3 = torch.stack(_split3_terms(pw, sc))
    return {"w3": w3, "wT_hi": w3[0], "wT_mid": w3[1], "wT_lo": w3[2],
            "iwT": pw["iwT"].contiguous()}


def _select_drift(w, sc, kv, cfg: SelectConfig):
    if cfg.drift == "select16":
        return lambda t, x: drift_select16(t, x, w, sc, kv)
    if cfg.drift in ("f32", "split3"):
        return lambda t, x: drift_premixed(t, x, w, sc, kv)
    raise ValueError(f"unknown selection drift {cfg.drift!r}")


class Attempt(NamedTuple):
    y_new: torch.Tensor  # (B, 3P) the two-half-step solution
    err: torch.Tensor  # (B, 1) scaled RMS error
    accept: torch.Tensor  # (B, 1) bool
    h: torch.Tensor  # (B, 1) the step used
    h_next: torch.Tensor  # (B, 1)
    t_new: torch.Tensor  # (B, 1)
    err_c: torch.Tensor  # (B, 1) max(err, 1e-10), the PI memory if accepted
    w1: torch.Tensor  # (B, 1) W(t + h)


def _constant_sigma(t, y):
    """The network's diffusion: sigma = 10 on every component."""
    return SIGMA


@torch.no_grad()
def attempt_plain(drift, diffusion, t1, y1, h, err_prev, w_t1, words,
                  cfg: SelectConfig) -> Attempt:
    """One controller attempt per lane (t1, h, err_prev, w_t1 (B, 1)) for
    ``drift(t, y)`` (t (B, 1), y (B, S)) and the additive diffusion
    ``diffusion(t, y)`` (its value at (t1, y1) serves every stage): step
    doubling with three SRA1 steps on the tree's Brownian data (the JAX
    package's ``_sra1_doubling``: the full step and the first half step
    share f1), the RMS error, the PI controller with exp(p log x) powers.
    The selection kernels of every drift repeat this order of operations."""
    h = torch.minimum(h, cfg.t_end - t1)
    h = (t1 + h) - t1  # the representable difference
    tm, te, hh = t1 + 0.5 * h, t1 + h, 0.5 * h
    tree, i10_draw = lane_noise(words, cfg.t_start, cfg.t_end, cfg.depth, cfg.brownian)
    w_mt = tree.evaluate(torch.cat([tm, te], dim=1))
    wm, w1 = w_mt[:, 0:1], w_mt[:, 1:2]
    za, zb = i10_draw(t1, tm), i10_draw(tm, te)
    dw_a, dw_b = wm - w_t1, w1 - wm
    sq = torch.sqrt(div(hh, 12.0))
    i10_a = hh * (0.5 * dw_a + sq * za)
    i10_b = hh * (0.5 * dw_b + sq * zb)
    i10_f = i10_a + i10_b + hh * dw_a
    g = diffusion(t1, y1)
    y_full = sra1_step(drift, t1, h, y1, dw_a + dw_b, i10_f, g)
    y_half = sra1_step(drift, t1, 0.5 * h, y1, dw_a, i10_a, g)
    y_half2 = sra1_step(drift, t1 + 0.5 * h, 0.5 * h, y_half, dw_b, i10_b, g)
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
def select_plain(drift, diffusion, y0, words, cfg: SelectConfig):
    """The selection loop of ``attempt_plain``, vectorised over lanes with
    per-lane masks: returns (step_times (B, M+1), naccept, nreject,
    success)."""
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
        a = attempt_plain(drift, diffusion, t1, y1, h, err_prev, w_t1, words, cfg)
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


def _attempt_plain(t1, y1, h, err_prev, w_t1, words, w, sc, kv, cfg: SelectConfig):
    """``attempt_plain`` of the network drift: ``w`` the selection weights
    in ``cfg.drift``'s format."""
    return attempt_plain(_select_drift(w, sc, kv, cfg), _constant_sigma, t1, y1, h, err_prev,
                         w_t1, words, cfg)


def _select_plain(y0, words, w, sc, kv, cfg: SelectConfig):
    """``select_plain`` of the network drift (the selection kernel's plain
    version)."""
    return select_plain(_select_drift(w, sc, kv, cfg), _constant_sigma, y0, words, cfg)


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


def _select_named(w, kv, P, cfg: SelectConfig):
    """The selection weights' contract for ``cfg.drift``, and their two
    tensors (the recurrent and the input matrix)."""
    if cfg.brownian not in TREES:
        raise ValueError(f"unknown brownian backend {cfg.brownian!r}")
    if cfg.drift not in SELECT_DRIFTS:
        raise ValueError(f"unknown selection drift {cfg.drift!r}")
    if cfg.drift == "split3":
        if cfg.brownian != "kernel":
            raise ValueError("the three-term selection drift is the in-kernel pass's: it draws "
                             "from the 'kernel' (krng) tree")
        named = {"w3": (w["w3"], _BF16, (3, P, P)), "iwT": (w["iwT"], _F32, (kv.shape[2], P))}
        return named, (w["w3"], w["iwT"])
    keys, dtype = (("wT16", "iwT16"), _BF16) if cfg.drift == "select16" else (("wT", "iwT"), _F32)
    named = {keys[0]: (w[keys[0]], dtype, (P, P)), keys[1]: (w[keys[1]], dtype, (kv.shape[2], P))}
    return named, (w[keys[0]], w[keys[1]])


# ---------------------------------------------------------------------------
# The selection's cluster teams (csrc/sde_select_team.cu)
# ---------------------------------------------------------------------------

SELECT_ROUTES = ("resident", "streamed", "block")


class SelectTeamPlan(NamedTuple):
    """The shape of a selection team at P populations (csrc/
    sde_select_team.cu ``plan_sel``, which ``cf_sde_select_plan``
    reports)."""

    C: int        # blocks per lane: the cluster size
    nc: int       # populations each block owns
    mode: int     # the drift's code (SELECT_DRIFTS): select16 (bf16, two a word), f32 (one
                  # a word), split3 (the three bf16 terms, each two a word)
    np: int       # column pairs of a block, (nc + 1) // 2
    wpt: int      # 32-bit words of a pair in a packed row (1, 2 or 3)
    xw: int       # exchanged float64 values of a row (the split's 3 terms, else 1)
    L: int        # lanes per pair: thread (pair, l) sums the rows k = l mod L
    rw: int       # words of a packed row: np wpt, padded to v times an odd number,
                  # v = (32 / L) wpt (the consecutive words a warp reads in a row)
    stream: bool  # the slice streams through a ring of tiles (else it stays resident)
    R: int        # rows per tile (resident: P)
    T: int        # tiles per product pass
    S: int        # stages of the ring (resident: 1)
    fits: bool    # False: no shape of this design fits a block
    fixed: int    # shared-memory bytes before the weights
    bytes: int    # shared-memory bytes of a block


def _sel_fixed(P, nc, C, n_in, xw):
    return (_align16(8 * 2 * xw * P) + _align16(4 * nc) + _align16(4 * 2 * n_in)
            + _align16(4 * _MAX_KNOTS * n_in) + _align16(4 * (n_in + 2) * nc)
            + _align16(4 * (8 + 2 * (_MAX_DEPTH + 1))) + _align16(8 * (_THREADS // 32 + 2 * C))
            + _align16(8 * (1 + 2 * _T2_MAX_STAGES)))


def sde_select_plan(P: int, n_in: int, drift: str, C: int = 16,
                    stream: bool = False) -> SelectTeamPlan:
    """The team shape of the selection on ``drift`` ("select16": bf16
    weights, two a word; "f32": float32, one a word; "split3": the three
    bf16 terms of ``select_weights_split3``, a word of each per column pair)
    at P populations and n_in inputs with clusters of C (8 or 16) blocks
    per lane: block r owns populations [r nc, (r + 1) nc) and keeps the
    columns [r nc, (r + 1) nc) of the weights as a (P, rw) slice of words,
    resident where it and the fixed part (two exchange slots of P float64,
    three for the split's terms, the lane's stimulus and knots, the own
    columns' iw, bg and adaptation, the trees' normals, the sums and the
    mbarriers) fit the 232,448 bytes a block can use, else (or with
    ``stream``) streamed in tiles of R rows through S stages. At 104
    columns and C = 16 select16 and float32 are resident (86.5 and 173
    KB), the split streams (260 KB); at 312 all stream."""
    if P <= 0 or P % 8:
        raise ValueError(f"P must be a positive multiple of 8, got {P}")
    if not 0 <= n_in <= _MAX_INPUTS:
        raise ValueError(f"n_in must lie in [0, {_MAX_INPUTS}], got {n_in}")
    if drift not in SELECT_DRIFTS:
        raise ValueError(f"no selection team takes the drift {drift!r}")
    if C not in (8, 16) or P % C:
        raise ValueError(f"a team of C={C} blocks does not take P={P}")
    nc = P // C
    np_ = -(-nc // 2)
    wpt = {"select16": 1, "f32": 2, "split3": 3}[drift]
    xw = 3 if drift == "split3" else 1
    L = 32
    while L > 1 and np_ * L > _THREADS:
        L //= 2
    v = (32 // L) * wpt
    rw = -(-np_ * wpt // v) * v
    if (rw // v) % 2 == 0:
        rw += v
    fits = nc <= _THREADS
    head = (C, nc, SELECT_DRIFTS[drift], np_, wpt, xw, L, rw)
    fixed = _sel_fixed(P, nc, C, n_in, xw)
    row = 4 * rw
    if not stream and fixed + row * P <= SMEM_BLOCK_BYTES:
        return SelectTeamPlan(*head, False, P, 1, 1, fits, fixed, fixed + row * P)
    room = max(SMEM_BLOCK_BYTES - fixed, 0)
    R = max(16 * L, _T2_MIN_TILE_ROWS)
    while R >= max(L, 8):
        T = -(-P // R)
        S = min(_T2_MAX_STAGES, room // (row * R), T)
        if S >= min(T, 2):
            return SelectTeamPlan(*head, True, R, T, S, fits, fixed, fixed + row * R * S)
        R //= 2
    return SelectTeamPlan(*head, True, P, 1, 0, False, fixed, fixed)


def sde_select_cluster(P: int, B: int, max_clusters) -> int:
    """The cluster size of B lanes' selection teams: 16 where 16 divides P
    and the card holds B clusters of 16 at once (``max_clusters(16)``, the
    kernel's ``cudaOccupancyMaxActiveClusters``), else 8, so that no lane
    waits for another's whole selection (at 104 columns 7 clusters of 16
    fit the H100: bench.py's batch 8 takes clusters of 8)."""
    return 16 if P % 16 == 0 and max_clusters(16) >= B else 8


def sde_select_route(P: int, n_in: int, B: int, drift: str, max_clusters) -> tuple:
    """How the selection runs on the card, by shape alone, before the launch:
    (route, C). "resident" or "streamed" (the cluster teams, as
    ``sde_select_plan`` holds the weights, with ``sde_select_cluster``'s C)
    where the plan fits, else "block" (the one-block kernel), C 0. From 13
    columns the team is the faster (~10x at 104); at 3 columns, a width no
    command line runs, the one-block kernel is 2-3 us an attempt faster
    (PERF.md). ``max_clusters(C)``: how many clusters of C the card holds at
    once."""
    C = sde_select_cluster(P, B, max_clusters)
    plan = sde_select_plan(P, n_in, drift, C)
    if not plan.fits:
        return "block", 0
    return ("streamed" if plan.stream else "resident"), C


def sde_select_pack(w0, P: int, plan: SelectTeamPlan) -> torch.Tensor:
    """The selection weights (select16's bf16 ``wT16`` (P, P), the float32
    ``wT``, or the split's bf16 terms ``w3`` (3, P, P)) packed per block,
    (C, P, rw) int32 words: row k of block r holds W[k, r nc:(r+1) nc] (two
    bf16 a word, the even column in the low half; or one float32 a word;
    the split: for each column pair the word of W_hi, of W_mid, of W_lo),
    then zero pad."""
    C, nc, np_ = plan.C, plan.nc, plan.np
    per = 1 if plan.mode == SELECT_DRIFTS["f32"] else 2
    pk = torch.zeros((C, P, per * plan.rw), dtype=w0.dtype, device=w0.device)
    if plan.mode != SELECT_DRIFTS["split3"]:
        pk[:, :, :nc] = w0.view(P, C, nc).transpose(0, 1)
        return pk.view(torch.int32)
    terms = torch.zeros((3, P, C, 2 * np_), dtype=w0.dtype, device=w0.device)
    terms[..., :nc] = w0.view(3, P, C, nc)
    # (3, P, C, np, 2) -> (C, P, np, 3, 2): a pair's three words side by side
    pk[:, :, :6 * np_] = terms.view(3, P, C, np_, 2).permute(2, 1, 3, 0, 4).reshape(C, P, -1)
    return pk.view(torch.int32)


@functools.lru_cache(maxsize=None)
def sde_select_max_clusters(P: int, n_in: int, tree: str, drift: str, C: int,
                            stream: bool) -> int:
    """cudaOccupancyMaxActiveClusters of the selection team kernel on the
    card: how many lanes' teams of C blocks run at once."""
    out = ctypes.c_int()
    _check(_lib().cf_sde_select_max_clusters(P, n_in, TREES[tree], SELECT_DRIFTS[drift], C,
                                             int(stream), ctypes.byref(out)),
           "sde_select_max_clusters")
    return out.value


def _check_select_route(route):
    if route is not None and route not in SELECT_ROUTES:
        raise ValueError(f"route must be one of {SELECT_ROUTES}, got {route!r}")


def _select_team(route, P, n_in, B, cfg: SelectConfig):
    """(route, plan) of a selection launch on the card: ``route`` or the
    shape's default; the plan None for "block". Raises where the team asked
    for does not take the shape."""
    def clusters(C):
        stream = sde_select_plan(P, n_in, cfg.drift, C).stream
        return sde_select_max_clusters(P, n_in, cfg.brownian, cfg.drift, C, stream)

    if route is None:
        route, C = sde_select_route(P, n_in, B, cfg.drift, clusters)
    elif route != "block":
        C = sde_select_cluster(P, B, clusters)
    if route == "block":
        return route, None
    plan = sde_select_plan(P, n_in, cfg.drift, C, stream=route == "streamed")
    if not plan.fits or (route == "resident" and plan.stream):
        raise ValueError(f"no {route} team takes P={P} with the {cfg.drift} drift")
    if clusters(C) < 1:
        raise RuntimeError(f"no cluster of {C} blocks with {plan.bytes} bytes of shared memory "
                           "each fits the card")
    return route, plan


def select_pass(y0, words, w, sc: SDEConsts, kv, cfg: SelectConfig, route=None):
    """The step-size selection of every lane: y0 (B, 3P), words (B, 4)
    (k0, k1, j0, j1 as int64: the tree's key and the space-time integrals'
    key of ``cfg.brownian``), ``w`` the selection weights (``premix_select16``
    for ``cfg.drift`` "select16", the float32 {"wT", "iwT"} for "f32",
    ``select_weights_split3`` for "split3"), kv
    (K, B, n_in). Returns (step_times (B, M+1), naccept, nreject (B,)
    int32, success (B,) bool). On the card a cluster team per lane
    (csrc/sde_select_team.cu); ``route`` (default ``sde_select_route``):
    "resident", "streamed", or "block", the one-block kernel (a
    yardstick)."""
    _check_select_route(route)
    B, S = y0.shape
    P = S // 3
    w_named, (w0, iw) = _select_named(w, kv, P, cfg)
    named = {"y0": (y0, _F32, (B, S)), "words": (words, _I64, (B, 4)), **w_named,
             **_drift_named(sc, kv, B, P)}
    if not _on_cuda(y0, named):
        return _select_plain(y0, words, w, sc, kv, cfg)
    route, plan = _select_team(route, P, kv.shape[2], B, cfg)
    st = torch.empty((B, cfg.max_steps + 1), dtype=_F32, device=y0.device)
    stats = torch.empty((B, 3), dtype=torch.int32, device=y0.device)
    keep, hc_p, hs_p = _select_host(sc, cfg)
    w32 = _words32(words)
    head = (B, P, kv.shape[2], kv.shape[0], hc_p, hs_p, cfg.max_steps, cfg.depth,
            TREES[cfg.brownian], SELECT_DRIFTS[cfg.drift])
    tail = (kv.data_ptr(), w32.data_ptr(), y0.data_ptr(), st.data_ptr(), stats.data_ptr(),
            _stream(y0))
    consts = (sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr())
    if route == "block":
        _check(_lib().cf_sde_select(*head, *consts, w0.data_ptr(), iw.data_ptr(), *tail),
               "sde_select_block")
        LAUNCHES["sde_select_block"] += 1
    else:
        wpk = sde_select_pack(w0, P, plan)
        _check(_lib().cf_sde_select_team(*head, plan.C, int(plan.stream), *consts,
                                         wpk.data_ptr(), iw.data_ptr(), *tail), "sde_select")
        LAUNCHES["sde_select"] += 1
    return st, stats[:, 0], stats[:, 1], stats[:, 2] > 0


def select_attempt(t1, y1, h, err_prev, w_t1, words, w, sc: SDEConsts, kv,
                   cfg: SelectConfig, route=None) -> Attempt:
    """One controller attempt for each of N records (t1, h, err_prev, w_t1
    (N, 1); y1 (N, 3P)): the body of the selection kernel, on ``route`` as
    ``select_pass``'s (a team per record)."""
    _check_select_route(route)
    N, S = y1.shape
    P = S // 3
    w_named, (w0, iw) = _select_named(w, kv, P, cfg)
    named = {"y1": (y1, _F32, (N, S)), "t1": (t1, _F32, (N, 1)), "h": (h, _F32, (N, 1)),
             "err_prev": (err_prev, _F32, (N, 1)), "w_t1": (w_t1, _F32, (N, 1)),
             "words": (words, _I64, (N, 4)), **w_named, **_drift_named(sc, kv, N, P)}
    if not _on_cuda(y1, named):
        return _attempt_plain(t1, y1, h, err_prev, w_t1, words, w, sc, kv, cfg)
    route, plan = _select_team(route, P, kv.shape[2], N, cfg)
    y_new = torch.empty_like(y1)
    rec = torch.empty((N, 6), dtype=_F32, device=y1.device)
    keep, hc_p, hs_p = _select_host(sc, cfg)
    w32 = _words32(words)
    head = (N, P, kv.shape[2], kv.shape[0], hc_p, hs_p, cfg.depth, TREES[cfg.brownian],
            SELECT_DRIFTS[cfg.drift])
    consts = (sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr())
    tail = (kv.data_ptr(), w32.data_ptr(), t1.data_ptr(), y1.data_ptr(), h.data_ptr(),
            err_prev.data_ptr(), w_t1.data_ptr(), y_new.data_ptr(), rec.data_ptr(), _stream(y1))
    if route == "block":
        _check(_lib().cf_sde_attempt(*head, *consts, w0.data_ptr(), iw.data_ptr(), *tail),
               "sde_attempt_block")
        LAUNCHES["sde_attempt_block"] += 1
    else:
        wpk = sde_select_pack(w0, P, plan)
        _check(_lib().cf_sde_attempt_team(*head, plan.C, int(plan.stream), *consts,
                                          wpk.data_ptr(), iw.data_ptr(), *tail), "sde_attempt")
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


# The cluster teams of B3 and B4 (csrc/replay2_team.cuh kT2MaxStages,
# kT2MinTileRows).
_T2_MAX_STAGES, _T2_MIN_TILE_ROWS = 8, 32
SPLIT2_ROUTES = ("resident", "streamed", "team8")


class Replay2Plan(NamedTuple):
    """The shape of B3's and B4's teams at P populations (csrc/
    replay2_team.cuh ``plan2``, which ``cf_sde2_plan`` reports)."""

    C: int        # blocks per lane: the cluster size
    nc: int       # populations each block owns
    nw: int       # 32-bit words of one term's row of a block's slice (nc bf16, padded to even)
    rw: int       # words of a packed row: hi (nw), mid (nw), one pad word
    L: int        # forward products: lanes per column pair
    Lv: int       # VJP products: lanes per row
    stream: bool  # the slice streams through a ring of tiles (else it stays resident)
    R: int        # rows per tile (resident: P)
    T: int        # tiles per product pass
    S: int        # stages of the ring (resident: 1)
    fixed: int    # shared-memory bytes before the weights
    bytes: int    # shared-memory bytes of a block


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def sde2_replay_plan(P: int, n_in: int, stream: bool = False) -> Replay2Plan:
    """The team shape of B3 and B4 at P populations and n_in inputs: a
    cluster of 16 blocks per lane where 16 divides P, else 8; block r owns
    populations [r nc, (r + 1) nc) and keeps the columns [r nc, (r + 1) nc)
    of both split2 terms in shared memory as (P, rw) packed words, beside
    two exchange slots of P float64 pairs, the own columns' sums, the VJP's
    own cotangents, the stimulus and the mbarriers (``fixed``). The slice
    stays resident where all of it fits the 232,448 bytes a block can use
    (every width through 79 columns, even ones through 110: 206,224 bytes
    at 104), else (or with ``stream``) it streams in tiles of R rows
    through S stages (at 312 columns three stages of 64 rows)."""
    if P <= 0 or P % 8:
        raise ValueError(f"P must be a positive multiple of 8, got {P}")
    if not 0 <= n_in <= _MAX_INPUTS:
        raise ValueError(f"n_in must lie in [0, {_MAX_INPUTS}], got {n_in}")
    C = 16 if P % 16 == 0 else 8
    nc = P // C
    nw = (nc + 1) // 2
    rw = 2 * nw + 1
    L = 32
    while L > 1 and nw * L > _THREADS:
        L //= 2
    Lv = 1
    while Lv < 32 and 16 * Lv < nw:
        Lv *= 2
    while Lv < 32 and Lv < nw and P * Lv < _THREADS:
        Lv *= 2
    fixed = (_align16(2 * 2 * 8 * P) + _align16(3 * 8 * nc) + _align16(2 * 8 * nw)
             + _align16(2 * 4 * n_in) + _align16(4 * _MAX_KNOTS * n_in)
             + _align16(4 * (n_in + 2) * nc) + _align16(8 * (1 + 2 * _T2_MAX_STAGES)))
    row = 4 * rw
    if not stream and fixed + row * P <= SMEM_BLOCK_BYTES:
        return Replay2Plan(C, nc, nw, rw, L, Lv, False, P, 1, 1, fixed, fixed + row * P)
    R = max(_T2_MIN_TILE_ROWS, L, _THREADS // Lv)
    T = -(-P // R)
    S = min(_T2_MAX_STAGES, max(SMEM_BLOCK_BYTES - fixed, 0) // (row * R), T)
    return Replay2Plan(C, nc, nw, rw, L, Lv, True, R, T, S, fixed, fixed + row * R * S)


def sde2_replay_route(P: int, n_in: int) -> str:
    """How B3 and B4 hold the weights on the card, by shape alone:
    "resident" (each block's packed slice stays in shared memory, copied
    once by TMA) where ``sde2_replay_plan`` fits it, else "streamed"
    (tiles through a ring of stages): "resident" at 13, 32, 63 and 104
    columns, "streamed" at 312."""
    return "streamed" if sde2_replay_plan(P, n_in).stream else "resident"


def sde2_pack(w2, P: int, plan: Replay2Plan) -> torch.Tensor:
    """The two split2 terms of wT packed per block, (C, P, rw) int32 words:
    row k of block r holds W_hi[k, r nc:(r+1) nc] then W_mid[k, ...], each
    padded to 2 nw bf16, then one zero pad word."""
    C, nc, nw = plan.C, plan.nc, plan.nw
    hi, mid = w2["wT_hi"], w2["wT_mid"]
    pk = torch.zeros((C, P, 2 * plan.rw), dtype=_BF16, device=hi.device)
    pk[:, :, :nc] = hi.view(P, C, nc).transpose(0, 1)
    pk[:, :, 2 * nw:2 * nw + nc] = mid.view(P, C, nc).transpose(0, 1)
    return pk.view(torch.int32)


@functools.lru_cache(maxsize=None)
def sde2_max_clusters(P: int, n_in: int, stream: bool, bwd: bool) -> int:
    """cudaOccupancyMaxActiveClusters of B3 (``bwd`` False) or B4 on the
    card: how many lanes' teams run at once."""
    out = ctypes.c_int()
    _check(_lib().cf_sde2_max_clusters(P, n_in, int(stream), int(bwd), ctypes.byref(out)),
           "sde2_max_clusters")
    return out.value


def _team2(route, P, n_in, bwd: bool):
    """(stream flag, plan) of a cluster-team launch on ``route``; raises
    where no team of the plan fits the card."""
    stream = route == "streamed" or sde2_replay_plan(P, n_in).stream
    plan = sde2_replay_plan(P, n_in, stream)
    if sde2_max_clusters(P, n_in, stream, bwd) < 1:
        raise RuntimeError(f"no cluster of {plan.C} blocks with {plan.bytes} bytes of shared "
                           "memory each fits the card")
    return stream, plan


def _check_route(route):
    if route is not None and route not in SPLIT2_ROUTES:
        raise ValueError(f"route must be one of {SPLIT2_ROUTES}, got {route!r}")


def replay_fwd(y0, t0s, hs, i1, i10, n_real: int, w2, sc: SDEConsts, kv, route=None):
    """SRA1 over each lane's frozen grid: y0 (B, 3P); t0s, hs, i1, i10
    (n, B); the first ``n_real`` steps are integrated, the rest are h == 0
    padding. w2 from ``prepare_premixed_split2``. Returns ys (n + 1, B, 3P).
    On the card B3, a cluster team per lane; ``route`` (default
    ``sde2_replay_route``): "resident", "streamed", or "team8", B3t-team's
    body on the two-term split (a yardstick, on no path)."""
    B, S = y0.shape
    P, n = S // 3, t0s.shape[0]
    _check_route(route)
    named = {"y0": (y0, _F32, (B, S)), "i1": (i1, _F32, (n, B)),
             **_replay_named(t0s, hs, i10, w2, sc, kv, B, P, n_real)}
    if not _on_cuda(y0, named):
        return _replay_fwd_plain(y0, t0s, hs, i1, i10, n_real, w2, sc, kv)
    route = route or sde2_replay_route(P, kv.shape[2])
    ys = torch.empty((n + 1, B, S), dtype=_F32, device=y0.device)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    grid = (kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i1.data_ptr(), i10.data_ptr(),
            y0.data_ptr())
    if route == "team8":
        scr = torch.empty((B, 4, S), dtype=_F32, device=y0.device)
        _check(_lib().cf_sde2_fwd_team8(
            B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), sc.fc["bg"].data_ptr(),
            sc.fc["adapt"].data_ptr(), w2["wT_hi"].data_ptr(), w2["wT_mid"].data_ptr(),
            w2["iwT"].data_ptr(), *grid, scr.data_ptr(), ys.data_ptr(), _stream(y0)),
            "sde2_fwd_team8")
        LAUNCHES["sde2_fwd_team8"] += 1
        return ys
    stream, plan = _team2(route, P, kv.shape[2], False)
    wpk = sde2_pack(w2, P, plan)
    _check(_lib().cf_sde_replay_fwd(
        B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), int(stream),
        sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), wpk.data_ptr(),
        w2["iwT"].data_ptr(), *grid, ys.data_ptr(), _stream(y0)), "sde_replay_fwd")
    LAUNCHES["sde_replay_fwd"] += 1
    return ys


def replay_bwd(ys_prev, ysbar, t0s, hs, i10, n_real: int, stride, w2, sc: SDEConsts, kv,
               route=None):
    """The reverse sweep of the state cotangent: ys_prev (n, B, 3P) the
    states before each step, ysbar (n, B, 3P) the direct cotangents on each
    step's output. Returns (ybar (B, 3P), seeds (n, B, 3P)). On the card B4,
    the teams and ``route`` of ``replay_fwd``."""
    n, B, S = ys_prev.shape
    P = S // 3
    _check_route(route)
    named = {"ys_prev": (ys_prev, _F32, (n, B, S)), "ysbar": (ysbar, _F32, (n, B, S)),
             **_replay_named(t0s, hs, i10, w2, sc, kv, B, P, n_real)}
    if not _on_cuda(ys_prev, named):
        return _replay_bwd_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, w2, sc, kv)
    route = route or sde2_replay_route(P, kv.shape[2])
    ybar = torch.empty((B, S), dtype=_F32, device=ys_prev.device)
    seeds = torch.empty_like(ys_prev)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    grid = (kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i10.data_ptr(), ys_prev.data_ptr(),
            ysbar.data_ptr())
    if route == "team8":
        hiT, midT = w2["wT_hi"].T.contiguous(), w2["wT_mid"].T.contiguous()
        scr = torch.empty((B, 7, S), dtype=_F32, device=ys_prev.device)
        _check(_lib().cf_sde2_bwd_team8(
            B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), int(stride or 0),
            sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), w2["wT_hi"].data_ptr(),
            w2["wT_mid"].data_ptr(), hiT.data_ptr(), midT.data_ptr(), w2["iwT"].data_ptr(),
            *grid, scr.data_ptr(), ybar.data_ptr(), seeds.data_ptr(), _stream(ys_prev)),
            "sde2_bwd_team8")
        LAUNCHES["sde2_bwd_team8"] += 1
        return ybar, seeds
    stream, plan = _team2(route, P, kv.shape[2], True)
    wpk = sde2_pack(w2, P, plan)
    _check(_lib().cf_sde_replay_bwd(
        B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), int(stride or 0), int(stream),
        sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), wpk.data_ptr(),
        w2["iwT"].data_ptr(), *grid, ybar.data_ptr(), seeds.data_ptr(), _stream(ys_prev)),
        "sde_replay_bwd")
    LAUNCHES["sde_replay_bwd"] += 1
    return ybar, seeds


def _replay3_named(t0s, hs, i10, pw, sc, kv, B, P, n_real):
    n = t0s.shape[0]
    if not 0 <= n_real <= n:
        raise ValueError(f"n_real must lie in [0, {n}], got {n_real}")
    grid = (n, B) if t0s.dim() == 2 else (n,)
    return {"t0s": (t0s, _F32, grid), "hs": (hs, _F32, grid), "i10": (i10, _F32, (n, B)),
            "wT": (pw["wT"], _F32, (P, P)), "iwT": (pw["iwT"], _F32, (kv.shape[2], P)),
            **_drift_named(sc, kv, B, P)}


def sde3_fwd_route(P: int, n_in: int) -> str:
    """Which kernel computes ``replay3_fwd`` on the card, by shape alone:
    "block" (B3t, ``cf_sde3_fwd``) where one lane's three-term weights
    (6 P^2 bytes), iwT and four state vectors fit the 232,448 bytes of
    shared memory a block can use (``setup_floats`` of
    csrc/split3_drift.cuh plus 4 (3P) floats), else "team" (B3t-team,
    ``cf_sde3_fwd_team``: a team of 8 blocks per lane, the weights streamed
    from L2). With 4 inputs that is "block" through 23 columns (P = 184)
    and "team" from 24; 13 columns take "block", 64 through 312 "team"."""
    floats = ((3 * P * P + 1) // 2 + n_in * P + 5 * P + _MAX_INPUTS + 1 + 2 * (_THREADS // 32)
              + 4 * 3 * P)
    return "block" if 4 * floats <= SMEM_BLOCK_BYTES else "team"


def _split3_terms(pw, sc: SDEConsts):
    """The bf16 (P, P) terms hi, mid, lo of ``prepare_premixed_split``
    (the split the one-block kernels take in shared memory), contiguous."""
    w3 = prepare_premixed_split(pw, sc.fc)[0]
    return tuple(w3[k].contiguous() for k in ("wT_hi", "wT_mid", "wT_lo"))


def replay3_fwd(y0, t0s, hs, i1, i10, n_real: int, pw, sc: SDEConsts, kv):
    """SRA1 on the three-term split of pw = {"wT", "iwT"} (float32): y0
    (B, 3P); t0s, hs (n, B) each lane's step times and sizes, or (n,) the
    uniform grid's for every lane; i1, i10 (n, B). The first ``n_real``
    steps are integrated, the rest are h == 0 padding. Returns ys
    (n + 1, B, 3P). On the card B3t or B3t-team, as ``sde3_fwd_route``
    decides by shape before the launch."""
    B, S = y0.shape
    P, n = S // 3, t0s.shape[0]
    named = {"y0": (y0, _F32, (B, S)), "i1": (i1, _F32, (n, B)),
             **_replay3_named(t0s, hs, i10, pw, sc, kv, B, P, n_real)}
    if not _on_cuda(y0, named):
        return _replay3_fwd_plain(y0, t0s, hs, i1, i10, n_real, pw, sc, kv)
    ys = torch.empty((n + 1, B, S), dtype=_F32, device=y0.device)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    lanes = int(t0s.dim() == 2)
    if sde3_fwd_route(P, kv.shape[2]) == "block":
        _check(_lib().cf_sde3_fwd(
            B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), lanes,
            sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), pw["wT"].data_ptr(),
            pw["iwT"].data_ptr(), kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i1.data_ptr(),
            i10.data_ptr(), y0.data_ptr(), ys.data_ptr(), _stream(y0)), "sde3_fwd")
        LAUNCHES["sde3_fwd"] += 1
        return ys
    hi, mid, lo = _split3_terms(pw, sc)
    scr = torch.empty((B, 4, S), dtype=_F32, device=y0.device)
    _check(_lib().cf_sde3_fwd_team(
        B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), lanes, sc.fc["bg"].data_ptr(),
        sc.fc["adapt"].data_ptr(), hi.data_ptr(), mid.data_ptr(), lo.data_ptr(),
        pw["iwT"].data_ptr(), kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i1.data_ptr(),
        i10.data_ptr(), y0.data_ptr(), scr.data_ptr(), ys.data_ptr(), _stream(y0)),
        "sde3_fwd_team")
    LAUNCHES["sde3_fwd_team"] += 1
    return ys


def replay3_bwd_emit(ys_prev, ysbar, t0s, hs, i10, n_real: int, stride: int, pw,
                     sc: SDEConsts, kv):
    """The emit-mode reverse sweep of ``replay3_fwd`` (B4t): the state
    cotangent alone. ys_prev (n, B, 3P) the states before each step, ysbar
    (n, B, 3P) the direct cotangents on each step's output; t0s, hs (n, B)
    or (n,) as ``replay3_fwd``. Returns (ybar (B, 3P) before step 0, seeds
    (n, B, 3P)): seeds[k] is the total cotangent on step k's output, from
    which the weight gradients are taken outside (``solvers.fused.
    outer_arg_grads_split3``); rows past n_real are zero. ``stride``:
    truncation (0: none). One team of 8 blocks per lane, at any width."""
    n, B, S = ys_prev.shape
    P = S // 3
    named = {"ys_prev": (ys_prev, _F32, (n, B, S)), "ysbar": (ysbar, _F32, (n, B, S)),
             **_replay3_named(t0s, hs, i10, pw, sc, kv, B, P, n_real)}
    if not _on_cuda(ys_prev, named):
        return _replay3_bwd_emit_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, pw, sc, kv)
    dev = ys_prev.device
    ybar = torch.empty((B, S), dtype=_F32, device=dev)
    seeds = torch.empty_like(ys_prev)
    scr = torch.empty((B, 7, S), dtype=_F32, device=dev)
    terms = _split3_terms(pw, sc)
    hiT, midT, loT = (t.T.contiguous() for t in terms)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    _check(_lib().cf_sde3_bwd_emit(
        B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), int(t0s.dim() == 2),
        int(stride or 0), sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(),
        *(t.data_ptr() for t in terms), hiT.data_ptr(), midT.data_ptr(), loT.data_ptr(),
        pw["iwT"].data_ptr(), kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i10.data_ptr(),
        ys_prev.data_ptr(), ysbar.data_ptr(), scr.data_ptr(), ybar.data_ptr(),
        seeds.data_ptr(), _stream(ys_prev)), "sde3_bwd_emit")
    LAUNCHES["sde3_bwd_emit"] += 1
    return ybar, seeds


def sde3_bwd_route(P: int, n_in: int, B: int, terms: int = 3) -> str:
    """Which kernel computes the kernel-mode sweep on the card, by shape
    alone. On the two-term split (``terms`` 2, ``replay2_bwd``) always
    "team" (B4s): there is no one-block two-term sweep. On the three-term
    split (``replay3_bwd``):
    "block" (B4't, ``cf_sde3_bwd``) where the three-term weights (6 P^2
    bytes), iwT, the drift's scratch for B lanes (``setup_floats`` of
    csrc/split3_drift.cuh), the sweep's eight (B, 3P) buffers, four lane
    scalars and two (n_in, P) accumulators fit the 232,448 bytes of shared
    memory a block can use, else "team" (B4't-team, ``cf_sde3_bwd_team``:
    the batch on one team of 8 blocks, the weights streamed from L2). With
    4 inputs and 4 lanes that is "block" through 19 columns (P = 152) and
    "team" from 20; fewer lanes move the edge up, more move it down."""
    if terms not in (2, 3):
        raise ValueError(f"terms must be 2 or 3, got {terms}")
    if terms == 2:
        return "team"
    floats = ((3 * P * P + 1) // 2 + n_in * P + 5 * B * P + B * _MAX_INPUTS + 1
              + 2 * (_THREADS // 32) + 8 * B * 3 * P + 4 * B + 2 * n_in * P)
    return "block" if 4 * floats <= SMEM_BLOCK_BYTES else "team"


def replay3_bwd(ys_prev, ysbar, t0s, hs, i10, n_real: int, stride: int, chunk: int, pw,
                sc: SDEConsts, kv):
    """The kernel-mode reverse sweep of ``replay3_fwd``: ys_prev (n, B, 3P)
    the states before each step, ysbar (n, B, 3P) the direct cotangents on
    each step's output. Returns (ybar (B, 3P) before step 0, d wT, d iwT).
    ``stride``: truncation (0: none); ``chunk``: the steps whose weight
    cotangents the JAX kernel sums before adding them to the total. On the
    card B4't or B4't-team, as ``sde3_bwd_route`` decides by shape before
    the launch."""
    n, B, S = ys_prev.shape
    P = S // 3
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    named = {"ys_prev": (ys_prev, _F32, (n, B, S)), "ysbar": (ysbar, _F32, (n, B, S)),
             **_replay3_named(t0s, hs, i10, pw, sc, kv, B, P, n_real)}
    if not _on_cuda(ys_prev, named):
        return _replay3_bwd_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, chunk, pw, sc,
                                  kv)
    dev = ys_prev.device
    ybar = torch.empty((B, S), dtype=_F32, device=dev)
    d_wT = torch.empty((P, P), dtype=_F32, device=dev)
    d_iwT = torch.empty((kv.shape[2], P), dtype=_F32, device=dev)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    if sde3_bwd_route(P, kv.shape[2], B) == "team":
        terms = _split3_terms(pw, sc)
        hiT, midT, loT = (t.T.contiguous() for t in terms)
        scr = torch.empty((7, B, S), dtype=_F32, device=dev)
        work = torch.empty((P + kv.shape[2], P), dtype=_F32, device=dev)
        _check(_lib().cf_sde3_bwd_team(
            B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), int(t0s.dim() == 2),
            int(stride or 0), int(chunk), sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(),
            *(t.data_ptr() for t in terms), hiT.data_ptr(), midT.data_ptr(), loT.data_ptr(),
            pw["iwT"].data_ptr(), kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i10.data_ptr(),
            ys_prev.data_ptr(), ysbar.data_ptr(), scr.data_ptr(), ybar.data_ptr(),
            d_wT.data_ptr(), d_iwT.data_ptr(), work.data_ptr(), _stream(ys_prev)),
            "sde3_bwd_team")
        LAUNCHES["sde3_bwd_team"] += 1
        return ybar, d_wT, d_iwT
    work = torch.empty((4, P, P), dtype=_F32, device=dev)
    _check(_lib().cf_sde3_bwd(
        B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), int(t0s.dim() == 2),
        int(stride or 0), int(chunk), sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(),
        pw["wT"].data_ptr(), pw["iwT"].data_ptr(), kv.data_ptr(), t0s.data_ptr(),
        hs.data_ptr(), i10.data_ptr(), ys_prev.data_ptr(), ysbar.data_ptr(), ybar.data_ptr(),
        d_wT.data_ptr(), d_iwT.data_ptr(), work.data_ptr(), _stream(ys_prev)), "sde3_bwd")
    LAUNCHES["sde3_bwd"] += 1
    return ybar, d_wT, d_iwT


def replay2_bwd(ys_prev, ysbar, t0s, hs, i10, n_real: int, stride: int, chunk: int, w2,
                sc: SDEConsts, kv):
    """The kernel-mode reverse sweep of the split2 replay (``replay_fwd``):
    ys_prev (n, B, 3P) the states before each step, ysbar (n, B, 3P) the
    direct cotangents on each step's output, t0s, hs, i10 (n, B) each lane's
    step times, sizes and noise, ``w2`` the two-term split
    (``prepare_premixed_split2``). Returns (ybar (B, 3P) before step 0, d
    wT, d iwT); ``stride`` and ``chunk`` as ``replay3_bwd``. On the card B4s,
    one team of 8 blocks for the batch (``sde3_bwd_route`` with two
    terms)."""
    n, B, S = ys_prev.shape
    P = S // 3
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    named = {"ys_prev": (ys_prev, _F32, (n, B, S)), "ysbar": (ysbar, _F32, (n, B, S)),
             **_replay_named(t0s, hs, i10, w2, sc, kv, B, P, n_real)}
    if not _on_cuda(ys_prev, named):
        return _replay2_bwd_plain(ys_prev, ysbar, t0s, hs, i10, n_real, stride, chunk, w2, sc, kv)
    dev = ys_prev.device
    ybar = torch.empty((B, S), dtype=_F32, device=dev)
    d_wT = torch.empty((P, P), dtype=_F32, device=dev)
    d_iwT = torch.empty((kv.shape[2], P), dtype=_F32, device=dev)
    hiT, midT = w2["wT_hi"].T.contiguous(), w2["wT_mid"].T.contiguous()
    scr = torch.empty((7, B, S), dtype=_F32, device=dev)
    work = torch.empty((P + kv.shape[2], P), dtype=_F32, device=dev)
    hc, hc_p = _host_floats(_drift_host_consts(sc))
    _check(_lib().cf_sde2_bwd(
        B, P, kv.shape[2], kv.shape[0], hc_p, n, int(n_real), 1, int(stride or 0), int(chunk),
        sc.fc["bg"].data_ptr(), sc.fc["adapt"].data_ptr(), w2["wT_hi"].data_ptr(),
        w2["wT_mid"].data_ptr(), hiT.data_ptr(), midT.data_ptr(), w2["iwT"].data_ptr(),
        kv.data_ptr(), t0s.data_ptr(), hs.data_ptr(), i10.data_ptr(), ys_prev.data_ptr(),
        ysbar.data_ptr(), scr.data_ptr(), ybar.data_ptr(), d_wT.data_ptr(), d_iwT.data_ptr(),
        work.data_ptr(), _stream(ys_prev)), "sde2_bwd")
    LAUNCHES["sde2_bwd"] += 1
    return ybar, d_wT, d_iwT
