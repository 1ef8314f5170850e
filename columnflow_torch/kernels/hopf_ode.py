"""The Hopf MLP drift's dopri5 kernels: adaptive step-size selection, the
dense-output replay over the frozen grid, and its reverse sweep in kernel
mode and in emit mode (ports of the Pallas kernels of
``odeint_dopri5_fused`` in ``columnflow/solvers/fused.py``, traced there
with ``hopf_mlp_drift`` and ``interp_at_onehot``).

Each kernel is CUDA C++, the templates of ``csrc/hopf_mlp.cuh`` built by
``_build`` in ``csrc/hopf_ode.cu`` (the kernel-mode path at the reference
width) and ``csrc/hopf_outer.cu`` (the emit-mode sweep, and at width 512
every kernel of the path, entry points ``cf_hopf_wide_*``), with a plain
PyTorch version beside it that repeats its arithmetic:

    wrapper               kernel                   plain version                 replaces (columnflow/solvers/fused.py)
    hopf_select           cf_hopf_select           _hopf_select_plain            _make_adaptive_kernel (B6h)
    hopf_attempt          cf_hopf_attempt          _hopf_attempt_plain           one iteration of that kernel's body
    hopf_replay_fwd       cf_hopf_replay_fwd       _hopf_replay_fwd_plain        _make_replay_chunk_kernel (B7h)
    hopf_replay_bwd       cf_hopf_replay_bwd       _hopf_replay_bwd_plain        _make_bwd_chunk_kernel, kernel mode (B8h)
    hopf_replay_bwd_emit  cf_hopf_replay_bwd_emit  _hopf_replay_bwd_emit_plain   _make_bwd_chunk_kernel, emit mode (B8ho)

The plain versions are the network engine's (``kernels.network_ode``
``select_plain``, ``attempt_plain``, ``replay_fwd_plain``, ``rk_step_vjp``)
on ``models.hopf.hopf_mlp_drift`` with the one-hot blend lookup of mu
(``ops.interp.interp_at_onehot``) and the hand-written VJP
``hopf_mlp_drift_vjp``. One controller steers the whole (B, 2) batch state,
as in the JAX package. The kernel-mode sweep returns the eight parameter
tensors' cotangents: each drift VJP's contracted over the lanes, the seven
of a step added from stage 6 down, the steps' sums added to the
accumulators step by step, from the last step back. The emit-mode sweep
returns the state cotangent and the cotangent each step's output receives
from the later steps; ``solvers.fused.hopf_outer_arg_grads`` takes the
parameter gradients from them.

The kernels hold the MLP 3 -> H -> H -> H -> 2 at two hidden widths
(``KERNEL_WIDTHS``): the reference's 100 (``models.hopf.MLP_SIZES``) and 512,
the smallest power of two whose parameters pass the 1 MiB that sends the
JAX package's ``arg_grads="auto"`` to outer mode (``WIDE``: B6h-wide,
B7h-wide, B8ho-wide), each with 1 to 32 lanes in one block; the kernel-mode
sweep holds the reference width only. The wrappers take the plain version
for tensors on the CPU (any width); for CUDA tensors they launch the kernel
or raise. ``LAUNCHES`` counts kernel launches, the wide ones under the name
with ``_wide`` (the plain versions count nothing).
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

KERNELS = ("hopf_select", "hopf_attempt", "hopf_replay_fwd", "hopf_replay_bwd",
           "hopf_replay_bwd_emit")
WIDE = 512
KERNEL_WIDTHS = (MLP_SIZES[1], WIDE)
LAUNCHES = {**{k: 0 for k in KERNELS},
            **{k + "_wide": 0 for k in KERNELS if k != "hopf_replay_bwd"}}
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


def _lookup_time(t):
    """A step-batched time (n, 1, 1), as ``rk_step_vjp`` carries it beside
    states (n, B, 2), as the mu lookup takes it: (n,)."""
    return t[:, 0, 0] if torch.is_tensor(t) and t.dim() == 3 else t


def hopf_ode_drift(t, y, params, mu: MuTable):
    """The drift of every Hopf kernel: y (..., B, 2), mu's table (T, B)."""
    return hopf_mlp_drift(_lookup_time(t), y, params, Stimulus(mu.t0, mu.dt, mu.table),
                          interp_fn=interp_at_onehot)


def hopf_ode_drift_vjp(t, y, ct, params, mu: MuTable, weights: bool = True):
    """``hopf_mlp_drift_vjp`` with the one-hot blend lookup."""
    return hopf_mlp_drift_vjp(_lookup_time(t), y, ct, params, Stimulus(mu.t0, mu.dt, mu.table),
                              interp_fn=interp_at_onehot, weights=weights)


def pack_params(params) -> torch.Tensor:
    """The parameters as one float32 vector, layer by layer, w then b. Axes
    before a layer's own (the steps of a step-batched VJP) stay in front."""
    lead = params[0]["b"].dim() - 1
    return torch.cat([layer[k].reshape(*layer[k].shape[:lead], -1)
                      for layer in params for k in PARAM_KEYS], dim=-1)


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


def hopf_step_vjp(t0, h, y, ybar, cbar, params, mu: MuTable, weights: bool = True):
    """The VJP of one replay step at (t0, h, y) for the cotangents ybar on
    y1 and cbar (5, B, 2) on its dense rows: (state cotangent, the step's
    parameter cotangents as one ``pack_params`` vector, or None without
    ``weights``). Leading axes before (B, 2) batch separate steps (t0 and h
    then carry them as (n, 1, 1)); each step keeps its own cotangents, a
    leading axis of the vector."""
    acc = [None]

    def drift_vjp(t, Y, kb):
        g, grads = hopf_ode_drift_vjp(t, Y, kb, params, mu, weights=weights)
        if weights:
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


@torch.no_grad()
def _hopf_replay_bwd_emit_plain(ys, cobar, st, params, mu):
    """The emit-mode reverse sweep over steps n-1..0, the state cotangent
    alone: (ybar0 (B, 2), ybar_steps (n, B, 2)); ybar_steps[k] is the
    cotangent on step k's output that the later steps send back, written
    before step k's VJP."""
    ybar = cobar.new_zeros(tuple(cobar.shape[2:]))
    ybar_steps = torch.empty_like(ys)
    for k in range(ys.shape[0] - 1, -1, -1):
        ybar_steps[k] = ybar
        ybar, _ = hopf_step_vjp(st[k], st[k + 1] - st[k], ys[k], ybar, cobar[k], params, mu,
                                weights=False)
    return ybar, ybar_steps


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on CUDA, anything else raises
# ---------------------------------------------------------------------------


def _named(B: int, flat, mu: MuTable) -> dict:
    """The contract of what every Hopf kernel reads besides its states."""
    return {"params": (flat, _F32, (flat.numel(),)),
            "mu": (mu.table, _F32, (mu.table.shape[0], B))}


def _state(y, name="y"):
    return {name: (y, _F32, (y.shape[0], 2))}


def _kernel_ready(params, B: int, widths=KERNEL_WIDTHS) -> int:
    """Raise unless the kernels hold this MLP and batch; return its hidden
    width."""
    sizes = (params[0]["w"].shape[1],) + tuple(layer["w"].shape[0] for layer in params)
    H = sizes[1]
    if sizes != (3, H, H, H, 2) or H not in widths:
        raise ValueError(f"the Hopf kernels hold the MLP (3, H, H, H, 2) with H in {widths}, "
                         f"got {sizes}")
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"the Hopf kernels hold 1 to {MAX_LANES} lanes in one block, got {B}")
    return H


def _args(B, params, mu: MuTable):
    """(flat params, (B, T), host floats (kept alive by the caller until the
    launch returns) and their pointer)."""
    flat = pack_params(params).contiguous()
    hc, hc_p = _host_floats([mu.t0, mu.dt])
    return flat, (B, mu.table.shape[0]), hc, hc_p


def _wide_args(params, H: int, B: int, bwd: bool, device):
    """What the wide kernels read besides the parameters: the hidden
    matrices transposed (w2^T then w3^T, for the forward's coalesced reads)
    and the activations' device-memory scratch, B (3 + 3 H) float64 values
    (and 2 B H more for the layer cotangents of the sweep). Returns (the
    tensors, kept alive by the caller until the launch returns; their
    pointers, passed after the parameters' own); at the reference width the
    kernels keep both in shared memory and take neither."""
    if H != WIDE:
        return (), ()
    wt = torch.cat([params[i]["w"].detach().t().reshape(-1) for i in (1, 2)])
    scratch = torch.empty(B * (3 + 3 * H) + (2 * B * H if bwd else 0), dtype=torch.float64,
                          device=device)
    return (wt, scratch), (wt.data_ptr(), scratch.data_ptr())


def _entry(name: str, H: int):
    """The C entry point of a kernel at hidden width H (``cf_hopf_*`` at
    100, ``cf_hopf_wide_*`` at 512)."""
    return getattr(_lib(), f"cf_hopf_wide_{name[5:]}" if H == WIDE else f"cf_{name}")


def _count(name: str, H: int):
    LAUNCHES[name + "_wide" if H == WIDE else name] += 1


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
    H = _kernel_ready(params, B)
    keep, wide = _wide_args(params, H, B, False, y0.device)
    st = torch.empty(cfg.max_steps + 1, dtype=_F32, device=y0.device)
    stats = torch.empty(3, dtype=torch.int32, device=y0.device)
    hs, hs_p = _select_floats(cfg)
    _check(_entry("hopf_select", H)(*dims, hc_p, hs_p, int(cfg.dt0 is None), cfg.max_steps,
                                    flat.data_ptr(), *wide, mu.table.data_ptr(), y0.data_ptr(),
                                    st.data_ptr(), stats.data_ptr(), _stream(y0)), "hopf_select")
    _count("hopf_select", H)
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
    H = _kernel_ready(params, B)
    keep, wide = _wide_args(params, H, B, False, y.device)
    y1, f1 = torch.empty_like(y), torch.empty_like(y)
    rec = torch.empty(3, dtype=_F32, device=y.device)
    hs, hs_p = _select_floats(cfg)
    _check(_entry("hopf_attempt", H)(*dims, hc_p, hs_p, flat.data_ptr(), *wide,
                                     mu.table.data_ptr(), t.data_ptr(), h.data_ptr(),
                                     y.data_ptr(), f0.data_ptr(), y1.data_ptr(), f1.data_ptr(),
                                     rec.data_ptr(), _stream(y)), "hopf_attempt")
    _count("hopf_attempt", H)
    return ODEAttempt(y1, f1, rec[0], rec[1], rec[2])


def hopf_replay_fwd(y0, st, params, mu: MuTable):
    """The replay of the frozen grid st (n + 1,) from y0 (B, 2): (ys (n, B,
    2) the step-start states, coeffs (n, 5, B, 2) the dense rows)."""
    n, B = st.shape[0] - 1, y0.shape[0]
    flat, dims, hc, hc_p = _args(B, params, mu)
    if not _on_cuda(y0, {**_named(B, flat, mu), **_state(y0), "st": (st, _F32, (n + 1,))}):
        return _hopf_replay_fwd_plain(y0, st, params, mu)
    H = _kernel_ready(params, B)
    keep, wide = _wide_args(params, H, B, False, y0.device)
    ys = torch.empty((n, B, 2), dtype=_F32, device=y0.device)
    coeffs = torch.empty((n, 5, B, 2), dtype=_F32, device=y0.device)
    _check(_entry("hopf_replay_fwd", H)(*dims, hc_p, n, flat.data_ptr(), *wide,
                                        mu.table.data_ptr(), st.data_ptr(), y0.data_ptr(),
                                        ys.data_ptr(), coeffs.data_ptr(), _stream(y0)),
           "hopf_replay_fwd")
    _count("hopf_replay_fwd", H)
    return ys, coeffs


def _sweep_named(ys, cobar, st, flat, mu):
    n, B, _ = ys.shape
    return {**_named(B, flat, mu), "ys": (ys, _F32, (n, B, 2)),
            "cobar": (cobar, _F32, (n, 5, B, 2)), "st": (st, _F32, (n + 1,))}


def hopf_replay_bwd(ys, cobar, st, params, mu: MuTable):
    """The kernel-mode reverse sweep: ys (n, B, 2) the step-start states,
    cobar (n, 5, B, 2) the cotangents of the dense rows. Returns (ybar0 (B,
    2), the parameters' cotangents as a list of ``{"w", "b"}``). On CUDA at
    the reference width only (the wide kernel-mode sweep is ROADMAP.md
    B8hw)."""
    n, B, _ = ys.shape
    flat, dims, hc, hc_p = _args(B, params, mu)
    if not _on_cuda(ys, _sweep_named(ys, cobar, st, flat, mu)):
        return _hopf_replay_bwd_plain(ys, cobar, st, params, mu)
    _kernel_ready(params, B, widths=KERNEL_WIDTHS[:1])
    ybar = torch.empty((B, 2), dtype=_F32, device=ys.device)
    dflat = torch.empty_like(flat)
    work = torch.empty_like(flat)  # the step's sum, each entry owned by one thread
    _check(_lib().cf_hopf_replay_bwd(*dims, hc_p, n, flat.data_ptr(), mu.table.data_ptr(),
                                     st.data_ptr(), ys.data_ptr(), cobar.data_ptr(),
                                     ybar.data_ptr(), dflat.data_ptr(), work.data_ptr(),
                                     _stream(ys)), "hopf_replay_bwd")
    _count("hopf_replay_bwd", KERNEL_WIDTHS[0])
    return ybar, unpack_params(dflat, params)


def hopf_replay_bwd_emit(ys, cobar, st, params, mu: MuTable):
    """The emit-mode reverse sweep: ys (n, B, 2) the step-start states,
    cobar (n, 5, B, 2) the cotangents of the dense rows. Returns (ybar0 (B,
    2), ybar_steps (n, B, 2)), ybar_steps[k] the cotangent on step k's output
    from the later steps."""
    n, B, _ = ys.shape
    flat, dims, hc, hc_p = _args(B, params, mu)
    if not _on_cuda(ys, _sweep_named(ys, cobar, st, flat, mu)):
        return _hopf_replay_bwd_emit_plain(ys, cobar, st, params, mu)
    H = _kernel_ready(params, B)
    keep, wide = _wide_args(params, H, B, True, ys.device)
    ybar = torch.empty((B, 2), dtype=_F32, device=ys.device)
    ybar_steps = torch.empty_like(ys)
    _check(_entry("hopf_replay_bwd_emit", H)(*dims, hc_p, n, flat.data_ptr(), *wide,
                                             mu.table.data_ptr(), st.data_ptr(), ys.data_ptr(),
                                             cobar.data_ptr(), ybar.data_ptr(),
                                             ybar_steps.data_ptr(), _stream(ys)),
           "hopf_replay_bwd_emit")
    _count("hopf_replay_bwd_emit", H)
    return ybar, ybar_steps
