"""Adaptive-step SDE integration with replay gradients, lane-batched (port
of ``sdeint_adaptive_batch``, ``FrozenGrid``, ``sde_select_grid`` and
``sdeint_replay`` in ``columnflow/solvers/sde_adaptive.py``, with
``fused=True``: the replay is the fused solver).

Step doubling with SRA1 and a PI controller selects each lane's step grid;
the frozen grids are then re-integrated, two half steps per accepted step,
in one lane-batched sweep (``solvers.fused.sdeint_fused``), and the states
are interpolated linearly onto ``ts``. The replay's noise comes from each
lane's own Brownian tree at its own half-step times, so it is the path the
selection saw.

Two selections, as in the JAX package, both a CUDA kernel per lane
(``kernels.network_sde.select_pass``, whose plain version is the port of
``_adaptive_pass``/``_make_body``/``_sra1_doubling``):

- ``fused_pass=True`` (the JAX package's in-kernel pass, B5): the krng tree
  (``brownian="kernel"``), the bf16 selection drift (``select_bf16``) or
  the three-term split of ``prepare_premixed_split`` (B5t, the JAX
  package's ``select_prepare``);
- ``fused_pass=False`` (its XLA pass): the ``jax.random`` tree
  (``brownian="jax"``, by default) or the krng tree, the bf16 or the float32
  selection drift (``select_bf16``).

The replay: the three-term split (``prepare="split"``, the f32-exact
replay: in kernel mode through 63 columns, in outer mode from 64, its outer
weight gradients exact or, with ``grad_bf16``, the gradbf16 substitute) or
the two-term split with the gradbf16 weight gradients outside the kernels
(``prepare="split2"``, ``grad_bf16``), per ``sdeint_fused``. The defaults
are the 104-column ``--fused-pass`` flagship's. Keys are raw key data (B, 2), uint32 words in
int64: a JAX key passes unchanged, and both packages then draw the same
paths.

The port specialises the path to the two models the tasks give it: the
parity task's (``PremixedNetworkSDE``) and the XOR task's (``XORSDE``: the
four feedforward rows, the membrane-only diffusion; its selection always
runs on the float32 ``xor_drift_batched``, its replay in the XOR kernels,
``solvers.fused.xor_sdeint_fused`` on per-lane grids, kernel mode). Other
drifts, the I controller and the other steppers are not ported (ROADMAP.md
A8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from columnflow_torch.kernels.network_sde import (
    SDEConsts,
    SelectConfig,
    lane_noise,
    select_pass,
    select_weights_split3,
)
from columnflow_torch.models.network import premix_select16
from columnflow_torch.ops.arith import div
from columnflow_torch.solvers import jrandom, krng
from columnflow_torch.solvers.brownian import interval_normal as _interval_normal  # noqa: F401
from columnflow_torch.kernels.xor_sde import xor_sde_select
from columnflow_torch.solvers.fused import sdeint_fused, xor_sdeint_fused

# The JAX package's names: ``_interval_normal(key, ta, tb)``, the jax
# backend's space-time-integral normal keyed by the interval's endpoint bit
# patterns, and ``_noise_backend(words, t_start, t_end, levy_depth,
# brownian)``, the lanes' (tree, i10_draw).
_noise_backend = lane_noise


class SDESolverStats(NamedTuple):
    """The JAX package's three counts, and the frozen grid (B, M+1) they
    belong to, so that a caller can replay the same grid elsewhere."""

    naccept: torch.Tensor
    nreject: torch.Tensor
    success: torch.Tensor
    step_times: torch.Tensor | None = None


class PremixedNetworkSDE(NamedTuple):
    """The parity task's SDE: premixed weights pw = {"wT", "iwT"}
    (differentiable), the drift constants and knot times, and the knot
    values kv (K, B, n_in), one stimulus per lane."""

    pw: dict
    sc: SDEConsts
    kv: torch.Tensor


class XORSDE(NamedTuple):
    """The XOR task's SDE: the four feedforward rows pf = {"w00", "w01",
    "w10", "w11"} (differentiable, ``split_xor_params``), the drift
    constants and knot times (``build_xor_fused_consts``), and the knot
    values kv (K, B, 32), one stimulus per lane; sigma = 10 on the membrane
    block only."""

    pf: dict
    sc: SDEConsts
    kv: torch.Tensor


def _sde_key_words(keys, brownian: str = "kernel"):
    """(B, 2) raw keys -> (B, 4) (k0, k1, j0, j1): the tree's key and the
    space-time integrals' key, the raw key with the 0x51DE tag folded in by
    the backend's own hash (``krng.fold2`` for "kernel", ``fold_in`` for
    "jax")."""
    keys = torch.as_tensor(keys, dtype=torch.int64)
    if brownian == "jax":
        return torch.cat([keys, jrandom.fold_in(keys, 0x51DE)], dim=1)
    if brownian != "kernel":
        raise ValueError(f"unknown brownian backend: {brownian!r}")
    j0, j1 = krng.fold2(keys[:, 0], keys[:, 1], 0x51DE, 0)
    return torch.stack([keys[:, 0], keys[:, 1], j0, j1], dim=1)


def _adaptive_pass(model, y0, words, cfg: SelectConfig):
    """The selection of every lane (kernel on CUDA, plain loop otherwise)
    with ``cfg``'s tree and drift: (step_times (B, M+1), naccept, nreject,
    success)."""
    if isinstance(model, XORSDE):
        return xor_sde_select(y0.detach().contiguous(), words,
                              {k: v.detach().contiguous() for k, v in model.pf.items()},
                              model.sc, model.kv.detach().contiguous(), cfg)
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    if cfg.drift == "select16":
        w = premix_select16(pw)
    elif cfg.drift == "split3":
        w = select_weights_split3(pw, model.sc)
    else:
        w = pw
    return select_pass(y0.detach().contiguous(), words, w, model.sc,
                       model.kv.detach().contiguous(), cfg)


def _interp_accepted(ys_acc, y0, ts, step_times, naccept):
    """Linear interpolation of each lane's accepted-point states onto ts:
    ys_acc (M+1, B, S), step_times (B, M+1), naccept (B,) -> (B, T, S)."""
    B = step_times.shape[0]
    idx = torch.searchsorted(step_times.contiguous(),
                             ts[None, :].expand(B, -1).contiguous(), right=True) - 1
    idx = torch.minimum(torch.clamp_min(idx, 0), (naccept.to(idx.dtype) - 1)[:, None])
    t0s = torch.gather(step_times, 1, idx)
    hs = torch.gather(step_times, 1, idx + 1) - t0s
    pos = hs > 0
    theta = torch.where(pos, (ts[None, :] - t0s) / torch.where(pos, hs, 1.0), 0.0)
    lanes = torch.arange(B, device=idx.device)[:, None]
    y_lo, y_hi = ys_acc[idx, lanes], ys_acc[idx + 1, lanes]
    ys = y_lo + theta[..., None] * (y_hi - y_lo)
    return torch.cat([y0[:, None], ys[:, 1:]], dim=1)


def _replay_grid(step_times, words, t_start, t_end, levy_depth, brownian: str = "kernel"):
    """Each lane's accepted steps as two half steps at the tree's own
    half-point times, with the Brownian data of every half step: returns
    ht (B, 2M + 1) and dw, i10 (B, 2M)."""
    st = step_times
    mids = st[:, :-1] + 0.5 * (st[:, 1:] - st[:, :-1])
    B = st.shape[0]
    ht = torch.cat([torch.stack([st[:, :-1], mids], dim=2).reshape(B, -1), st[:, -1:]],
                   dim=1)
    tree, i10_draw = _noise_backend(words, t_start, t_end, levy_depth, brownian)
    w = tree.evaluate(ht)
    dw = w[:, 1:] - w[:, :-1]
    za = i10_draw(ht[:, :-1], ht[:, 1:])
    hh = ht[:, 1:] - ht[:, :-1]
    return ht, dw, hh * (0.5 * dw + torch.sqrt(div(hh, 12.0)) * za)


def _replay_pass_fused_batch(model, y0, ts, step_times, naccept,
                             words, t_start, t_end, levy_depth, bptt_every=None,
                             brownian: str = "kernel", prepare: str = "split2",
                             grad_bf16: bool = True):
    """The batched replay over every lane's frozen grid in one sweep. The
    tail past 2 * max(naccept) is h == 0 padding for every lane and is
    skipped; that count is read to the host (one synchronisation per
    step). ``prepare`` and ``grad_bf16`` apply to the network model."""
    st = step_times
    ht, dw, i10 = _replay_grid(st, words, t_start, t_end, levy_depth, brownian)
    n_real = 2 * int(naccept.max())
    if isinstance(model, XORSDE):
        ys_h = xor_sdeint_fused(model.pf, model.sc, model.kv, y0,
                                noise_pack=(dw.T.contiguous(), i10.T.contiguous()), ts_steps=ht,
                                n_real=n_real)
        return _interp_accepted(ys_h[::2], y0, ts, st, naccept)
    ys_h = sdeint_fused(model.pw, model.sc, model.kv, y0, ht,
                        (dw.T.contiguous(), i10.T.contiguous()),
                        bptt_every=None if bptt_every is None else 2 * bptt_every,
                        n_real=n_real, prepare=prepare,
                        vjp_drift="gradbf16" if grad_bf16 else None)  # (2M + 1, B, S)
    return _interp_accepted(ys_h[::2], y0, ts, st, naccept)


def select_config(ts, rtol: float = 1e-3, atol: float = 1e-3, dt0: float | None = None,
                  dt_min: float = 0.0, max_steps: int = 16384, levy_depth: int = 20,
                  brownian: str = "kernel", drift: str = "select16") -> SelectConfig:
    """The selection's settings for the output grid ``ts`` (the port of
    ``_setup``): the horizon is [ts[0], ts[-1]] and the first step, unless
    given, a quarter of the mean grid step (computed in float32, as the JAX
    package does)."""
    ts_host = torch.as_tensor(ts, dtype=torch.float32).detach().cpu()
    h0 = float(dt0) if dt0 is not None else float(
        (ts_host[-1] - ts_host[0]) / (4.0 * ts_host.shape[0]))
    return SelectConfig(float(ts_host[0]), float(ts_host[-1]), rtol, atol, h0, max_steps,
                        levy_depth, dt_min, brownian, drift)


def resolve_selection(fused_pass: bool, brownian: str | None, select_bf16: bool) -> tuple:
    """(brownian, drift) of the selection, as the JAX package resolves
    them: the in-kernel pass implies the krng tree, and without
    ``select_bf16`` it selects on the three-term split
    (``select_prepare=prepare_premixed_split``: "split3"); the XLA pass on
    the float32 weights ("f32")."""
    if brownian is None:
        brownian = "kernel" if fused_pass else "jax"
    if fused_pass and brownian != "kernel":
        raise ValueError("fused_pass=True requires the 'kernel' Brownian backend (the pass "
                         "evaluates the tree in-kernel)")
    if select_bf16:
        return brownian, "select16"
    return brownian, "split3" if fused_pass else "f32"


def sdeint_adaptive_batch(model, y0, ts, keys, *, rtol: float = 1e-3,
                          atol: float = 1e-3, dt0: float | None = None, dt_min: float = 0.0,
                          max_steps: int = 16384, levy_depth: int = 20,
                          bptt_every: int | None = None, return_stats: bool = False,
                          grid=None, fused_pass: bool = True, brownian: str | None = None,
                          select_bf16: bool | None = None, prepare: str | None = None,
                          grad_bf16: bool | None = None):
    """Batched differentiable adaptive SDE integration: y0 (B, S), keys
    (B, 2) raw keys (uint32 words in int64), one Brownian path per lane.
    Returns ys (B, len(ts), S) (and ``SDESolverStats`` with
    ``return_stats``). The JAX function's ``method="sra1", controller="pi",
    fused=True``, with its ``fused_pass`` and ``brownian``.

    ``model``: ``PremixedNetworkSDE`` (S = 3P) or ``XORSDE`` (S = 72). For
    the network, ``select_bf16`` picks the JAX function's ``select_drift``
    (``network_drift_premixed_select16`` or the float32
    ``network_drift_premixed``), ``prepare`` and ``grad_bf16`` its replay's
    prepare hook and ``vjp_drift`` (``sdeint_fused``); unset, they are the
    104-column flagship's (True, "split2", True). The XOR model takes none
    of them (its selection drift is the float32 one, its replay the XOR
    kernels in kernel mode) and no ``bptt_every``.

    ``grid`` = (step_times (B, M+1), naccept (B,), nreject (B,)) skips the
    selection and replays that frozen grid (tests hand in the JAX package's
    grid this way)."""
    if bptt_every is not None and bptt_every < 1:
        raise ValueError(f"bptt_every must be >= 1, got {bptt_every}")
    if isinstance(model, XORSDE):
        if select_bf16 or grad_bf16 or prepare is not None:
            raise ValueError("select_bf16, prepare and grad_bf16 apply to the network model: the "
                             "XOR model selects on its float32 drift and replays in kernel mode")
        if bptt_every is not None:
            raise NotImplementedError(
                "truncated BPTT in the XOR replay's reverse sweep is not ported (no XOR command "
                "line passes it): ROADMAP.md B, the XOR drift's truncated sweep")
        brownian, drift = resolve_selection(fused_pass, brownian, False)[0], "f32"
    else:
        select_bf16 = True if select_bf16 is None else select_bf16
        prepare = "split2" if prepare is None else prepare
        grad_bf16 = True if grad_bf16 is None else grad_bf16
        brownian, drift = resolve_selection(fused_pass, brownian, select_bf16)
    ts = torch.as_tensor(ts, dtype=torch.float32, device=y0.device)
    cfg = select_config(ts, rtol, atol, dt0, dt_min, max_steps, levy_depth, brownian, drift)
    t_start, t_end = cfg.t_start, cfg.t_end
    words = _sde_key_words(keys, brownian).to(y0.device)
    if grid is None:
        step_times, naccept, nreject, success = _adaptive_pass(model, y0, words, cfg)
    else:
        step_times, naccept, nreject = (torch.as_tensor(x, device=y0.device) for x in grid)
        step_times = step_times.to(torch.float32)
        last = torch.gather(step_times, 1, naccept.to(torch.int64)[:, None])[:, 0]
        success = last >= t_end
    ys = _replay_pass_fused_batch(model, y0, ts, step_times, naccept, words, t_start,
                                  t_end, levy_depth, bptt_every, brownian, prepare, grad_bf16)
    if return_stats:
        return ys, SDESolverStats(naccept, nreject, success, step_times)
    return ys


class FrozenGrid(NamedTuple):
    """The accepted-step sequences of one selection, a first-class object,
    so selection and integration over the frozen grid compose explicitly:
    ``step_times`` (B, M+1) accepted times padded with t_end, ``naccept``
    (B,) the real steps, ``stats`` the controller's record."""

    step_times: torch.Tensor
    naccept: torch.Tensor
    stats: SDESolverStats


def sde_select_grid(model: PremixedNetworkSDE, y0, ts, keys, *, rtol: float = 1e-3,
                    atol: float = 1e-3, dt0: float | None = None, dt_min: float = 0.0,
                    max_steps: int = 16384, levy_depth: int = 20, brownian: str = "jax",
                    select_bf16: bool = False) -> FrozenGrid:
    """Run only the selection (the XLA pass's kernel) and return the frozen
    grids. A pure function of (keys, y0, weights, settings): running it
    again reproduces the grids bit for bit."""
    brownian, drift = resolve_selection(False, brownian, select_bf16)
    cfg = select_config(torch.as_tensor(ts, dtype=torch.float32), rtol, atol, dt0, dt_min,
                        max_steps, levy_depth, brownian, drift)
    words = _sde_key_words(keys, brownian).to(y0.device)
    st, na, nr, ok = _adaptive_pass(model, y0, words, cfg)
    return FrozenGrid(st, na, SDESolverStats(na, nr, ok, st))


def sdeint_replay(model: PremixedNetworkSDE, y0, ts, keys, grid: FrozenGrid, *,
                  levy_depth: int = 20, brownian: str = "jax", bptt_every: int | None = None,
                  prepare: str = "split", grad_bf16: bool = False):
    """Differentiable integration over frozen grids (``sde_select_grid``):
    two half steps per accepted step on the same Brownian data from the
    same keys, through ``sdeint_fused`` (the three-term split in kernel mode
    by default), interpolated onto ``ts``. Returns ys (B, len(ts), 3P)."""
    if bptt_every is not None and bptt_every < 1:
        raise ValueError(f"bptt_every must be >= 1, got {bptt_every}")
    ts = torch.as_tensor(ts, dtype=torch.float32, device=y0.device)
    cfg = select_config(ts, levy_depth=levy_depth)
    words = _sde_key_words(keys, brownian).to(y0.device)
    return _replay_pass_fused_batch(model, y0, ts, grid.step_times.to(torch.float32),
                                    grid.naccept, words, cfg.t_start, cfg.t_end, levy_depth,
                                    bptt_every, brownian, prepare, grad_bf16)
