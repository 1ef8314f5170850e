"""Adaptive-step SDE integration with replay gradients, lane-batched (port
of the ``fused=True, fused_pass=True`` path of ``sdeint_adaptive_batch`` in
``columnflow/solvers/sde_adaptive.py``).

Step doubling with SRA1 and a PI controller selects each lane's step grid
(the selection kernel, B5, with the krng Brownian tree evaluated in-kernel);
the frozen grids are then re-integrated, two half steps per accepted step,
by the replay kernel (B3) whose backward is the reverse-sweep kernel (B4),
and the states are interpolated linearly onto ``ts``. The replay's noise
comes from each lane's own tree at its own half-step times, so it is the
path the selection saw.

The port specialises the path to the parity task's model: the selection
drift is ``network_drift_premixed_select16`` (``--select-bf16``), the
replay drift ``network_drift_premixed`` with the split2 weights, the weight
gradients through ``network_drift_premixed_gradbf16`` (``--grad-bf16``).
Other modes of the JAX function (the XLA selection with the jax-random
Brownian tree, other drifts, the I controller) are not ported; they are
queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from columnflow_torch.kernels.network_sde import SDEConsts, SelectConfig, select_pass
from columnflow_torch.models.network import premix_select16
from columnflow_torch.ops.arith import div
from columnflow_torch.solvers import krng
from columnflow_torch.solvers.fused import sdeint_fused

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


def _sde_key_words(keys):
    """(B, 2) tree key words (k0, k1) -> (B, 4) (k0, k1, j0, j1): the
    space-time-integral words are (k0, k1) hashed with the 0x51DE tag."""
    keys = torch.as_tensor(keys, dtype=torch.int64)
    j0, j1 = krng.fold2(keys[:, 0], keys[:, 1], 0x51DE, 0)
    return torch.stack([keys[:, 0], keys[:, 1], j0, j1], dim=1)


def _noise_backend(words, t_start, t_end, levy_depth):
    """(tree, i10_draw) of the krng backend (the JAX package's
    ``brownian="kernel"``) for lanes with key words (B, 4)."""
    tree = krng.KernelBrownianTree(t_start, t_end, words[:, 0:1], words[:, 1:2],
                                   depth=levy_depth)

    def i10_draw(ta, tb):
        return krng.interval_normal(words[:, 2:3], words[:, 3:4], ta, tb, t_start, t_end)

    return tree, i10_draw


def _adaptive_pass_fused(model: PremixedNetworkSDE, y0, words, cfg: SelectConfig):
    """The selection of every lane (kernel on CUDA, plain loop otherwise):
    (step_times (B, M+1), naccept, nreject, success)."""
    w16 = {k: v.detach().contiguous() for k, v in premix_select16(model.pw).items()}
    return select_pass(y0.detach().contiguous(), words, w16, model.sc,
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


def _replay_grid(step_times, words, t_start, t_end, levy_depth):
    """Each lane's accepted steps as two half steps at the tree's own
    half-point times, with the Brownian data of every half step: returns
    ht (B, 2M + 1) and dw, i10 (B, 2M)."""
    st = step_times
    mids = st[:, :-1] + 0.5 * (st[:, 1:] - st[:, :-1])
    B = st.shape[0]
    ht = torch.cat([torch.stack([st[:, :-1], mids], dim=2).reshape(B, -1), st[:, -1:]],
                   dim=1)
    tree, i10_draw = _noise_backend(words, t_start, t_end, levy_depth)
    w = tree.evaluate(ht)
    dw = w[:, 1:] - w[:, :-1]
    za = i10_draw(ht[:, :-1], ht[:, 1:])
    hh = ht[:, 1:] - ht[:, :-1]
    return ht, dw, hh * (0.5 * dw + torch.sqrt(div(hh, 12.0)) * za)


def _replay_pass_fused_batch(model: PremixedNetworkSDE, y0, ts, step_times, naccept,
                             words, t_start, t_end, levy_depth, bptt_every=None):
    """The batched replay over every lane's frozen grid in one sweep. The
    tail past 2 * max(naccept) is h == 0 padding for every lane and is
    skipped; that count is read to the host (one synchronisation per
    step)."""
    st = step_times
    ht, dw, i10 = _replay_grid(st, words, t_start, t_end, levy_depth)
    n_real = 2 * int(naccept.max())
    ys_h = sdeint_fused(model.pw, model.sc, model.kv, y0, ht,
                        (dw.T.contiguous(), i10.T.contiguous()),
                        bptt_every=None if bptt_every is None else 2 * bptt_every,
                        n_real=n_real)                      # (2M + 1, B, S)
    return _interp_accepted(ys_h[::2], y0, ts, st, naccept)


def select_config(ts, rtol: float = 1e-3, atol: float = 1e-3, dt0: float | None = None,
                  dt_min: float = 0.0, max_steps: int = 16384,
                  levy_depth: int = 20) -> SelectConfig:
    """The selection's settings for the output grid ``ts``: the horizon is
    [ts[0], ts[-1]] and the first step, unless given, a quarter of the mean
    grid step (computed in float32, as the JAX package does)."""
    ts_host = torch.as_tensor(ts, dtype=torch.float32).detach().cpu()
    h0 = float(dt0) if dt0 is not None else float(
        (ts_host[-1] - ts_host[0]) / (4.0 * ts_host.shape[0]))
    return SelectConfig(float(ts_host[0]), float(ts_host[-1]), rtol, atol, h0, max_steps,
                        levy_depth, dt_min)


def sdeint_adaptive_batch(model: PremixedNetworkSDE, y0, ts, keys, *, rtol: float = 1e-3,
                          atol: float = 1e-3, dt0: float | None = None, dt_min: float = 0.0,
                          max_steps: int = 16384, levy_depth: int = 20,
                          bptt_every: int | None = None, return_stats: bool = False,
                          grid=None):
    """Batched differentiable adaptive SDE integration: y0 (B, S), keys
    (B, 2) tree key words (k0, k1) per lane. Returns ys (B, len(ts), S)
    (and ``SDESolverStats`` with ``return_stats``). The JAX function's
    ``method="sra1", controller="pi", fused=True, fused_pass=True,
    brownian="kernel"``, the port's only mode.

    ``grid`` = (step_times (B, M+1), naccept (B,), nreject (B,)) skips the
    selection and replays that frozen grid (tests hand in the JAX package's
    grid this way)."""
    if bptt_every is not None and bptt_every < 1:
        raise ValueError(f"bptt_every must be >= 1, got {bptt_every}")
    ts = torch.as_tensor(ts, dtype=torch.float32, device=y0.device)
    cfg = select_config(ts, rtol, atol, dt0, dt_min, max_steps, levy_depth)
    t_start, t_end = cfg.t_start, cfg.t_end
    words = _sde_key_words(keys).to(y0.device)
    if grid is None:
        step_times, naccept, nreject, success = _adaptive_pass_fused(model, y0, words, cfg)
    else:
        step_times, naccept, nreject = (torch.as_tensor(x, device=y0.device) for x in grid)
        step_times = step_times.to(torch.float32)
        last = torch.gather(step_times, 1, naccept.to(torch.int64)[:, None])[:, 0]
        success = last >= t_end
    ys = _replay_pass_fused_batch(model, y0, ts, step_times, naccept, words, t_start,
                                  t_end, levy_depth, bptt_every)
    if return_stats:
        return ys, SDESolverStats(naccept, nreject, success, step_times)
    return ys
