"""WTA, parity, XOR and Hopf stimuli and datasets (port of
``columnflow/data.py``)."""

from __future__ import annotations

import numpy as np
import torch

from columnflow_torch.ops.interp import interp_at_lanes
from columnflow_torch.solvers.dopri import odeint_dopri5_lanes

# Stimulus targets L4e/L4i of each column: indices 2,3 (column A) and
# 10,11 (column B) in the 16-population layout. Slices, not index lists: a
# list index is copied to the device, which waits for the device.
_WTA_STIM_IDX_A = slice(2, 4)
_WTA_STIM_IDX_B = slice(10, 12)


def wta_stim_three_phases(stim_pair, time_steps: int, num_pops: int = 16):
    """Three-phase stimulus table: zeros, stimulus, zeros.

    ``stim_pair`` (..., 2) holds (muA, muB); returns (..., T, 16) with the
    drive on the L4e/L4i populations of the two columns during the middle
    third of the grid.
    """
    stim_pair = torch.as_tensor(stim_pair)
    stim = torch.zeros(stim_pair.shape[:-1] + (num_pops,),
                       dtype=stim_pair.dtype, device=stim_pair.device)
    stim[..., _WTA_STIM_IDX_A] = stim_pair[..., 0:1]
    stim[..., _WTA_STIM_IDX_B] = stim_pair[..., 1:2]
    onset = time_steps // 3
    offset = onset + time_steps // 3
    step_idx = torch.arange(time_steps, device=stim_pair.device)
    in_phase = ((step_idx >= onset) & (step_idx < offset)).to(stim.dtype)
    return in_phase[:, None] * stim[..., None, :]


def sample_wta_mus(generator: torch.Generator, n_samples: int, device=None):
    """Random (muA, muB) drives: muA ~ U(15, 25), muB = muA + U(10, 20),
    order shuffled per sample. Returns (N, 2)."""
    def uniform(lo, hi):
        u = torch.rand(n_samples, generator=generator, device=generator.device)
        return (lo + (hi - lo) * u).to(device)

    mu_a = uniform(15.0, 25.0)
    mu_b = mu_a + uniform(10.0, 20.0)
    flip = torch.rand(n_samples, generator=generator,
                      device=generator.device).to(device) < 0.5
    lo = torch.where(flip, mu_b, mu_a)
    hi = torch.where(flip, mu_a, mu_b)
    return torch.stack([lo, hi], dim=-1)


def make_wta_dataset(generator: torch.Generator, n_samples: int,
                     time_steps: int, phase_time: float = 5.0,
                     dt: float = 1e-3, device=None):
    """Wong-Wang training dataset: (states (N, T, 2), stims (N, 2)).

    Each sample is a three-phase DM simulation (all samples batched in one
    loop over steps), downsampled x10 and truncated to ``time_steps``.
    States are raw Wong-Wang rates; the caller scales by 1/20.
    """
    from columnflow_torch.models.ww import wong_wang_three_phase

    stims = sample_wta_mus(generator, n_samples, device=device)
    rates = wong_wang_three_phase(stims[:, 0], stims[:, 1],
                                  phase_time=phase_time, dt=dt)
    return rates[:, ::10][:, :time_steps].contiguous(), stims


# ---------------------------------------------------------------------------
# Parity (port of the parity part of ``columnflow/data.py``)
# ---------------------------------------------------------------------------


def parity_combinations(n_inputs: int, fixed_position: bool = True,
                        level: float = 15.0) -> np.ndarray:
    """All input patterns, scaled to ``level`` Hz: with ``fixed_position``
    the patterns [0...0 1...1] with k trailing ones, k = 1..n_inputs,
    otherwise all 2^n binary combinations."""
    if fixed_position:
        combos = np.tril(np.ones((n_inputs, n_inputs), dtype=np.float32))[:, ::-1]
    else:
        combos = np.array(
            [[(i >> bit) & 1 for bit in reversed(range(n_inputs))]
             for i in range(2**n_inputs)],
            dtype=np.float32,
        )
    return combos * level


def make_parity_batch(generator: torch.Generator, n_inputs: int, batch_size: int,
                      fixed_position: bool = True, level: float = 15.0,
                      device=None):
    """A shuffled batch of parity input patterns (B, n_inputs): the
    patterns tiled to at least ``batch_size`` rows, permuted by
    ``generator``, truncated."""
    combos = torch.as_tensor(parity_combinations(n_inputs, fixed_position, level),
                             device=device)
    reps = -(-batch_size // combos.shape[0])  # ceil
    tiled = combos.repeat(reps, 1)
    perm = torch.randperm(tiled.shape[0], generator=generator,
                          device=generator.device).to(tiled.device)
    return tiled[perm][:batch_size]


def parity_stim_table(stim_raw, time_steps: int):
    """Parity stimulus table (T, n_inputs): zeros for the first half, the
    input pattern for the second."""
    stim_raw = torch.as_tensor(stim_raw)
    on = (torch.arange(time_steps, device=stim_raw.device)
          >= time_steps // 2).to(stim_raw.dtype)
    return on[:, None] * stim_raw[None, :]


# ---------------------------------------------------------------------------
# XOR (port of the XOR part of ``columnflow/data.py``)
# ---------------------------------------------------------------------------


def xor_conditions() -> np.ndarray:
    """The four XOR input conditions in Hz: (20, 0) and (0, 20) are
    "different", (20, 20) and (0, 0) "same"."""
    return np.array([[20.0, 0.0], [0.0, 20.0], [20.0, 20.0], [0.0, 0.0]], dtype=np.float32)


def prep_xor_stim(cond, time_steps: int, num_pops: int = 16):
    """XOR stimulus table (..., T, 2, 16) of conditions (..., 2): zeros for
    the first half, then the stimulus; the second slot carries the
    column-swapped copy, so both input columns see both stimuli."""
    cond = torch.as_tensor(cond)
    stim = torch.zeros(cond.shape[:-1] + (num_pops,), dtype=cond.dtype, device=cond.device)
    stim[..., _WTA_STIM_IDX_A] = cond[..., 0:1]
    stim[..., _WTA_STIM_IDX_B] = cond[..., 1:2]
    half = num_pops // 2
    pair = torch.stack([stim, torch.cat([stim[..., half:], stim[..., :half]], dim=-1)], dim=-2)
    on = (torch.arange(time_steps, device=cond.device) >= time_steps // 2).to(cond.dtype)
    return on[:, None, None] * pair[..., None, :, :]


# ---------------------------------------------------------------------------
# Hopf bifurcation (port of the Hopf part of columnflow/data.py)
# ---------------------------------------------------------------------------

HOPF_OMEGA = 1.0
HOPF_SINE_AMP = 1.0
HOPF_SINE_FREQ = 0.25


def hopf_dynamics(t, state, mu_t):
    """Supercritical Hopf normal form with drive mu(t)."""
    x, y = state[..., 0], state[..., 1]
    rad = mu_t - x * x - y * y
    dx = rad * x - HOPF_OMEGA * y
    dy = rad * y + HOPF_OMEGA * x
    return torch.stack([dx, dy], dim=-1)


def _hopf_solve(y0s, mus, ts, max_steps: int = 4096, return_stats: bool = False):
    """Integrate ground-truth Hopf trajectories: y0s (N, 2), mus (T, N) ->
    (T, N, 2); each trajectory under its own dopri5 controller at rtol 1e-7
    / atol 1e-9, its drive mu interpolated from its column of ``mus``."""
    ts = torch.as_tensor(ts, dtype=torch.float32, device=y0s.device)
    t0, dt = float(ts[0]), float(ts[1] - ts[0])

    def f(t, y):  # t (N,): each lane's own time
        return hopf_dynamics(t, y, interp_at_lanes(t, t0, dt, mus))

    return odeint_dopri5_lanes(f, y0s, ts, max_steps=max_steps, return_stats=return_stats)


def make_hopf_dataset(generator: torch.Generator, n_samples: int, ts, max_steps: int = 4096,
                      device=None):
    """Ground-truth Hopf dataset (T, N, 3), channels (x, y, mu), on
    ``device``: start points U(-2, 2)^2 and random-phase sine drives mu(t) =
    sin(0.25 t + c), c ~ U(-pi, pi), drawn from ``generator`` and integrated
    with the per-lane adaptive dopri5 (``solvers.dopri``)."""
    ts = torch.as_tensor(ts, dtype=torch.float32).to(device)
    u = torch.rand((n_samples, 2), generator=generator, device=generator.device)
    y0s = (-2.0 + 4.0 * u).to(device)
    c = torch.rand((n_samples,), generator=generator, device=generator.device)
    phases = (-np.pi + 2.0 * np.pi * c).to(device)
    mus = HOPF_SINE_AMP * torch.sin(ts[:, None] * HOPF_SINE_FREQ + phases[None, :])
    ys = _hopf_solve(y0s, mus, ts, max_steps=max_steps)
    return torch.cat([ys, mus[..., None]], dim=-1)
