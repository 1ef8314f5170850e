"""WTA stimulus tables and dataset (port of the WTA part of
``columnflow/data.py``)."""

from __future__ import annotations

import torch

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
