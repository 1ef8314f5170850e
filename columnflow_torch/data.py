"""WTA and parity stimuli and datasets (port of the WTA and parity parts of
``columnflow/data.py``)."""

from __future__ import annotations

import numpy as np
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
