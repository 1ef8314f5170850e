"""Wong-Wang (2006) two-pool decision-making model — the WTA training-target
generator (port of ``columnflow/models/ww.py``).

One Python loop over steps, batched over any leading axes of ``mus``. The
update is plain explicit Euler on s and I_noise, as in the JAX package.
"""

from __future__ import annotations

import torch

GAMMA = 0.641
TAU_S = 0.1
TAU_AMPA = 0.002
J_WITHIN = 0.2609
J_BETWEEN = 0.0497
J_EXT = 5.2e-4
I_0 = 0.3255
DT = 1e-3

_W = ((J_WITHIN, -J_BETWEEN), (-J_BETWEEN, J_WITHIN))


def _f(x):
    """Wong-Wang f-I curve, a=270, b=108, d=0.154, with the removable
    singularity at a*x = b guarded (limit 1/d)."""
    num = 270.0 * x - 108.0
    den = 1.0 - torch.exp(-0.154 * num)
    near = torch.abs(den) < 1e-12
    return torch.where(near, 1.0 / 0.154, num / torch.where(near, 1.0, den))


def wong_wang_sim(mus, num_steps_per_phase, dt=DT, sigma_noise=0.0,
                  generator: torch.Generator | None = None):
    """Simulate the DM model over phases with per-phase external drives.

    Args:
        mus: (..., num_phases, 2) external drive (muA, muB) per phase.
        num_steps_per_phase: steps per phase.
        generator: draws the AMPA noise; needed only when sigma_noise != 0.

    Returns firing rates (..., num_phases * num_steps_per_phase, 2),
    recorded after each update.
    """
    mus = torch.as_tensor(mus, dtype=torch.float32)
    batch = mus.shape[:-2]
    n_phases = mus.shape[-2]
    total = n_phases * num_steps_per_phase
    w = torch.tensor(_W, dtype=torch.float32, device=mus.device)
    dsig = (dt / TAU_AMPA) ** 0.5 * sigma_noise

    s = 0.1 * torch.ones(batch + (2,), device=mus.device)
    i_noise = torch.zeros(batch + (2,), device=mus.device)
    if sigma_noise != 0.0:
        i_noise = sigma_noise * torch.randn(
            batch + (2,), generator=generator, device=generator.device
        ).to(mus.device)
    rates = torch.empty(batch + (total, 2), device=mus.device)
    for step in range(total):
        i_ext = J_EXT * mus[..., step // num_steps_per_phase, :]
        i_rec = s @ w.T
        i_noise = i_noise + dt * (I_0 - i_noise) / TAU_AMPA
        if sigma_noise != 0.0:
            i_noise = i_noise + dsig * torch.randn(
                batch + (2,), generator=generator, device=generator.device
            ).to(mus.device)
        x = i_rec + i_ext + i_noise
        r = _f(x)
        s = s + dt * (-s / TAU_S + (1.0 - s) * GAMMA * r)
        rates[..., step, :] = r
    return rates


def wong_wang_three_phase(mu_a, mu_b, phase_time=5.0, dt=DT, sigma_noise=0.0,
                          generator: torch.Generator | None = None):
    """The three-phase protocol: pre-stimulus (0, 0), stimulus (muA, muB),
    post-stimulus (0, 0), ``phase_time`` each. ``mu_a``/``mu_b`` may be
    tensors of any matching shape (one simulation per element)."""
    mu_a = torch.as_tensor(mu_a, dtype=torch.float32)
    mu_b = torch.as_tensor(mu_b, dtype=torch.float32, device=mu_a.device)
    steps = int(phase_time / dt) + 1
    on = torch.stack([mu_a, mu_b], dim=-1)
    mus = torch.stack([torch.zeros_like(on), on, torch.zeros_like(on)], dim=-2)
    return wong_wang_sim(mus, steps, dt=dt, sigma_noise=sigma_noise,
                         generator=generator)
