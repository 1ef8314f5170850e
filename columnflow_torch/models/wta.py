"""Winner-take-all two-column model (port of ``columnflow/models/wta.py``).

Two cortical columns with trainable lateral-inhibition (L2/3e -> other
column's L2/3i) and self-excitation (L2/3e -> L2/3e) entries in the recurrent
matrix; everything else is fixed anatomy. State layout (..., 48):
[membrane(16), adaptation(16), rate(16)]. Leading axes are independent lanes.

Drift equations:
    fr      = f(V - a)
    I_total = (w_ff * stim(t) + I_bg + W_rec @ fr) * tau_syn
    dV/dt   = (-V + R * I_total) / tau_mem
    da/dt   = (-a + g_adapt * fr) / tau_adapt
    dr/dt   = (-r + fr) / tau_syn
"""

from __future__ import annotations

import numpy as np
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.models.column import (
    AreaParams,
    Stimulus,
    area_to_torch,
    build_area_params,
)
from columnflow_torch.ops.interp import interp_at
from columnflow_torch.ops.transfer import compute_firing_rate

NUM_COLUMNS = 2
NUM_POPS = 16
WTA_STATE_DIM = 48
WTA_NOISE_STD = 100.0


def wta_lat_in_mask() -> np.ndarray:
    """Trainable-entry mask: lateral inhibition + self-excitation."""
    m = np.zeros((NUM_POPS, NUM_POPS), dtype=np.float32)
    m[1, 8] = m[9, 0] = 1.0  # L2/3e -> other column's L2/3i
    m[0, 0] = m[8, 8] = 1.0  # L2/3e self-excitation
    return m


def build_wta(cfg: ColumnConfig, generator: torch.Generator, area: str = "mt",
              init_std: float = 1e-4, device=None):
    """Build WTA parameters: (params dict of tensors, area on ``device``).

    The recurrent matrix starts at anatomy plus |N(w, init_std)|
    perturbations on the cross-column trainable entries. The draw comes from
    ``generator`` (on its own device), so its numbers differ from the JAX
    package's ``jax.random`` draw; every other entry is identical.
    """
    area_np: AreaParams = build_area_params(cfg, area, NUM_COLUMNS,
                                            small_network=True)
    mask = wta_lat_in_mask()
    orig = torch.as_tensor(area_np.recurrent_weights)
    z = torch.randn(orig.shape, generator=generator, dtype=torch.float32,
                    device=generator.device).cpu()
    rand = torch.abs(orig + init_std * z)
    recurrent = rand * torch.as_tensor(mask * area_np.external_mask) + orig

    output_weights = np.zeros(8, dtype=np.float32)
    output_weights[0] = 1.0  # readout = L2/3e

    params = {
        "recurrent_weights": recurrent.to(device),
        "output_weights": torch.as_tensor(output_weights, device=device),
    }
    return params, area_to_torch(area_np, device)


def wta_drift(t, y, params, area: AreaParams, stim: Stimulus,
              interp_fn=interp_at):
    """dy/dt for the WTA state y (..., 48); ``area`` holds tensors
    (``area_to_torch``) and ``interp_fn(t, ...)`` returns (..., 16)."""
    v, a, r = y[..., :NUM_POPS], y[..., NUM_POPS:2 * NUM_POPS], y[..., 2 * NUM_POPS:]
    fr = compute_firing_rate(v - a)

    ff_rate = interp_fn(t, stim.t0, stim.dt, stim.table)
    ff_current = area.feedforward_weights * ff_rate
    recurrent_current = fr @ params["recurrent_weights"].T
    total = (ff_current + area.background_current + recurrent_current) * area.tau_syn

    dv = (-v + total * area.resistance) / area.tau_mem
    da = (-a + area.adaptation_strength * fr) / area.tau_adapt
    dr = (-r + fr) / area.tau_syn
    return torch.cat([dv, da, dr], dim=-1)


def wta_diffusion(t, y, params, area: AreaParams, stim: Stimulus,
                  membrane_only: bool = False):
    """Constant diffusion, sigma = 100.

    The original model's docstring says membrane-only, but its row-indexing
    applies sigma to the WHOLE state; the default reproduces that behaviour
    and ``membrane_only=True`` gives the documented one.
    """
    if membrane_only:
        g = torch.zeros_like(y)
        g[..., :NUM_POPS] = WTA_NOISE_STD
    else:
        g = torch.full_like(y, WTA_NOISE_STD)
    return g
