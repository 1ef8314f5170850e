"""Wong-Wang-style firing-rate transfer function (port of
``columnflow/ops/transfer.py``).

f(x) = (a*x - b) / (1 - exp(-d*(a*x - b))) with the exponent soft-clamped to
+-80 by a tanh, a=48, b=981, d=0.0089. The removable singularity at a*x = b
(limit 1/d) is guarded exactly as in the JAX package, so values and autograd
gradients agree with ``jax.grad`` there too.
"""

from __future__ import annotations

import torch

GAIN_A = 48.0
THRESHOLD_B = 981.0
NOISE_D = 0.0089
_CLAMP = 80.0


def soft_clamp(x, max_val: float = _CLAMP):
    """Smoothly clamp x to (-max_val, max_val)."""
    return max_val * torch.tanh(x / max_val)


def compute_firing_rate(x):
    """Firing rate from (membrane potential - adaptation), any shape."""
    x_nom = GAIN_A * x - THRESHOLD_B
    exp_term = torch.exp(soft_clamp(-NOISE_D * x_nom))
    denom = 1.0 - exp_term
    # Guard the removable singularity at x_nom == 0 (limit = 1/d): a safe
    # denominator first, then the limit value, so no nan reaches gradients.
    near_zero = torch.abs(denom) < 1e-12
    safe_denom = torch.where(near_zero, 1.0, denom)
    return torch.where(near_zero, 1.0 / NOISE_D, x_nom / safe_denom)
