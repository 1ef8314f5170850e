"""Loss and readout functions (port of ``columnflow/ops/losses.py``)."""

from __future__ import annotations

import torch

from columnflow_torch.ops.transfer import compute_firing_rate


def min_max(firing_rates):
    """Min-max normalize firing rates to [0, 1]."""
    max_val = torch.max(firing_rates)
    min_val = torch.min(firing_rates)
    return (firing_rates - min_val) / (max_val - min_val)


def fr_to_binary(firing_rates, scaling_factor: float = 1.0):
    """Loose z-score followed by a sigmoid."""
    threshold = torch.mean(firing_rates)
    sd_fr = torch.std(firing_rates, correction=1) / scaling_factor
    return 1.0 / (1.0 + torch.exp(-(firing_rates - threshold) / sd_fr))


def smooth_l1(pred, true, beta: float = 1.0):
    """SmoothL1/Huber loss, mean-reduced (torch.nn.SmoothL1Loss semantics)."""
    diff = torch.abs(pred - true)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return torch.mean(loss)


def huber_trajectory_loss_wta(pred_states, true, output_weights, beta: float = 1.0):
    """WTA trajectory loss: firing rates recomputed from the membrane and
    adaptation blocks, each column's 8 populations read out through
    ``output_weights``, SmoothL1 against the Wong-Wang targets.

    Args:
        pred_states: (batch, T, 48) solver output for the 2-column WTA model.
        true: (batch, T, 2) target firing-rate trajectories.
        output_weights: (8,) readout weights over one column's populations.
    """
    mem = pred_states[..., :16]
    adap = pred_states[..., 16:32]
    fr = compute_firing_rate(mem - adap)
    fr_a = torch.sum(fr[..., :8] * output_weights, dim=-1)
    fr_b = torch.sum(fr[..., 8:16] * output_weights, dim=-1)
    pred = torch.stack([fr_a, fr_b], dim=-1)
    return smooth_l1(pred, true, beta=beta)
