from columnflow_torch.ops.interp import interp_at
from columnflow_torch.ops.losses import (
    fr_to_binary,
    huber_trajectory_loss_wta,
    min_max,
    smooth_l1,
)
from columnflow_torch.ops.transfer import compute_firing_rate, soft_clamp

__all__ = [
    "compute_firing_rate",
    "soft_clamp",
    "interp_at",
    "min_max",
    "fr_to_binary",
    "smooth_l1",
    "huber_trajectory_loss_wta",
]
