from columnflow_torch.kernels.column_step import (
    LAUNCHES,
    fused_drift,
    make_wta_rollout_diff,
    wta_rollout_fused,
    wta_rollout_reference,
)

__all__ = [
    "LAUNCHES",
    "fused_drift",
    "make_wta_rollout_diff",
    "wta_rollout_fused",
    "wta_rollout_reference",
]
