from columnflow_torch.models.column import (
    AreaParams,
    Stimulus,
    area_to_torch,
    build_area_params,
)
from columnflow_torch.models.wta import (
    WTA_STATE_DIM,
    build_wta,
    wta_diffusion,
    wta_drift,
    wta_lat_in_mask,
)
from columnflow_torch.models.ww import wong_wang_sim, wong_wang_three_phase

__all__ = [
    "AreaParams",
    "Stimulus",
    "area_to_torch",
    "build_area_params",
    "WTA_STATE_DIM",
    "build_wta",
    "wta_diffusion",
    "wta_drift",
    "wta_lat_in_mask",
    "wong_wang_sim",
    "wong_wang_three_phase",
]
