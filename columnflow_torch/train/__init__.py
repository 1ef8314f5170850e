from columnflow_torch.train.optim import (
    clamp_params,
    global_norm,
    mask_grads,
    torch_rmsprop,
)

__all__ = ["clamp_params", "global_norm", "mask_grads", "torch_rmsprop"]
