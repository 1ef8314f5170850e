from columnflow_torch.train.optim import (
    adam,
    clamp_params,
    global_norm,
    mask_grads,
    torch_rmsprop,
)

__all__ = ["adam", "clamp_params", "global_norm", "mask_grads", "torch_rmsprop"]
