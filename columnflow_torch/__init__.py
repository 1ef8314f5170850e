"""columnflow_torch — the PyTorch/CUDA port of columnflow.

The JAX package ``columnflow`` is the reference; this package computes the
same functions with the same names and array layouts, in PyTorch, with the
hot loops as CUDA C++ kernels written for Hopper (``sm_90a``). It imports
neither ``jax`` nor ``columnflow``.

Layering mirrors the JAX package:
    config   -> typed TOML loading (shared ``config/model.toml``)
    ops      -> transfer function, interpolation, losses
    models   -> WTA column model, Wong-Wang target generator
    data     -> WTA stimulus tables and dataset
    solvers  -> fixed-step SRA1 ``sdeint`` (pure torch, autograd)
    kernels  -> CUDA kernels with their plain PyTorch versions
    train    -> gradient masks, norms, clamps, torch RMSprop
    tasks    -> the WTA training task

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Float32 throughout, with TF32 off for matrix products and convolutions.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# f32 means f32: the JAX reference computes its products at
# Precision.HIGHEST, so TF32 stays off on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    otherwise. Raises when CUDA is asked for (or defaulted to) and absent;
    there is no silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "columnflow_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device", "__version__"]
