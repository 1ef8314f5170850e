"""Move the JAX package's parameters into the port.

Parameter init and Brownian paths use ``jax.random`` on the JAX side and a
``torch.Generator`` here, so the two never draw the same numbers. Tests build
the parameters once in ``columnflow``, take them as numpy arrays, and hand
them to the port with these functions, so both sides compute the same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from columnflow_torch.models.column import AreaParams, area_to_torch


def params_from_jax(params_np: dict, device=None) -> dict:
    """A parameter dict of arrays (anything ``np.asarray`` takes) -> a dict of
    float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
            for k, v in params_np.items()}


def area_from_jax(area_np, device=None) -> AreaParams:
    """The JAX package's ``AreaParams`` (numpy fields) -> the port's area,
    float32 tensors on ``device``."""
    return area_to_torch(
        AreaParams(**{f: getattr(area_np, f) for f in AreaParams._fields}), device)


def network_from_jax(params_np: dict, static, device=None):
    """The JAX package's network (params dict, ``NetworkStatic``) -> the
    port's (float32 tensors on ``device``, the port's ``NetworkStatic``)."""
    from columnflow_torch.models.network import NetworkStatic

    fields = {f: getattr(static, f) for f in NetworkStatic._fields}
    for f, v in fields.items():
        if isinstance(v, np.ndarray):
            fields[f] = np.array(v, dtype=np.float32)
    fields["columns_per_area"] = tuple(fields["columns_per_area"])
    fields["num_pops"] = int(fields["num_pops"])
    return params_from_jax(params_np, device), NetworkStatic(**fields)


def lane_key_words(keys) -> torch.Tensor:
    """(B, 2) raw JAX PRNG keys (uint32 key data, anything ``np.asarray``
    takes) -> the (B, 2) tree key words (k0, k1) the port takes, uint32
    values in int64."""
    return torch.as_tensor(np.asarray(keys, dtype=np.uint32).astype(np.int64)).reshape(-1, 2)
