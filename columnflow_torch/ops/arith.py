"""Division by a Python number that rounds as IEEE division on every device.

On CUDA, PyTorch divides a tensor by a Python number (or a 0-dim CPU
tensor) as a multiplication by the number's float32 reciprocal, which can
land an ulp away from the quotient; on the CPU it divides, as the JAX
package and the port's CUDA kernels do. The plain versions of the kernels
must round as the kernels do on either device, so they divide through
``div``, which hands CUDA a 0-dim tensor on the tensor's own device: that
takes PyTorch's division path.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _divisor(c: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # Made once per constant: a tensor built from a host number is a copy
    # to the device that waits for it.
    return torch.tensor(c, dtype=dtype, device=device)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, rounded as a division of x by float32(c) on every device."""
    if x.device.type == "cpu":
        return x / c
    return x / _divisor(float(c), x.dtype, x.device)
