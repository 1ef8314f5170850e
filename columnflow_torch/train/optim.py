"""Optimizer, gradient masking, norms and weight clamping (port of
``columnflow/train/optim.py``).

Parameters and gradients are plain dicts of tensors (the JAX package's
pytrees). ``torch_rmsprop`` is ``torch.optim.RMSprop`` itself (eps outside
the square root, which the JAX package reproduces by hand) with a
per-update ``ExponentialLR``; ``adam`` is ``torch.optim.Adam``, whose update
is optax's (eps outside the square root).
"""

from __future__ import annotations

import torch


def torch_rmsprop(params, lr: float, alpha: float = 0.99, eps: float = 1e-8,
                  lr_gamma: float = 1.0):
    """``(optimizer, scheduler)``: RMSprop over ``params`` (an iterable of
    tensors) and ExponentialLR(gamma=lr_gamma), stepped once per update, so
    update t uses lr * gamma**t."""
    optimizer = torch.optim.RMSprop(params, lr=lr, alpha=alpha, eps=eps)
    scheduler = torch.optim.lr_scheduler.ExponentialLR(optimizer, gamma=lr_gamma)
    return optimizer, scheduler


def adam(params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """torch.optim.Adam over ``params`` (an iterable of tensors): the update
    of the JAX package's ``adam`` (optax), b1/b2/eps as there."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def mask_grads(grads: dict, masks: dict) -> dict:
    """Elementwise-multiply gradients by binary masks; entries whose mask is
    None pass through unchanged."""
    return {k: g if masks.get(k) is None else g * masks[k]
            for k, g in grads.items()}


def global_norm(tree: dict):
    """Global L2 norm of a dict of tensors, overflow-robust via
    max-prescaling. Returns (norm, gmax, norm_scaled) with
    norm == gmax * norm_scaled. Leaves are visited in sorted key order, the
    order of the JAX package's pytree leaves."""
    leaves = [tree[k] for k in sorted(tree)]
    gmax = torch.clamp(torch.max(torch.stack([torch.max(torch.abs(g)) for g in leaves])),
                       min=1e-30)
    norm_scaled = torch.sqrt(sum(torch.sum(torch.square(g / gmax)) for g in leaves))
    return gmax * norm_scaled, gmax, norm_scaled


def clamp_params(params: dict, clamps: dict) -> dict:
    """Clamp parameters to (min, max) bounds; ``clamps`` maps names to
    (lo, hi) tuples or None."""
    out = {}
    for k, p in params.items():
        c = clamps.get(k)
        out[k] = p if c is None else torch.clamp(p, c[0], c[1])
    return out
