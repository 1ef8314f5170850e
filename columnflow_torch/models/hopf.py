"""Hopf-bifurcation task models (port of ``columnflow/models/hopf.py``).

- ``hopf_dynamics``: the supercritical Hopf normal form with time-varying
  input mu(t), the ground-truth system.
- ``build_hopf_mlp`` / ``hopf_mlp_drift``: the trainable neural-ODE drift, an
  MLP 3 -> 100 -> 100 -> 100 -> 2 with ReLU, weights N(0, 0.1), zero biases.
- ``hopf_mlp_drift_vjp``: its hand-derived VJP for the fused engine's
  reverse sweeps (``kernels.hopf_ode``): the kernel-mode sweep takes the
  weight cotangents in the kernel, the emit-mode sweep the state cotangent
  alone, and the outer pass (``solvers.fused.hopf_outer_arg_grads``) the
  weight cotangents of many steps at once.

Params are a list of ``{"w": (dout, din), "b": (dout,)}`` float32 tensors,
as in the JAX package. Every product of a layer takes its float32 terms
exactly in float64, adds them in the pairwise order of ``tree_sum`` and
rounds once to float32; the bias is added after, in float32. The CUDA
kernels sum in the same order, so a kernel and its plain version give the
same bits. The JAX package's float32 HIGHEST products round differently,
within an ulp or two per product.
"""

from __future__ import annotations

import torch

from columnflow_torch.models.column import Stimulus
from columnflow_torch.models.xor import tree_sum
from columnflow_torch.ops.interp import interp_at

MLP_SIZES = (3, 100, 100, 100, 2)
PARAM_KEYS = ("w", "b")


def hopf_dynamics(t, y, stim: Stimulus, omega=1.0):
    """Hopf normal form; y (..., 2), mu interpolated at t from stim (T, ...)."""
    mu_t = interp_at(t, stim.t0, stim.dt, stim.table)
    x, v = y[..., 0], y[..., 1]
    r2 = x * x + v * v
    dx = (mu_t - r2) * x - omega * v
    dv = (mu_t - r2) * v + omega * x
    return torch.stack([dx, dv], dim=-1)


def build_hopf_mlp(generator: torch.Generator, sizes=MLP_SIZES, init_std: float = 0.1,
                   device=None):
    """MLP parameters: [{"w", "b"}, ...] with w ~ N(0, init_std) of shape
    (dout, din), drawn from ``generator``, and b = 0, on ``device``."""
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((dout, din), generator=generator, device=generator.device)
        params.append({"w": (init_std * w).to(device=device, dtype=torch.float32),
                       "b": torch.zeros(dout, dtype=torch.float32, device=device)})
    return params


def linear(x, w, b):
    """x (..., din) @ w.T + b: the products exact in float64, summed in
    ``tree_sum`` order, rounded once, then the bias in float32."""
    return tree_sum(x.double()[..., None, :] * w.double()).to(x.dtype) + b


def mlp_apply(params, x):
    """ReLU MLP; x (..., sizes[0]) -> (..., sizes[-1])."""
    h = x
    for i, layer in enumerate(params):
        h = linear(h, layer["w"], layer["b"])
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def _mlp_input(t, y, stim: Stimulus, interp_fn):
    mu_t = interp_fn(t, stim.t0, stim.dt, stim.table)  # (B,)
    return torch.cat([y, mu_t[..., None].to(y.dtype)], dim=-1)


def hopf_mlp_drift(t, y, params, stim: Stimulus, interp_fn=interp_at):
    """Neural-ODE drift: y (B, 2), stim table (T, B) of mu values -> (B, 2);
    the net sees (x, y, mu(t))."""
    return mlp_apply(params, _mlp_input(t, y, stim, interp_fn))


def _contract(a, b):
    """sum over the lane axis (-2) of a[..., l, i] b[..., l, j] -> (..., i,
    j): the products exact in float64, ``tree_sum``-ed over the lanes,
    rounded once."""
    return tree_sum(a.double().mT[..., :, None, :] * b.double().mT[..., None, :, :]).to(a.dtype)


def hopf_mlp_drift_vjp(t, y, ct, params, stim: Stimulus, interp_fn=interp_at,
                       weights: bool = True):
    """The VJP of ``hopf_mlp_drift`` at (t, y) for the output cotangent ct
    (B, 2): (state cotangent (B, 2), [{"w", "b"}] each layer's cotangents,
    contracted over the lanes, or None without ``weights``). Axes before
    (B, 2) batch separate evaluations (t then gives each its own time, as
    ``interp_fn`` takes it), each with its own cotangents.

    The forward is recomputed at (t, y), so the ReLU masks are those of the
    drift at the same state; the derivative at exactly 0 is 0, as in
    ``jax.nn.relu``'s. Per layer from the last: the input's cotangent is
    sum_o g[b, o] w[o, k], masked by the input's activation (> 0); w takes
    sum_b g[b, o] x[b, k] and b takes sum_b g[b, o], each in float64 over
    the lanes and rounded once. The mu column is data: its cotangent is
    dropped."""
    xs = [_mlp_input(t, y, stim, interp_fn)]
    for layer in params[:-1]:
        xs.append(torch.relu(linear(xs[-1], layer["w"], layer["b"])))
    g = ct
    grads = [None] * len(params) if weights else None
    for i in range(len(params) - 1, -1, -1):
        x = xs[i]
        if weights:
            ones = torch.ones_like(g[..., :1])
            grads[i] = {"w": _contract(g, x), "b": _contract(g, ones)[..., 0]}
        gx = tree_sum(g.double()[..., None, :] * params[i]["w"].double().T).to(g.dtype)
        g = torch.where(x > 0, gx, torch.zeros_like(gx)) if i else gx
    return g[..., :2], grads
