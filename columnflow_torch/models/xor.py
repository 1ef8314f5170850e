"""XOR column network (port of ``columnflow/models/xor.py``).

Two areas, area 0 with two input columns (A, B) and area 1 with one output
column (C), with per-source trainable feedforward target-weight vectors.
Lateral connectivity is removed; the feedforward source is L2/3e, the
target L4e/L4i; the previous area's source rate is summed and scaled x10.

State layout (72,) or (B, 72): [membrane(24), adaptation(24), rate(24)],
columns ordered [A(8), B(8), C(8)].

Sums. ``xor_drift_batched`` and its VJP sum every product of float32
values in float64 in one fixed pairwise order (``tree_sum``) and round to
float32 once; the CUDA kernels (``kernels/csrc/xor_drift.cuh``) sum in the
same order, so a kernel and its plain version agree bit for bit. The JAX
package sums its float32 products at ``Precision.HIGHEST`` in XLA's order;
the two agree to rounding.

The JAX package differentiates the drift with ``jax.vjp``; the VJP the
port needs is written out here (``xor_drift_batched_vjp``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.models.column import AreaParams, Stimulus, area_to_torch, build_area_params
from columnflow_torch.models.network import fr_and_grad
from columnflow_torch.ops.arith import div
from columnflow_torch.ops.interp import interp_at
from columnflow_torch.ops.transfer import compute_firing_rate

NUM_POPS = 24
XOR_STATE_DIM = 72
XOR_NOISE_STD = 10.0
FF_GAIN = 10.0  # the summed source rate is pumped up x10

FF_SOURCE_MASK = np.array([1.0, 0, 0, 0, 0, 0, 0, 0], dtype=np.float32)
FF_TARGET_MASK = np.array([0.0, 0, 1.0, 1.0, 0, 0, 0, 0], dtype=np.float32)

_AREA0 = 16  # populations of area 0 (columns A and B)
_SRC_A, _SRC_B = 0, 8  # the L2/3e population of columns A and B
PF_KEYS = ("w00", "w01", "w10", "w11")


class XORNetwork(NamedTuple):
    """Static structure: per-area anatomy plus shared constants."""

    area0: AreaParams  # 2 columns, small_network
    area1: AreaParams  # 1 column, small_network
    consts: AreaParams  # whole-network constants (3 columns, full size)
    ff_source_mask: np.ndarray
    ff_target_mask: np.ndarray


def build_xor_network(cfg: ColumnConfig, generator: torch.Generator, areas=("mt", "mt"),
                      init_std: float = 0.1, device=None):
    """(params, net): the trainable ff vectors and the static structure.
    The feedforward weights start at |N(anatomical ff weights, init_std)|
    masked to L4e/L4i targets, drawn from ``generator``."""
    area0 = build_area_params(cfg, areas[0], 2, small_network=True)
    area1 = build_area_params(cfg, areas[1], 1, small_network=True)
    consts = build_area_params(cfg, "mt", 3, small_network=False)
    # Lateral connectivity removed.
    area0 = area0._replace(recurrent_weights=area0.recurrent_weights * area0.internal_mask)

    def init_ff(area):
        base = torch.as_tensor(np.asarray(area.feedforward_weights, np.float32))
        mask = torch.as_tensor(np.tile(FF_TARGET_MASK, base.shape[0] // 8))
        noise = init_std * torch.randn((2,) + tuple(base.shape), generator=generator,
                                       device=generator.device).cpu()
        return (torch.abs(base[None] + noise) * mask[None]).to(device)

    params = {"ff_w0": init_ff(area0),  # (2, 16): input i -> area-0 pops
              "ff_w1": init_ff(area1)}  # (2, 8): column A/B -> column C
    net = XORNetwork(*(area_to_torch(a, device) for a in (area0, area1, consts)),
                     FF_SOURCE_MASK, FF_TARGET_MASK)
    return params, net


def xor_drift(t, y, params, net: XORNetwork, stim: Stimulus, interp_fn=interp_at):
    """dy/dt for the 72-dim XOR state, y (72,), stimulus table (T, 2, 16)."""
    P = NUM_POPS
    v, a, r = y[:P], y[P:2 * P], y[2 * P:]
    fr = compute_firing_rate(v - a)
    fr0, fr1 = fr[:_AREA0], fr[_AREA0:]
    ext = interp_fn(t, stim.t0, stim.dt, stim.table)  # (2, 16)
    ff0 = torch.einsum("ip,ip->p", ext, params["ff_w0"])
    src_mask = torch.as_tensor(net.ff_source_mask, device=y.device)
    src = FF_GAIN * torch.matmul(fr0.reshape(2, 8), src_mask)  # (2,)
    ff1 = torch.einsum("i,ip->p", src, params["ff_w1"])
    rec0 = torch.matmul(net.area0.recurrent_weights, fr0)
    rec1 = torch.matmul(net.area1.recurrent_weights, fr1)
    cur0 = (ff0 + net.area0.background_current + rec0) * net.area0.tau_syn
    cur1 = (ff1 + net.area1.background_current + rec1) * net.area1.tau_syn
    total = torch.cat([cur0, cur1])
    c = net.consts
    dv = div(-v + total * c.resistance, c.tau_mem)
    da = div(-a + c.adaptation_strength * fr, c.tau_adapt)
    dr = div(-r + fr, c.tau_syn)
    return torch.cat([dv, da, dr])


def xor_diffusion(t, y, *args):
    """Membrane-only noise, sigma = 10, for a state of any leading shape."""
    g = torch.zeros_like(y)
    g[..., :NUM_POPS] = XOR_NOISE_STD
    return g


def build_xor_fused_consts(net: XORNetwork, device=None) -> dict:
    """The constants ``xor_drift_batched`` reads: the two areas as one
    24-population network (block-diagonal recurrent matrix ``w24``, row i =
    target), ``bg24``, ``adapt`` (float32 tensors) and the four time
    constants (Python floats holding float32 values). The JAX package's
    placement matrices P0/P1 are identity embeddings; the port places the
    per-area feedforward currents directly."""
    w24 = torch.zeros((NUM_POPS, NUM_POPS), dtype=torch.float32, device=device)
    w24[:_AREA0, :_AREA0] = net.area0.recurrent_weights
    w24[_AREA0:, _AREA0:] = net.area1.recurrent_weights
    c = net.consts
    return {"w24": w24,
            "bg24": torch.cat([net.area0.background_current,
                               net.area1.background_current]).to(device),
            "adapt": c.adaptation_strength.to(device),
            "tau_syn": c.tau_syn, "tau_mem": c.tau_mem, "tau_adapt": c.tau_adapt,
            "resistance": c.resistance}


def split_xor_params(params: dict) -> dict:
    """The (2, ...) per-source ff weights as four (1, ...) rows; slicing is
    differentiable, so gradients reach ``params``."""
    return {"w00": params["ff_w0"][0:1], "w01": params["ff_w0"][1:2],
            "w10": params["ff_w1"][0:1], "w11": params["ff_w1"][1:2]}


def tree_sum(s):
    """Sum over the last axis, pairwise in a fixed order: neighbours (2j,
    2j+1) add level by level, an odd last entry carries to the next level
    (24 terms: 12 pairs, 6, 3, then (s0 + s1) + s2). The CUDA kernels sum
    in this order."""
    while s.shape[-1] > 1:
        n, m = s.shape[-1], s.shape[-1] // 2
        pair = s[..., 0:2 * m:2] + s[..., 1:2 * m:2]
        s = torch.cat([pair, s[..., 2 * m:]], dim=-1) if n % 2 else pair
    return s[..., 0]


def _dot(a, b):
    """sum_k a_k b_k over the last axis (broadcast): the products of float32
    values taken exactly in float64, ``tree_sum``-ed, rounded once to a's
    type."""
    return tree_sum(a.double() * b.double()).to(a.dtype)


def xor_drift_batched(t, y, pf, fc: dict, stim: Stimulus, interp_fn=interp_at):
    """Batched ``xor_drift``: y (B, 72) -> (B, 72); the stimulus' two
    16-population slots flattened to (B, 32). ``pf`` from
    ``split_xor_params``, ``fc`` from ``build_xor_fused_consts``."""
    P = NUM_POPS
    v, a, r = y[..., :P], y[..., P:2 * P], y[..., 2 * P:]
    fr = compute_firing_rate(v - a)
    ext = interp_fn(t, stim.t0, stim.dt, stim.table)  # (B, 32)
    ff0 = ext[..., :_AREA0] * pf["w00"] + ext[..., _AREA0:] * pf["w01"]  # (B, 16)
    src_a, src_b = fr[..., _SRC_A:_SRC_A + 1], fr[..., _SRC_B:_SRC_B + 1]  # (B, 1)
    ff1 = FF_GAIN * (src_a * pf["w10"] + src_b * pf["w11"])  # (B, 8)
    rec = _dot(fr[..., None, :], fc["w24"])  # (B, 24): sum_j fr_j w24[i, j]
    total = (torch.cat([ff0, ff1], dim=-1) + fc["bg24"] + rec) * fc["tau_syn"]
    dv = div(-v + total * fc["resistance"], fc["tau_mem"])
    da = div(-a + fc["adapt"] * fr, fc["tau_adapt"])
    dr = div(-r + fr, fc["tau_syn"])
    return torch.cat([dv, da, dr], dim=-1)


def xor_drift_batched_vjp(t, y, ct, pf, fc: dict, stim: Stimulus, interp_fn=interp_at):
    """The VJP of ``xor_drift_batched`` at (t, y) for the output cotangent
    ct (B, 72): (state cotangent (B, 72), {"w00", "w01", "w10", "w11"} the
    four ff rows' cotangents, each contracted over the batch).

    With cc = ((c_v / tau_mem) R) tau_syn the cotangent of the summed
    current, the rates take the transposed recurrent product sum_i cc_i
    w24[i, j], plus at j = 0 and 8 (the source populations) the sums
    sum_q (10 cc_{16+q}) w1{0,1}[q]; then the adaptation and rate terms, and
    the firing rate's derivative. The rows take sum_b cc[b, p] ext[b, p]
    (w00, w01: the two stimulus slots) and sum_b (10 cc[b, 16+q]) fr[b, 0 or
    8] (w10, w11)."""
    P = NUM_POPS
    v, a = y[..., :P], y[..., P:2 * P]
    cv, ca, cr = ct[..., :P], ct[..., P:2 * P], ct[..., 2 * P:]
    fr, frp = fr_and_grad(v - a)
    ext = interp_fn(t, stim.t0, stim.dt, stim.table)
    cc = (div(cv, fc["tau_mem"]) * fc["resistance"]) * fc["tau_syn"]
    s_bar = FF_GAIN * cc[..., _AREA0:]  # (B, 8)
    g = _dot(cc[..., None, :], fc["w24"].T)  # (B, 24)
    g_src_a = g[..., _SRC_A:_SRC_A + 1] + _dot(s_bar, pf["w10"])[..., None]
    g_src_b = g[..., _SRC_B:_SRC_B + 1] + _dot(s_bar, pf["w11"])[..., None]
    g = torch.cat([g_src_a, g[..., _SRC_A + 1:_SRC_B], g_src_b, g[..., _SRC_B + 1:]], dim=-1)
    ca_t, cr_t = div(ca, fc["tau_adapt"]), div(cr, fc["tau_syn"])
    c_x = frp * ((g + fc["adapt"] * ca_t) + cr_t)
    state = torch.cat([-div(cv, fc["tau_mem"]) + c_x, -ca_t - c_x, -cr_t], dim=-1)

    def lanes(a, b):  # sum_b a[b, p] b[b, p], contracted over the batch axis
        return _dot(a.transpose(-1, -2), b.transpose(-1, -2))[None]

    rows = {"w00": lanes(cc[..., :_AREA0], ext[..., :_AREA0]),
            "w01": lanes(cc[..., :_AREA0], ext[..., _AREA0:]),
            "w10": lanes(s_bar, fr[..., _SRC_A:_SRC_A + 1].expand_as(s_bar)),
            "w11": lanes(s_bar, fr[..., _SRC_B:_SRC_B + 1].expand_as(s_bar))}
    return state, rows
