"""Hierarchical column network: the parity-task model family (port of
``columnflow/models/network.py``).

Areas are stacked feedforwardly; every per-area matrix is embedded into one
full (P, P) matrix at build time, so a drift evaluation is one matrix
product with W_inner + W_lateral + W_ff. State layout (3P,) or (B, 3P):
[membrane(P), adaptation(P), rate(P)], P = 8 * total columns, columns
ordered area-major.

Products. Every matrix product here is summed in float64 and rounded to
float32 once (``_mm``): where the JAX package multiplies bf16 operands with
float32 accumulation, the products themselves are exact in float32, so this
is that sum without its summation-order rounding. The CUDA kernels of
``kernels.network_sde`` sum the same way, so a kernel and its plain version
give the same float32 value, and a later bf16 rounding of it rounds the
same way in both.

The JAX package differentiates its drifts with ``jax.vjp``; the VJPs the
port needs are written out here (``network_drift_premixed_split2_vjp``,
``network_drift_premixed_gradbf16_vjp``), with the bf16 rounding points
that ``jax.vjp`` of the bf16 casts has.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from columnflow_torch.config import POPS_PER_COLUMN, ColumnConfig
from columnflow_torch.models.column import Stimulus, build_area_params
from columnflow_torch.ops.arith import div
from columnflow_torch.ops.interp import interp_at
from columnflow_torch.ops.transfer import (
    GAIN_A,
    NOISE_D,
    THRESHOLD_B,
    _CLAMP,
    compute_firing_rate,
)

NETWORK_NOISE_STD = 10.0

_BF16 = torch.bfloat16


class NetworkStatic(NamedTuple):
    """Static structure of the hierarchical network (numpy arrays)."""

    inner_weights: np.ndarray  # (P, P) fixed within-column anatomy, block-diag
    background_current: np.ndarray  # (P,)
    adaptation_strength: np.ndarray  # (P,)
    input_mask: np.ndarray  # (P, n_inputs)
    feedforward_mask: np.ndarray  # (P, P)
    lateral_mask: np.ndarray  # (P, P)
    output_mask: np.ndarray  # (8,)
    columns_per_area: tuple
    num_pops: int
    tau_syn: float
    tau_mem: float
    tau_adapt: float
    resistance: float


def _mm(a, b):
    """a @ b summed in float64, rounded to float32 once."""
    return torch.matmul(a.double(), b.double()).float()


def _bf(x):
    """Round to bf16 (nearest even) and back to float32."""
    return x.to(_BF16).float()


def make_mask_fan_in(mask: np.ndarray, num_target_blocks: int, num_source_blocks: int):
    """Keep only diagonal (target-block, source-block) pairs."""
    size_t, size_s = mask.shape
    fan = np.zeros_like(mask)
    ft = size_t // num_target_blocks
    fs = size_s // num_source_blocks
    for i, j in zip(range(0, size_t, ft), range(0, size_s, fs)):
        fan[i : i + ft, j : j + fs] = 1.0
    return mask * fan


def _block_offsets(columns_per_area: Sequence[int]):
    pops = [c * POPS_PER_COLUMN for c in columns_per_area]
    offs = np.concatenate([[0], np.cumsum(pops)])
    return pops, offs


def build_column_network(
    cfg: ColumnConfig,
    generator: torch.Generator,
    areas: Sequence[str] = ("mt", "mt", "mt"),
    columns_per_area: Sequence[int] = (8, 4, 1),
    n_inputs: int = 4,
    random_fan_in: bool = False,
    device=None,
):
    """Build (params, static) for the hierarchical network: the JAX
    package's construction with its normal draws taken from ``generator``
    (input, then feedforward per area, lateral per area, output), so the
    same seed gives other weights than ``jax.random`` but the same masks.

    Trainable params (float32 tensors on ``device``, full size, masked):
    input_weights (P, n_inputs), feedforward (P, P), lateral (P, P),
    output_weights (8,).
    """
    if random_fan_in:
        raise NotImplementedError(
            "random_fan_in is not ported yet (ROADMAP.md); the fixed fan-in "
            "masks are")
    columns_per_area = tuple(columns_per_area)
    area_ps = [build_area_params(cfg, a, c) for a, c in zip(areas, columns_per_area)]
    pops, offs = _block_offsets(columns_per_area)
    P = int(offs[-1])
    consts = build_area_params(cfg, "mt", sum(columns_per_area))
    masks, inits = cfg.connection_masks, cfg.connection_inits

    def normal(shape):
        return torch.randn(shape, generator=generator, device=generator.device,
                           dtype=torch.float32).cpu().numpy()

    inner = np.zeros((P, P), dtype=np.float32)
    bg = np.zeros(P, dtype=np.float32)
    for k, ap in enumerate(area_ps):
        sl = slice(int(offs[k]), int(offs[k + 1]))
        inner[sl, sl] = ap.recurrent_weights * ap.internal_mask
        bg[sl] = ap.background_current

    # --- input weights (first area), the reference's row swap at P0 >= 48 ---
    P0 = pops[0]
    in_init = np.tile(np.asarray(inits["input"]), (columns_per_area[0], n_inputs))
    in_rand = np.abs(in_init + 3.0 * normal(in_init.shape)) * 0.8
    in_mask = make_mask_fan_in(
        np.tile(np.asarray(masks["input"]), (columns_per_area[0], n_inputs)), 2, 2)
    if P0 >= 48:
        in_mask[0:16, :] = in_mask[32:48, :]
        in_mask[32:48, :] = in_mask[16:32, :]
    input_mask_full = np.zeros((P, n_inputs), dtype=np.float32)
    input_mask_full[:P0] = in_mask
    input_weights_full = np.zeros((P, n_inputs), dtype=np.float32)
    input_weights_full[:P0] = (in_rand * in_mask).astype(np.float32)

    # --- feedforward (area k-1 -> k), embedded at block (k, k-1) ---
    ff_full = np.zeros((P, P), dtype=np.float32)
    ff_mask_full = np.zeros((P, P), dtype=np.float32)
    for k in range(1, len(area_ps)):
        tc, sc = columns_per_area[k], columns_per_area[k - 1]
        ff_init = np.tile(np.asarray(inits["feedforward"]), (tc, sc))
        rand = np.abs(ff_init + 1.0 * normal(ff_init.shape)) * 4.0
        m = np.tile(np.asarray(masks["feedforward"]), (tc, sc))
        if tc > 1:
            m = make_mask_fan_in(m, 2, 2)
        rows = slice(int(offs[k]), int(offs[k + 1]))
        cols = slice(int(offs[k - 1]), int(offs[k]))
        ff_full[rows, cols] = rand * m
        ff_mask_full[rows, cols] = m

    # --- lateral (within-area, cross-column), embedded at block (k, k) ---
    lat_full = np.zeros((P, P), dtype=np.float32)
    lat_mask_full = np.zeros((P, P), dtype=np.float32)
    for k, ap in enumerate(area_ps):
        c = columns_per_area[k]
        lat_init = np.tile(np.asarray(inits["lateral"]), (c, c))
        rand = (lat_init + 0.01 * normal(lat_init.shape)) * 0.01
        m = np.tile(np.asarray(masks["lateral"]), (c, c)) * np.asarray(ap.external_mask)
        sl = slice(int(offs[k]), int(offs[k + 1]))
        lat_full[sl, sl] = rand * m
        if c > 1:  # single-column areas have no trainable laterals
            lat_mask_full[sl, sl] = m

    # --- output readout over the last column's populations ---
    out_init = np.asarray(inits["output"], dtype=np.float32)
    out_mask = np.asarray(masks["output"], dtype=np.float32)
    out_rand = np.abs(out_init + 1e-3 * normal(out_init.shape))
    output_weights = (out_rand * out_rand * out_mask).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    params = {"input_weights": t(input_weights_full), "feedforward": t(ff_full),
              "lateral": t(lat_full), "output_weights": t(output_weights)}
    static = NetworkStatic(
        inner_weights=inner, background_current=bg,
        adaptation_strength=np.asarray(consts.adaptation_strength, np.float32),
        input_mask=input_mask_full, feedforward_mask=ff_mask_full,
        lateral_mask=lat_mask_full, output_mask=out_mask,
        columns_per_area=columns_per_area, num_pops=P,
        tau_syn=consts.tau_syn, tau_mem=consts.tau_mem,
        tau_adapt=consts.tau_adapt, resistance=consts.resistance)
    return params, static


def _tail(v, a, r, fr, current, tau_syn, tau_mem, tau_adapt, resistance, adapt):
    total = current * tau_syn
    dv = div(-v + total * resistance, tau_mem)
    da = div(-a + adapt * fr, tau_adapt)
    dr = div(-r + fr, tau_syn)
    return torch.cat([dv, da, dr], dim=-1)


def _scalars(net):
    return tuple(float(np.float32(x)) for x in
                 (net.tau_syn, net.tau_mem, net.tau_adapt, net.resistance))


def network_drift(t, y, params, net: NetworkStatic, stim: Stimulus,
                  interp_fn=interp_at):
    """dy/dt for the (3P,) state (or a (..., 3P) batch sharing ``stim``):
    one matrix product over the whole network."""
    P = net.num_pops
    v, a, r = y[..., :P], y[..., P : 2 * P], y[..., 2 * P :]
    fr = compute_firing_rate(v - a)
    ext = interp_fn(t, stim.t0, stim.dt, stim.table)
    dev = y.device
    w = (torch.as_tensor(net.inner_weights, device=dev) + params["lateral"]
         + params["feedforward"])
    current = (_mm(fr, w.T) + _mm(ext, params["input_weights"].T)
               + torch.as_tensor(net.background_current, device=dev))
    return _tail(v, a, r, fr, current, *_scalars(net),
                 torch.as_tensor(net.adaptation_strength, device=dev))


def network_diffusion(t, y, params, net: NetworkStatic, stim: Stimulus,
                      membrane_only: bool = False):
    """Constant diffusion, sigma = 10, on the whole state by default."""
    if membrane_only:
        g = torch.zeros_like(y)
        g[..., : net.num_pops] = NETWORK_NOISE_STD
        return g
    return torch.full_like(y, NETWORK_NOISE_STD)


def build_network_fused_consts(net: NetworkStatic, device=None) -> dict:
    """The constants the premixed drifts read: bg and adapt (float32
    tensors) and the four time constants (Python floats holding float32
    values)."""
    tau_syn, tau_mem, tau_adapt, resistance = _scalars(net)
    return {
        "bg": torch.as_tensor(np.asarray(net.background_current, np.float32), device=device),
        "adapt": torch.as_tensor(np.asarray(net.adaptation_strength, np.float32),
                                 device=device),
        "tau_syn": tau_syn, "tau_mem": tau_mem, "tau_adapt": tau_adapt,
        "resistance": resistance,
    }


def premix_network_weights(params: dict, net: NetworkStatic) -> dict:
    """inner + lateral + feedforward as one matrix, stored transposed
    (differentiable: the lateral/feedforward gradients flow through)."""
    inner = torch.as_tensor(net.inner_weights, device=params["lateral"].device)
    return {"wT": (inner + params["lateral"] + params["feedforward"]).T,
            "iwT": params["input_weights"].T}


def split_f32(w):
    """3-term bf16 decomposition w ~ hi + mid + lo (bf16 tensors)."""
    w_hi = w.to(_BF16)
    r = w - w_hi.float()
    w_mid = r.to(_BF16)
    w_lo = (r - w_mid.float()).to(_BF16)
    return w_hi, w_mid, w_lo


def matmul_split(x, w_hi, w_mid, w_lo):
    """x @ W from a pre-split W: six bf16 products summed in float32."""
    x_hi = _bf(x)
    r = x - x_hi
    x_mid = _bf(r)
    x_lo = _bf(r - x_mid)
    hi, mid, lo = w_hi.float(), w_mid.float(), w_lo.float()
    return (_mm(x_hi, lo) + _mm(x_mid, mid) + _mm(x_lo, hi)
            + _mm(x_hi, mid) + _mm(x_mid, hi) + _mm(x_hi, hi))


def prepare_premixed_split(pw, fc, *rest):
    hi, mid, lo = split_f32(pw["wT"])
    return ({"wT_hi": hi, "wT_mid": mid, "wT_lo": lo, "iwT": pw["iwT"]}, fc) + rest


def matmul_split2(x, w_hi, w_mid):
    """x @ W from two-term bf16 splits of both operands: hi*hi + hi*mid +
    mid*hi, each product in float32, summed in that order."""
    x_hi = _bf(x)
    x_mid = _bf(x - x_hi)
    hi, mid = w_hi.float(), w_mid.float()
    return _mm(x_hi, hi) + _mm(x_hi, mid) + _mm(x_mid, hi)


def prepare_premixed_split2(pw, fc, *rest):
    """The two-term split of the premixed matrix (``--split2``)."""
    w = pw["wT"]
    hi = w.to(_BF16)
    mid = (w - hi.float()).to(_BF16)
    return ({"wT_hi": hi, "wT_mid": mid, "iwT": pw["iwT"]}, fc) + rest


def _fc_tail(v, a, r, fr, current, fc):
    return _tail(v, a, r, fr, current, fc["tau_syn"], fc["tau_mem"],
                 fc["tau_adapt"], fc["resistance"], fc["adapt"])


def network_drift_premixed(t, y, pw, fc: dict, stim: Stimulus, interp_fn=interp_at):
    """The batched drift with pre-mixed weights: y (B, 3P), pw from
    ``premix_network_weights`` (optionally through a prepare hook)."""
    P = fc["bg"].shape[0]
    v, a, r = y[..., :P], y[..., P : 2 * P], y[..., 2 * P :]
    fr = compute_firing_rate(v - a)
    ext = interp_fn(t, stim.t0, stim.dt, stim.table)
    if "wT_lo" in pw:
        rec = matmul_split(fr, pw["wT_hi"], pw["wT_mid"], pw["wT_lo"])
    elif "wT_hi" in pw:
        rec = matmul_split2(fr, pw["wT_hi"], pw["wT_mid"])
    else:
        rec = _mm(fr, pw["wT"])
    current = rec + _mm(ext, pw["iwT"]) + fc["bg"]
    return _fc_tail(v, a, r, fr, current, fc)


def premix_select16(pw: dict) -> dict:
    """bf16 copy of the premixed weights for the step-size selection."""
    return {"wT16": pw["wT"].to(_BF16).contiguous(),
            "iwT16": pw["iwT"].to(_BF16).contiguous()}


def network_drift_premixed_select16(t, y, pw16: dict, fc: dict, stim: Stimulus,
                                    interp_fn=interp_at):
    """``network_drift_premixed`` with bf16 weight products (float32 sums):
    the selection drift for ``premix_select16``."""
    P = fc["bg"].shape[0]
    v, a, r = y[..., :P], y[..., P : 2 * P], y[..., 2 * P :]
    fr = compute_firing_rate(v - a)
    ext = interp_fn(t, stim.t0, stim.dt, stim.table)
    current = (_mm(_bf(fr), pw16["wT16"].float())
               + _mm(_bf(ext), pw16["iwT16"].float()) + fc["bg"])
    return _fc_tail(v, a, r, fr, current, fc)


def network_drift_premixed_gradbf16(t, y, pw, fc: dict, stim: Stimulus,
                                    interp_fn=interp_at):
    """``network_drift_premixed`` with the weights cast to bf16 in-function:
    the drift whose VJP gives the replay's weight gradients with
    ``--grad-bf16`` (``network_drift_premixed_gradbf16_vjp``)."""
    P = fc["bg"].shape[0]
    v, a, r = y[..., :P], y[..., P : 2 * P], y[..., 2 * P :]
    fr = compute_firing_rate(v - a)
    ext = interp_fn(t, stim.t0, stim.dt, stim.table)
    current = (_mm(_bf(fr), _bf(pw["wT"])) + _mm(_bf(ext), _bf(pw["iwT"]))
               + fc["bg"])
    return _fc_tail(v, a, r, fr, current, fc)


# ---------------------------------------------------------------------------
# Hand-derived VJPs
# ---------------------------------------------------------------------------


def fr_and_grad(x):
    """Firing rate and its derivative with respect to x. At the removable
    singularity the rate is the limit 1/d and the derivative is 0: the
    value ``jax.grad`` of ``compute_firing_rate`` gives there, since its
    guard selects a constant (the CUDA kernels compute the same)."""
    xn = GAIN_A * x - THRESHOLD_B
    th = torch.tanh(div(-NOISE_D * xn, _CLAMP))
    e = torch.exp(_CLAMP * th)
    den = 1.0 - e
    near = torch.abs(den) < 1e-12
    sden = torch.where(near, 1.0, den)
    fr = torch.where(near, 1.0 / NOISE_D, xn / sden)
    dden = (e * NOISE_D) * (1.0 - th * th)
    dfr = (sden - xn * dden) / (sden * sden)
    return fr, torch.where(near, 0.0, GAIN_A * dfr)


def _cot_current(cv, fc):
    """Cotangent of the synaptic current from that of dv: the transposes of
    / tau_mem, * resistance, * tau_syn, in that order."""
    return (div(cv, fc["tau_mem"]) * fc["resistance"]) * fc["tau_syn"]


def _state_cot(y, ct, x_bar, frp, fc):
    """The state cotangent of one drift evaluation given the cotangent
    ``x_bar`` that the recurrent product sends to the firing rates."""
    P = fc["bg"].shape[0]
    cv, ca, cr = ct[..., :P], ct[..., P : 2 * P], ct[..., 2 * P :]
    ca_t, cr_t = div(ca, fc["tau_adapt"]), div(cr, fc["tau_syn"])
    c_fr = (x_bar + fc["adapt"] * ca_t) + cr_t
    c_x = frp * c_fr
    return torch.cat([-div(cv, fc["tau_mem"]) + c_x, -ca_t - c_x, -cr_t], dim=-1)


def split2_cotangent(c_cur, w_hi, w_mid):
    """Cotangent that ``matmul_split2(fr, w_hi, w_mid)`` sends to fr, with
    the rounding points of ``jax.vjp`` through its bf16 casts: with
    m = bf16(c @ w_hi^T) and q = bf16(c @ w_mid^T) it is
    m + bf16(bf16(m + q) - m) (the x_mid path gives m, the x_hi path
    bf16(m + q) - m, each cotangent of a bf16 operand rounded to bf16)."""
    m = _bf(_mm(c_cur, w_hi.float().T))
    q = _bf(_mm(c_cur, w_mid.float().T))
    return m + _bf(_bf(m + q) - m)


def network_drift_premixed_split2_vjp(y, ct, pw2, fc):
    """State cotangent of ``network_drift_premixed`` with split2 weights
    (``prepare_premixed_split2`` output) at state y for output cotangent
    ``ct``; the stimulus is data (no time cotangent)."""
    P = fc["bg"].shape[0]
    _, frp = fr_and_grad(y[..., :P] - y[..., P : 2 * P])
    c_cur = _cot_current(ct[..., :P], fc)
    return _state_cot(y, ct, split2_cotangent(c_cur, pw2["wT_hi"], pw2["wT_mid"]),
                      frp, fc)


def network_drift_premixed_gradbf16_vjp(t, y, ct, pw, fc, stim: Stimulus,
                                        interp_fn=interp_at):
    """VJP of ``network_drift_premixed_gradbf16`` for a batch of rows
    (..., 3P): returns (state cotangent, per-row operands of the weight
    cotangent). The weight cotangents are
    d wT = x16^T c_cur and d iwT = e16^T c_cur summed over rows, where
    ``x16``/``e16`` are the bf16-rounded rates and stimulus and ``c_cur``
    the current's cotangent; returned as (x16, e16, c_cur) so the caller
    contracts all steps at once and, as ``jax.vjp`` through the bf16 casts
    does, rounds each evaluation's contracted cotangent to bf16
    (``solvers.fused.outer_arg_grads``)."""
    P = fc["bg"].shape[0]
    fr, frp = fr_and_grad(y[..., :P] - y[..., P : 2 * P])
    ext = interp_fn(t, stim.t0, stim.dt, stim.table)
    c_cur = _cot_current(ct[..., :P], fc)
    x_bar = _bf(_mm(c_cur, _bf(pw["wT"]).T))
    return _state_cot(y, ct, x_bar, frp, fc), (_bf(fr), _bf(ext), c_cur)
