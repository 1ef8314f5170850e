"""The WTA column kernels: drift, SRA1 rollout, and its reverse sweep
(port of ``columnflow/kernels/column_step.py``).

Each kernel is CUDA C++ in ``csrc/column_step.cu`` (built by ``_build``) with
a plain PyTorch version beside it that repeats its arithmetic in the same
time-major layout:

    kernel            plain version         replaces (columnflow/kernels/column_step.py)
    wta_drift         _drift_plain          _drift_kernel (B9)
    wta_rollout_fwd   _rollout_fwd_plain    _rollout_kernel (B1)
    wta_rollout_bwd   _rollout_bwd_plain    _rollout_bwd_kernel (B2)
    wta_wbar_reduce   (inside the above)    the batch sum of B2

The wrappers (``drift``, ``rollout_fwd``, ``rollout_bwd``) take the plain
version for tensors on the CPU; for CUDA tensors they launch the kernel or
raise. ``LAUNCHES`` counts kernel launches (the plain versions count
nothing), so a run can show that it went through the kernels.

Bound on the card (see the source note in ``csrc/column_step.cu``): a serial
chain of 1499 dependent SRA1 steps; per training step at 15 lanes ~61 MFLOP
forward and ~5.8 MB of trajectory and stimulus traffic. The simple design
does nothing about the chain yet.

The TPU kernels split the horizon into time chunks (``auto_chunk``) only
because the trajectory had to fit the TPU's 16 MB VMEM. Device memory holds
the whole (T, B, 48) trajectory, so each kernel here runs the whole horizon
in one launch; ``chunk=`` is accepted for API parity and ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from columnflow_torch.models.column import AreaParams, Stimulus

_GAIN, _THRESH, _D, _CLAMP = 48.0, 981.0, 0.0089, 80.0

LAUNCHES = {"drift": 0, "rollout_fwd": 0, "rollout_bwd": 0, "wbar_reduce": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' arithmetic, time-major layout)
# ---------------------------------------------------------------------------


def _firing_rate(x):
    xn = _GAIN * x - _THRESH
    e = torch.exp(_CLAMP * torch.tanh((-_D * xn) / _CLAMP))
    den = 1.0 - e
    near = torch.abs(den) < 1e-12
    return torch.where(near, 1.0 / _D, xn / torch.where(near, 1.0, den))


def _fr_and_grad(x):
    """Firing rate AND its derivative wrt x, sharing subexpressions.

    phi(x) = xn / (1 - exp(softclamp(-d*xn))), xn = 48x - 981; at the
    removable singularity xn=0 the limits are phi=1/d, phi'=48/2.
    """
    xn = _GAIN * x - _THRESH
    th = torch.tanh((-_D * xn) / _CLAMP)
    e = torch.exp(_CLAMP * th)
    den = 1.0 - e
    near = torch.abs(den) < 1e-12
    sden = torch.where(near, 1.0, den)
    fr = torch.where(near, 1.0 / _D, xn / sden)
    # d(den)/dxn = -e * (1 - th^2) * (-d) = e*d*(1 - th^2)
    dden = e * _D * (1.0 - th * th)
    dfr_dxn = torch.where(near, 0.5, (sden - xn * dden) / (sden * sden))
    return fr, _GAIN * dfr_dxn


def _drift_plain(scalars, y, s, w, consts):
    """Drift on (B, 48) packed state; consts rows [bg_current, ffw, adapt];
    scalars (tau_s, tau_m, tau_a, R)."""
    tau_s, tau_m, tau_a, R = scalars
    v, a, r = y[:, 0:16], y[:, 16:32], y[:, 32:48]
    fr = _firing_rate(v - a)
    rec = fr @ w.T
    cur = (consts[1] * s + consts[0] + rec) * tau_s
    dv = (-v + cur * R) / tau_m
    da = (-a + consts[2] * fr) / tau_a
    dr = (-r + fr) / tau_s
    return torch.cat([dv, da, dr], dim=1)


def _drift_abs_terms(scalars, y, s, w, consts):
    """Sum of the absolute terms of each drift component, (B, 48): the scale
    a drift's rounding error is held against. The membrane derivative's 16
    recurrent terms cancel, so its own magnitude is no scale."""
    tau_s, tau_m, tau_a, R = scalars
    fr = _firing_rate(y[:, :16] - y[:, 16:32]).abs()
    sv = (y[:, :16].abs() / tau_m + R * tau_s / tau_m
          * ((consts[1] * s).abs() + consts[0].abs() + fr @ w.abs().T))
    sa = (y[:, 16:32].abs() + (consts[2] * fr).abs()) / tau_a
    sr = (y[:, 32:].abs() + fr) / tau_s
    return torch.cat([sv, sa, sr], dim=1)


def _rollout_fwd_plain(h, scalars, w, consts, g, y0, stim, i1, i10):
    """SRA1 rollout: stim (T, B, 16), i1/i10 (T-1, B) -> (T, B, 48)."""
    T = stim.shape[0]
    out = torch.empty((T,) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
    out[0] = y0
    y = y0
    for i in range(T - 1):
        s0 = stim[i]
        s1 = stim[min(i + 1, T - 1)]
        s_mid = s0 + 0.75 * (s1 - s0)
        n1 = i1[i][:, None]
        i10_h = (i10[i] / h)[:, None]
        f1 = _drift_plain(scalars, y, s0, w, consts)
        h2 = y + 0.75 * h * f1 + 1.5 * i10_h * g
        f2 = _drift_plain(scalars, h2, s_mid, w, consts)
        # Constant diffusion: the two g evaluations of SRA1 coincide, so the
        # stochastic terms reduce to i1 * g.
        y = y + h * (f1 / 3.0 + 2.0 * f2 / 3.0) + n1 * g
        out[i + 1] = y
    return out


def _drift_vjp(scalars, y, cot, w, consts):
    """Hand-derived VJP of the drift at packed state y (B, 48): returns
    (y_bar (B, 48), w_bar (16, 16)); stimulus and constants are data."""
    tau_s, tau_m, tau_a, R = scalars
    v, a = y[:, 0:16], y[:, 16:32]
    cv, ca, cr = cot[:, 0:16], cot[:, 16:32], cot[:, 32:48]
    fr, frp = _fr_and_grad(v - a)
    # rec[b,p] = sum_q fr[b,q] w[p,q]; dv/drec = R*tau_s/tau_m (diagonal).
    rec_bar = cv * (R * tau_s / tau_m)
    fr_bar = rec_bar @ w + ca * (consts[2] / tau_a) + cr / tau_s
    x_bar = frp * fr_bar
    yb_v = -cv / tau_m + x_bar
    yb_a = -ca / tau_a - x_bar
    yb_r = -cr / tau_s
    w_bar = rec_bar.T @ fr
    return torch.cat([yb_v, yb_a, yb_r], dim=1), w_bar


def _rollout_bwd_plain(h, scalars, w, consts, g, stim, i10, ys, ysbar, cin):
    """Reverse sweep over K steps: stim (K+1, B, 16), i10 (K, B),
    ys/ysbar (K, B, 48), cin = cot(y_K) (B, 48) -> (cot(y_0), w_bar).

    Forward step: f1 = f(y_i, s0);  h2 = y_i + 0.75 h f1 + 1.5 (I10/h) g
                  f2 = f(h2, s_mid);  y_{i+1} = y_i + h (f1/3 + 2 f2/3) + I1 g
    Backward given c = cot(y_{i+1}):
        f2_bar = (2h/3) c;       (h2_bar, wb2) = f^T|_{h2} f2_bar
        f1_bar = (h/3) c + 0.75 h h2_bar
        (y_bar, wb1) = f^T|_{y_i} f1_bar
        cot(y_i) = c + h2_bar + y_bar + ysbar[i]
    """
    K = ys.shape[0]
    c = cin
    wbar = torch.zeros_like(w)
    for k in range(K - 1, -1, -1):
        y = ys[k]
        i10_h = (i10[k] / h)[:, None]
        f1 = _drift_plain(scalars, y, stim[k], w, consts)
        h2 = y + 0.75 * h * f1 + 1.5 * i10_h * g
        f2_bar = (2.0 * h / 3.0) * c
        h2_bar, wb2 = _drift_vjp(scalars, h2, f2_bar, w, consts)
        f1_bar = (h / 3.0) * c + 0.75 * h * h2_bar
        y_bar, wb1 = _drift_vjp(scalars, y, f1_bar, w, consts)
        c = c + h2_bar + y_bar + ysbar[k]
        wbar = wbar + wb1 + wb2
    return c, wbar


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on CUDA, anything else raises
# ---------------------------------------------------------------------------


def _on_cuda(ref: torch.Tensor, named: dict) -> bool:
    """Check every tensor against the wrapper's contract and say whether the
    kernel (CUDA) or the plain version (CPU) computes it."""
    if ref.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {ref.device}")
    for name, (t, shape) in named.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return ref.device.type == "cuda"


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def drift(scalars, y, s, w, consts):
    """One batched drift evaluation: y (B, 48), s (B, 16) -> (B, 48)."""
    B = y.shape[0]
    if not _on_cuda(y, {"y": (y, (B, 48)), "s": (s, (B, 16)), "w": (w, (16, 16)),
                        "consts": (consts, (3, 16))}):
        return _drift_plain(scalars, y, s, w, consts)
    from columnflow_torch.kernels._build import library

    out = torch.empty_like(y)
    if B:
        _check(library().cf_wta_drift(B, *scalars, y.data_ptr(), s.data_ptr(),
                                      w.data_ptr(), consts.data_ptr(),
                                      out.data_ptr(), _stream(y)), "wta_drift")
        LAUNCHES["drift"] += 1
    return out


def rollout_fwd(h, scalars, w, consts, g, y0, stim, i1, i10):
    """Whole-horizon SRA1 rollout: stim (T, B, 16), i1/i10 (T-1, B),
    y0 (B, 48) -> (T, B, 48)."""
    T, B = stim.shape[0], stim.shape[1]
    if not _on_cuda(y0, {"w": (w, (16, 16)), "consts": (consts, (3, 16)),
                         "g": (g, (1, 48)), "y0": (y0, (B, 48)),
                         "stim": (stim, (T, B, 16)), "i1": (i1, (T - 1, B)),
                         "i10": (i10, (T - 1, B))}):
        return _rollout_fwd_plain(h, scalars, w, consts, g, y0, stim, i1, i10)
    from columnflow_torch.kernels._build import library

    out = torch.empty((T, B, 48), dtype=torch.float32, device=y0.device)
    if B:
        _check(library().cf_wta_rollout_fwd(
            T, B, h, *scalars, w.data_ptr(), consts.data_ptr(), g.data_ptr(),
            y0.data_ptr(), stim.data_ptr(), i1.data_ptr(), i10.data_ptr(),
            out.data_ptr(), _stream(y0)), "wta_rollout_fwd")
        LAUNCHES["rollout_fwd"] += 1
    return out


def rollout_bwd(h, scalars, w, consts, g, stim, i10, ys, ysbar, cin):
    """Reverse sweep: stim (K+1, B, 16), i10 (K, B), ys/ysbar (K, B, 48),
    cin (B, 48) -> (cout (B, 48), wbar (16, 16)). On CUDA: the sweep kernel
    writes per-lane partials (B, 16, 16), a second kernel sums them."""
    K, B = ys.shape[0], ys.shape[1]
    if not _on_cuda(cin, {"w": (w, (16, 16)), "consts": (consts, (3, 16)),
                          "g": (g, (1, 48)), "stim": (stim, (K + 1, B, 16)),
                          "i10": (i10, (K, B)), "ys": (ys, (K, B, 48)),
                          "ysbar": (ysbar, (K, B, 48)), "cin": (cin, (B, 48))}):
        return _rollout_bwd_plain(h, scalars, w, consts, g, stim, i10, ys, ysbar, cin)
    from columnflow_torch.kernels._build import library

    lib = library()
    cout = torch.empty((B, 48), dtype=torch.float32, device=cin.device)
    wbar = torch.zeros((16, 16), dtype=torch.float32, device=cin.device)
    if B:
        wpart = torch.empty((B, 16, 16), dtype=torch.float32, device=cin.device)
        stream = _stream(cin)
        _check(lib.cf_wta_rollout_bwd(
            K, B, h, *scalars, w.data_ptr(), consts.data_ptr(), g.data_ptr(),
            stim.data_ptr(), i10.data_ptr(), ys.data_ptr(), ysbar.data_ptr(),
            cin.data_ptr(), cout.data_ptr(), wpart.data_ptr(), stream),
            "wta_rollout_bwd")
        LAUNCHES["rollout_bwd"] += 1
        _check(lib.cf_wta_wbar_reduce(B, wpart.data_ptr(), wbar.data_ptr(), stream),
               "wta_wbar_reduce")
        LAUNCHES["wbar_reduce"] += 1
    return cout, wbar


# ---------------------------------------------------------------------------
# Public functions (names and layouts of the JAX package)
# ---------------------------------------------------------------------------


def _area_consts(area: AreaParams):
    consts = torch.stack([area.background_current, area.feedforward_weights,
                          area.adaptation_strength])
    scalars = (area.tau_syn, area.tau_mem, area.tau_adapt, area.resistance)
    return consts, scalars


def _diffusion_row(noise_std, membrane_only, device):
    g = torch.full((1, 48), noise_std, dtype=torch.float32, device=device)
    if membrane_only:
        g[:, 16:] = 0.0
    return g


def _grid_step(ts) -> float:
    """The step the kernels bake in: ts[1] - ts[0] in float32 (a uniform
    grid; the value is exact as a Python float)."""
    ts_host = np.asarray(torch.as_tensor(ts).detach().cpu(), dtype=np.float32)
    return float(ts_host[1] - ts_host[0])


def fused_drift(y, stim_t, params, area: AreaParams):
    """Single batched WTA drift evaluation: y (B, 48), stim_t (B, 16);
    equivalent to ``models.wta.wta_drift`` at a fixed stimulus row."""
    consts, scalars = _area_consts(area)
    return drift(scalars, y, stim_t, params["recurrent_weights"], consts)


def wta_rollout_fused(params, area: AreaParams, stim_tables, ts, i1, i10,
                      noise_std: float = 100.0, membrane_only: bool = False,
                      y0=None):
    """Batched SRA1 rollout of the WTA model in ONE kernel launch.

    Args:
        stim_tables: (B, T, 16) per-sample stimulus on the ts grid.
        ts: (T,) uniform time grid.
        i1, i10: (T-1, B) Brownian increment / time-integral per step+sample
            (the convention of ``solvers.sde.brownian_pack``).
        y0: (B, 48) initial state; zeros if None.

    Returns (B, T, 48) trajectories.
    """
    B = stim_tables.shape[0]
    consts, scalars = _area_consts(area)
    g = _diffusion_row(noise_std, membrane_only, stim_tables.device)
    if y0 is None:
        y0 = torch.zeros((B, 48), dtype=torch.float32, device=stim_tables.device)
    out = rollout_fwd(_grid_step(ts), scalars, params["recurrent_weights"],
                      consts, g, y0, stim_tables.transpose(0, 1).contiguous(),
                      i1, i10)
    return out.transpose(0, 1)


def wta_rollout_reference(params, area: AreaParams, stim_tables, ts, i1, i10,
                          noise_std: float = 100.0,
                          membrane_only: bool = False):
    """The same rollout through the solver (``solvers.sdeint`` SRA1 over
    ``models.wta``): the parity oracle for the fused kernels."""
    from columnflow_torch.models.wta import wta_diffusion, wta_drift
    from columnflow_torch.solvers.sde import sdeint

    B = stim_tables.shape[0]
    stim = Stimulus(0.0, _grid_step(ts), stim_tables.transpose(0, 1))

    def drift_fn(t, y):
        return wta_drift(t, y, params, area, stim)

    def diffusion_fn(t, y):
        return wta_diffusion(t, y, params, area, stim,
                             membrane_only=membrane_only)

    ys = sdeint(drift_fn, diffusion_fn,
                torch.zeros((B, 48), dtype=torch.float32, device=stim_tables.device),
                ts, None, method="srk", additive=True, noise="scalar",
                noise_pack=(i1, i10, None, None))
    return ys.transpose(0, 1)


class _WTARollout(torch.autograd.Function):
    """Forward: ``rollout_fwd``; backward: ``rollout_bwd``. Only ``w`` gets a
    gradient: stimulus and noise are data in every workload."""

    @staticmethod
    def forward(ctx, w, stim_tables, i1, i10, spec):
        h, scalars, consts, g = spec
        B = stim_tables.shape[0]
        stim_tb = stim_tables.detach().transpose(0, 1).contiguous()
        i10 = i10.detach().contiguous()
        y0 = torch.zeros((B, 48), dtype=torch.float32, device=w.device)
        ys_tb = rollout_fwd(h, scalars, w.detach(), consts, g, y0, stim_tb,
                            i1.detach().contiguous(), i10)
        ctx.spec = spec
        ctx.save_for_backward(w, stim_tb, i10, ys_tb)
        return ys_tb.transpose(0, 1)

    @staticmethod
    def backward(ctx, ys_bar):
        h, scalars, consts, g = ctx.spec
        w, stim_tb, i10, ys_tb = ctx.saved_tensors
        ysbar_tb = ys_bar.transpose(0, 1).to(torch.float32).contiguous()
        _, wbar = rollout_bwd(h, scalars, w.detach(), consts, g, stim_tb, i10,
                              ys_tb[:-1], ysbar_tb[:-1], ysbar_tb[-1].contiguous())
        return wbar, None, None, None, None


def make_wta_rollout_diff(area: AreaParams, ts, noise_std: float = 100.0,
                          membrane_only: bool = False,
                          chunk: int | None = None, device=None):
    """Build a differentiable fused WTA rollout.

    Returns ``rollout(w, stim_tables, i1, i10) -> (B, T, 48)``, a
    ``torch.autograd.Function`` whose forward is the rollout kernel and whose
    backward is the reverse-sweep kernel plus the batch reduction (or their
    plain versions on the CPU). Only ``w`` receives a gradient. ``chunk`` is
    ignored: both sweeps run the whole horizon in one launch.
    """
    del chunk
    consts, scalars = _area_consts(area)
    if device is None:
        device = consts.device
    spec = (_grid_step(ts), scalars, consts.to(device),
            _diffusion_row(noise_std, membrane_only, device))

    def rollout(w, stim_tables, i1, i10):
        return _WTARollout.apply(w, stim_tables, i1, i10, spec)

    return rollout


def auto_chunk(batch: int, budget_bytes: int = 8 << 20) -> int:
    """Time-chunk size the TPU kernels use under a VMEM budget:
    per chunk ~ (K+1) * B * 4 bytes * (48 out + 16 stim + 2 noise). Kept as
    a plain function for API parity; the CUDA kernels do not chunk."""
    per_step = batch * 4 * (48 + 16 + 2)
    return max(16, budget_bytes // per_step)
