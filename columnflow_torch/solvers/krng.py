"""Counter-based RNG and Brownian tree that a kernel can evaluate (port of
``columnflow/solvers/krng.py``).

- ``threefry2x32``: Threefry-2x32, 20 rounds, on uint32 words held in int64
  tensors (every sum masked to 32 bits): bit-identical to the JAX package.
- ``normal_from_bits``: uint32 -> standard normal through the Acklam inverse
  normal CDF in float32 (log/sqrt and rational polynomials; ``log`` may
  differ from XLA's by an ulp, so normals agree to a few ulp).
- ``KernelBrownianTree``: the fixed-depth Brownian-bridge bisection tree
  keyed by bisection codes, queried here for a whole tensor of times at
  once. The CUDA selection kernel walks the same tree one time at a time
  with the same float32 operations, so the replay sees the path the
  selection saw.

Times enter as float32; every operation on them rounds as in the JAX
package, which matters: ``_t_code`` turns a time into the counter of an
interval normal, so one ulp of a time draws another normal.
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def _u32(x, device=None):
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 words (int64 tensors or ints,
    broadcast elementwise). Returns (o0, o1) as int64 tensors."""
    dev = next((a.device for a in (k0, k1, x0, x1) if torch.is_tensor(a)), None)
    k0, k1, x0, x1 = (_u32(a, dev) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for r in range(5):
        for rot in (_ROT_A if r % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + ks[(r + 1) % 3]) & _M32
        x1 = (x1 + ks[(r + 2) % 3] + (r + 1)) & _M32
    return x0, x1


def fold2(k0, k1, a, b):
    """Derive a new key pair by hashing (a, b) under (k0, k1)."""
    return threefry2x32(k0, k1, a, b)


# Acklam's inverse-normal-CDF approximation (|relative error| < 1.15e-9).
_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
      1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
      6.680131188771972e+01, -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
      -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
      3.754408661907416e+00)
_P_LOW = 0.02425


def ndtri(p):
    """Inverse standard-normal CDF (Acklam), float32; p in (0, 1). Every
    constant is rounded to float32 where it meets p, as in the JAX
    package."""
    p = torch.as_tensor(p, dtype=torch.float32)
    p_tail = torch.where(p < 0.5, p, 1.0 - p)
    p_safe = torch.clamp_min(p_tail, 1e-38)
    q = torch.sqrt(-2.0 * torch.log(p_safe))
    num = ((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q + _C[4]) * q + _C[5]
    den = (((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1.0
    x_tail = num / den
    x_tail = torch.where(p < 0.5, x_tail, -x_tail)
    qc = p - 0.5
    r = qc * qc
    num = (((((_A[0] * r + _A[1]) * r + _A[2]) * r + _A[3]) * r + _A[4]) * r
           + _A[5]) * qc
    den = ((((_B[0] * r + _B[1]) * r + _B[2]) * r + _B[3]) * r + _B[4]) * r + 1.0
    x_central = num / den
    central = (p >= _P_LOW) & (p <= 1.0 - _P_LOW)
    return torch.where(central, x_central, x_tail)


def uniform_from_bits(bits):
    """uint32 bits -> float32 uniform k * 2^-23 + 2^-24 in (0, 1) from the
    top 23 bits (exact)."""
    m = (_u32(bits) >> 9).to(torch.float32)
    return m * 2.0 ** -23 + 2.0 ** -24


def normal_from_bits(bits):
    return ndtri(uniform_from_bits(bits))


def normal2(k0, k1, a, b):
    """One standard-normal draw keyed by counter words (a, b)."""
    u0, _ = threefry2x32(k0, k1, a, b)
    return normal_from_bits(u0)


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _t_code(t, t0, t1):
    """30-bit fixed-point code of a float32 time within [t0, t1]."""
    t = _f32(t)
    t0, t1 = _f32(t0, t.device), _f32(t1, t.device)
    span = torch.clamp_min(t1 - t0, 1e-38)
    x = (t - t0) / span
    return (x * 2.0 ** 30).to(torch.int32).to(torch.int64) & _M32


def interval_normal(k0, k1, ta, tb, t0, t1):
    """Standard normal keyed by an interval's endpoint codes within
    [t0, t1]."""
    return normal2(k0, k1, _t_code(ta, t0, t1), _t_code(tb, t0, t1))


@dataclasses.dataclass(frozen=True)
class KernelBrownianTree:
    """Scalar Brownian path W on [t0, t1], W(t0) = 0, queryable anywhere.

    ``k0``/``k1`` are uint32 words (ints or int64 tensors that broadcast
    against the query times, e.g. (B, 1) for one path per lane)."""

    t0: object
    t1: object
    k0: object
    k1: object
    depth: int = 20

    def evaluate(self, t) -> torch.Tensor:
        """W at every time of ``t`` (float32, any shape). The bisection path
        of each time is found first, then the normals of all its levels
        are drawn in one batch, then the bridge values are combined level by
        level: the operations of the sequential walk, in another order of
        evaluation, so the values are the same."""
        t = _f32(t)
        dev = t.device
        t0, t1 = _f32(self.t0, dev), _f32(self.t1, dev)
        t = torch.minimum(torch.maximum(t, t0), t1)
        k0, k1 = _u32(self.k0, dev), _u32(self.k1, dev)
        w_right = normal2(k0, k1, 0, 0) * torch.sqrt(torch.clamp_min(t1 - t0, 0.0))
        tl, tr = torch.full_like(t, float(t0)), torch.full_like(t, float(t1))
        code = torch.zeros(t.shape, dtype=torch.int64, device=dev)
        lefts, spans, codes = [], [], []
        for _ in range(self.depth):
            tm = 0.5 * (tl + tr)
            code_m = code * 2 + 1
            go_left = t < tm
            lefts.append(go_left)
            spans.append(tr - tl)
            codes.append(code_m)
            tl = torch.where(go_left, tl, tm)
            tr = torch.where(go_left, tm, tr)
            code = torch.where(go_left, code_m, code * 2 + 2)
        z = normal2(k0[..., None], k1[..., None], torch.stack(codes, dim=-1), 0)
        wl = torch.zeros_like(t)
        wr = torch.broadcast_to(w_right, t.shape)
        for d in range(self.depth):
            wm = 0.5 * (wl + wr) + 0.5 * torch.sqrt(spans[d]) * z[..., d]
            wl = torch.where(lefts[d], wl, wm)
            wr = torch.where(lefts[d], wm, wr)
        pos = tr > tl
        frac = torch.where(pos, (t - tl) / torch.where(pos, tr - tl, 1.0), 0.0)
        return wl + frac * (wr - wl)
