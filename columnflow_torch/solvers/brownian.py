"""Brownian-motion sampling on ``jax.random`` keys (port of
``columnflow/solvers/brownian.py``).

Noise is a pure function of (key, location), drawn with the port's
``jax.random`` (``solvers.jrandom``), so for the same key both packages
realise the same path:

- ``normal``, ``step_increments``: draws keyed by a step counter, and the
  increments of a fixed grid;
- ``VirtualBrownianTree``: W(t) at any time by a fixed-depth Brownian-bridge
  bisection of [t0, t1], every bisection's normal keyed by ``fold_in(key,
  code)``; ``evaluate`` takes a tensor of times at once (and keys with
  leading lane axes), which the adaptive solver's replay needs;
- ``BrownianInterval`` / ``brownian_path``: torchsde's path object over the
  tree, with ``space_time`` and ``pack``.

Keys are int64 tensors (..., 2) of uint32 key data (``jrandom``). Times are
float32, and every operation on them rounds as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from columnflow_torch.ops.arith import div
from columnflow_torch.solvers import jrandom


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def normal(key, step, shape=()) -> torch.Tensor:
    """Standard-normal draw keyed by a step counter."""
    return jrandom.normal(jrandom.fold_in(key, step), shape)


def step_increments(key, num_steps: int, hs, shape=()) -> torch.Tensor:
    """All Brownian increments dW_i ~ N(0, h_i) of a fixed grid: hs
    (num_steps,) -> (num_steps,) + shape."""
    shape = tuple(shape)
    z = jrandom.normal(key, (num_steps,) + shape)
    hs = _f32(hs, z.device).reshape((num_steps,) + (1,) * len(shape))
    return torch.sqrt(hs) * z


@dataclasses.dataclass(frozen=True)
class VirtualBrownianTree:
    """Reproducible scalar Brownian path W on [t0, t1], W(t0) = 0.

    ``key``: (..., 2) key words; its leading axes broadcast against the
    query times, e.g. (B, 1, 2) for one path per lane and (B, n) times.
    ``depth`` bisections; below (t1 - t0) / 2^depth queries interpolate
    linearly. Only the scalar path (``shape=()``) is ported: the SDE solvers
    take one Brownian per lane."""

    t0: object
    t1: object
    key: object
    depth: int = 20

    def evaluate(self, t) -> torch.Tensor:
        """W at every time of ``t`` (float32, any shape broadcasting with the
        key's leading axes). The bisection path of each time is found first,
        then the normals of all its levels are drawn in one batch, then the
        bridge values are combined level by level: the operations of the
        JAX package's sequential walk, in another order of evaluation, so
        the values are the same."""
        key = torch.as_tensor(self.key, dtype=torch.int64)
        t = _f32(t, key.device)
        t0, t1 = _f32(self.t0, t.device), _f32(self.t1, t.device)
        t = torch.minimum(torch.maximum(t, t0), t1)
        shape = torch.broadcast_shapes(t.shape, key.shape[:-1])
        t = t.expand(shape)
        key = key.expand(shape + (2,))
        if torch.is_tensor(self.t0) or torch.is_tensor(self.t1):
            span = t1 - t0
        else:  # Python numbers subtract in double, as in the JAX package
            span = _f32(self.t1 - self.t0, t.device)
        w_right = jrandom.normal(jrandom.fold_in(key, 0)) * torch.sqrt(span)
        tl, tr = t0.expand(shape), t1.expand(shape)
        code = torch.zeros(shape, dtype=torch.int64, device=t.device)
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
        z = jrandom.normal(jrandom.fold_in(key[..., None, :], torch.stack(codes, dim=-1)))
        wl = torch.zeros_like(t)
        wr = w_right
        for d in range(self.depth):
            wm = 0.5 * (wl + wr) + (0.5 * torch.sqrt(spans[d])) * z[..., d]
            wl = torch.where(lefts[d], wl, wm)
            wr = torch.where(lefts[d], wm, wr)
        pos = tr > tl
        frac = torch.where(pos, (t - tl) / torch.where(pos, tr - tl, 1.0), 0.0)
        return wl + frac * (wr - wl)

    def increment(self, ta, tb) -> torch.Tensor:
        """W(tb) - W(ta)."""
        return self.evaluate(tb) - self.evaluate(ta)


def _fold_time(key, t) -> torch.Tensor:
    """Fold a float32 time's bit pattern into a key."""
    key = torch.as_tensor(key, dtype=torch.int64)
    return jrandom.fold_in(key, jrandom.float_bits(_f32(t, key.device)))


def interval_normal(key, ta, tb) -> torch.Tensor:
    """A standard normal keyed by an interval's endpoints: the normal of
    the key with the bit patterns of ta, then tb, folded in (the JAX
    package's ``_interval_normal`` and ``BrownianInterval``'s space-time
    draws). Key and times broadcast."""
    return jrandom.normal(_fold_time(_fold_time(key, ta), tb))


@dataclasses.dataclass(frozen=True)
class BrownianInterval:
    """torchsde-style scalar Brownian sample path over [t0, t1], backed by
    the ``VirtualBrownianTree`` of the first key of ``split(key)`` (or of
    ``PRNGKey(entropy)``). ``bm(t)`` is W(t), ``bm(ta, tb)`` W(tb) - W(ta);
    with ``levy_area_approximation`` "space-time" (or "davie"/"foster"),
    ``space_time`` gives (W increment, U) with U's conditional draw keyed by
    the interval's endpoints, and ``pack(ts)`` the per-step integrals
    (I1, I10, I11, I111). The Levy-area pack of the log-ODE scheme
    (``pack_levy``) is not ported (ROADMAP.md A8)."""

    t0: float = 0.0
    t1: float = 1.0
    shape: tuple = ()
    entropy: int = 0
    key: object = None
    levy_area_approximation: str = "none"
    depth: int = 24

    def __post_init__(self):
        if tuple(self.shape) != ():
            raise NotImplementedError(
                "BrownianInterval is ported for a scalar path (shape ()); general noise "
                "channels go with the solver surface (ROADMAP.md A8)")

    def _keys(self):
        base = self.key if self.key is not None else jrandom.prng_key(self.entropy)
        ks = jrandom.split(base)
        return ks[..., 0, :], ks[..., 1, :]

    def _tree(self):
        return VirtualBrownianTree(self.t0, self.t1, self._keys()[0], self.depth)

    def __call__(self, ta, tb=None):
        tree = self._tree()
        if tb is None:
            return tree.evaluate(ta)
        return tree.increment(ta, tb)

    def _has_space_time(self):
        if self.levy_area_approximation not in ("space-time", "davie", "foster"):
            raise ValueError(
                "space_time queries need levy_area_approximation='space-time' (torchsde "
                "raises the same way when the approximation level is too low)")

    def space_time(self, ta, tb):
        """(W increment, space-time integral U) over [ta, tb]."""
        self._has_space_time()
        k_u = self._keys()[1]
        w = self(ta, tb)
        h = _f32(tb) - _f32(ta)
        z = interval_normal(k_u, ta, tb)
        return w, h * (0.5 * w + torch.sqrt(div(h, 12.0)) * z)

    def pack(self, ts):
        """Per-step integrals (I1, I10, I11, I111) on the grid ``ts``; I10
        is zero without a space-time approximation."""
        ts = _f32(ts)
        ws = self(ts)
        i1 = ws[1:] - ws[:-1]
        hs = ts[1:] - ts[:-1]
        if self.levy_area_approximation in ("space-time", "davie", "foster"):
            k_u = self._keys()[1]
            z = interval_normal(k_u, ts[:-1], ts[1:])
            i10 = hs * (0.5 * i1 + torch.sqrt(div(hs, 12.0)) * z)
        else:
            i10 = torch.zeros_like(i1)
        i11 = 0.5 * (i1 * i1 - hs)
        i111 = div(i1 * i1 * i1 - 3.0 * hs * i1, 6.0)
        return i1, i10, i11, i111

    def pack_levy(self, ts):
        raise NotImplementedError(
            "the Levy-area pack of the log-ODE scheme is not ported (ROADMAP.md A8: "
            "solvers/levy.py)")


def brownian_path(t0, t1, shape=(), entropy=0, key=None, depth=24) -> BrownianInterval:
    """torchsde's ``BrownianPath``/``BrownianTree`` constructors: a
    ``BrownianInterval`` with the space-time approximation."""
    return BrownianInterval(t0=t0, t1=t1, shape=shape, entropy=entropy, key=key, depth=depth,
                            levy_area_approximation="space-time")
