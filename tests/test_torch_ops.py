"""Port parity: ``columnflow_torch.ops`` against ``columnflow.ops``.

Same float32 inputs (numpy, seeded) through both packages.

Tolerance of the transfer function and its gradient: rel 1e-6, plus what
the two libraries' tanh and exp may differ by. XLA's CPU tanh is a rational
approximation off by up to 3.6 ulp (measured against float64), torch's by
0.52 ulp. With a = 80 tanh(-d xn / 80) and e = exp(a), k ulp of tanh and exp
move e by de = k 2**-24 (1 + |a|) |e|; phi = xn / (1 - e) then moves by
de / |1 - e| relative, which grows without bound at the removable
singularity where 1 - e cancels, and phi' = 48 num / (1 - e)**2 with
num = (1 - e) - xn e d (1 - th**2) by de (1 + |xn d (1 - th**2)|) / |num| +
2 de / |1 - e|. ``_fr_tol`` adds these terms with k = 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.ops import interp_at as jax_interp_at
from columnflow.ops import losses as jax_losses
from columnflow.ops import transfer as jax_transfer
from columnflow_torch.ops import interp, losses, transfer

SING = np.float32(981.0 / 48.0)  # 20.4375 exactly: 48 x - 981 == 0


def _fr_inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(10.0, 30.0, 256).astype(np.float32)
    special = np.array([SING, np.nextafter(SING, np.float32(np.inf)),
                        np.nextafter(SING, np.float32(-np.inf)), 0.0, -50.0,
                        100.0], dtype=np.float32)
    return np.concatenate([x, special])


def _fr_tol(x, grad=False):
    """Per-element relative tolerance (see the module docstring)."""
    xn = 48.0 * x.astype(np.float64) - 981.0
    th = np.tanh(-0.0089 * xn / 80.0)
    a = 80.0 * th
    e = np.exp(a)
    den = np.maximum(np.abs(1.0 - e), 1e-300)
    de = 8 * 2.0 ** -24 * (1.0 + np.abs(a)) * e
    if not grad:
        return 1e-6 + de / den
    slope = xn * e * 0.0089 * (1.0 - th * th)
    num = np.maximum(np.abs((1.0 - e) - slope), 1e-300)
    return 1e-6 + de * (1.0 + np.abs(slope / e)) / num + 2.0 * de / den


def _assert_close_fr(got, want, x, grad=False):
    sing = 48.0 * x.astype(np.float64) - 981.0 == 0.0
    np.testing.assert_array_equal(got[sing], want[sing])
    rel = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1e-30)
    tol = _fr_tol(x, grad)
    bad = ~sing & ~(rel <= tol)
    assert not bad.any(), (x[bad], rel[bad], tol[bad])


def test_firing_rate_values_match_jax():
    x = _fr_inputs()
    want = np.asarray(jax_transfer.compute_firing_rate(jnp.asarray(x)))
    got = transfer.compute_firing_rate(torch.from_numpy(x)).numpy()
    _assert_close_fr(got, want, x)
    # The removable singularity: the guarded limit 1/d, on both sides.
    assert got[256] == np.float32(1.0 / transfer.NOISE_D)


def test_firing_rate_gradient_matches_jax_grad():
    x = _fr_inputs()
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jax_transfer.compute_firing_rate(v)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    transfer.compute_firing_rate(xt).sum().backward()
    got = xt.grad.numpy()
    assert np.all(np.isfinite(got))
    _assert_close_fr(got, want, x, grad=True)


def test_hand_derived_derivative_at_singularity():
    """The kernels' plain ``_fr_and_grad`` takes the limits phi = 1/d and
    phi' = 48/2 = 24 at the singularity (autograd through the guard gives 0
    there on both sides, which the test above pins)."""
    from columnflow_torch.kernels.column_step import _fr_and_grad

    fr, frp = _fr_and_grad(torch.tensor([SING]))
    assert fr.item() == np.float32(1.0 / 0.0089)
    assert frp.item() == 24.0


def test_soft_clamp_matches_jax():
    x = np.random.default_rng(1).normal(0, 100, 512).astype(np.float32)
    want = np.asarray(jax_transfer.soft_clamp(jnp.asarray(x)))
    got = transfer.soft_clamp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("x", [0.0, 3.3e-5, 1.0e-4, 0.0299, 0.03, 0.05])
def test_interp_at_matches_jax(x):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(300, 16)).astype(np.float32)
    dt = float(np.float32(1.0003344e-4))
    want = np.asarray(jax_interp_at(jnp.float32(x), 0.0, dt, jnp.asarray(table)))
    got = interp.interp_at(torch.tensor(x, dtype=torch.float32), 0.0, dt,
                           torch.from_numpy(table)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_smooth_l1_and_wta_loss_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.normal(0, 2, (3, 50, 2)).astype(np.float32)
    true = rng.normal(0, 2, (3, 50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.smooth_l1(torch.from_numpy(pred), torch.from_numpy(true))),
        float(jax_losses.smooth_l1(jnp.asarray(pred), jnp.asarray(true))),
        rtol=1e-6)
    states = np.concatenate([rng.uniform(15, 25, (3, 50, 16)),
                             rng.uniform(-1, 1, (3, 50, 32))],
                            axis=-1).astype(np.float32)
    ow = rng.normal(size=8).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.huber_trajectory_loss_wta(
            torch.from_numpy(states), torch.from_numpy(true), torch.from_numpy(ow))),
        float(jax_losses.huber_trajectory_loss_wta(
            jnp.asarray(states), jnp.asarray(true), jnp.asarray(ow))),
        rtol=1e-6)


def test_min_max_and_fr_to_binary_match_jax():
    fr = np.random.default_rng(4).uniform(0, 40, 64).astype(np.float32)
    np.testing.assert_allclose(losses.min_max(torch.from_numpy(fr)).numpy(),
                               np.asarray(jax_losses.min_max(jnp.asarray(fr))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        losses.fr_to_binary(torch.from_numpy(fr), 2.0).numpy(),
        np.asarray(jax_losses.fr_to_binary(jnp.asarray(fr), 2.0)),
        rtol=1e-6, atol=1e-7)
