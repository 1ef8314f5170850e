"""Port parity: ``columnflow_torch.kernels.column_step`` (the plain PyTorch
versions of the CUDA kernels, and the ``torch.autograd.Function`` around
them) against ``columnflow.kernels.column_step``'s Pallas kernels run in
interpret mode.

Same parameters (``convert.params_from_jax``), stimulus and Brownian pack
(numpy, seeded) on both sides. The kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against these plain versions there.
Each tolerance is stated at its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.data import wta_stim_three_phases as jax_stim
from columnflow.kernels import column_step as jcs
from columnflow.models import build_wta as jax_build_wta
from columnflow.ops.losses import huber_trajectory_loss_wta as jax_loss
from columnflow_torch.convert import area_from_jax, params_from_jax
from columnflow_torch.data import wta_stim_three_phases
from columnflow_torch.kernels import column_step as cs
from columnflow_torch.ops.losses import huber_trajectory_loss_wta
from columnflow_torch.tasks.wta import linspace

DT = 1e-4


def _setup(B, T, seed=0):
    jparams, jarea = jax_build_wta(JaxConfig.load(), jax.random.PRNGKey(seed))
    ts = np.array(jnp.linspace(0.0, T * DT, T))
    h = np.float32(ts[1] - ts[0])
    rng = np.random.default_rng(seed + 100)
    stims = np.stack([rng.uniform(15, 25, B), rng.uniform(25, 45, B)], -1).astype(np.float32)
    z1, z2 = rng.normal(size=(2, T - 1, B)).astype(np.float32)
    i1 = (np.sqrt(h) * z1).astype(np.float32)
    i10 = (h * (0.5 * i1 + np.sqrt(h / 12) * z2)).astype(np.float32)
    return dict(jparams=jparams, jarea=jarea, params=params_from_jax(jparams),
                area=area_from_jax(jarea), ts=ts, stims=stims, i1=i1, i10=i10,
                tables=np.stack([np.asarray(jax_stim(jnp.asarray(s), T)) for s in stims]))


def test_plain_drift_matches_pallas_drift():
    """Tolerance: 1e-6 of each component's sum of absolute terms (the
    recurrent sum cancels; see test_torch_models.py), with v - a kept out of
    the firing rate's ill-conditioned band except one population exactly at
    the singularity."""
    from test_torch_models import _drift_scale, _well_conditioned_state

    d = _setup(B=4, T=30)
    y = _well_conditioned_state(np.random.default_rng(7), 4)
    y[1, 5], y[1, 21] = 20.4375, 0.0  # singular population
    s = np.ascontiguousarray(d["tables"][:, 12, :])
    want = np.asarray(jcs.fused_drift(jnp.asarray(y), jnp.asarray(s), d["jparams"],
                                      d["jarea"], interpret=True))
    got = cs.fused_drift(torch.from_numpy(y), torch.from_numpy(s), d["params"],
                         d["area"]).numpy()
    assert np.all(np.isfinite(got))
    scale = _drift_scale(torch.from_numpy(y), torch.from_numpy(s), d["params"], d["area"])
    assert np.all(np.abs(got.astype(np.float64) - want) <= 1e-6 * scale)


@pytest.mark.parametrize("membrane_only", [False, True])
def test_plain_forward_matches_pallas_rollout(membrane_only):
    """Tolerance: 1e-5 of each component's largest magnitude over the run;
    the same float32 SRA1 stages on both sides, differing by XLA's tanh and
    the order of the recurrent sum over 199 steps (measured 2.6e-6)."""
    B, T = 3, 200
    d = _setup(B, T, seed=1)
    want = np.asarray(jcs.wta_rollout_fused(
        d["jparams"], d["jarea"], jnp.asarray(d["tables"]), jnp.asarray(d["ts"]),
        jnp.asarray(d["i1"]), jnp.asarray(d["i10"]), membrane_only=membrane_only,
        interpret=True))
    got = cs.wta_rollout_fused(d["params"], d["area"], torch.from_numpy(d["tables"]),
                               torch.from_numpy(d["ts"]), torch.from_numpy(d["i1"]),
                               torch.from_numpy(d["i10"]),
                               membrane_only=membrane_only).numpy()
    assert got.shape == want.shape == (B, T, 48)
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


def test_autograd_function_matches_pallas_custom_vjp():
    """Loss rtol 1e-4 (measured 7.0e-7). Gradient: relative L2 error below
    1e-5 (measured 8.3e-7). The JAX suite allows 0.05 between the fused and
    the scan paths, which are different algorithms; this pair runs one
    algorithm, the same hand-derived reverse sweep, in float32 on both
    sides."""
    B, T = 3, 150
    d = _setup(B, T, seed=2)
    true = np.random.default_rng(3).uniform(0.0, 1.5, (B, T, 2)).astype(np.float32)
    rollout_j = jcs.make_wta_rollout_diff(d["jarea"], jnp.asarray(d["ts"]), interpret=True)

    def loss_j(w):
        return jax_loss(rollout_j(w, jnp.asarray(d["tables"]), jnp.asarray(d["i1"]),
                                  jnp.asarray(d["i10"])),
                        jnp.asarray(true), d["jparams"]["output_weights"])

    lj, gj = jax.value_and_grad(loss_j)(d["jparams"]["recurrent_weights"])

    rollout = cs.make_wta_rollout_diff(d["area"], torch.from_numpy(d["ts"]))
    w = d["params"]["recurrent_weights"].clone().requires_grad_(True)
    loss = huber_trajectory_loss_wta(
        rollout(w, torch.from_numpy(d["tables"]), torch.from_numpy(d["i1"]),
                torch.from_numpy(d["i10"])),
        torch.from_numpy(true), d["params"]["output_weights"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-4)
    g, gj = w.grad.numpy().astype(np.float64), np.asarray(gj, np.float64)
    assert np.all(np.isfinite(g))
    assert np.linalg.norm(g - gj) < 1e-5 * np.linalg.norm(gj)


def test_hand_derived_backward_matches_autograd_float64():
    """``_rollout_bwd_plain`` against torch autograd through
    ``_rollout_fwd_plain``, both in float64: the hand-derived algebra must
    agree with the chain rule to rel 1e-9 (elementwise, with atol 1e-9 of
    the largest entry)."""
    B, T = 3, 60
    d = _setup(B, T, seed=3)
    f64 = torch.float64
    area = d["area"]
    consts = torch.stack([area.background_current, area.feedforward_weights,
                          area.adaptation_strength]).to(f64)
    scalars = (area.tau_syn, area.tau_mem, area.tau_adapt, area.resistance)
    h = float(d["ts"][1] - d["ts"][0])
    g = torch.full((1, 48), 100.0, dtype=f64)
    rng = np.random.default_rng(4)
    y0 = torch.from_numpy(np.concatenate(
        [rng.uniform(14, 18, (B, 16)), rng.normal(0, 1, (B, 32))], 1)).requires_grad_(True)
    w = d["params"]["recurrent_weights"].to(f64).requires_grad_(True)
    stim = torch.from_numpy(d["tables"]).transpose(0, 1).to(f64).contiguous()
    i1 = torch.from_numpy(d["i1"]).to(f64)
    i10 = torch.from_numpy(d["i10"]).to(f64)
    cot = torch.from_numpy(rng.normal(size=(T, B, 48)))

    ys = cs._rollout_fwd_plain(h, scalars, w, consts, g, y0, stim, i1, i10)
    gw, gy0 = torch.autograd.grad((ys * cot).sum(), [w, y0])
    cout, wbar = cs._rollout_bwd_plain(h, scalars, w.detach(), consts, g, stim, i10,
                                       ys.detach()[:-1], cot[:-1], cot[-1])
    for got, want in ((wbar, gw), (cout, gy0)):
        want = want.numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_no_gradient_for_data_inputs():
    B, T = 2, 40
    d = _setup(B, T, seed=4)
    rollout = cs.make_wta_rollout_diff(d["area"], torch.from_numpy(d["ts"]))
    w = d["params"]["recurrent_weights"].clone().requires_grad_(True)
    tables = torch.from_numpy(d["tables"]).requires_grad_(True)
    i1 = torch.from_numpy(d["i1"]).requires_grad_(True)
    i10 = torch.from_numpy(d["i10"]).requires_grad_(True)
    out = rollout(w, tables, i1, i10)
    grads = torch.autograd.grad(out[..., :16].sum(), [w, tables, i1, i10],
                                allow_unused=True, materialize_grads=True)
    assert torch.any(grads[0] != 0)
    for gr in grads[1:]:
        assert torch.all(gr == 0)


def test_wrappers_check_their_inputs():
    d = _setup(B=2, T=10)
    consts, scalars = cs._area_consts(d["area"])
    w = d["params"]["recurrent_weights"]
    y = torch.zeros(2, 48)
    with pytest.raises(ValueError, match="float32"):
        cs.drift(scalars, y.double(), torch.zeros(2, 16), w, consts)
    with pytest.raises(ValueError, match="shape"):
        cs.drift(scalars, y, torch.zeros(3, 16), w, consts)
    with pytest.raises(ValueError, match="contiguous"):
        cs.drift(scalars, torch.zeros(48, 2).T, torch.zeros(2, 16), w, consts)


def test_auto_chunk_matches_jax():
    for b in (1, 15, 60, 1152):
        assert cs.auto_chunk(b) == jcs.auto_chunk(b)


def test_reference_rollout_matches_plain_forward():
    """``wta_rollout_reference`` (the solver path) against the plain kernel
    version: the SRA1 noise terms are (i1 - i10/h) g + (i10/h) g in one and
    i1 g in the other, and the mid-stage stimulus is interpolated from the
    stage time in one and blended from two rows in the other; tolerance
    1e-5 of each component's largest magnitude (measured 1.1e-6)."""
    B, T = 2, 120
    d = _setup(B, T, seed=5)
    args = (d["params"], d["area"], torch.from_numpy(d["tables"]),
            linspace(0.0, T * DT, T), torch.from_numpy(d["i1"]),
            torch.from_numpy(d["i10"]))
    ref = cs.wta_rollout_reference(*args).numpy()
    fused = cs.wta_rollout_fused(*args).numpy()
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert np.all(np.abs(fused - ref) <= 1e-5 * scale)
