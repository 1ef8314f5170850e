"""Port parity: ``columnflow_torch`` config, models and WTA data against
``columnflow``.

Anatomy is numpy on both sides and must agree bit for bit. ``build_wta``'s
random perturbation comes from ``jax.random`` on one side and a
``torch.Generator`` on the other, so only its two random entries may
differ. Drift tolerance: 1e-6 of the sum of the absolute terms of each
component (``_drift_scale``). The membrane derivative sums 16 recurrent
terms of both signs that cancel to as little as 1e-5 of their size, so a
plain relative bound would measure the cancellation; the terms themselves
differ by XLA's tanh being a few ulp off torch's (test_torch_ops.py), and
the sum is taken in another order. Measured: 7.1e-7 of the scale. The
drift inputs keep v - a out of the band |48(v - a) - 981| < 112 where the
firing rate itself loses digits to cancellation (test_torch_ops.py holds it
there with a tolerance that follows the conditioning), apart from one
population exactly at the singularity, where both sides give 1/d.
Wong-Wang rtol 1e-5: 153 explicit-Euler steps of the
same float32 arithmetic, 2x2 products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.data import wta_stim_three_phases as jax_stim
from columnflow.models import Stimulus as JaxStimulus
from columnflow.models import build_area_params as jax_build_area
from columnflow.models import build_wta as jax_build_wta
from columnflow.models import wta_drift as jax_wta_drift
from columnflow.models.wta import wta_lat_in_mask as jax_mask
from columnflow.models.ww import wong_wang_three_phase as jax_ww3
from columnflow_torch.config import ColumnConfig, legacy_wta_config, load_config
from columnflow_torch.convert import area_from_jax, params_from_jax
from columnflow_torch.data import make_wta_dataset, wta_stim_three_phases
from columnflow_torch.models import (
    AreaParams,
    Stimulus,
    build_area_params,
    build_wta,
    wta_diffusion,
    wta_drift,
    wta_lat_in_mask,
)
from columnflow_torch.models.ww import wong_wang_three_phase


def test_config_matches_jax():
    from columnflow.config import legacy_wta_config as jax_legacy

    assert ColumnConfig.load().__dict__.keys() == JaxConfig.load().__dict__.keys()
    for k in ("background_drive", "tau_synapse", "baseline_synaptic_strength",
              "connection_probabilities", "population_sizes"):
        assert getattr(ColumnConfig.load(), k) == getattr(JaxConfig.load(), k)
    assert ColumnConfig.load().resistance == JaxConfig.load().resistance
    assert (legacy_wta_config(ColumnConfig.load()).connection_probabilities
            == jax_legacy(JaxConfig.load()).connection_probabilities)
    assert "time_constants" in load_config()


@pytest.mark.parametrize("area,num_columns,small", [("mt", 2, True),
                                                     ("v1", 3, False)])
def test_build_area_params_bit_equal(area, num_columns, small):
    got = build_area_params(ColumnConfig.load(), area, num_columns, small_network=small)
    want = jax_build_area(JaxConfig.load(), area, num_columns, small_network=small)
    for f in AreaParams._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_lat_in_mask_equal():
    np.testing.assert_array_equal(wta_lat_in_mask(), jax_mask())


def test_build_wta_matches_except_random_entries():
    gen = torch.Generator().manual_seed(0)
    params, area = build_wta(ColumnConfig.load(), gen)
    jparams, jarea = jax_build_wta(JaxConfig.load(), jax.random.PRNGKey(0))
    got = params["recurrent_weights"].numpy()
    want = np.asarray(jparams["recurrent_weights"])
    rand = np.zeros((16, 16), bool)
    rand[1, 8] = rand[9, 0] = True
    np.testing.assert_array_equal(got[~rand], want[~rand])
    assert np.all((got[rand] >= 0.0) & (got[rand] <= 1e-3))
    np.testing.assert_array_equal(params["output_weights"].numpy(),
                                  np.asarray(jparams["output_weights"]))
    moved = area_from_jax(jarea)
    for f in AreaParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(area, f)),
                                      np.asarray(getattr(moved, f)), err_msg=f)


def _well_conditioned_state(rng, B):
    """(B, 48) states with v - a in [14, 18] or [23, 27] (|xn| > 112)."""
    x = rng.uniform(14.0, 18.0, (B, 16)) + 9.0 * (rng.uniform(size=(B, 16)) < 0.5)
    a = rng.normal(0, 2, (B, 16))
    r = rng.uniform(0, 40, (B, 16))
    return np.concatenate([x + a, a, r], axis=1).astype(np.float32)


def _drift_scale(y, s, params, area):
    """Sum of the absolute terms of each drift component, (B, 48), float64."""
    from columnflow_torch.kernels import column_step as cs

    consts, scalars = cs._area_consts(area)
    f64 = torch.float64
    return cs._drift_abs_terms(scalars, y.to(f64), s.to(f64),
                               params["recurrent_weights"].to(f64), consts.to(f64)).numpy()


@pytest.mark.parametrize("t", [0.0, 0.0123, 0.0499])
def test_wta_drift_matches_jax(t):
    jparams, jarea = jax_build_wta(JaxConfig.load(), jax.random.PRNGKey(1))
    params, area = params_from_jax(jparams), area_from_jax(jarea)
    rng = np.random.default_rng(5)
    B, T, dt = 4, 500, 1e-4
    y = _well_conditioned_state(rng, B)
    y[0, 3], y[0, 19] = 20.4375, 0.0  # population 3 at the singularity
    tables = rng.uniform(0, 40, (B, T, 16)).astype(np.float32)

    want = np.stack([
        np.asarray(jax_wta_drift(jnp.float32(t), jnp.asarray(y[b]), jparams, jarea,
                                 JaxStimulus(0.0, dt, jnp.asarray(tables[b]))))
        for b in range(B)])
    stim = Stimulus(0.0, dt, torch.from_numpy(tables).transpose(0, 1))
    got = wta_drift(torch.tensor(t, dtype=torch.float32), torch.from_numpy(y),
                    params, area, stim).numpy()
    assert np.all(np.isfinite(got))
    s = stim.table[min(int(np.floor(t / dt)), T - 1)]
    scale = _drift_scale(torch.from_numpy(y), s, params, area)
    assert np.all(np.abs(got.astype(np.float64) - want) <= 1e-6 * scale)


def test_wta_diffusion_quirk_and_membrane_only():
    y = torch.zeros(3, 48)
    g = wta_diffusion(0.0, y, None, None, None)
    assert torch.all(g == 100.0)
    gm = wta_diffusion(0.0, y, None, None, None, membrane_only=True)
    assert torch.all(gm[:, :16] == 100.0) and torch.all(gm[:, 16:] == 0.0)


def test_wong_wang_three_phase_matches_jax():
    mus = [(20.0, 35.0), (40.0, 25.0)]
    got = wong_wang_three_phase(torch.tensor([m[0] for m in mus]),
                                torch.tensor([m[1] for m in mus]),
                                phase_time=0.05).numpy()
    want = np.stack([np.asarray(jax_ww3(jax.random.PRNGKey(0), jnp.float32(a),
                                        jnp.float32(b), phase_time=0.05))
                     for a, b in mus])
    assert got.shape == want.shape == (2, 153, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_wta_stim_three_phases_exact():
    stims = np.array([[18.5, 31.25], [40.0, 22.0]], np.float32)
    for T in (300, 1500):
        got = wta_stim_three_phases(torch.from_numpy(stims), T).numpy()
        want = np.stack([np.asarray(jax_stim(jnp.asarray(s), T)) for s in stims])
        np.testing.assert_array_equal(got, want)


def test_make_wta_dataset_shapes_and_ranges():
    gen = torch.Generator().manual_seed(3)
    states, stims = make_wta_dataset(gen, 5, 15, phase_time=0.05)
    assert states.shape == (5, 15, 2) and stims.shape == (5, 2)
    lo, hi = stims.min(dim=1).values, stims.max(dim=1).values
    assert torch.all((lo >= 15.0) & (lo <= 25.0))
    assert torch.all((hi - lo >= 10.0) & (hi - lo <= 20.0))
    assert torch.isfinite(states).all()
