"""Port parity: ``columnflow_torch.solvers.sdeint`` (SRA1, scalar additive
noise) against ``columnflow.solvers.sdeint`` on the WTA drift.

Both sides get the same parameters (``convert.params_from_jax``), the same
grid and the same Brownian pack (i1, i10), made with numpy from a seed.
JAX integrates each lane by itself (as ``vmap`` would); the port takes the
lanes as a leading axis of y0 and noise of shape (T-1, B).

Tolerance: see ``test_sra1_matches_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.data import wta_stim_three_phases as jax_stim
from columnflow.models import Stimulus as JaxStimulus
from columnflow.models import build_wta as jax_build_wta
from columnflow.models import wta_diffusion as jax_diffusion
from columnflow.models import wta_drift as jax_drift
from columnflow.solvers import sdeint as jax_sdeint
from columnflow_torch.convert import area_from_jax, params_from_jax
from columnflow_torch.data import wta_stim_three_phases
from columnflow_torch.models import Stimulus, wta_diffusion, wta_drift
from columnflow_torch.solvers import brownian_pack, sdeint
from columnflow_torch.tasks.wta import linspace

T, B, DT = 300, 3, 1e-4


def _noise(ts, seed=11):
    """i1 = sqrt(h) z1, i10 = h (i1/2 + sqrt(h/12) z2), (T-1, B) float32."""
    h = np.diff(np.asarray(ts, np.float32)).astype(np.float32)[:, None]
    z1, z2 = np.random.default_rng(seed).normal(size=(2, len(h), B)).astype(np.float32)
    i1 = (np.sqrt(h) * z1).astype(np.float32)
    i10 = (h * (0.5 * i1 + np.sqrt(h / 12.0) * z2)).astype(np.float32)
    return i1, i10


def test_linspace_matches_jnp_linspace():
    for n in (T, 1500):
        want = np.asarray(jnp.linspace(0.0, n * DT, n))
        got = linspace(0.0, n * DT, n).numpy()
        np.testing.assert_array_equal(got, want)


def test_sra1_matches_jax():
    """Trajectories agree to rtol 1e-5 relative to each component's largest
    magnitude over the run (atol = 1e-5 * max|y|). Both sides take the same
    SRA1 stages in float32; the differences are XLA's tanh (a few ulp off
    torch's) and the 16-term recurrent sum's order, carried through 299
    steps. Measured: 2.5e-6 of max|y|."""
    jparams, jarea = jax_build_wta(JaxConfig.load(), jax.random.PRNGKey(2))
    params, area = params_from_jax(jparams), area_from_jax(jarea)
    ts_j = jnp.linspace(0.0, T * DT, T)
    dt = float(ts_j[1] - ts_j[0])
    stims = np.array([[20.0, 32.0], [35.0, 22.5], [18.0, 30.0]], np.float32)
    i1, i10 = _noise(np.asarray(ts_j))

    def one(b):
        table = jax_stim(jnp.asarray(stims[b]), T)
        stim = JaxStimulus(0.0, dt, table)
        z = jnp.zeros(T - 1)
        return jax_sdeint(
            lambda t, y: jax_drift(t, y, jparams, jarea, stim),
            lambda t, y: jax_diffusion(t, y, jparams, jarea, stim),
            jnp.zeros(48), ts_j, jax.random.PRNGKey(0), method="srk",
            additive=True, noise="scalar",
            noise_pack=(jnp.asarray(i1[:, b]), jnp.asarray(i10[:, b]), z, z))

    want = np.stack([np.asarray(one(b)) for b in range(B)], axis=1)  # (T, B, 48)

    ts = linspace(0.0, T * DT, T)
    stim = Stimulus(0.0, dt, wta_stim_three_phases(torch.from_numpy(stims), T).transpose(0, 1))
    got = sdeint(lambda t, y: wta_drift(t, y, params, area, stim),
                 lambda t, y: wta_diffusion(t, y, params, area, stim),
                 torch.zeros(B, 48), ts, None, method="srk", additive=True,
                 noise="scalar",
                 noise_pack=(torch.from_numpy(i1), torch.from_numpy(i10), None, None)).numpy()
    assert got.shape == want.shape == (T, B, 48)
    assert np.all(np.isfinite(got))
    scale = np.abs(want).max(axis=0, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


def test_brownian_pack_moments():
    gen = torch.Generator().manual_seed(0)
    ts = linspace(0.0, 2000 * DT, 2000)
    hs, i1, i10, i11, i111 = brownian_pack(gen, ts, (64,))
    assert i1.shape == i10.shape == (1999, 64)
    h = float(hs.mean())
    assert abs(float(i1.var()) / h - 1.0) < 0.05
    # E[I10^2] = h^3/3, E[I1 I10] = h^2/2.
    assert abs(float((i10 * i10).mean()) / (h ** 3 / 3) - 1.0) < 0.05
    assert abs(float((i1 * i10).mean()) / (h ** 2 / 2) - 1.0) < 0.05
    np.testing.assert_allclose(i11.numpy(), 0.5 * (i1 * i1 - hs[:, None]).numpy())


def test_unported_methods_raise():
    y0 = torch.zeros(2, 3)
    ts = torch.linspace(0, 1, 5)
    for kw in ({"method": "euler", "additive": True}, {"method": "srk", "additive": False},
               {"method": "srk", "additive": True, "noise": "diagonal"}):
        with pytest.raises(NotImplementedError):
            sdeint(lambda t, y: y, lambda t, y: y, y0, ts, torch.Generator(), **kw)
