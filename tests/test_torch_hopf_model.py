"""Port parity: the Hopf models (``columnflow_torch.models.hopf``), the
ground-truth dataset (``data._hopf_solve``, ``solvers.dopri``) and the fused
dopri5 engine on the MLP drift (``kernels.hopf_ode``,
``solvers.fused.hopf_odeint_dopri5_fused``) against ``columnflow.models.
hopf``, ``columnflow.data`` and the JAX package's ``odeint_dopri5_fused``
traced with ``hopf_mlp_drift`` and ``interp_at_onehot``.

Size: the MLP at sizes (3, 16, 16, 16, 2), 8 lanes, 100 grid points over
2.5 s, max_steps 512 (a multiple of the replay chunk, 256). The parameters come
from ``columnflow.models.build_hopf_mlp`` (biases drawn from numpy, so that
they are not all zero) and move across with ``convert.hopf_params_from_jax``;
start points, phases and the mu table are drawn with numpy. The JAX kernels
run in interpret mode; on the CPU the port runs its plain versions.

What can be held and how: the port's products are float64 sums rounded
once, JAX's are float32 HIGHEST products, an ulp or two apart per layer.
At rtol 1e-7 an accepted step's error estimate is float32 noise, so the
whole selection is held by its counts and the replay on JAX's own grid.
Tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from columnflow import data as jdata
from columnflow.models import hopf as jh
from columnflow.models.column import Stimulus as JStim
from columnflow.ops.interp import interp_at_onehot as j_onehot
from columnflow.solvers import fused as jf
from columnflow_torch import data as tdata
from columnflow_torch.convert import frozen_grid_from_jax, hopf_params_from_jax
from columnflow_torch.kernels import hopf_ode as ho
from columnflow_torch.kernels.network_ode import ODESelectConfig, step_with_coeffs
from columnflow_torch.models import hopf as th
from columnflow_torch.models.column import Stimulus
from columnflow_torch.ops.interp import interp_at_onehot
from columnflow_torch.solvers import fused as tf
from columnflow_torch.solvers.dopri import odeint_dopri5_lanes

SIZES = (3, 16, 16, 16, 2)
T, B, M, SPAN = 100, 8, 512, 2.5


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scaled(got, want):
    """Largest |got - want| over each state component's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).reshape(-1, want.shape[-1]).max(0), 1e-30)
    return float((np.abs(got - want) / scale).max())


def jax_params(seed=0, sizes=SIZES):
    """JAX's MLP for the key, with biases drawn from numpy."""
    params = jh.build_hopf_mlp(jax.random.PRNGKey(seed), sizes)
    rng = np.random.default_rng(seed + 100)
    return [{"w": layer["w"], "b": jnp.asarray(rng.normal(0.0, 0.05, layer["b"].shape),
                                              jnp.float32)} for layer in params]


def inputs(seed=1, n=B, t_points=T, span=SPAN):
    """(ts, dt, y0 (n, 2), mu table (t_points, n)) drawn with numpy."""
    rng = np.random.default_rng(seed)
    ts = np.asarray(jnp.linspace(0.0, span, t_points))
    y0 = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    phases = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    mu = np.sin(ts[:, None] * np.float32(0.25) + phases[None]).astype(np.float32)
    return ts, float(ts[1] - ts[0]), y0, mu


def jax_drift(dt):
    """The drift closure of ``columnflow/tasks/bifurcation.py:61-68``."""
    def drift(t, y, p, mu_tab):
        return jh.hopf_mlp_drift(t, y, p, JStim(0.0, dt, mu_tab), interp_fn=j_onehot)

    return drift


def jax_select(params, mu, y0, ts, dt, max_steps=M):
    """The adaptive kernel's (step_times, stats), built as
    ``odeint_dopri5_fused`` builds the call (interpret mode)."""
    func, prep, dyn, _ = jf._flatten_for_kernel(jax_drift(dt), (params, jnp.asarray(mu)), (1,))
    M_r = tf.round_max_steps(y0.shape, max_steps)
    call = pl.pallas_call(
        jf._make_adaptive_kernel(func, prep, len(dyn), float(ts[0]), float(ts[-1]), 1e-7, 1e-9,
                                 None, M_r),
        out_shape=(jax.ShapeDtypeStruct((M_r + 1,), jnp.float32),
                   jax.ShapeDtypeStruct((3,), jnp.int32)),
        in_specs=[jf._VMEM()] * (1 + len(dyn)),
        out_specs=(pl.BlockSpec(memory_space=pltpu.SMEM),) * 2,
        interpret=True)
    return call(jnp.asarray(y0), *dyn)


def jax_fused(params, mu, y0, ts, dt, max_steps=M):
    return jf.odeint_dopri5_fused(jax_drift(dt), jnp.asarray(y0), jnp.asarray(ts), params,
                                  jnp.asarray(mu), max_steps=max_steps, nondiff_args=(1,),
                                  interpret=True)


@pytest.fixture(scope="module")
def setup():
    jp = jax_params()
    ts, dt, y0, mu = inputs()
    params = hopf_params_from_jax([{k: np.asarray(v) for k, v in layer.items()} for layer in jp])
    return dict(jp=jp, params=params, ts=ts, dt=dt, y0=y0, mu=mu,
                tmu=ho.MuTable(torch.as_tensor(mu), 0.0, dt))


@pytest.fixture(scope="module")
def jax_grid(setup):
    s = setup
    st, stats = jax_select(s["jp"], s["mu"], s["y0"], s["ts"], s["dt"])
    return np.asarray(st), np.asarray(stats)


def test_build_hopf_mlp_shapes_and_init():
    params = th.build_hopf_mlp(torch.Generator().manual_seed(0))
    shapes = [(tuple(p["w"].shape), tuple(p["b"].shape)) for p in params]
    assert shapes == [((100, 3), (100,)), ((100, 100), (100,)), ((100, 100), (100,)),
                      ((2, 100), (2,))]
    assert sum(p["w"].numel() + p["b"].numel() for p in params) == 20802
    w = torch.cat([p["w"].reshape(-1) for p in params])
    assert abs(float(w.std()) - 0.1) < 0.005 and abs(float(w.mean())) < 0.005
    assert all(bool((p["b"] == 0).all()) and p["w"].dtype == torch.float32 for p in params)


def test_hopf_dynamics_match_jax():
    ts, dt, y0, mu = inputs()
    y = np.random.default_rng(2).normal(0, 1.5, (T, B, 2)).astype(np.float32)
    for t in (0.0, 0.3, 1.234, float(ts[-1])):
        want = jh.hopf_dynamics(jnp.float32(t), jnp.asarray(y[0]), JStim(0.0, dt, jnp.asarray(mu)))
        got = th.hopf_dynamics(torch.tensor(t), torch.as_tensor(y[0]),
                               Stimulus(0.0, dt, torch.as_tensor(mu)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = jdata.hopf_dynamics(0.0, jnp.asarray(y), jnp.asarray(mu))
    got = tdata.hopf_dynamics(0.0, torch.as_tensor(y), torch.as_tensor(mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_onehot_lookup_matches_jax():
    """The one-hot blend against JAX's (a HIGHEST matmul that adds exact
    zeros): equal up to an ulp of the values, at grid points, between them
    and clamped past both ends."""
    ts, dt, _, mu = inputs()
    for t in (-0.1, 0.0, 0.0125, 1.0, 1.23456, float(ts[-1]), 3.0):
        want = np.asarray(j_onehot(jnp.float32(t), 0.0, dt, jnp.asarray(mu)))
        got = interp_at_onehot(torch.tensor(t, dtype=torch.float32), 0.0, dt,
                               torch.as_tensor(mu)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def test_drift_matches_jax(setup):
    """The drift at random states and several times: within 1e-6 of each
    output component's scale."""
    s = setup
    rng = np.random.default_rng(3)
    for t in (0.0, 0.77, 1.9, float(s["ts"][-1])):
        y = rng.normal(0, 1.5, (B, 2)).astype(np.float32)
        want = jh.hopf_mlp_drift(jnp.float32(t), jnp.asarray(y), s["jp"],
                                 JStim(0.0, s["dt"], jnp.asarray(s["mu"])), interp_fn=j_onehot)
        got = ho.hopf_ode_drift(torch.tensor(t), torch.as_tensor(y), s["params"], s["tmu"])
        assert scaled(got.numpy(), np.asarray(want)) < 1e-6, t


def test_mlp_apply_is_the_float64_product_rounded_once(setup):
    """The port's layer product against the same product in float64: the
    pairwise float64 sum rounds to the nearest float32 of the exact sum."""
    x = torch.as_tensor(np.random.default_rng(4).normal(0, 1, (B, 16)).astype(np.float32))
    w, b = setup["params"][1]["w"], setup["params"][1]["b"]
    exact = (x.double() @ w.double().T).float() + b
    assert torch.equal(th.linear(x, w, b), exact)


def test_drift_vjp_matches_jax_vjp(setup):
    """The hand-written VJP against ``jax.vjp`` of ``hopf_mlp_drift`` with
    respect to the state and every w and b: rel L2 1e-5."""
    s = setup
    rng = np.random.default_rng(5)
    for t in (0.1, 1.3):
        y = rng.normal(0, 1.5, (B, 2)).astype(np.float32)
        ct = rng.normal(0, 1, (B, 2)).astype(np.float32)
        stim = JStim(0.0, s["dt"], jnp.asarray(s["mu"]))
        _, vjp = jax.vjp(lambda y_, p_: jh.hopf_mlp_drift(jnp.float32(t), y_, p_, stim,
                                                          interp_fn=j_onehot),
                         jnp.asarray(y), s["jp"])
        gy_j, gp_j = vjp(jnp.asarray(ct))
        gy, gp = ho.hopf_ode_drift_vjp(torch.tensor(t), torch.as_tensor(y), torch.as_tensor(ct),
                                       s["params"], s["tmu"])
        assert rel_l2(gy.numpy(), gy_j) < 1e-5
        for i, (layer, layer_j) in enumerate(zip(gp, gp_j)):
            for k in ("w", "b"):
                assert rel_l2(layer[k].numpy(), layer_j[k]) < 1e-5, (t, i, k)


def test_drift_vjp_against_float64_autograd(setup):
    """The hand-written VJP's formulas against PyTorch autograd of the same
    drift in float64 (no roundings on either side): rel 1e-12."""
    s = setup
    rng = np.random.default_rng(6)
    y = torch.as_tensor(rng.normal(0, 1.5, (B, 2)))
    ct = torch.as_tensor(rng.normal(0, 1, (B, 2)))
    p64 = [{k: v.double().requires_grad_(True) for k, v in layer.items()}
           for layer in s["params"]]
    mu64 = ho.MuTable(s["tmu"].table.double(), 0.0, s["dt"])
    t = torch.tensor(0.9, dtype=torch.float64)
    yr = y.clone().requires_grad_(True)
    out = ho.hopf_ode_drift(t, yr, p64, mu64)
    grads = torch.autograd.grad(out, [yr] + [l[k] for l in p64 for k in ("w", "b")], ct)
    gy, gp = ho.hopf_ode_drift_vjp(t, y, ct, [{k: v.detach() for k, v in l.items()} for l in p64],
                                   mu64)
    assert rel_l2(gy.numpy(), grads[0].numpy()) < 1e-12
    flat = [l[k] for l in gp for k in ("w", "b")]
    for got, want in zip(flat, grads[1:]):
        assert rel_l2(got.numpy(), want.numpy()) < 1e-12


def test_step_vjp_matches_jax(setup):
    """One replay step's VJP (state and parameters) for random cotangents
    on y1 and the dense rows, against ``jax.vjp`` of JAX's
    ``_step_with_coeffs``: rel L2 1e-4."""
    s = setup
    rng = np.random.default_rng(8)
    y = s["y0"]
    t0, h = 0.5, 0.07
    ybar = rng.normal(0, 1, (B, 2)).astype(np.float32)
    cbar = rng.normal(0, 1, (5, B, 2)).astype(np.float32)
    func = jax_drift(s["dt"])
    mu = jnp.asarray(s["mu"])
    _, vjp = jax.vjp(lambda y_, p_: jf._step_with_coeffs(func, jnp.float32(t0), jnp.float32(h),
                                                         y_, (p_, mu)),
                     jnp.asarray(y), s["jp"])
    gy_j, gp_j = vjp((jnp.asarray(ybar), jnp.asarray(cbar)))
    gy, gflat = ho.hopf_step_vjp(torch.tensor(t0), torch.tensor(h), torch.as_tensor(y),
                                 torch.as_tensor(ybar), torch.as_tensor(cbar), s["params"],
                                 s["tmu"])
    assert rel_l2(gy.numpy(), gy_j) < 1e-4
    gp = ho.unpack_params(gflat, s["params"])
    for i, (layer, layer_j) in enumerate(zip(gp, gp_j)):
        for k in ("w", "b"):
            assert rel_l2(layer[k].numpy(), layer_j[k]) < 1e-4, (i, k)


def test_step_with_coeffs_matches_jax(setup):
    s = setup
    t0, h = 0.5, 0.07
    func = jax_drift(s["dt"])
    y1_j, co_j = jf._step_with_coeffs(func, jnp.float32(t0), jnp.float32(h), jnp.asarray(s["y0"]),
                                      (s["jp"], jnp.asarray(s["mu"])))
    f = lambda t, y: ho.hopf_ode_drift(t, y, s["params"], s["tmu"])  # noqa: E731
    y1, co = step_with_coeffs(f, torch.tensor(t0), torch.tensor(h), torch.as_tensor(s["y0"]))
    assert scaled(y1.numpy(), np.asarray(y1_j)) < 1e-6
    assert scaled(co.numpy().reshape(-1, 2), np.asarray(co_j).reshape(-1, 2)) < 1e-6


def test_whole_selection_counts_match_jax(setup, jax_grid):
    """The port's selection (plain loop) against JAX's adaptive kernel. At
    rtol 1e-7 the error estimate of an accepted step is float32 noise: the
    grids part after the first accepted step, and a 1e-7 nudge of the
    weights moves either side's rejected count (measured: JAX's 4 -> 1-4
    here, 27 -> 22-40 over 25 s). So both must succeed, the first accepted
    time agree to 1e-5, the accepted counts within 2% (+1), and the rejected
    counts within 5% of the accepted (+1) plus twice the spread of the
    port's own count under +-1e-7 nudges (ROADMAP.md section C)."""
    s = setup
    st_j, stats_j = jax_grid
    M_r = tf.round_max_steps((B, 2), M)
    assert M_r == 512
    cfg = ODESelectConfig(float(s["ts"][0]), float(s["ts"][-1]), max_steps=M_r)
    y0 = torch.as_tensor(s["y0"])
    st, stats = ho.hopf_select(y0, s["params"], s["tmu"], cfg)
    na, nr, ok = stats.tolist()
    na_j, nr_j, ok_j = stats_j.tolist()
    nudged = [int(ho.hopf_select(y0, [{k: v * (1.0 + eps) for k, v in layer.items()}
                                       for layer in s["params"]], s["tmu"], cfg)[1][1])
              for eps in (1e-7, -1e-7)]
    spread = max(nudged + [nr]) - min(nudged + [nr])
    assert ok == 1 and ok_j == 1
    assert abs(na - na_j) <= 0.02 * na_j + 1, (stats.tolist(), stats_j.tolist())
    assert abs(nr - nr_j) <= 0.05 * na_j + 1 + 2 * spread, (stats.tolist(), stats_j.tolist(),
                                                           nudged)
    assert abs(float(st[1]) - float(st_j[1])) <= 1e-5 * float(st_j[1])


def test_initial_step_matches_jax(setup):
    s = setup
    f = lambda t, y: ho.hopf_ode_drift(t, y, s["params"], s["tmu"])  # noqa: E731
    y0 = torch.as_tensor(s["y0"])
    from columnflow_torch.kernels.network_ode import initial_step_size
    t0 = torch.tensor(0.0)
    h = initial_step_size(f, t0, y0, f(t0, y0), 1e-7, 1e-9)
    func = jax_drift(s["dt"])
    args = (s["jp"], jnp.asarray(s["mu"]))
    jy0 = jnp.asarray(s["y0"])
    h_j = jf._initial_step_size_k(func, 0.0, jy0, func(0.0, jy0, *args), 1e-7, 1e-9, *args)
    assert abs(float(h) - float(h_j)) <= 1e-5 * float(h_j)


def test_replay_on_jax_grid_matches_jax(setup, jax_grid):
    """The port's fused solve replaying JAX's frozen grid against JAX's fused
    solve: within 1e-5 of each component's scale."""
    s = setup
    want = np.asarray(jax_fused(s["jp"], s["mu"], s["y0"], s["ts"], s["dt"]))
    ys, stats = tf.hopf_odeint_dopri5_fused(
        s["params"], torch.as_tensor(s["mu"]), s["dt"], torch.as_tensor(s["y0"]),
        torch.tensor(s["ts"]), max_steps=M, grid=frozen_grid_from_jax(*jax_grid),
        return_stats=True)
    assert int(stats.naccept) == int(jax_grid[1][0]) and bool(stats.success)
    assert ys.shape == (T, B, 2)
    assert scaled(ys.detach().numpy(), want) < 1e-5


def test_replay_sweep_matches_jax_vjp_of_replay(setup, jax_grid):
    """The plain reverse sweep over JAX's grid for random cotangents on the
    dense rows against ``jax.vjp`` of JAX's step-by-step replay: the state
    cotangent and every parameter cotangent rel L2 1e-4."""
    s = setup
    st, na = frozen_grid_from_jax(*jax_grid)
    n = min(na, 12)
    st = st[:n + 1].contiguous()
    func = jax_drift(s["dt"])
    mu = jnp.asarray(s["mu"])
    stj = jnp.asarray(st.numpy())

    def replay(y0, p):
        rows, y = [], y0
        for k in range(n):
            y, co = jf._step_with_coeffs(func, stj[k], stj[k + 1] - stj[k], y, (p, mu))
            rows.append(co)
        return jnp.stack(rows)

    cobar = np.random.default_rng(9).normal(0, 1, (n, 5, B, 2)).astype(np.float32)
    _, vjp = jax.vjp(replay, jnp.asarray(s["y0"]), s["jp"])
    gy_j, gp_j = vjp(jnp.asarray(cobar))
    ys, _ = ho.hopf_replay_fwd(torch.as_tensor(s["y0"]), st, s["params"], s["tmu"])
    gy, gp = ho.hopf_replay_bwd(ys, torch.as_tensor(cobar), st, s["params"], s["tmu"])
    assert rel_l2(gy.numpy(), gy_j) < 1e-4
    for i, (layer, layer_j) in enumerate(zip(gp, gp_j)):
        for k in ("w", "b"):
            assert rel_l2(layer[k].numpy(), layer_j[k]) < 1e-4, (i, k)


def test_hopf_solve_matches_jax():
    """The per-lane dopri5 forward against ``columnflow.data._hopf_solve``
    on the same start points and drives: within 1e-5 of each component's
    scale; per-lane accepted counts within 2%, rejected within 5% of the
    accepted (each lane its own controller)."""
    ts, dt, y0, mu = inputs(seed=11, n=16)
    want = np.asarray(jdata._hopf_solve(jnp.asarray(y0), jnp.asarray(mu), jnp.asarray(ts),
                                        max_steps=512))
    got, stats = tdata._hopf_solve(torch.as_tensor(y0), torch.as_tensor(mu), torch.as_tensor(ts),
                                   max_steps=512, return_stats=True)
    assert scaled(got.numpy(), want) < 1e-5

    from columnflow.ops.interp import interp_at
    from columnflow.solvers import odeint_stats

    def one(y, m):
        f = lambda t, y_, m_: jdata.hopf_dynamics(t, y_, interp_at(t, ts[0], dt, m_))  # noqa: E731
        return odeint_stats(f, y, jnp.asarray(ts), m, max_steps=512)

    js = jax.vmap(one, in_axes=(0, 1))(jnp.asarray(y0), jnp.asarray(mu))
    na_j, nr_j = np.asarray(js.naccept), np.asarray(js.nreject)
    na, nr = stats.naccept.numpy(), stats.nreject.numpy()
    assert bool(stats.success.all())
    assert (np.abs(na - na_j) <= 0.02 * na_j + 1).all(), (na, na_j)
    assert (np.abs(nr - nr_j) <= 0.05 * na_j + 1).all(), (nr, nr_j)


def test_make_hopf_dataset_shape_and_channels():
    ts = torch.linspace(0.0, SPAN, T)
    ds = tdata.make_hopf_dataset(torch.Generator().manual_seed(0), 6, ts, max_steps=512)
    assert ds.shape == (T, 6, 3) and bool(torch.isfinite(ds).all())
    g = torch.Generator().manual_seed(0)
    y0 = -2.0 + 4.0 * torch.rand((6, 2), generator=g)
    phases = -np.pi + 2.0 * np.pi * torch.rand((6,), generator=g)
    assert torch.equal(ds[0, :, :2], y0)
    assert torch.equal(ds[..., 2], torch.sin(ts[:, None] * 0.25 + phases[None]))


def test_dopri_lanes_refuses_unported_options():
    f = lambda t, y: -y  # noqa: E731
    y0, ts = torch.ones(2, 2), torch.linspace(0, 1, 5)
    for kw in (dict(method="bosh3"), dict(controller="pi"), dict(dt0=0.1)):
        with pytest.raises(NotImplementedError, match="A7"):
            odeint_dopri5_lanes(f, y0, ts, **kw)
    ys = odeint_dopri5_lanes(f, y0, ts)
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0) * np.ones((2, 2)), rtol=1e-5)


def test_arg_grads_rule(setup):
    """JAX's rule: "kernel" up to 1 MiB of parameters, "outer" past it or on
    request; kernel mode past 1 MiB is not ported (B8hw)."""
    assert tf.hopf_arg_grads(setup["params"]) == "kernel"
    assert tf.hopf_arg_grads(setup["params"], "outer") == "outer"
    big = [{"w": torch.zeros(600, 600), "b": torch.zeros(600)}]
    assert tf.hopf_arg_grads(big) == "outer"
    with pytest.raises(NotImplementedError, match="B8hw"):
        tf.hopf_arg_grads(big, "kernel")
    with pytest.raises(ValueError):
        tf.hopf_arg_grads(setup["params"], "both")


def test_kernels_hold_the_reference_width_only(setup):
    """The kernels hold the MLP (3, H, H, H, 2) at the reference width 100
    and at 512 (the wide kernels), 1 to 32 lanes; any other width, and 33
    lanes, are refused. The kernel-mode sweep holds the reference width
    only."""
    with pytest.raises(ValueError, match="MLP"):
        ho._kernel_ready(setup["params"], B)
    full = th.build_hopf_mlp(torch.Generator().manual_seed(0))
    assert ho._kernel_ready(full, 32) == 100
    wide = th.build_hopf_mlp(torch.Generator().manual_seed(0), sizes=(3, 512, 512, 512, 2))
    assert ho._kernel_ready(wide, 1) == 512
    with pytest.raises(ValueError, match="MLP"):
        ho._kernel_ready(wide, 32, widths=ho.KERNEL_WIDTHS[:1])
    for sizes in ((3, 256, 256, 256, 2), (3, 100, 512, 100, 2), (3, 512, 512, 2)):
        with pytest.raises(ValueError, match="MLP"):
            ho._kernel_ready(th.build_hopf_mlp(torch.Generator().manual_seed(0), sizes=sizes), 8)
    for params in (full, wide):
        with pytest.raises(ValueError, match="lanes"):
            ho._kernel_ready(params, 33)


def test_pack_params_round_trip(setup):
    flat = ho.pack_params(setup["params"])
    assert flat.shape == (sum(p.numel() for layer in setup["params"] for p in layer.values()),)
    back = ho.unpack_params(flat, setup["params"])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(back, setup["params"]) for k in ("w", "b"))
