"""Port parity: the XOR model (``columnflow_torch.models.xor``) and its two
fused engines (``kernels.xor_ode``, ``kernels.xor_sde``,
``solvers.fused.xor_odeint_dopri5_fused`` and ``xor_sdeint_fused``)
against ``columnflow.models.xor`` and the JAX package's
``odeint_dopri5_fused`` / ``sdeint_fused`` traced with the XOR drift.

Size: the XOR network as it is (24 populations, state 72), the four
conditions as one batch, 60 grid points, max_steps 512 (rounded to 660 on
both sides), as the JAX package's XOR tests. Both sides take the JAX
package's parameters (``convert.xor_network_from_jax``) and the same
Brownian integrals (``columnflow.solvers.sde._brownian_pack``). The JAX
kernels run in interpret mode, with the drift closures of
``columnflow/tasks/xor.py``; on the CPU the port runs its plain versions.

What can be held and how. rtol 1e-7 in float32 sits at the rounding floor:
an error estimate an ulp apart flips an accept and the grids part, so single
attempts are held at rtol 1e-4, the whole selection by its counts, and the
replay and gradients on JAX's own grid. Tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from columnflow import data as jdata
from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import xor as jx
from columnflow.models.column import Stimulus as JStim
from columnflow.ops.interp import interp_at as j_interp_at
from columnflow.ops.interp import interp_knots as j_knots
from columnflow.ops.interp import step_table_knots as j_step_knots
from columnflow.solvers import fused as jf
from columnflow.solvers.dopri import _error_ratio
from columnflow.solvers.sde import _brownian_pack
from columnflow.tasks import xor as jxt
from columnflow_torch import data as tdata
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import frozen_grid_from_jax, xor_network_from_jax
from columnflow_torch.kernels import xor_ode as xo
from columnflow_torch.kernels import xor_sde as xs
from columnflow_torch.kernels.network_ode import step_with_coeffs
from columnflow_torch.models import xor as tx
from columnflow_torch.models.column import Stimulus
from columnflow_torch.solvers import fused as tf
from columnflow_torch.tasks import xor as txt

T, B, M = 60, 4, 512
CONDS = np.asarray(jdata.xor_conditions())


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scaled(got, want):
    """Largest |got - want| over each state component's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).reshape(-1, want.shape[-1]).max(0), 1e-30)
    return float((np.abs(got - want) / scale).max())


def jax_drift_inputs(jtask, conds=CONDS):
    """The drift closure, its constants and knot values, as
    ``columnflow/tasks/xor.py:264-296`` builds them."""
    time_steps, dt = jtask.ts.shape[0], jtask.dt
    tables = jax.vmap(lambda c: jdata.prep_xor_stim(c, time_steps))(jnp.asarray(conds))
    on_vals = tables[:, -1].reshape(conds.shape[0], 32)
    kts, kvals = j_step_knots(time_steps, dt, jnp.zeros_like(on_vals), on_vals)

    def drift(t, y, p, fc, kv):
        return jx.xor_drift_batched(t, y, p, fc, JStim(0.0, dt, kv),
                                    interp_fn=lambda t_, t0_, dt_, v: j_knots(t_, kts, v))

    return drift, jx.build_xor_fused_consts(jtask.net), kvals


def jax_diffusion(t, y, p, fc, kv):
    idx = jax.lax.broadcasted_iota(jnp.int32, y.shape, 1)
    return jnp.where(idx < 24, jx.XOR_NOISE_STD, 0.0).astype(y.dtype)


def jax_xor_select(jtask, params, conds=CONDS, max_steps=M):
    """The XOR selection kernel's (step_times, stats) for these parameters,
    built as ``odeint_dopri5_fused`` builds the call."""
    drift, jfc, kvals = jax_drift_inputs(jtask, conds)
    args = (jx.split_xor_params(params), jfc, kvals)
    func, prep, dyn, _ = jf._flatten_for_kernel(drift, args, (1, 2))
    y0 = jnp.zeros((conds.shape[0], jx.XOR_STATE_DIM))
    ts = np.asarray(jtask.ts)
    M_r = tf.round_max_steps(y0.shape, max_steps)
    call = pl.pallas_call(
        jf._make_adaptive_kernel(func, prep, len(dyn), float(ts[0]), float(ts[-1]), 1e-7, 1e-9,
                                 None, M_r),
        out_shape=(jax.ShapeDtypeStruct((M_r + 1,), y0.dtype),
                   jax.ShapeDtypeStruct((3,), jnp.int32)),
        in_specs=[jf._VMEM()] * (1 + len(dyn)),
        out_specs=(pl.BlockSpec(memory_space=pltpu.SMEM),) * 2,
        interpret=True)
    return call(y0, *dyn)


def jax_solve(jtask, params, conds=CONDS):
    """ys (T, B, 72) of the deterministic fused solve (interpret mode)."""
    drift, jfc, kvals = jax_drift_inputs(jtask, conds)
    return jf.odeint_dopri5_fused(drift, jnp.zeros((conds.shape[0], 72)), jtask.ts,
                                  jx.split_xor_params(params), jfc, kvals,
                                  max_steps=jtask.max_steps, nondiff_args=(1, 2), interpret=True)


def jax_sde(jtask, params, pack, conds=CONDS):
    """ys (T, B, 72) of the fixed-grid fused SDE on the given pack."""
    drift, jfc, kvals = jax_drift_inputs(jtask, conds)
    return jf.sdeint_fused(drift, jax_diffusion, jnp.zeros((conds.shape[0], 72)), jtask.ts,
                           None, jx.split_xor_params(params), jfc, kvals, method="srk",
                           noise_shape=(conds.shape[0], 1), noise_pack=pack,
                           nondiff_args=(1, 2), interpret=True)


def port_task(jtask, time_steps=T, max_steps=M):
    """The port's task with the JAX package's parameters and network."""
    task = txt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          time_steps=time_steps, max_steps=max_steps, device="cpu")
    params, net = xor_network_from_jax({k: np.asarray(v) for k, v in jtask.params.items()},
                                       jtask.net)
    with torch.no_grad():
        for k, p in task.params.items():
            p.copy_(params[k])
    return task._replace(net=net, fc=tx.build_xor_fused_consts(net))


@pytest.fixture(scope="module")
def setup():
    jtask = jxt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), time_steps=T, max_steps=M)
    task = port_task(jtask)
    conds = torch.as_tensor(CONDS)
    sc, kv = txt.drift_inputs(task, conds)
    pf = {k: v.detach() for k, v in tx.split_xor_params(task.params).items()}
    drift, jfc, jkv = jax_drift_inputs(jtask)
    rng = np.random.default_rng(7)
    y = np.concatenate([rng.uniform(-5, 25, (B, 24)), rng.uniform(0, 5, (B, 24)),
                        rng.uniform(0, 50, (B, 24))], axis=1).astype(np.float32)
    st, stats = jax_xor_select(jtask, jtask.params)
    return dict(jtask=jtask, task=task, sc=sc, kv=kv, pf=pf, jdrift=drift,
                jargs=(jx.split_xor_params(jtask.params), jfc, jkv), y=y, rng=rng,
                jgrid=(np.asarray(st), np.asarray(stats)))


def test_data_and_constants_equal_jax(setup):
    s = setup
    conds = torch.as_tensor(CONDS)
    table = tdata.prep_xor_stim(conds, T)
    want = np.stack([np.asarray(jdata.prep_xor_stim(c, T)) for c in CONDS])
    assert np.array_equal(table.numpy(), want)
    assert np.array_equal(tdata.xor_conditions(), CONDS)
    assert np.array_equal(s["kv"].numpy(), np.asarray(s["jargs"][2]))
    jfc = s["jargs"][1]
    for k in ("w24", "bg24", "adapt"):
        assert np.array_equal(s["sc"].fc[k].numpy(), np.asarray(jfc[k])), k
    for k in ("tau_syn", "tau_mem", "tau_adapt", "resistance"):
        assert s["sc"].fc[k] == jfc[k], k
    assert s["task"].dt == s["jtask"].dt
    assert np.array_equal(s["task"].ts.numpy(), np.asarray(s["jtask"].ts))


def test_network_structure_equals_jax():
    """The port's own build: the anatomy of the JAX package's, the ff rows
    |N(anatomical, 0.1)| on the L4e/L4i targets only."""
    params_j, net_j = jx.build_xor_network(JaxConfig.load(), jax.random.PRNGKey(0))
    params, net = tx.build_xor_network(ColumnConfig.load(), torch.Generator().manual_seed(0))
    for f in ("area0", "area1", "consts"):
        a, b = getattr(net, f), getattr(net_j, f)
        for name in ("recurrent_weights", "background_current", "adaptation_strength"):
            assert np.array_equal(getattr(a, name).numpy(), np.asarray(getattr(b, name))), name
        assert a.tau_syn == float(b.tau_syn)
    for k, n_t in (("ff_w0", 16), ("ff_w1", 8)):
        assert params[k].shape == params_j[k].shape == (2, n_t)
        target = np.tile(tx.FF_TARGET_MASK, n_t // 8).astype(bool)
        assert (params[k][:, ~target] == 0).all() and (params[k][:, target] > 0).all()


def _drift_scale(s, y, lanes=slice(None)):
    """Each component's sum of absolute terms of the drift (rows ``lanes``
    of the batch)."""
    fc, pf = s["sc"].fc, s["pf"]
    y = torch.as_tensor(y)
    v, a, r = y[:, :24], y[:, 24:48], y[:, 48:]
    fr = tx.compute_firing_rate(v - a)
    ext = s["kv"][-1, lanes]  # the on-values bound the stimulus
    ff = torch.cat([ext[:, :16].abs() * pf["w00"] + ext[:, 16:].abs() * pf["w01"],
                    10 * (fr[:, :1] * pf["w10"] + fr[:, 8:9] * pf["w11"])], dim=1)
    cur = ff + fc["bg24"].abs() + fr @ fc["w24"].abs().T
    return torch.cat([(v.abs() + cur * fc["tau_syn"] * fc["resistance"]) / fc["tau_mem"],
                      (a.abs() + fc["adapt"].abs() * fr) / fc["tau_adapt"],
                      (r.abs() + fr) / fc["tau_syn"]], dim=1).numpy()


@pytest.mark.parametrize("t", [0.0, 0.0295, 0.03, 0.05])
def test_drift_batched_matches_jax(setup, t):
    """1e-6 of each component's sum of absolute terms (measured <= 8.0e-7,
    inside the stimulus' ramp): the recurrent sums round in another order
    than XLA's."""
    s = setup
    got = xo.xor_ode_drift(torch.tensor(t), torch.as_tensor(s["y"]), s["pf"], s["sc"], s["kv"])
    want = s["jdrift"](jnp.float32(t), jnp.asarray(s["y"]), *s["jargs"])
    err = np.abs(got.numpy() - np.asarray(want)) / _drift_scale(s, s["y"])
    assert err.max() < 1e-6


def test_drift_per_row_matches_jax(setup):
    """``xor_drift`` on one row with the dense stimulus table, at a time
    inside the stimulus' ramp: 1e-6 of each component's sum of absolute
    terms."""
    s = setup
    task, jtask = s["task"], s["jtask"]
    table = tdata.prep_xor_stim(torch.as_tensor(CONDS[0]), T)
    jtable = jdata.prep_xor_stim(jnp.asarray(CONDS[0]), T)
    t = 0.0295
    got = tx.xor_drift(torch.tensor(t), torch.as_tensor(s["y"][0]), task.params, task.net,
                       Stimulus(0.0, task.dt, table))
    want = jx.xor_drift(jnp.float32(t), jnp.asarray(s["y"][0]), jtask.params, jtask.net,
                        JStim(0.0, jtask.dt, jtable), interp_fn=j_interp_at)
    err = np.abs(got.detach().numpy() - np.asarray(want)) / _drift_scale(s, s["y"][:1], slice(0, 1))[0]
    assert err.max() < 1e-6


def _vjp_inputs(s, dtype):
    y = torch.as_tensor(s["y"], dtype=dtype)
    ct = torch.as_tensor(s["rng"].normal(size=(B, 72)), dtype=dtype)
    pf = {k: v.to(dtype) for k, v in s["pf"].items()}
    fc = {k: v.to(dtype) if torch.is_tensor(v) else v for k, v in s["sc"].fc.items()}
    return y, ct, pf, fc, Stimulus(0.0, 0.0, s["kv"].to(dtype))


@pytest.mark.parametrize("t", [0.0295, 0.05])
def test_drift_vjp_matches_autograd_in_float64(setup, t):
    """The hand-written VJP against ``torch.func.vjp`` of the drift, both
    in float64: rel 1e-12."""
    s = setup
    y, ct, pf, fc, stim = _vjp_inputs(s, torch.float64)
    interp = xo._knots(s["sc"].knot_ts)
    tt = torch.tensor(t, dtype=torch.float64)
    g, rows = tx.xor_drift_batched_vjp(tt, y, ct, pf, fc, stim, interp_fn=interp)
    _, vjp = torch.func.vjp(lambda y_, p_: tx.xor_drift_batched(tt, y_, p_, fc, stim,
                                                               interp_fn=interp), y, pf)
    g_a, rows_a = vjp(ct)
    assert rel_l2(g, g_a) < 1e-12
    for k in tx.PF_KEYS:
        assert rel_l2(rows[k], rows_a[k]) < 1e-12, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_vjp_matches_jax_vjp(setup, seed):
    """Against ``jax.vjp`` of the JAX drift in float32: the rows rel L2
    1e-6 (measured <= 3.6e-7). The state cotangent cannot hold 1e-6: the
    firing rate's derivative cancels (sden - xn dden), and the port's
    closed form rounds it ~3e-7 (median, relative) from float64 where
    ``jax.grad`` of the guarded rate rounds it ~7.5e-7, so the two differ
    by up to 2e-6 rel L2 over the state; held at 5e-6, with the port nearer
    the float64 VJP than JAX is (ROADMAP.md section C)."""
    s = setup
    rng = np.random.default_rng(seed)
    ct = rng.normal(size=(B, 72)).astype(np.float32)
    t = 0.0295
    y, pf = torch.as_tensor(s["y"]), s["pf"]
    g, rows = xo.xor_ode_drift_vjp(torch.tensor(t), y, torch.as_tensor(ct), pf, s["sc"], s["kv"])
    jpf, jfc, jkv = s["jargs"]
    _, vjp = jax.vjp(lambda y_, p_: s["jdrift"](jnp.float32(t), y_, p_, jfc, jkv),
                     jnp.asarray(s["y"]), jpf)
    g_j, rows_j = vjp(jnp.asarray(ct))
    d = torch.float64
    sc64 = xo.SDEConsts({k: v.to(d) if torch.is_tensor(v) else v for k, v in s["sc"].fc.items()},
                        s["sc"].knot_ts)
    g64, _ = xo.xor_ode_drift_vjp(torch.tensor(t, dtype=d), y.to(d), torch.as_tensor(ct, dtype=d),
                                  {k: v.to(d) for k, v in pf.items()}, sc64, s["kv"].to(d))
    assert rel_l2(g, g_j) < 5e-6
    assert rel_l2(g, g64) <= rel_l2(g_j, g64)
    for k in tx.PF_KEYS:
        assert rel_l2(rows[k], rows_j[k]) < 1e-6, k


def _jax_attempt(s, t, y, h, rtol, atol):
    jpf, jfc, jkv = s["jargs"]
    f0 = s["jdrift"](t, y, jpf, jfc, jkv)
    y1, _, ks = jf._rk_step_u(s["jdrift"], t, y, h, f0, s["jargs"])
    return y1, float(_error_ratio(jf._err_u(h, ks), rtol, atol, y, y1))


@pytest.fixture(scope="module")
def replay_states(setup):
    """The step-start states of the port's replay on JAX's frozen grid."""
    st, n = frozen_grid_from_jax(*setup["jgrid"])
    return xo.xor_replay_fwd(torch.zeros(B, 72), st[:n + 1].contiguous(), setup["pf"],
                             setup["sc"], setup["kv"])[0]


@pytest.mark.parametrize("k,stretch", [(1, 4.0), (5, 4.0), (20, 16.0), (40, 4.0), (80, 4.0),
                                       (120, 16.0)])
def test_one_attempt_matches_jax(setup, replay_states, k, stretch):
    """One controller attempt from the replay's state at JAX's accepted
    step k with JAX's step stretched 4 or 16 times, at rtol 1e-4 / atol
    1e-6: the same decision and the error ratio rel 1e-3 (measured <=
    3.7e-4). At JAX's own steps the ratio is ~5e-4, float32
    rounding noise of the stage derivatives, and the two differ by up to
    60% (ROADMAP.md section C)."""
    s = setup
    st = s["jgrid"][0]
    t, y = float(st[k]), replay_states[k]
    h = np.float32((st[k + 1] - st[k]) * stretch)
    cfg = xo.ODESelectConfig(0.0, float(s["jtask"].ts[-1]), 1e-4, 1e-6, None, 660)
    f0 = xo.xor_ode_drift(torch.tensor(t), y, s["pf"], s["sc"], s["kv"])
    a = xo.xor_attempt(torch.tensor(t), y, f0, torch.tensor(h), s["pf"], s["sc"], s["kv"], cfg)
    _, ratio_j = _jax_attempt(s, jnp.float32(t), jnp.asarray(y.numpy()), jnp.float32(h),
                                 1e-4, 1e-6)
    assert bool(a.ratio <= 1.0) == (ratio_j <= 1.0)
    assert abs(float(a.ratio) - ratio_j) <= 1e-3 * ratio_j


def test_whole_selection_by_counts(setup):
    """The whole selection over the 60 points at rtol 1e-7: both succeed,
    naccept within 5% of JAX's (measured 256 against 258). nreject cannot
    hold 5% of itself: a rejection at rtol 1e-7 is float32 rounding noise in
    an error estimate near 1, and a 1e-7 nudge of the weights moves the
    port's own count between 14 and 18 and JAX's between 16 and 23 (ROADMAP.md
    section C); it is held within 5% of the accepted steps (measured 17
    against 23), beside the port's own spread under a 1e-7 nudge. The first accepted step (measured 1.0% apart) comes from
    Hairer's initial step, whose d2 divides the difference of two drifts
    1e-6 s apart by atol 1e-9 from the zero state: rounding noise under a
    fifth root; held to 2%."""
    s = setup
    cfg = xo.ODESelectConfig(0.0, float(s["jtask"].ts[-1]), 1e-7, 1e-9, None,
                             tf.round_max_steps((B, 72), M))
    st, stats = xo.xor_select(torch.zeros(B, 72), s["pf"], s["sc"], s["kv"], cfg)
    na, nr, ok = (int(x) for x in stats)
    na_j, nr_j, ok_j = (int(x) for x in s["jgrid"][1])
    assert ok == ok_j == 1 and cfg.max_steps == 660
    assert abs(na - na_j) <= 0.05 * na_j and abs(nr - nr_j) <= 0.05 * na_j
    # The spread beside it: the port's own nreject under 1e-7 nudges.
    nudged = [int(xo.xor_select(torch.zeros(B, 72), {k: v * (1.0 + e) for k, v in s["pf"].items()},
                                s["sc"], s["kv"], cfg)[1][1]) for e in (1e-7, -1e-7)]
    assert max(nudged + [nr]) - min(nudged + [nr]) >= 2
    assert abs(float(st[1]) - float(s["jgrid"][0][1])) <= 2e-2 * float(s["jgrid"][0][1])


def _port_solve(s, pf, y0, grid):
    return tf.xor_odeint_dopri5_fused(pf, s["sc"], s["kv"], y0, s["task"].ts, max_steps=M,
                                      grid=grid)


def test_replay_on_jax_grid(setup):
    """The dense solution on JAX's frozen grid: 1e-5 of each component's
    largest magnitude."""
    s = setup
    ys = _port_solve(s, s["pf"], torch.zeros(B, 72), frozen_grid_from_jax(*s["jgrid"]))
    want = np.asarray(jax_solve(s["jtask"], s["jtask"].params))
    assert np.isfinite(ys.numpy()).all()
    assert scaled(ys.numpy(), want) < 1e-5


def test_kernel_mode_sweep_on_jax_grid(setup):
    """Gradients of sum(ys * R) on JAX's grid (dense output, the replay's
    reverse sweep in kernel mode): y0 and the four rows rel L2 1e-4."""
    s = setup
    R = s["rng"].normal(size=(T, B, 72)).astype(np.float32)
    pf = {k: v.clone().requires_grad_(True) for k, v in s["pf"].items()}
    y0 = torch.zeros(B, 72, requires_grad=True)
    st, stats = s["jgrid"]
    ys = _port_solve(s, pf, y0, frozen_grid_from_jax(st, stats))
    (ys * torch.as_tensor(R)).sum().backward()
    drift, jfc, jkv = jax_drift_inputs(s["jtask"])

    def jloss(y0_, p_):
        ys_ = jf.odeint_dopri5_fused(drift, y0_, s["jtask"].ts, p_, jfc, jkv, max_steps=M,
                                     nondiff_args=(1, 2), interpret=True)
        return jnp.sum(ys_ * R)

    g_y0, g_p = jax.grad(jloss, argnums=(0, 1))(jnp.zeros((B, 72)), s["jargs"][0])
    assert rel_l2(y0.grad, g_y0) < 1e-4
    for k in tx.PF_KEYS:
        assert rel_l2(pf[k].grad, g_p[k]) < 1e-4, k


def test_uniform_step_times_equal_jax_arithmetic():
    """The uniform grid's step times at the full horizon (999 steps, chunk
    303 for a (4, 72) state) and at the test's: the JAX kernel's float32
    arithmetic, bit for bit."""
    for time_steps in (1000, T):
        ts = np.asarray(jnp.linspace(0.0, time_steps * 1e-3, time_steps))
        n, h = time_steps - 1, float(ts[1] - ts[0])
        chunk = min(303, n)
        off = (np.arange(n) // chunk) * chunk
        want = (jnp.asarray(off, jnp.float32) * h + float(ts[0])) + jnp.asarray(
            np.arange(n) - off, jnp.float32) * h
        t0s, h_t = tf.uniform_step_times(torch.as_tensor(ts), (B, 72))
        assert h_t == h and np.array_equal(t0s.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def sde_pack(setup):
    _, i1, i10, _, _ = _brownian_pack(jax.random.PRNGKey(3), setup["jtask"].ts, (B, 1),
                                      jnp.float32)
    return i1, i10


def test_sde_trajectory_matches_jax(setup, sde_pack):
    """The fixed-grid SDE on the same Brownian integrals. 1e-5 of each
    component's largest magnitude cannot hold: the stimulus' onset at 30 ms
    amplifies float32 rounding, so by step 59 JAX's own trajectory is
    1.5e-5 from the float64 one and the port's 8.5e-6, and the two 2.4e-5
    apart. Held at 5e-5, with the port nearer the float64 trajectory than
    JAX is (ROADMAP.md section C)."""
    s = setup
    pack = tuple(torch.as_tensor(np.array(x)) for x in sde_pack)
    ys = tf.xor_sdeint_fused(s["pf"], s["sc"], s["kv"], torch.zeros(B, 72), s["task"].ts, pack)
    want = np.asarray(jax_sde(s["jtask"], s["jtask"].params, sde_pack))
    d = torch.float64
    sc64 = xo.SDEConsts({k: v.to(d) if torch.is_tensor(v) else v for k, v in s["sc"].fc.items()},
                        s["sc"].knot_ts)
    t0s, h = tf.uniform_step_times(s["task"].ts, (B, 72))
    ys64 = xs._xor_sde_fwd_plain(torch.zeros(B, 72, dtype=d), t0s.to(d), h,
                                 *(x.reshape(T - 1, B).to(d) for x in pack),
                                 {k: v.to(d) for k, v in s["pf"].items()}, sc64, s["kv"].to(d))
    assert ys.shape == want.shape == (T, B, 72)
    assert scaled(ys.numpy(), want) < 5e-5
    assert scaled(ys.numpy(), ys64.numpy()) <= scaled(want, ys64.numpy())


def test_sde_gradients_match_jax(setup, sde_pack):
    """Gradients of sum(ys * R) through the kernel-mode reverse sweep: y0
    and the four rows rel L2 1e-3."""
    s = setup
    R = s["rng"].normal(size=(T, B, 72)).astype(np.float32)
    pf = {k: v.clone().requires_grad_(True) for k, v in s["pf"].items()}
    y0 = torch.zeros(B, 72, requires_grad=True)
    pack = tuple(torch.as_tensor(np.array(x)) for x in sde_pack)
    ys = tf.xor_sdeint_fused(pf, s["sc"], s["kv"], y0, s["task"].ts, pack)
    (ys * torch.as_tensor(R)).sum().backward()
    drift, jfc, jkv = jax_drift_inputs(s["jtask"])

    def jloss(y0_, p_):
        ys_ = jf.sdeint_fused(drift, jax_diffusion, y0_, s["jtask"].ts, None, p_, jfc, jkv,
                              method="srk", noise_shape=(B, 1), noise_pack=sde_pack,
                              nondiff_args=(1, 2), interpret=True)
        return jnp.sum(ys_ * R)

    g_y0, g_p = jax.grad(jloss, argnums=(0, 1))(jnp.zeros((B, 72)), s["jargs"][0])
    assert rel_l2(y0.grad, g_y0) < 1e-3
    for k in tx.PF_KEYS:
        assert rel_l2(pf[k].grad, g_p[k]) < 1e-3, k


def test_step_vjps_match_autograd_in_float64(setup):
    """The dopri5 step's and the SRA1 step's hand-written VJPs against
    ``torch.func.vjp`` of the plain steps, in float64: rel 1e-12."""
    s = setup
    d = torch.float64
    y, ct, pf, fc, _ = _vjp_inputs(s, d)
    sc = xo.SDEConsts(fc, s["sc"].knot_ts)
    kv = s["kv"].to(d)
    t0, h = torch.tensor(0.029, dtype=d), torch.tensor(1.3e-3, dtype=d)
    cbar = torch.as_tensor(s["rng"].normal(size=(5, B, 72)), dtype=d)
    g, rows = xo.xor_step_vjp(t0, h, y, ct, cbar, pf, sc, kv)
    f = lambda y_, p_: step_with_coeffs(lambda t, x: xo.xor_ode_drift(t, x, p_, sc, kv),  # noqa: E731
                                        t0, h, y_)
    _, vjp = torch.func.vjp(f, y, pf)
    g_a, rows_a = vjp((ct, cbar))
    assert rel_l2(g, g_a) < 1e-12
    for k in tx.PF_KEYS:
        assert rel_l2(rows[k], rows_a[k]) < 1e-12, k
    i10 = torch.as_tensor(s["rng"].normal(size=B), dtype=d) * 1e-4
    i1 = torch.as_tensor(s["rng"].normal(size=B), dtype=d) * 1e-2
    g, rows = xs.xor_sde_step_vjp(t0, h, y, i10, ct, pf, sc, kv)
    _, vjp = torch.func.vjp(
        lambda y_, p_: xs._sra1_step(lambda t, x: xo.xor_ode_drift(t, x, p_, sc, kv),
                                     tx.xor_diffusion, t0, y_, h, i1, i10, ()), y, pf)
    g_a, rows_a = vjp(ct)
    assert rel_l2(g, g_a) < 1e-12
    for k in tx.PF_KEYS:
        assert rel_l2(rows[k], rows_a[k]) < 1e-12, k


def test_wrappers_check_their_tensors(setup):
    s = setup
    cfg = xo.ODESelectConfig(0.0, 0.06, max_steps=8)
    with pytest.raises(ValueError, match="w00"):
        xo.xor_select(torch.zeros(B, 72), {**s["pf"], "w00": s["pf"]["w00"][:, :8]}, s["sc"],
                      s["kv"], cfg)
    with pytest.raises(ValueError, match="lanes"):
        xo.xor_select(torch.zeros(33, 72), s["pf"], s["sc"], s["kv"], cfg)
    with pytest.raises(ValueError, match="y0"):
        xo.xor_select(torch.zeros(B, 72, dtype=torch.float64), s["pf"], s["sc"], s["kv"], cfg)
    with pytest.raises(ValueError, match="i1"):
        xs.xor_sde_fwd(torch.zeros(B, 72), torch.zeros(3), 1e-3, torch.zeros(2, B),
                       torch.zeros(3, B), s["pf"], s["sc"], s["kv"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.xor_odeint_dopri5_fused(s["pf"], s["sc"], s["kv"], torch.zeros(B, 72), s["task"].ts,
                                   arg_grads="outer")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.xor_sdeint_fused(s["pf"], s["sc"], s["kv"], torch.zeros(B, 72), s["task"].ts,
                            (torch.zeros(T - 1, B), torch.zeros(T - 1, B)), arg_grads="outer")
    assert tf.xor_arg_grads(s["pf"]) == tf.xor_arg_grads(s["pf"], sde=True) == "kernel"

