"""Port parity: the fused dopri5 engine of ``columnflow_torch``
(``kernels.network_ode``, ``solvers.fused.odeint_dopri5_fused``) against
``columnflow.solvers.fused.odeint_dopri5_fused`` on the parity network.

Size: columns (2, 1), 2 inputs, batch 4, 60 grid points, max_steps 512
(rounded to 660 on both sides). Both sides take the JAX package's parameters
(``convert.network_from_jax``). The JAX kernels run in interpret mode; its
frozen grid is read by building the selection call as
``odeint_dopri5_fused`` builds it.

What can be held and how. rtol 1e-7 in float32 sits at the rounding floor:
an error estimate an ulp apart flips an accept, and from there two grids
part. So the initial step and single attempts are held against JAX from the
same state, the whole selection statistically, and the replay, the loss and
the gradients on JAX's own grid (``convert.frozen_grid_from_jax``).
Tolerances are stated at each test with the value measured here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import network as jn
from columnflow.models.column import Stimulus as JStim
from columnflow.ops.interp import interp_knots as j_knots
from columnflow.ops.interp import step_table_knots as j_step_knots
from columnflow.solvers import fused as jf
from columnflow.solvers.dopri import _error_ratio
from columnflow.tasks import parity as jpt
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import frozen_grid_from_jax, network_from_jax
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.kernels.network_sde import SDEConsts
from columnflow_torch.models import network as tn
from columnflow_torch.solvers import rk
from columnflow_torch.solvers.fused import odeint_dopri5_fused, round_max_steps
from columnflow_torch.tasks import parity as tpt

T, B, N_IN, M = 60, 4, 2, 512
STIMS = np.array([[0.0, 15.0], [15.0, 0.0], [15.0, 15.0], [0.0, 0.0]], np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scaled(got, want):
    """Largest |got - want| over each state component's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).reshape(-1, want.shape[-1]).max(0), 1e-30)
    return float((np.abs(got - want) / scale).max())


def _jax_drift(jtask):
    kts, kv = j_step_knots(T, jtask.dt, jnp.zeros_like(STIMS), jnp.asarray(STIMS))

    def drift(t, y, pw, fc, kv_):
        return jn.network_drift_premixed(t, y, pw, fc, JStim(0.0, jtask.dt, kv_),
                                         interp_fn=lambda t_, a, b, v: j_knots(t_, kts, v))

    return drift, kv


def jax_select(jtask, params, dt0=None):
    """The selection kernel's outputs (step_times, stats) for these
    parameters, built as ``odeint_dopri5_fused`` builds the call."""
    drift, kv = _jax_drift(jtask)
    args = (jn.premix_network_weights(params, jtask.net),
            jn.build_network_fused_consts(jtask.net), kv)
    func, prep, dyn, _ = jf._flatten_for_kernel(drift, args, (1, 2), jn.prepare_premixed_split)
    y0 = jnp.zeros((B, 3 * jtask.net.num_pops))
    ts = np.asarray(jtask.ts)
    max_steps = round_max_steps(y0.shape, M)
    call = pl.pallas_call(
        jf._make_adaptive_kernel(func, prep, len(dyn), float(ts[0]), float(ts[-1]), 1e-7, 1e-9,
                                 dt0, max_steps),
        out_shape=(jax.ShapeDtypeStruct((max_steps + 1,), y0.dtype),
                   jax.ShapeDtypeStruct((3,), jnp.int32)),
        in_specs=[jf._VMEM()] * (1 + len(dyn)),
        out_specs=(pl.BlockSpec(memory_space=pltpu.SMEM),) * 2,
        interpret=True)
    return call(y0, *dyn)


@pytest.fixture(scope="module")
def setup():
    jtask = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                           n_inputs=N_IN, time_steps=T, max_steps=M)
    jparams = {k: np.asarray(v) for k, v in jtask.params.items()}
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=N_IN, time_steps=T, max_steps=M,
                          device="cpu")
    params, _ = network_from_jax(jparams, jtask.net)
    with torch.no_grad():
        for k, p in task.params.items():
            p.copy_(params[k])
    model = tpt.sde_model(task.params, task, torch.as_tensor(STIMS))
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    drift, jkv = _jax_drift(jtask)
    jpw = jn.premix_network_weights(jtask.params, jtask.net)
    jfc = jn.build_network_fused_consts(jtask.net)
    rng = np.random.default_rng(5)
    P = task.net.num_pops
    y = np.concatenate([rng.uniform(-5, 25, (B, P)), rng.uniform(0, 5, (B, P)),
                        rng.uniform(0, 50, (B, P))], axis=1).astype(np.float32)
    st, stats = jax_select(jtask, jtask.params)
    return dict(jtask=jtask, task=task, model=model, pw=pw, sc=model.sc, kv=model.kv,
                drift=drift, jargs=(jpw, jfc, jkv), y=y, rng=rng, P=P,
                jgrid=(np.asarray(st), np.asarray(stats)))


def _jstep(s, t0, h, y, pw=None):
    pw = s["jargs"][0] if pw is None else pw
    args = jn.prepare_premixed_split(pw, *s["jargs"][1:])
    return jf._step_with_coeffs(s["drift"], t0, h, y, args)


def test_tableau_equals_jax():
    assert (list(rk.C), [list(r) for r in rk.A], list(rk.B), list(rk.B_ERR),
            list(rk.DOPRI5_DENSE_D)) == (
        jf._C, [[x for x in r[:i]] for i, r in enumerate(jf._A)], jf._B, jf._BE, jf._D)


def test_rounded_max_steps_equals_jax_formula():
    # columnflow/solvers/fused.py:557-566 for the parity states of the tests
    # and of the reference network.
    for shape, m, want in (((4, 72), 512, 660), ((4, 312), 3072, 3078), ((4, 2496), 3072, 3072)):
        state_bytes = 4 * int(np.prod(shape))
        chunk = int(max(4, min(256, (2 << 20) // (11 * state_bytes))))
        assert round_max_steps(shape, m) == -(-m // chunk) * chunk == want


def test_split3_drift_vjp_matches_jax_vjp(setup):
    """State, wT and iwT cotangents of one drift evaluation through
    ``prepare_premixed_split``: rel L2 <= 1e-5 each (measured 1.3e-7, 0.0,
    6.6e-8; a float32 product without the bf16 rounding points misses the
    wT cotangent by ~2e-3)."""
    s = setup
    t = 0.0301
    c = s["rng"].normal(size=s["y"].shape).astype(np.float32)
    jpw, jfc, jkv = s["jargs"]
    _, vjp = jax.vjp(lambda yy, pw: s["drift"](t, yy, *jn.prepare_premixed_split(pw, jfc, jkv)),
                     jnp.asarray(s["y"]), jpw)
    want_y, want_pw = vjp(jnp.asarray(c))
    w3 = tn.prepare_premixed_split(s["pw"], s["sc"].fc)[0]
    from columnflow_torch.kernels.network_sde import _knots
    from columnflow_torch.models.column import Stimulus

    got_y, acc, got_iw = tn.network_drift_premixed_split_vjp(
        torch.tensor(t), torch.as_tensor(s["y"]), torch.as_tensor(c), w3, s["sc"].fc,
        Stimulus(0.0, 0.0, s["kv"]), _knots(s["sc"].knot_ts))
    got_w = tn.split3_fold(acc)
    assert rel_l2(got_y, want_y) < 1e-5
    assert rel_l2(got_w, want_pw["wT"]) < 1e-5
    assert rel_l2(got_iw, want_pw["iwT"]) < 1e-5
    plain = tn._mm(tn.compute_firing_rate(
        torch.as_tensor(s["y"][:, :s["P"]] - s["y"][:, s["P"]:2 * s["P"]])).T,
        tn._cot_current(torch.as_tensor(c[:, :s["P"]]), s["sc"].fc))
    assert rel_l2(plain, want_pw["wT"]) > 1e-4  # the rounding points matter


def test_step_vjp_matches_jax_vjp_of_the_step(setup):
    """The whole replay step (seven drift evaluations sharing one split)
    against ``jax.vjp`` of ``_step_with_coeffs``. XLA's exp/tanh sit a few
    ulp from torch's, which now and then rounds a bf16 cotangent the other
    way: a few entries then differ by one bf16 ulp and everything else is
    equal to float32 rounding. So: rel L2 <= 1e-3 each (measured over three
    draws: state 3.9e-5..6.3e-5, wT 2.6e-5..2.1e-4, iwT 2.5e-6..9.8e-5), and
    at most 3% of the wT entries differ at all (measured 1 to 5 of 576). A
    wrong order of the step's bf16 accumulations, or rounding after the
    lanes are summed instead of before, moves most entries."""
    s = setup
    t0, h = np.float32(0.0295), np.float32(2e-4)
    w3 = tn.prepare_premixed_split(s["pw"], s["sc"].fc)[0]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        ybar = rng.normal(size=s["y"].shape).astype(np.float32)
        cbar = rng.normal(size=(5,) + s["y"].shape).astype(np.float32)
        _, vjp = jax.vjp(lambda yy, pw: _jstep(s, t0, h, yy, pw), jnp.asarray(s["y"]),
                         s["jargs"][0])
        want_y, want_pw = vjp((jnp.asarray(ybar), jnp.asarray(cbar)))
        got_y, got_w, got_iw = no.step_vjp(
            torch.tensor(t0), torch.tensor(h), torch.as_tensor(s["y"]), torch.as_tensor(ybar),
            torch.as_tensor(cbar), w3, s["sc"], s["kv"])
        assert rel_l2(got_y, want_y) < 1e-3
        assert rel_l2(got_w, want_pw["wT"]) < 1e-3
        assert rel_l2(got_iw, want_pw["iwT"]) < 1e-3
        want_w = np.asarray(want_pw["wT"])
        differ = np.abs(got_w.numpy() - want_w) > 1e-6 * np.abs(want_w).max()
        assert differ.mean() < 0.03, int(differ.sum())


def test_step_vjp_matches_autograd_in_float64(setup):
    """The hand-written VJP of the step and its dense coefficients against
    torch autograd of the plain forward, both in float64 with the bf16
    roundings taken out: rel <= 1e-9 (measured 6e-15, 7e-16, 4e-16)."""
    s = setup
    fc64 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in s["sc"].fc.items()}
    sc64, kv64 = SDEConsts(fc64, s["sc"].knot_ts), s["kv"].double()
    y = torch.as_tensor(s["y"]).double().requires_grad_(True)
    wT = s["pw"]["wT"].double().requires_grad_(True)
    iwT = s["pw"]["iwT"].double().requires_grad_(True)
    t0, h = torch.tensor(0.0295, dtype=torch.float64), torch.tensor(3e-4, dtype=torch.float64)
    w3 = tn.prepare_premixed_split({"wT": wT, "iwT": iwT}, fc64)[0]
    y1, co = no.step_with_coeffs(lambda t_, y_: no.ode_drift(t_, y_, w3, sc64, kv64), t0, h, y)
    gen = torch.Generator().manual_seed(3)
    ybar = torch.randn(y1.shape, generator=gen, dtype=torch.float64)
    cbar = torch.randn(co.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad((y1 * ybar).sum() + (co * cbar).sum(), [y, wT, iwT])
    got = no.step_vjp(t0, h, y.detach(), ybar, cbar, {k: v.detach() for k, v in w3.items()},
                      sc64, kv64)
    for g, w in zip(got, want):
        assert rel_l2(g, w) < 1e-9


def test_initial_step_matches_jax(setup):
    """Hairer's starting step from y0 = 0: rel <= 1e-3 (measured 0.0)."""
    s = setup
    jpw, jfc, jkv = s["jargs"]
    args = jn.prepare_premixed_split(jpw, jfc, jkv)
    y0 = jnp.zeros_like(s["y"])
    want = float(jf._initial_step_size_k(s["drift"], 0.0, y0, s["drift"](0.0, y0, *args),
                                         1e-7, 1e-9, *args))
    w3 = tn.prepare_premixed_split(s["pw"], s["sc"].fc)[0]
    f = lambda t_, y_: no.ode_drift(t_, y_, w3, s["sc"], s["kv"])  # noqa: E731
    t0, y0t = torch.tensor(0.0), torch.zeros_like(torch.as_tensor(s["y"]))
    got = float(no.initial_step_size(f, t0, y0t, f(t0, y0t), 1e-7, 1e-9))
    assert got == pytest.approx(want, rel=1e-3)


@pytest.fixture(scope="module")
def jax_states(setup):
    """States of JAX's replay at its accepted steps 5, 60 and 120."""
    st, _ = setup["jgrid"]
    step = jax.jit(lambda t0, h, y: _jstep(setup, t0, h, y)[0])
    y, states = jnp.zeros_like(setup["y"]), {}
    for i in range(121):
        states[i] = y
        y = step(st[i], st[i + 1] - st[i], y)
    return {k: states[k] for k in (5, 60, 120)}


@pytest.mark.parametrize("k,stretch,rtol,atol,tol_ratio,tol_h", [
    (5, 4.0, 1e-4, 1e-6, 1e-3, 1e-3), (5, 6.0, 1e-4, 1e-6, 1e-3, 1e-3),
    (60, 2.0, 1e-4, 1e-6, 1e-3, 1e-3), (60, 4.0, 1e-4, 1e-6, 1e-3, 1e-3),
    (60, 6.0, 1e-4, 1e-6, 1e-3, 1e-3),
    (5, 1.0, 1e-7, 1e-9, None, None), (60, 1.0, 1e-7, 1e-9, None, None),
    (120, 1.0, 1e-7, 1e-9, None, None), (60, 2.0, 1e-7, 1e-9, 1e-3, 1e-3),
    (120, 4.0, 1e-7, 1e-9, 1e-2, 2e-3)])
def test_one_attempt_matches_jax(setup, jax_states, k, stretch, rtol, atol, tol_ratio, tol_h):
    """One controller attempt from a state of JAX's replay at its accepted
    step k, with the accepted step stretched: the same decision, the error
    ratio and the next step within the stated tolerance, y1 within 1e-5 of
    each component's scale (measured <= 8.7e-6).

    Where the embedded error stands clear of float32 rounding (a stretched
    step; rtol 1e-4 puts its ratio near 1) ratio and next step agree to
    1e-3 (measured: ratio 2.7e-5..5.7e-4, next step <= 1.1e-4). At the
    solver's own rtol 1e-7 an accepted step's estimate IS float32 rounding
    noise of the stage derivatives (XLA's exp/tanh against torch's), the
    same absolute amount whatever the step: there the ratios differ by
    1% to 34% (0.128 against 0.194 at step 5) and only the decision is
    held, with both ratios below 0.7; rejected steps stand clear of the noise
    again (ratio 19: 5.7e-5; ratio 215: 3.4e-3, held to 1e-2). The chosen
    states keep the ratio further than twice the tolerance from 1."""
    s = setup
    st, _ = s["jgrid"]
    cfg = no.ODESelectConfig(0.0, float(np.asarray(s["jtask"].ts)[-1]), rtol, atol,
                             max_steps=660)
    y = jax_states[k]
    t, h = st[k], np.float32((st[k + 1] - st[k]) * stretch)
    args = jn.prepare_premixed_split(*s["jargs"])
    f0 = s["drift"](t, y, *args)
    hj = jnp.minimum(h, cfg.t_end - t)
    y1, _, ks = jf._rk_step_u(s["drift"], t, y, hj, f0, args)
    ratio = _error_ratio(jf._err_u(hj, ks), rtol, atol, y, y1)
    h_next = float(jf._next_step_size_k(hj, ratio))
    a = no.ode_attempt(torch.tensor(t), torch.tensor(np.array(y)), torch.tensor(np.array(f0)),
                       torch.tensor(h), s["pw"], s["sc"], s["kv"], cfg)
    assert bool(a.ratio <= 1.0) == bool(ratio <= 1.0)
    if tol_ratio is None:
        assert max(float(a.ratio), float(ratio)) < 0.7
    else:
        assert abs(float(ratio) - 1.0) > 2 * tol_ratio
        assert float(a.ratio) == pytest.approx(float(ratio), rel=tol_ratio)
        assert float(a.h_next) == pytest.approx(h_next, rel=tol_h)
    assert float(a.h) == float(hj)
    assert scaled(a.y1, y1) < 1e-5


def test_whole_selection_statistically(setup):
    """The port's own selection against JAX's: both succeed, naccept and
    nreject within 10% (measured 213/7 against JAX's 215/9), step_times has
    JAX's rounded length, and the first step (Hairer's initial step, clear
    of the noise) agrees to 1e-3 (measured 7.8e-4). From the second step on
    the accepted steps' error estimates are float32 rounding noise
    (``test_one_attempt_matches_jax``) and the grids part by a few percent
    per step."""
    s = setup
    st, stats = s["jgrid"]
    cfg = no.ODESelectConfig(0.0, float(np.asarray(s["jtask"].ts)[-1]),
                             max_steps=round_max_steps((B, 3 * s["P"]), M))
    got_st, got = no.ode_select(torch.zeros(B, 3 * s["P"]), s["pw"], s["sc"], s["kv"], cfg)
    assert got_st.shape[0] == st.shape[0] == 661
    assert int(got[2]) == int(stats[2]) == 1
    assert abs(int(got[0]) - int(stats[0])) <= 0.1 * int(stats[0])
    assert abs(int(got[1]) - int(stats[1])) <= max(2, 0.1 * int(stats[1]))
    np.testing.assert_allclose(got_st[:2].numpy(), st[:2], rtol=1e-3)
    assert float(got_st[int(got[0])]) == float(st[int(stats[0])])  # both end at t_end
    assert bool((got_st[int(got[0]):] == got_st[-1]).all())


def _jax_replay(s):
    """The JAX package's replay step (interpret mode) over JAX's accepted
    steps, computed once for the module: (ys (n, B, 3P), coeffs (n, 5, B,
    3P)) as numpy."""
    if "jreplay" not in s:
        st, stats = s["jgrid"]
        step = jax.jit(lambda t0, h, y: _jstep(s, t0, h, y))
        y, want_ys, want_co = jnp.zeros_like(s["y"]), [], []
        for k in range(int(stats[0])):
            want_ys.append(np.asarray(y))
            y, co = step(st[k], st[k + 1] - st[k], y)
            want_co.append(np.asarray(co))
        s["jreplay"] = np.stack(want_ys), np.stack(want_co)
    return s["jreplay"]


def test_replay_on_jax_grid(setup):
    """ys and the dense coefficients of every accepted step on JAX's grid:
    within 1e-5 of each state component's largest magnitude (measured ys
    4.4e-6; rows 4.4e-6, 2.0e-6, 2.2e-6, 5.6e-6), the last row within 5e-5
    (measured 1.6e-5: a cancelling sum of all seven stage derivatives, and
    the interpolant weighs it by at most 1/16). The rows are held on the
    state's scale, the one they are added on in the interpolant: dy = y1 - y
    carries the float32 rounding of the two states, 5.8e-5 of its own
    largest magnitude."""
    s = setup
    st, stats = s["jgrid"]
    n = int(stats[0])
    ys, co = no.ode_replay_fwd(torch.zeros(B, 3 * s["P"]), torch.as_tensor(st[:n + 1]),
                               s["pw"], s["sc"], s["kv"])
    assert tuple(ys.shape) == (n, B, 3 * s["P"]) and tuple(co.shape) == (n, 5, B, 3 * s["P"])
    want_ys, want_co = _jax_replay(s)
    assert scaled(ys, want_ys) < 1e-5
    scale = np.maximum(np.abs(want_ys).reshape(-1, want_ys.shape[-1]).max(0), 1e-30)
    for r in range(5):
        err = float((np.abs(co[:, r].numpy() - want_co[:, r]) / scale).max())
        assert err < (5e-5 if r == 4 else 1e-5), r


@pytest.mark.parametrize("route", no.ODE_TEAM_ROUTES)
def test_replay_routes_on_jax_grid(setup, route):
    """``ode_replay_fwd`` on each route of the card's cluster team
    (B7t-team: "resident", "streamed", "team8") with CPU tensors: the plain
    version, whatever the route, held against the JAX package's replay on
    its grid with the limits of ``test_replay_on_jax_grid`` (ys and rows
    1-4 within 1e-5 of each state component's largest magnitude, the last
    row within 5e-5), and equal to the route-less call bit for bit."""
    s = setup
    st, stats = s["jgrid"]
    n = int(stats[0])
    args = (torch.zeros(B, 3 * s["P"]), torch.as_tensor(st[:n + 1]), s["pw"], s["sc"], s["kv"])
    ys, co = no.ode_replay_fwd(*args, route=route)
    want_ys, want_co = _jax_replay(s)
    assert scaled(ys, want_ys) < 1e-5
    scale = np.maximum(np.abs(want_ys).reshape(-1, want_ys.shape[-1]).max(0), 1e-30)
    for r in range(5):
        err = float((np.abs(co[:, r].numpy() - want_co[:, r]) / scale).max())
        assert err < (5e-5 if r == 4 else 1e-5), r
    ys0, co0 = no.ode_replay_fwd(*args)
    assert torch.equal(ys, ys0) and torch.equal(co, co0)
    assert all(v == 0 for v in no.LAUNCHES.values())  # plain versions count nothing


def test_solve_loss_and_gradients_on_jax_grid(setup):
    """The whole solve on JAX's frozen grid: ys within 1e-5 of each
    component's largest magnitude (measured 4.4e-6), loss rel <= 1e-5
    (measured 0.0), masked gradients rel L2 <= 3e-2 (measured: input
    2.8e-3, feedforward 1.1e-2, lateral 9.0e-3, output 2.9e-4).

    Why not 1e-3: the kernel-mode reverse sweep is bf16-grade by
    construction. ``jax.vjp`` through the three-term split rounds every
    transposed product to bf16 (models/network.py, "the three-term split"),
    so each drift VJP carries a relative error near 2^-9 whose sign turns
    on the last float32 bit of its input. Either side's own gradient moves
    as much when every weight is nudged by one part in 1e7 (measured: the
    port 2.8e-3, 6.1e-3, 1.2e-2, 6.5e-5; JAX 6.0e-3, 1.1e-2, 5.5e-3,
    7.8e-4), so the two agree as well as either agrees with itself; the
    port's spread is asserted beside the difference."""
    s = setup
    jtask, task = s["jtask"], s["task"]

    def jloss(p):
        ys = jpt.batched_rollout(p, jtask, jnp.asarray(STIMS), use_fused=True)
        out = jpt.readout(ys, p, jtask.net)
        return jnp.mean(jnp.abs(out - jpt.parity_targets(jnp.asarray(STIMS)))), ys

    (want_loss, want_ys), want_g = jax.value_and_grad(jloss, has_aux=True)(jtask.params)
    grid = frozen_grid_from_jax(*s["jgrid"])
    ys, stats = tpt.batched_rollout(task.params, task, torch.as_tensor(STIMS), grid=grid,
                                    return_stats=True)
    assert bool(stats.success) and int(stats.naccept) == int(s["jgrid"][1][0])
    assert scaled(ys.detach(), want_ys) < 1e-5
    assert bool((ys[:, 0] == 0).all())
    loss = torch.mean(torch.abs(tpt.readout(ys, task.params, task.net)
                                - tpt.parity_targets(torch.as_tensor(STIMS))))
    grads = torch.autograd.grad(loss, list(task.params.values()))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    nudged = {k: (p.detach() * (1.0 + 1e-7)).requires_grad_(True)
              for k, p in task.params.items()}
    ys_n = tpt.batched_rollout(nudged, task, torch.as_tensor(STIMS), grid=grid)
    loss_n = torch.mean(torch.abs(tpt.readout(ys_n, nudged, task.net)
                                  - tpt.parity_targets(torch.as_tensor(STIMS))))
    grads_n = torch.autograd.grad(loss_n, list(nudged.values()))
    for (k, m), g, gn in zip(task.grad_mask.items(), grads, grads_n):
        err = rel_l2(g * m, np.asarray(want_g[k]) * np.asarray(jtask.grad_mask[k]))
        spread = rel_l2(gn * m, (g * m).numpy())
        assert err < 3e-2, k
        assert 1e-6 < spread < 3e-2, k  # the gradient's own rounding spread


def test_y0_gradient_and_first_row(setup):
    """``ys.at[0].set(y0)``: output row 0 is y0 itself, so its cotangent
    reaches y0 by the identity and not through coefficient row 0."""
    s = setup
    y0 = torch.as_tensor(s["y"]).clone().requires_grad_(True)
    ts = torch.linspace(0.0, 2e-3, 5)
    ys = odeint_dopri5_fused(s["pw"], s["sc"], s["kv"], y0, ts, max_steps=64)
    assert torch.equal(ys[0], y0)
    g, = torch.autograd.grad(ys[0].sum(), y0)
    assert torch.equal(g, torch.ones_like(g))


def test_wrappers_check_their_tensors(setup):
    s = setup
    cfg = no.ODESelectConfig(0.0, 0.06, max_steps=660)
    with pytest.raises(ValueError, match="wT must be torch.float32"):
        no.ode_select(torch.zeros(B, 3 * s["P"]), {**s["pw"], "wT": s["pw"]["wT"].double()},
                      s["sc"], s["kv"], cfg)
    with pytest.raises(ValueError, match="step_times has shape"):
        no.ode_replay_bwd(torch.zeros(3, B, 3 * s["P"]), torch.zeros(3, 5, B, 3 * s["P"]),
                          torch.zeros(3), s["pw"], s["sc"], s["kv"])
    assert all(v == 0 for v in no.LAUNCHES.values())  # plain versions count nothing
