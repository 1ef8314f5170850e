"""Port parity: the three-term SDE sweeps in kernel mode (the plain versions
of B3t and B4't, ``kernels.network_sde.replay3_fwd``/``replay3_bwd``, and
``solvers.fused.sdeint_fused(prepare="split")``) against
``columnflow.solvers.fused.sdeint_fused`` with ``prepare_premixed_split``
(its Pallas kernels in interpret mode), on the uniform grid (the fixed-grid
step, ``--stochastic``) and on per-lane grids (the adaptive replay,
``--stochastic --adaptive`` below 104 columns).

Size: columns (2, 1), 2 inputs, batch 4, 60 grid points; the per-lane grids
are JAX's own XLA selection on the jax.random tree
(``test_torch_sde_jaxtree.build_setup``), the fixed grid's noise JAX's
``_brownian_pack``. Both sides take the JAX package's parameters.

Tolerances, each measured here:
- one step's VJP: the state cotangent rel L2 1e-4; the wT / iwT
  cotangents cannot hold 1e-4 (measured up to 5.2e-4: a bf16 rounding of a
  cotangent product flips between XLA's float32 sums and the port's float64
  sums, 2^-9 on that entry) and are held at 1e-3 (ROADMAP.md section C);
- the sweep on JAX's own trajectory: rel L2 3e-2 (measured 1.4e-3 for the
  state cotangent, 6.4e-3 / 4.2e-3 for wT / iwT, beside the port's own
  spread under a 1e-7 nudge of the weights, 1.3e-3 / 4.6e-3);
- the fixed-grid forward: 5e-5 of each component's largest magnitude over
  the 60 points;
- loss rel 1e-5; gradients rel L2 3e-2 (the kernel-mode precedent of the
  deterministic engine), beside each side's own spread under a 1e-7 nudge
  of the weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.models import network as jn
from columnflow.solvers import fused as jf
from columnflow.solvers import sde_adaptive as jsa
from columnflow.solvers.sde import _brownian_pack
from columnflow.tasks import parity as jpt
from columnflow_torch.convert import lane_key_words
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.models import network as tn
from columnflow_torch.solvers import fused as tf
from columnflow_torch.solvers import sde_adaptive as tsa
from columnflow_torch.tasks import parity as tpt
from test_torch_sde_jaxtree import B, M, STIMS, build_setup


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).reshape(-1, want.shape[-1]).max(0), 1e-30)
    return float((np.abs(got - want) / scale).max())


@pytest.fixture(scope="module")
def setup():
    s = build_setup()
    key = jax.random.PRNGKey(21)
    ts = s["jtask"].ts
    _, i1, i10, _, _ = _brownian_pack(key, ts, (B, 1), jnp.float32)
    s["pack"] = (np.asarray(i1), np.asarray(i10))
    return s


def _jax_uniform(s, jpw):
    """JAX's fixed-grid fused SDE of the parity task (batched_rollout's
    ``use_fused and not adaptive`` branch) on the setup's noise pack."""
    P = s["P"]
    return jf.sdeint_fused(
        s["drift"](jn.network_drift_premixed), s["a_diff"], jnp.zeros((B, 3 * P)), s["jtask"].ts,
        None, jpw, s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1), method="srk", noise_shape=(B, 1),
        noise_pack=tuple(jnp.asarray(x) for x in s["pack"]), nondiff_args=(1, 2),
        prepare=jn.prepare_premixed_split, interpret=True)


def _port_uniform(s, pw):
    m = s["model"]
    return tf.sdeint_fused(pw, m.sc, m.kv, torch.zeros(B, 3 * s["P"]), ts=s["task"].ts,
                           noise_pack=tuple(torch.as_tensor(x) for x in s["pack"]),
                           prepare="split", vjp_drift=None)


def _loss_jax(s, ys_btp):
    out = jpt.readout(ys_btp, s["jtask"].params, s["jtask"].net)
    return jnp.mean(jnp.abs(out - jpt.parity_targets(jnp.asarray(STIMS))))


def _loss_port(s, ys_btp):
    out = tpt.readout(ys_btp, s["task"].params, s["task"].net)
    return torch.mean(torch.abs(out - tpt.parity_targets(torch.as_tensor(STIMS))))


def _port_pw(s, scale=1.0):
    return {k: (v.detach() * scale).clone().requires_grad_(True) for k, v in s["model"].pw.items()}


def test_fixed_grid_forward_matches_jax(setup):
    """Measured 1.4e-6 of scale over the 60 points."""
    s = setup
    want = _jax_uniform(s, s["jpw"])
    got = _port_uniform(s, s["model"].pw)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert scaled(got.detach().numpy(), want) < 5e-5


def test_fixed_grid_loss_and_gradients_match_jax(setup):
    s = setup
    want_loss, want_g = jax.value_and_grad(
        lambda pw: _loss_jax(s, jnp.transpose(_jax_uniform(s, pw), (1, 0, 2))))(s["jpw"])
    grads = []
    for scale in (1.0, 1.0 + 1e-7):
        pw = _port_pw(s, scale)
        loss = _loss_port(s, _port_uniform(s, pw).transpose(0, 1))
        loss.backward()
        grads.append({k: v.grad.numpy() for k, v in pw.items()})
        if scale == 1.0:
            assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k in ("wT", "iwT"):
        spread = rel_l2(grads[1][k], grads[0][k])
        assert np.isfinite(grads[0][k]).all()
        assert rel_l2(grads[0][k], want_g[k]) < 3e-2 + 10 * spread, k


def _jax_step_vjp(s, t0, h, y, i1, i10, c, lane_times=True):
    step = jf._make_sde_step(s["drift"](jn.network_drift_premixed), s["a_diff"], "srk",
                             safe_h=lane_times)
    kv = jnp.moveaxis(s["kv_all"], 0, 1)

    def f(y_, wT, iwT):
        pw3 = jn.prepare_premixed_split({"wT": wT, "iwT": iwT}, s["jfc"])[0]
        return step(t0, h, y_, i1, i10, (pw3, s["jfc"], kv))

    _, vjp = jax.vjp(f, y, s["jpw"]["wT"], s["jpw"]["iwT"])
    return vjp(c)


def test_one_step_vjp_matches_jax_vjp(setup):
    """One SRA1 step of the batch on the three-term split: the state
    cotangent rel L2 <= 1e-4 (measured 5.1e-5), the step's wT / iwT
    cotangents (the second stage's evaluation opens the bf16 accumulators,
    the first adds, one fold) <= 1e-3 (measured 5.0e-4 / 5.2e-4 at the
    largest step, 8e-5 and 0.0 at the others)."""
    s = setup
    P, m = s["P"], s["model"]
    rng = np.random.default_rng(7)
    w3 = tn.prepare_premixed_split({k: v.detach() for k, v in m.pw.items()}, m.sc.fc)[0]
    for trial in range(3):
        y = np.concatenate([rng.uniform(-5, 25, (B, P)), rng.uniform(0, 5, (B, P)),
                            rng.uniform(0, 50, (B, P))], axis=1).astype(np.float32)
        c = rng.normal(size=(B, 3 * P)).astype(np.float32)
        t0 = rng.uniform(0.0, 0.05, (B, 1)).astype(np.float32)
        h = np.full((B, 1), 2e-4 * (trial + 1), np.float32)
        i1 = rng.normal(0, 1e-2, (B, 1)).astype(np.float32)
        i10 = (h * (0.5 * i1 + np.sqrt(h / 12) * rng.normal(size=(B, 1)))).astype(np.float32)
        want = _jax_step_vjp(s, *(jnp.asarray(x) for x in (t0, h, y, i1, i10, c)))
        got = ns.step_vjp_split3(*(torch.as_tensor(x) for x in (t0, h, y, i10, c)), w3, m.sc,
                                 m.kv)
        assert rel_l2(got[0].numpy(), want[0]) < 1e-4
        for g, w in zip(got[1:], want[1:]):
            assert rel_l2(g.numpy(), w) < 1e-3


def test_step_vjp_algebra_equals_autograd_in_float64(setup):
    """The same step in float64, where ``_bf`` passes values through: the
    hand-written VJP equals autograd of the plain step to rel 1e-9, so the
    float32 version differs from the exact one by its bf16 rounding points
    alone."""
    s = setup
    P, m = s["P"], s["model"]
    rng = np.random.default_rng(8)
    f64 = torch.float64
    wT = m.pw["wT"].detach().to(f64).requires_grad_(True)
    iwT = m.pw["iwT"].detach().to(f64).requires_grad_(True)
    y = torch.as_tensor(np.concatenate([rng.uniform(-5, 25, (B, P)), rng.uniform(0, 5, (B, P)),
                                        rng.uniform(0, 50, (B, P))], axis=1)).requires_grad_(True)
    c = torch.as_tensor(rng.normal(size=(B, 3 * P)))
    t0 = torch.full((B, 1), 0.045, dtype=f64)  # the stimulus is on
    h = torch.full((B, 1), 5e-4, dtype=f64)
    i1 = torch.as_tensor(rng.normal(0, 1e-2, (B, 1)))
    i10 = torch.as_tensor(rng.normal(0, 1e-6, (B, 1)))
    fc = {k: (v.to(f64) if torch.is_tensor(v) else v) for k, v in m.sc.fc.items()}
    sc = ns.SDEConsts(fc, m.sc.knot_ts)
    kv = m.kv.to(f64)
    w3 = tn.prepare_premixed_split({"wT": wT, "iwT": iwT}, fc)[0]
    drift = lambda t, x: ns.drift_premixed(t, x, w3, sc, kv)  # noqa: E731
    out = ns.sra1_step(drift, t0, h, y, i1, i10)
    want = torch.autograd.grad((out * c).sum(), [y, wT, iwT])
    w3d = {k: v.detach() for k, v in w3.items()}
    got = ns.step_vjp_split3(t0, h, y.detach(), i10, c, w3d, sc, kv)
    for g, w in zip(got, want):
        assert rel_l2(g.numpy(), w.numpy()) < 1e-9


def test_sweep_on_jax_trajectory_matches_jax(setup):
    """The kernel-mode reverse sweep of the fixed grid, fed JAX's own
    trajectory and a cotangent on every state: ybar, d wT and d iwT rel L2
    <= 3e-2 (measured 1.4e-3, 6.4e-3, 4.2e-3; the port's own 1e-7-nudge
    spread is 1.3e-3 and 4.6e-3: over 59 steps the pathwise cotangent is
    that sensitive). The steps' weight cotangents add chunk by chunk (one
    chunk of 59 steps here) as the JAX kernel sums them."""
    s = setup
    m = s["model"]
    rng = np.random.default_rng(9)
    ys_j = np.asarray(_jax_uniform(s, s["jpw"]))
    ysbar = rng.normal(size=ys_j.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda y0, pw: jf.sdeint_fused(
        s["drift"](jn.network_drift_premixed), s["a_diff"], y0, s["jtask"].ts, None, pw,
        s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1), method="srk", noise_shape=(B, 1),
        noise_pack=tuple(jnp.asarray(x) for x in s["pack"]), nondiff_args=(1, 2),
        prepare=jn.prepare_premixed_split, interpret=True), jnp.zeros(ys_j.shape[1:]), s["jpw"])
    want_y0, want_pw = vjp(jnp.asarray(ysbar))
    t0s, h = tf.uniform_step_times(s["task"].ts, (B, 3 * s["P"]))
    n = t0s.shape[0]
    i10 = torch.as_tensor(s["pack"][1]).reshape(n, B)
    chunk = tf.sweep_chunk((B, 3 * s["P"]), n)
    pw = {k: v.detach().contiguous() for k, v in m.pw.items()}
    ybar, d_wT, d_iwT = ns.replay3_bwd(torch.as_tensor(ys_j[:-1]), torch.as_tensor(ysbar[1:]),
                                       t0s, torch.full_like(t0s, h), i10, n, 0, chunk, pw, m.sc,
                                       m.kv)
    assert rel_l2(ybar.numpy() + ysbar[0], want_y0) < 3e-2
    assert rel_l2(d_wT.numpy(), want_pw["wT"]) < 3e-2
    assert rel_l2(d_iwT.numpy(), want_pw["iwT"]) < 3e-2


@pytest.mark.parametrize("bptt_every", [None, 3])
def test_lanes_replay_loss_and_gradients_on_jax_grid(setup, bptt_every):
    """The adaptive replay over JAX's frozen per-lane grids (the XLA
    selection's, jax.random noise), three-term split, kernel mode. bptt 3
    is a 6-half-step window: the sweep's chunk is 6 and the cotangent is
    zeroed after every 6th half step. Loss rel 1e-5, gradients rel L2 3e-2
    beside the port's own nudge spread."""
    s = setup
    st, na, nr = (jnp.asarray(x) for x in s["grid"][:3])
    P = s["P"]

    def loss_jax(pw):
        ys = jsa._replay_pass_fused_batch(
            "sra1", True, s["drift"](jn.network_drift_premixed), s["a_diff"],
            jnp.zeros((B, 3 * P)), s["jtask"].ts, st, na, M, s["keys"],
            (pw, s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1)), "jax", 20, s["jtask"].ts[0],
            s["jtask"].ts[-1], interpret=True, nondiff_args=(1, 2),
            prepare=jn.prepare_premixed_split, bptt_every=bptt_every)
        return _loss_jax(s, ys)

    want_loss, want_g = jax.value_and_grad(loss_jax)(s["jpw"])
    grads = []
    for scale in (1.0, 1.0 + 1e-7):
        pw = _port_pw(s, scale)
        model = tsa.PremixedNetworkSDE(pw, s["model"].sc, s["model"].kv)
        ys = tsa.sdeint_adaptive_batch(
            model, torch.zeros(B, 3 * P), s["task"].ts, lane_key_words(s["keys"]), max_steps=M,
            bptt_every=bptt_every, grid=tuple(torch.as_tensor(np.array(x)) for x in s["grid"][:3]),
            fused_pass=False, select_bf16=False, prepare="split", grad_bf16=False)
        loss = _loss_port(s, ys)
        loss.backward()
        grads.append({k: v.grad.numpy() for k, v in pw.items()})
        if scale == 1.0:
            assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k in ("wT", "iwT"):
        spread = rel_l2(grads[1][k], grads[0][k])
        assert np.isfinite(grads[0][k]).all()
        assert rel_l2(grads[0][k], want_g[k]) < 3e-2 + 10 * spread, k


@pytest.mark.parametrize("cpa,prepare,vjp,arg_grads,lanes,want", [
    ((2, 1), "split", None, "auto", True, "split"),
    ((8, 4, 1), "split", None, "auto", True, "split"),  # 43 KB of weights: kernel mode
    ((64, 32, 8), "split2", "gradbf16", "auto", True, "split2"),
    ((2, 1), "split2", "gradbf16", "auto", True, "split2"),  # the substitute forces outer
    ((64, 32, 8), "split", None, "auto", True, "split-outer"),  # 2.8 MB: outer, three-term
    ((2, 1), "split", "gradbf16", "auto", True, "split-outer"),  # the substitute forces outer
    # The two-term split without the substitute: kernel mode (B4s) while
    # the weights hold at most 1 MiB, the exact outer pass from 64 columns.
    ((2, 1), "split2", None, "auto", True, "split2-kernel"),
    ((64, 32, 8), "split2", None, "auto", True, "split2-outer"),
    ((2, 1), "split2", None, "outer", True, "split2-outer"),
    ((2, 1), "split2", "gradbf16", "auto", False, "uniform grid"),
    ((2, 1), "split2", None, "auto", False, "uniform grid"),
    ((2, 1), "split", "gradbf16", "kernel", True, ValueError),
    # The uniform grid (the fixed-grid step): the three-term split in outer
    # mode, exact (the substitute on that grid: test_torch_sde_lanes_outer).
    ((64, 32, 8), "split", None, "auto", False, "split-outer"),
    ((2, 1), "split", None, "outer", False, "split-outer"),
    ((192, 96, 24), "split", None, "auto", False, "split-outer")])
def test_sdeint_fused_resolves_its_tier_as_jax(cpa, prepare, vjp, arg_grads, lanes, want):
    P = 8 * sum(cpa)
    pw = {"wT": torch.empty(P, P, device="meta"), "iwT": torch.empty(4, P, device="meta")}
    if want is ValueError:
        with pytest.raises(ValueError, match="vjp_drift"):
            tf.sde_tier(pw, prepare, vjp, arg_grads, lanes)
    elif want in ("split", "split2", "split-outer", "split2-kernel", "split2-outer"):
        assert tf.sde_tier(pw, prepare, vjp, arg_grads, lanes) == want
    else:
        with pytest.raises(NotImplementedError, match=want):
            tf.sde_tier(pw, prepare, vjp, arg_grads, lanes)


def test_sdeint_fused_takes_one_grid(setup):
    s = setup
    m = s["model"]
    y0 = torch.zeros(B, 3 * s["P"])
    with pytest.raises(ValueError, match="either"):
        tf.sdeint_fused(m.pw, m.sc, m.kv, y0, noise_pack=s["pack"])
    with pytest.raises(NotImplementedError, match="per-sample"):
        tf.sdeint_fused(m.pw, m.sc, m.kv, y0, torch.linspace(0, 1, 5), s["pack"], prepare="split",
                        vjp_drift=None)
    with pytest.raises(NotImplementedError, match="uniform grid"):
        tf.sdeint_fused(m.pw, m.sc, m.kv, y0, ts=s["task"].ts, noise_pack=s["pack"])


def test_wrappers_check_their_tensors(setup):
    s = setup
    m = s["model"]
    pw = {k: v.detach().contiguous() for k, v in m.pw.items()}
    n, P = 8, s["P"]
    t0s, hs = torch.zeros(n, B), torch.full((n, B), 1e-3)
    noise = torch.zeros(n, B)
    y0 = torch.zeros(B, 3 * P)
    with pytest.raises(ValueError, match="n_real"):
        ns.replay3_fwd(y0, t0s, hs, noise, noise, n + 1, pw, m.sc, m.kv)
    with pytest.raises(ValueError, match="hs has shape"):
        ns.replay3_fwd(y0, t0s, hs[:, :1].contiguous(), noise, noise, n, pw, m.sc, m.kv)
    with pytest.raises(ValueError, match="contiguous"):
        ns.replay3_fwd(y0, t0s, hs, noise, noise, n, m.pw, m.sc, m.kv)
    with pytest.raises(ValueError, match="chunk"):
        ns.replay3_bwd(torch.zeros(n, B, 3 * P), torch.zeros(n, B, 3 * P), t0s, hs, noise, n, 0,
                       0, pw, m.sc, m.kv)
    ys = ns.replay3_fwd(y0, t0s[:, 0].contiguous(), hs[:, 0].contiguous(), noise, noise, n, pw,
                        m.sc, m.kv)
    ys_l = ns.replay3_fwd(y0, t0s, hs, noise, noise, n, pw, m.sc, m.kv)
    assert torch.equal(ys, ys_l)  # the uniform grid is every lane's grid
