"""Port parity: the three-term SDE replay in outer mode (the fixed-grid step
from 64 through 312 columns, ``--stochastic``): the plain versions of B4t
(``kernels.network_sde.replay3_bwd_emit``) and B3t-team (``replay3_fwd``),
the step-batched weight VJPs ``solvers.fused.outer_arg_grads_split3`` and
``sdeint_fused(prepare="split")`` with ``arg_grads`` "outer", against
``columnflow.solvers.fused.sdeint_fused`` with ``prepare_premixed_split``
and ``arg_grads="outer"`` (its Pallas kernels in interpret mode), and
against the port's own kernel mode.

Size: columns (2, 1), 2 inputs, batch 4, 60 grid points, the JAX package's
parameters and ``test_torch_sde_split3``'s noise pack; the per-lane grids
are JAX's XLA selection (``test_torch_sde_jaxtree.build_setup``). At this
size the weights hold 2.7 KB, so the port goes to outer mode with
``OUTER_ARG_BYTES`` at 0 and JAX is told ``arg_grads="outer"``.

Tolerances, each measured here and stated at its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import columnflow.solvers as jsolvers
from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import network as jn
from columnflow.solvers import fused as jf
from columnflow.tasks import parity as jpt
from columnflow.train import mask_grads as j_mask_grads
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import network_from_jax
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.solvers import fused as tf
from columnflow_torch.tasks import parity as tpt
from test_torch_sde_jaxtree import B, STIMS, T
from test_torch_sde_split3 import (  # noqa: F401  (setup is a fixture)
    _jax_uniform,
    _loss_jax,
    _loss_port,
    _port_pw,
    _port_uniform,
    rel_l2,
    scaled,
    setup,
)


@pytest.fixture
def outer(monkeypatch):
    """The port in outer mode at any size ("auto" resolves to "outer")."""
    monkeypatch.setattr(tf, "OUTER_ARG_BYTES", 0)


def _flat(s, jpw):
    """The JAX kernels' step function and flattened arguments on the
    three-term split, as ``sdeint_fused`` builds them."""
    kv = jnp.moveaxis(s["kv_all"], 0, 1)
    args = (jpw, s["jfc"], kv)
    func, prep, dyn, _ = jf._flatten_for_kernel(s["drift"](jn.network_drift_premixed), args,
                                                (1, 2), jn.prepare_premixed_split)
    diff, _, _, _ = jf._flatten_for_kernel(s["a_diff"], args, (1, 2), jn.prepare_premixed_split)
    return func, diff, prep, dyn


def _jax_emit(s, jpw, ys_prev, ysbar, lanes=None):
    """The JAX package's emit-mode reverse-sweep kernel on the three-term
    split (interpret mode), all steps in one chunk: (ybar0, seeds). The
    uniform grid of the task, or ``lanes`` = (t0s, hs) (n, B) per-lane
    grids with their noise (i1, i10) (n, B)."""
    func, diff, prep, dyn = _flat(s, jpw)
    n = ys_prev.shape[0]
    S = ys_prev.shape[1:]
    if lanes is None:
        ts = np.asarray(s["jtask"].ts)
        h, t_base = float(ts[1] - ts[0]), float(ts[0])
        i1, i10 = (jnp.asarray(x).reshape(n, B) for x in s["pack"])
        variable, extra, n_smem, n_vmem = False, (), 1, 0
    else:
        t0s, hs, i1, i10 = (jnp.asarray(x) for x in lanes)
        h = t_base = None
        variable, n_smem, n_vmem = "lanes", 2, 2
        extra = (jnp.array([[n]], jnp.int32), t0s[:, :, None], hs[:, :, None])
    step = jf._make_sde_step(func, diff, "srk", safe_h=bool(variable))
    i1, i10 = (jnp.broadcast_to(x[:, :, None], (n,) + S) for x in (i1, i10))
    call = pl.pallas_call(
        jf._make_sde_bwd_chunk_kernel(step, prep, len(dyn), n, h, t_base, (), emit_steps=True,
                                      variable_h=variable),
        out_shape=(jax.ShapeDtypeStruct(S, jnp.float32),
                   jax.ShapeDtypeStruct((n,) + S, jnp.float32)),
        in_specs=([pl.BlockSpec(memory_space=pltpu.SMEM)] * n_smem
                  + [jf._VMEM()] * (n_vmem + 5 + len(dyn))),
        out_specs=(jf._VMEM(), jf._VMEM()), interpret=True)
    return call(jnp.zeros((1, 1), jnp.int32), *extra, jnp.asarray(ys_prev), jnp.asarray(ysbar),
                jnp.zeros(S, jnp.float32), i1, i10, *dyn)


def _uniform_inputs(s):
    """JAX's trajectory on the fixed grid, a cotangent on every state, and
    the port's sweep arguments (the kernels' step times, the noise)."""
    ys = np.asarray(_jax_uniform(s, s["jpw"]))
    ysbar = np.random.default_rng(9).normal(size=ys.shape).astype(np.float32)
    t0s, h = tf.uniform_step_times(s["task"].ts, (B, 3 * s["P"]))
    n = t0s.shape[0]
    i10 = torch.as_tensor(s["pack"][1]).reshape(n, B)
    return ys, ysbar, t0s, torch.full_like(t0s, h), i10


def _pw(s, scale=1.0):
    return {k: (v.detach() * scale).contiguous() for k, v in s["model"].pw.items()}


@pytest.fixture(scope="module")
def jax_replay(setup):
    """JAX's fixed-grid three-term replay, a cotangent on every state, and
    JAX's emit-mode sweep on that trajectory, at the weights and nudged by
    1e-7 (the sweep's own spread)."""
    s = setup
    ys, ysbar, t0s, hs, i10 = _uniform_inputs(s)
    nudged = {k: v * (1.0 + 1e-7) for k, v in s["jpw"].items()}
    return dict(ys=ys, ysbar=ysbar, grid=(t0s, hs, i10),
                emit=_jax_emit(s, s["jpw"], ys[:-1], ysbar[1:]),
                emit_nudged=_jax_emit(s, nudged, ys[:-1], ysbar[1:]))


@pytest.mark.parametrize("route", [None, "resident", "streamed", "team8"])
def test_replay_routes_hold_jax_three_term_replay(setup, jax_replay, route):
    """``replay3_fwd`` and ``replay3_bwd_emit`` on each ``route`` (CPU
    tensors: the plain versions, whatever the route) against the JAX
    package's three-term replay on the fixed grid and its emit-mode sweep,
    at 3 columns: the forward within 5e-5 of each component's scale (as
    ``test_fixed_grid_forward_matches_jax``), the sweep within 1e-3 plus
    twice the larger nudge spread, rel L2 (as
    ``test_emit_sweep_on_jax_trajectory_matches_jax``)."""
    s, j = setup, jax_replay
    m = s["model"]
    t0s, hs, i10 = j["grid"]
    n, P = t0s.shape[0], s["P"]
    i1 = torch.as_tensor(s["pack"][0]).reshape(n, B)
    ys = ns.replay3_fwd(torch.zeros(B, 3 * P), t0s, hs, i1, i10, n, _pw(s), m.sc, m.kv,
                        route=route)
    assert ys.shape == j["ys"].shape and torch.isfinite(ys).all()
    assert scaled(ys.numpy(), j["ys"]) < 5e-5
    args = (torch.as_tensor(j["ys"][:-1]), torch.as_tensor(j["ysbar"][1:]), t0s, hs, i10, n, 0)
    yb, seeds = ns.replay3_bwd_emit(*args, _pw(s), m.sc, m.kv, route=route)
    yb_n, seeds_n = ns.replay3_bwd_emit(*args, _pw(s, 1.0 + 1e-7), m.sc, m.kv, route=route)
    (want_yb, want_seeds), (jyb_n, jseeds_n) = j["emit"], j["emit_nudged"]
    spread = max(rel_l2(yb_n, yb), rel_l2(seeds_n, seeds), rel_l2(jyb_n, want_yb),
                 rel_l2(jseeds_n, want_seeds))
    err = (rel_l2(yb, want_yb), rel_l2(seeds, want_seeds))
    assert max(err) < 1e-3 + 2 * spread, (err, spread)


def test_emit_sweep_on_jax_trajectory_matches_jax(setup):
    """B4t's plain version on JAX's fixed-grid trajectory with a cotangent
    on every state, against JAX's emit kernel: ybar0 and the seeds of all 59
    steps. It cannot hold 1e-3 alone: measured ybar0 1.4e-3 and the seeds
    1.5e-3 rel L2, where a 1e-7 nudge of the weights moves the port's own
    ybar0 by 1.3e-3 (its seeds 9.1e-4) and JAX's by 2.4e-3 (6.0e-4): over
    59 steps the pathwise cotangent is that sensitive, and every transposed
    product rounds to bf16 on both sides (ROADMAP.md section C). Held at
    1e-3 plus twice the largest of those spreads."""
    s = setup
    m = s["model"]
    ys, ysbar, t0s, hs, i10 = _uniform_inputs(s)
    n = t0s.shape[0]
    want_yb, want_seeds = _jax_emit(s, s["jpw"], ys[:-1], ysbar[1:])
    args = (torch.as_tensor(ys[:-1]), torch.as_tensor(ysbar[1:]), t0s, hs, i10, n, 0)
    yb, seeds = ns.replay3_bwd_emit(*args, _pw(s), m.sc, m.kv)
    yb_n, seeds_n = ns.replay3_bwd_emit(*args, _pw(s, 1.0 + 1e-7), m.sc, m.kv)
    jyb_n, jseeds_n = _jax_emit(s, {k: v * (1.0 + 1e-7) for k, v in s["jpw"].items()},
                                ys[:-1], ysbar[1:])
    spread = max(rel_l2(yb_n, yb), rel_l2(seeds_n, seeds), rel_l2(jyb_n, want_yb),
                 rel_l2(jseeds_n, want_seeds))
    err = (rel_l2(yb, want_yb), rel_l2(seeds, want_seeds))
    assert torch.equal(seeds[-1], torch.as_tensor(ysbar[-1]))  # the last step's seed
    assert max(err) < 1e-3 + 2 * spread, (err, spread)
    assert spread < 3e-2


def test_step_batched_outer_vjps_match_jax_vmap(setup):
    """``outer_arg_grads_split3`` on JAX's trajectory and JAX's emitted
    seeds, at the outer pass's step times (t_base + h k), against
    ``jax.vmap`` of ``jax.vjp`` of one SRA1 step through
    ``prepare_premixed_split``: every step's wT / iwT cotangent within 1e-3
    rel L2 (measured up to 4.2e-4 for wT: a bf16 rounding of a product
    cotangent can flip between XLA's float32 sums and the port's float64
    ones, ROADMAP.md section C; iwT is float32 and, while the stimulus is
    off, exactly zero on both sides), and their float32 sums over the steps
    within 3e-2 plus twice the port's own nudge spread (measured 1.9e-5 /
    1.1e-6, the spreads 5.7e-5 / 6.4e-7). The sum is the per-step
    cotangents' float32 sum: at one sub-block it equals ``step_vjp_split3``
    batched over all steps and summed."""
    s = setup
    m = s["model"]
    ys, ysbar, _, _, i10 = _uniform_inputs(s)
    _, seeds = _jax_emit(s, s["jpw"], ys[:-1], ysbar[1:])
    t0o, h = tf.outer_step_times(s["task"].ts)
    n = t0o.shape[0]
    ho = torch.full_like(t0o, h)
    step = jf._make_sde_step(s["drift"](jn.network_drift_premixed), s["a_diff"], "srk",
                             safe_h=False)
    kv = jnp.moveaxis(s["kv_all"], 0, 1)
    i1_j = jnp.asarray(s["pack"][0]).reshape(n, B, 1)
    i10_j = jnp.asarray(s["pack"][1]).reshape(n, B, 1)

    def one(t0, yk, i1k, i10k, seedk):
        def stepfn(wT, iwT):
            pw3 = jn.prepare_premixed_split({"wT": wT, "iwT": iwT}, s["jfc"])[0]
            return step(t0, jnp.float32(h), yk, i1k, i10k, (pw3, s["jfc"], kv))

        return jax.vjp(stepfn, s["jpw"]["wT"], s["jpw"]["iwT"])[1](seedk)

    want_w, want_iw = jax.vmap(one)(jnp.asarray(t0o.numpy()), jnp.asarray(ys[:-1]), i1_j, i10_j,
                                    seeds)
    pw = _pw(s)
    w3 = tf.prepare_premixed_split(pw, m.sc.fc)[0]
    y_t, c_t = torch.as_tensor(ys[:-1]), torch.as_tensor(np.asarray(seeds))
    _, g_w, g_iw = ns.step_vjp_split3(t0o[:, None, None], ho[:, None, None], y_t, i10[:, :, None],
                                      c_t, w3, m.sc, m.kv)
    want_w, want_iw = np.asarray(want_w), np.asarray(want_iw)
    assert all(np.any(want_w[k]) for k in range(n))
    assert max(rel_l2(g_w[k], want_w[k]) for k in range(n)) < 1e-3
    for k in range(n):
        if np.any(want_iw[k]):
            assert rel_l2(g_iw[k], want_iw[k]) < 1e-3, k
        else:
            assert not g_iw[k].any(), k
    d_wT, d_iwT = tf.outer_arg_grads_split3(y_t, c_t, t0o, ho, i10, pw, m.sc, m.kv)
    assert torch.equal(d_wT, g_w.sum(0)) and torch.equal(d_iwT, g_iw.sum(0))  # one sub-block
    d_n = tf.outer_arg_grads_split3(y_t, c_t, t0o, ho, i10, _pw(s, 1.0 + 1e-7), m.sc, m.kv)
    for got, nudged, want in ((d_wT, d_n[0], want_w), (d_iwT, d_n[1], want_iw)):
        spread = rel_l2(nudged, got)
        assert rel_l2(got, want.sum(0)) < 3e-2 + 2 * spread


def test_outer_pass_blocks_and_sub_blocks_sum_the_same_steps(setup, monkeypatch):
    """The outer pass's sum over blocks of ``block`` steps, each summed over
    sub-blocks (their size set through ``OUTER_SUB_BYTES``) before it joins
    the total: any cut of the 59 steps gives the per-step cotangents' sum
    up to float32 reassociation (rel L2 <= 1e-6; measured up to 1.1e-7)."""
    s = setup
    m = s["model"]
    ys, ysbar, _, _, i10 = _uniform_inputs(s)
    t0o, h = tf.outer_step_times(s["task"].ts)
    ho = torch.full_like(t0o, h)
    y_t, c_t = torch.as_tensor(ys[:-1]), torch.as_tensor(ysbar[1:])
    want = tf.outer_arg_grads_split3(y_t, c_t, t0o, ho, i10, _pw(s), m.sc, m.kv)
    for block, sub in ((16, 5), (7, 7), (256, 1)):
        monkeypatch.setattr(tf, "OUTER_SUB_BYTES", sub * 4 * s["P"] ** 2)
        got = tf.outer_arg_grads_split3(y_t, c_t, t0o, ho, i10, _pw(s), m.sc, m.kv, block=block)
        for g, w in zip(got, want):
            assert rel_l2(g, w) < 1e-6, (block, sub)


def test_outer_step_times_are_jaxs(setup):
    """The outer pass's step times are t_base + h k in float32, bit for bit
    as ``_outer_sde_arg_grads`` computes them; at this size (one chunk of
    59 steps) they equal the sweep kernels' times."""
    s = setup
    ts = np.asarray(s["jtask"].ts)
    h, t_base = float(ts[1] - ts[0]), float(ts[0])
    want = np.asarray((t_base + h * jnp.arange(ts.shape[0] - 1)).astype(jnp.float32))
    got, h_got = tf.outer_step_times(s["task"].ts)
    np.testing.assert_array_equal(got.numpy(), want)
    assert h_got == h
    np.testing.assert_array_equal(tf.uniform_step_times(s["task"].ts, (B, 3 * s["P"]))[0].numpy(),
                                  want)
    # At the 104-column state (4, 2496) the chunk is 8, and a later chunk's
    # times are (8c h + t_base) + i h: an ulp (6e-8) from t_base + h k at
    # 232 of the 999 steps.
    ts_full = torch.linspace(0.0, 0.999, 1000)
    chunked = tf.uniform_step_times(ts_full, (4, 2496))[0]
    outer_t = tf.outer_step_times(ts_full)[0]
    assert tf.sde_chunk((4, 2496), 999) == 8
    assert (chunked - outer_t).abs().max() <= 1e-7


def _jax_outer_loss(s):
    """JAX's fixed-grid loss with the weight gradients in outer mode."""
    P = s["P"]

    def loss(pw):
        ys = jf.sdeint_fused(
            s["drift"](jn.network_drift_premixed), s["a_diff"], jnp.zeros((B, 3 * P)),
            s["jtask"].ts, None, pw, s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1), method="srk",
            noise_shape=(B, 1), noise_pack=tuple(jnp.asarray(x) for x in s["pack"]),
            nondiff_args=(1, 2), prepare=jn.prepare_premixed_split, arg_grads="outer",
            interpret=True)
        return _loss_jax(s, jnp.transpose(ys, (1, 0, 2)))

    return loss


def _port_grads(s, scale=1.0):
    pw = _port_pw(s, scale)
    loss = _loss_port(s, _port_uniform(s, pw).transpose(0, 1))
    loss.backward()
    return float(loss), {k: v.grad.numpy() for k, v in pw.items()}


def test_outer_mode_loss_and_gradients_match_jax_outer_mode(setup, outer):
    """The whole fixed-grid solve in outer mode against JAX's outer mode:
    loss rel 1e-5 (measured: equal), the wT / iwT gradients rel L2 within
    3e-2 plus twice the larger of the two sides' own spreads under a 1e-7
    nudge of the weights (measured 1.3e-3 / 7.4e-4 against spreads of
    2.0e-3 / 7.5e-4)."""
    s = setup
    assert tf.sde_tier(s["model"].pw, "split", None, "auto", False) == "split-outer"
    jloss = _jax_outer_loss(s)
    want_loss, want_g = jax.value_and_grad(jloss)(s["jpw"])
    _, want_gn = jax.value_and_grad(jloss)({k: v * (1.0 + 1e-7) for k, v in s["jpw"].items()})
    loss, grads = _port_grads(s)
    _, grads_n = _port_grads(s, 1.0 + 1e-7)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for k in ("wT", "iwT"):
        spread = max(rel_l2(grads_n[k], grads[k]), rel_l2(want_gn[k], want_g[k]))
        assert np.isfinite(grads[k]).all()
        assert rel_l2(grads[k], want_g[k]) < 3e-2 + 2 * spread, (k, spread)


def test_outer_mode_matches_the_ports_kernel_mode(setup, outer, monkeypatch):
    """``_Replay3Outer`` against ``_Replay3`` (kernel mode) on the same
    inputs: the same trajectory, and gradients that differ only in the
    float32 order of the per-step sums (one 59-step block summed by
    ``torch.sum`` against the kernel sweep's running chunk sum): rel L2
    within 1e-5 (measured 2.5e-10 / 1.4e-7)."""
    s = setup
    loss_o, grads_o = _port_grads(s)
    pw = _port_pw(s)
    ys_o = _port_uniform(s, pw).detach()
    monkeypatch.setattr(tf, "OUTER_ARG_BYTES", 1 << 20)
    assert tf.sde_tier(s["model"].pw, "split", None, "auto", False) == "split"
    loss_k, grads_k = _port_grads(s)
    assert torch.equal(ys_o, _port_uniform(s, _port_pw(s)).detach())
    assert loss_o == loss_k
    for k in ("wT", "iwT"):
        assert rel_l2(grads_o[k], grads_k[k]) < 1e-5, k


def test_train_step_matches_jax_outer_train_step(setup, outer, monkeypatch):
    """One ``make_train_step(task, stochastic=True)`` step in outer mode
    against JAX's ``make_train_step(task, use_fused=True, stochastic=True)``
    with its ``sdeint_fused`` told ``arg_grads="outer"``, on JAX's noise
    pack: loss rel 1e-5, the skip decision equal, each masked gradient
    within rel L2 3e-2 plus twice the larger of the two sides' own spreads
    under a 1e-7 nudge of the weights (measured <= 3.5e-3: feedforward,
    beside spreads of 1.4e-3 / 1.1e-3; losses 1e-7 apart)."""
    from columnflow.solvers.sde import _brownian_pack

    orig = jsolvers.sdeint_fused
    monkeypatch.setattr(jsolvers, "sdeint_fused",
                        lambda *a, **k: orig(*a, **{**k, "arg_grads": "outer"}))
    jtask = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                           n_inputs=2, time_steps=T, max_steps=512)
    stims = jnp.asarray(STIMS)
    key = jax.random.PRNGKey(30)

    @jax.jit
    def grads_of(p):
        def loss(p):
            ys = jpt.batched_rollout(p, jtask, stims, key=key, use_fused=True, stochastic=True)
            return jnp.mean(jnp.abs(jpt.readout(ys, p, jtask.net) - jpt.parity_targets(stims)))

        return j_mask_grads(jax.grad(loss)(p), jtask.grad_mask)

    params = jax.tree_util.tree_map(jnp.array, jtask.params)
    want = {k: np.asarray(v) for k, v in grads_of(params).items()}
    want_n = {k: np.asarray(v) for k, v in grads_of(
        {k: v * (1.0 + 1e-7) for k, v in params.items()}).items()}
    before = {k: np.array(v) for k, v in params.items()}
    step = jpt.make_train_step(jtask, use_fused=True, stochastic=True)
    _, _, want_loss, _, _, want_ok = step(params, jtask.optimizer.init(params), stims, key)
    _, i1, i10, _, _ = _brownian_pack(key, jtask.ts, (B, 1), jnp.float32)
    noise = (torch.as_tensor(np.asarray(i1)), torch.as_tensor(np.asarray(i10)))
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=512,
                          device="cpu")

    def port_step(scale):
        p, _ = network_from_jax({k: v * scale for k, v in before.items()}, jtask.net)
        with torch.no_grad():
            for k, q in task.params.items():
                q.copy_(p[k])
        out = tpt.make_train_step(task, stochastic=True)(torch.as_tensor(STIMS), noise=noise)
        return out, {k: q.grad.detach().numpy().copy() for k, q in task.params.items()}

    out, grads = port_step(1.0)
    _, grads_n = port_step(np.float32(1.0 + 1e-7))
    assert float(out["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    assert out["ok"] == bool(want_ok)
    for k, g in grads.items():
        if not np.any(want[k]):
            assert not np.any(g), k
            continue
        spread = max(rel_l2(grads_n[k], g), rel_l2(want_n[k], want[k]))
        assert np.isfinite(g).all()
        assert rel_l2(g, want[k]) < 3e-2 + 2 * spread, (k, rel_l2(g, want[k]), spread)


def test_lanes_plain_versions_on_jax_lanes_grid(setup):
    """The lanes mode of B3t-team's and B4t's plain versions on JAX's
    per-lane grids (its XLA selection, the jax.random noise, 2 x max
    accepted half steps): the replay within 1e-5 of each component's scale
    of ``sdeint_fused``'s lanes mode (measured 2.4e-6), and the emit sweep
    (a cotangent on every state) against JAX's emit kernel in lanes mode
    within 1e-3 plus twice the port's own nudge spread, rel L2 (measured
    ybar0 3.4e-5 and the seeds 3.5e-5, beside spreads of 3.3e-5 /
    3.5e-5)."""
    from columnflow_torch.solvers import sde_adaptive as tsa

    s = setup
    m = s["model"]
    st = torch.as_tensor(s["grid"][0])
    ht, dw, i10 = tsa._replay_grid(st, s["words"], s["t0"], s["t1"], 20, "jax")
    n = 2 * int(np.max(s["grid"][1]))
    grid = (ht[:, :n].T.contiguous(), (ht[:, 1:n + 1] - ht[:, :n]).T.contiguous(),
            dw[:, :n].T.contiguous(), i10[:, :n].T.contiguous())
    y0 = torch.zeros(B, 3 * s["P"])
    ys = ns.replay3_fwd(y0, *grid, n, _pw(s), m.sc, m.kv)
    func, diff, prep, dyn = _flat(s, s["jpw"])
    want_ys = jf.sdeint_fused(
        s["drift"](jn.network_drift_premixed), s["a_diff"], jnp.zeros((B, 3 * s["P"])), None,
        None, s["jpw"], s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1), method="srk",
        noise_shape=(B, 1), ts_steps=jnp.asarray(torch.cat([grid[0], grid[0][-1:] + grid[1][-1:]])
                                                 .T.numpy()),
        noise_pack=(jnp.asarray(grid[2].numpy()), jnp.asarray(grid[3].numpy())),
        nondiff_args=(1, 2), prepare=jn.prepare_premixed_split, interpret=True)
    assert scaled(ys.numpy(), want_ys) < 1e-5
    ysbar = np.random.default_rng(12).normal(size=ys.shape).astype(np.float32)
    want_yb, want_seeds = _jax_emit(s, s["jpw"], np.asarray(want_ys)[:-1], ysbar[1:],
                                    lanes=[x.numpy() for x in grid])
    args = (torch.as_tensor(np.asarray(want_ys)[:-1]), torch.as_tensor(ysbar[1:]), grid[0],
            grid[1], grid[3], n, 0)
    yb, seeds = ns.replay3_bwd_emit(*args, _pw(s), m.sc, m.kv)
    yb_n, seeds_n = ns.replay3_bwd_emit(*args, _pw(s, 1.0 + 1e-7), m.sc, m.kv)
    spread = max(rel_l2(yb_n, yb), rel_l2(seeds_n, seeds))
    err = (rel_l2(yb, want_yb), rel_l2(seeds, want_seeds))
    assert max(err) < 1e-3 + 2 * spread, (err, spread)


def test_emit_wrapper_checks_and_zero_fills(setup):
    """Rows past n_real carry zero seeds and the carry passes through;
    truncation zeroes the cotangent after every stride-th step."""
    s = setup
    m = s["model"]
    P, n = s["P"], 8
    gen = torch.Generator().manual_seed(3)
    ys = torch.rand(n, B, 3 * P, generator=gen) * 20
    ysbar = torch.randn(n, B, 3 * P, generator=gen)
    t0s, hs = torch.arange(n) * 1e-3, torch.full((n,), 1e-3)
    i10 = torch.zeros(n, B)
    yb, seeds = ns.replay3_bwd_emit(ys, ysbar, t0s, hs, i10, 5, 0, _pw(s), m.sc, m.kv)
    assert not seeds[5:].any() and torch.equal(seeds[4], ysbar[4])
    yb_c, seeds_c = ns.replay3_bwd_emit(ys, ysbar, t0s, hs, i10, n, 3, _pw(s), m.sc, m.kv)
    assert torch.equal(seeds_c[2], ysbar[2])  # zeroed after step 3
    assert torch.equal(yb_c, torch.zeros_like(yb_c))  # and after step 0
    with pytest.raises(ValueError, match="n_real"):
        ns.replay3_bwd_emit(ys, ysbar, t0s, hs, i10, n + 1, 0, _pw(s), m.sc, m.kv)
    with pytest.raises(ValueError, match="ysbar has shape"):
        ns.replay3_bwd_emit(ys, ysbar[1:], t0s, hs, i10, n, 0, _pw(s), m.sc, m.kv)


@pytest.mark.parametrize("cols,want", [(3, "block"), (13, "block"), (23, "block"),
                                       (24, "team"), (64, "team"), (104, "team"), (312, "team")])
def test_forward_kernel_is_chosen_by_shape(cols, want):
    """``replay3_fwd`` takes the one-block kernel where one lane's
    three-term weights, iwT and four state vectors fit a block's 227 KB of
    shared memory (4 inputs: through 23 columns), the team otherwise."""
    assert ns.sde3_fwd_route(8 * cols, 4) == want
