"""Port parity: the XOR task's stochastic-adaptive step (``--stochastic
--adaptive``, and ``--fused --fused-pass``) against the JAX package:
``columnflow.solvers.sde_adaptive`` traced with ``xor_drift_batched`` and
the membrane-only diffusion as ``columnflow/tasks/xor.py:110-172`` builds
them, and ``columnflow.tasks.xor.make_train_step``.

Size: the JAX package's own ``TestXORStochastic::test_adaptive_fused_
rollout_and_grads``: ``build_task(cfg, PRNGKey(0), time_steps=60)``, the
four conditions, lane keys ``jax.random.split(PRNGKey(5), 4)``,
max_steps 512. The JAX selection is its XLA pass (``_adaptive_pass``) on
the ``jax.random`` tree, and on the krng tree (``brownian="kernel"``, the
controller the in-kernel pass B5 computes op for op); the JAX replay
(``_replay_pass_fused_batch``) runs in interpret mode. On the CPU the port
runs its plain versions (``kernels.xor_sde``).

Tolerances, each measured here (ROADMAP.md section C):
- the lane key words of both trees: bit for bit;
- one attempt: the same decision, the error ratio and the next step rel
  1e-3 where the ratio lies near the decision (0.3..20), the next step rel
  1e-2 below it (there the ratio is float32 rounding), the new state within
  1e-5 of its largest magnitude;
- the whole selection: per lane the accepted count within 2% plus twice
  the port's own spread under a 1e-7 nudge of the weights, the rejected
  count within 5% of the accepted plus twice that spread; at the full 1000
  points the budget runs out before 1 s in both packages (each lane's
  reached time within 5% plus twice its spread);
- the replay on JAX's frozen grid: 1e-5 of each component's scale;
- the loss and the four rows' gradients on JAX's grid: within 1e-4 plus
  four times the port's own nudge spread;
- one train step's parameters: abs 1e-4 (RMSprop's first step moves each
  trained entry by +-2.24 lr whatever the gradient's size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow import data as jdata
from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import xor as jx
from columnflow.models.column import Stimulus as JStim
from columnflow.ops.interp import interp_knots as j_knots
from columnflow.ops.interp import step_table_knots as j_step_knots
from columnflow.solvers import krng as jkrng
from columnflow.solvers import sde_adaptive as jsa
from columnflow.tasks import xor as jxt
from columnflow.train import mask_grads as j_mask_grads
from columnflow_torch.convert import lane_key_words
from columnflow_torch.kernels import xor_sde as xs
from columnflow_torch.models import xor as tx
from columnflow_torch.solvers import sde_adaptive as tsa
from columnflow_torch.tasks import xor as txt
from test_torch_xor_model import jax_diffusion, port_task, rel_l2, scaled

T, B, M = 60, 4, 512
CONDS = np.asarray(jxt.xor_conditions())
TREES = ("jax", "kernel")


def jax_lanes(jtask, conds=CONDS):
    """The adaptive path's drift closure, constants and per-lane knot
    values (B, K, 1, 32), as ``columnflow/tasks/xor.py:121-158`` builds
    them."""
    time_steps, dt = jtask.ts.shape[0], jtask.dt
    kts, _ = j_step_knots(time_steps, dt, jnp.zeros(32), jnp.zeros(32))

    def a_drift(t, y, pf, fc, kv):
        return jx.xor_drift_batched(t, y, pf, fc, JStim(0.0, dt, kv),
                                    interp_fn=lambda t_, t0_, dt_, v: j_knots(t_, kts, v))

    def lane_knots(cond):
        on_vals = jdata.prep_xor_stim(cond, time_steps)[-1].reshape(1, 32)
        return j_step_knots(time_steps, dt, jnp.zeros_like(on_vals), on_vals)[1]

    return a_drift, jx.build_xor_fused_consts(jtask.net), jax.vmap(lane_knots)(jnp.asarray(conds))


def jax_select(s, params, brownian, max_steps=M):
    """JAX's XLA selection of every lane (``sdeint_adaptive_batch``'s
    ``one_pass`` without ``fused_pass``): (step_times, naccept, nreject,
    t1) as numpy arrays. The grid ``ts`` enters the jitted pass as an
    argument (see ``jax_body``)."""
    pf = jx.split_xor_params(params)

    def one_pass(y0_b, key_b, kv_b, ts):
        (stp, ee, wi, dbl, _, t0_, t1_, tree, i10_draw, h0) = jsa._setup(
            "sra1", y0_b, ts, key_b, None, 20, brownian=brownian)
        c = jsa._adaptive_pass(stp, ee, wi, s["a_drift"], jax_diffusion, y0_b, t0_, t1_, tree,
                               i10_draw, 1e-3, 1e-3, h0, max_steps, (pf, s["jfc"], kv_b),
                               controller="pi", doubling=dbl)
        return c.step_times, c.naccept, c.nreject, c.t1

    out = jax.jit(jax.vmap(one_pass, in_axes=(0, 0, 0, None)))(
        jnp.zeros((B, 1, 72)), s["keys"], s["kv_all"], s["jtask"].ts)
    return tuple(np.asarray(x) for x in out)


def jax_body(s, b, brownian, jpf):
    """JAX's controller attempt of lane b (``_make_body`` with
    ``_sra1_doubling`` and the PI controller), jitted with the horizon
    [t0, t1] as arguments: with the horizon a compile-time constant, XLA
    rewrites the krng interval code (t - t0) / span * 2^30 and 68% of the
    codes of 1e5 times in [0, 60 ms] move by one (measured), drawing other
    normals than the JAX package's eager ``krng.interval_normal``, its
    in-kernel pass and the port (ROADMAP.md section C)."""
    def body(c, t0, t1):
        tree, i10_draw = jsa._noise_backend(s["keys"][b], t0, t1, 20, jnp.float32, brownian)
        return jsa._make_body(jsa._sra1_step, 0.5, True, s["a_drift"], jax_diffusion, t1, tree,
                              i10_draw, 1e-3, 1e-3, jnp.float32, (jpf, s["jfc"], s["kv_all"][b]),
                              controller="pi", doubling=jsa._sra1_doubling)(c)

    return jax.jit(body)


def jax_replay(s, params, brownian):
    """JAX's lane-batched replay over its frozen grid of ``brownian``,
    interpolated onto ts: (B, T, 72)."""
    st, na = (jnp.asarray(x) for x in s["grid"][brownian][:2])
    ts = s["jtask"].ts
    return jsa._replay_pass_fused_batch(
        "sra1", True, s["a_drift"], jax_diffusion, jnp.zeros((B, 72)), ts, st, na, M, s["keys"],
        (jx.split_xor_params(params), s["jfc"], jnp.moveaxis(s["kv_all"][:, :, 0, :], 0, 1)),
        brownian, 20, ts[0], ts[-1], interpret=True, nondiff_args=(1, 2))


@pytest.fixture(scope="module")
def setup():
    jtask = jxt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), time_steps=T, max_steps=M)
    task = port_task(jtask)
    conds = torch.as_tensor(CONDS)
    sc, kv = txt.drift_inputs(task, conds)
    a_drift, jfc, kv_all = jax_lanes(jtask)
    s = dict(jtask=jtask, task=task, conds=conds, sc=sc, kv=kv, a_drift=a_drift, jfc=jfc,
             kv_all=kv_all, keys=jax.random.split(jax.random.PRNGKey(5), B))
    s["grid"] = {tree: jax_select(s, jtask.params, tree) for tree in TREES}
    return s


def _words(s, tree):
    return tsa._sde_key_words(lane_key_words(s["keys"]), tree)


def _pf(s, scale=1.0):
    return {k: v.detach() * scale for k, v in tx.split_xor_params(s["task"].params).items()}


def _cfg(s, tree):
    return tsa.select_config(s["task"].ts, max_steps=M, brownian=tree, drift="f32")


@pytest.mark.parametrize("tree", TREES)
def test_lane_key_words_equal_jax(setup, tree):
    words = _words(setup, tree).numpy()
    keys = setup["keys"]
    if tree == "jax":
        want = np.concatenate([np.asarray(keys), np.asarray(jax.vmap(
            lambda k: jax.random.fold_in(k, 0x51DE))(keys))], axis=1)
    else:
        want = np.stack([np.asarray(jax.vmap(lambda k, i=i: jsa._sde_key_words(k)[i])(keys))
                         for i in range(4)], axis=1)
        np.testing.assert_array_equal(want[:, :2], np.asarray(jax.vmap(
            lambda k: jnp.stack(jkrng.key_pair(k)))(keys)))
    np.testing.assert_array_equal(words, want.astype(np.int64))


@pytest.mark.parametrize("tree", TREES)
def test_one_attempt_matches_jax_body(setup, tree):
    """From states of the lanes' replay (before, at and after the
    stimulus' onset at 29-30 ms), three steps each: the port's attempt
    (``xor_sde_attempt``, the kernel's plain version) against JAX's
    ``_make_body`` with ``_sra1_doubling`` and the PI controller. The same
    decision; where the error ratio lies near the decision (0.3..20, below
    the controller's clip) the ratio and the next step rel 1e-3 (measured
    5.8e-5 on the jax.random tree, 1.8e-4 on the krng tree); below 0.3 the
    ratio is the float32 rounding of two solutions that agree to a few
    ulps, and the next step (err^-1/4) is held at rel 1e-2 (measured
    1.1e-3); the new state within 1e-5 of its largest magnitude."""
    s = setup
    ys = np.asarray(jax_replay(s, s["jtask"].params, tree))
    pf, jpf = _pf(s), jx.split_xor_params(s["jtask"].params)
    words, cfg = _words(s, tree), _cfg(s, tree)
    t_end = float(s["jtask"].ts[-1])
    decisions, rel, small = set(), [0.0], [0.0]
    horizon = (jnp.float32(0.0), jnp.float32(t_end))
    for b in range(B):
        tree_b = jsa._noise_backend(s["keys"][b], *horizon, 20, jnp.float32, tree)[0]
        body = jax_body(s, b, tree, jpf)
        for k in (12, 29, 31, 45):
            t1f = np.float32(s["jtask"].ts[k])
            y1 = ys[b, k][None].astype(np.float32)
            w_t1 = tree_b.evaluate(jnp.float32(t1f))
            for h in (3e-5, 2e-4, 8e-4):
                hf = np.float32(h)
                c = jsa._Carry(t0=jnp.float32(t1f), y0=jnp.asarray(y1), t1=jnp.float32(t1f),
                               y1=jnp.asarray(y1), h=jnp.float32(hf), step_times=jnp.zeros(8),
                               naccept=jnp.int32(0), nreject=jnp.int32(0),
                               err_prev=jnp.float32(0.7), w_t1=w_t1)
                out = body(c, *horizon)
                got = xs.xor_sde_attempt(
                    torch.tensor([[t1f]]), torch.as_tensor(y1), torch.tensor([[hf]]),
                    torch.tensor([[0.7]]), torch.tensor([[float(w_t1)]]), words[b:b + 1], pf,
                    s["sc"], s["kv"][:, b:b + 1].contiguous(), cfg)
                accept = int(out.naccept) == 1
                decisions.add(accept)
                assert bool(got.accept) == accept, (b, k, h)
                assert float(got.t_new) == float(out.t1)
                err_jax = (float(out.err_prev) if accept
                           else (0.9 * float(hf) / float(out.h)) ** 2)
                h_rel = abs(float(got.h_next) / float(out.h) - 1)
                if 0.3 <= err_jax < 20.0:
                    rel += [h_rel, abs(float(got.err) / err_jax - 1)]
                else:
                    small.append(h_rel)
                if accept:
                    want = np.asarray(out.y1)
                    assert np.abs(got.y_new.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert decisions == {True, False}
    assert max(rel) < 1e-3, max(rel)
    assert max(small) < 1e-2, max(small)


@pytest.mark.parametrize("tree", TREES)
def test_whole_selection_matches_jax_statistically(setup, tree):
    """Every lane reaches 60 ms in both packages at max_steps 512. Per lane
    the accepted count within 2% of JAX's plus twice the port's own spread
    under a 1e-7 nudge of the weights, the rejected count within 5% of
    JAX's accepted count plus twice that spread (an error estimate an ulp
    apart flips a decision, and from there the two runs draw other
    noise). Measured: accepted (371, 373, 375, 352) against (364, 373, 380,
    360) on the jax.random tree, (378, 375, 379, 367) against (368, 360,
    362, 366) on the krng tree; a nudge moves the port's own lanes by up to
    18 accepted and 7 rejected steps."""
    s = setup
    st_j, na_j, nr_j, t1_j = s["grid"][tree]
    y0, words, cfg = torch.zeros(B, 72), _words(s, tree), _cfg(s, tree)
    st, na, nr, ok = xs.xor_sde_select(y0, words, _pf(s), s["sc"], s["kv"], cfg)
    _, na_n, nr_n, _ = xs.xor_sde_select(y0, words, _pf(s, 1.0 + 1e-7), s["sc"], s["kv"], cfg)
    t_end = float(s["jtask"].ts[-1])
    assert ok.all() and (t1_j >= t_end).all()
    assert (st[torch.arange(B), na.long()] == t_end).all() and (torch.diff(st, dim=1) >= 0).all()
    spread_a = float((na_n - na).abs().max())
    spread_r = float((nr_n - nr).abs().max())
    na, nr = na.numpy().astype(float), nr.numpy().astype(float)
    assert np.all(np.abs(na - na_j) <= 0.02 * na_j + 2 * spread_a), (na, na_j, spread_a)
    assert np.all(np.abs(nr - nr_j) <= 0.05 * na_j + 2 * spread_r), (nr, nr_j, spread_r)


def test_replay_on_jax_grid_matches_jax(setup):
    """The lane-batched replay over JAX's frozen grids (the jax.random
    tree) with the same noise, interpolated onto ts: 1e-5 of each
    component's scale (measured 3.1e-6)."""
    s = setup
    want = np.asarray(jax_replay(s, s["jtask"].params, "jax"))
    grid = tuple(torch.as_tensor(x) for x in s["grid"]["jax"][:3])
    got = tsa.sdeint_adaptive_batch(tsa.XORSDE(_pf(s), s["sc"], s["kv"]), torch.zeros(B, 72),
                                    s["task"].ts, lane_key_words(s["keys"]), max_steps=M,
                                    grid=grid, fused_pass=False)
    assert got.shape == want.shape == (B, T, 72) and torch.isfinite(got).all()
    assert scaled(got.numpy(), want) < 1e-5


def _port_loss_grads(s, tree, scale=1.0):
    task = port_task(s["jtask"])
    with torch.no_grad():
        for p in task.params.values():
            p.mul_(scale)
    grid = tuple(torch.as_tensor(x) for x in s["grid"][tree][:3])
    ys = txt.batched_rollout(task.params, task, s["conds"], stochastic=True, adaptive=True,
                             fused_pass=tree == "kernel", keys=lane_key_words(s["keys"]),
                             grid=grid)
    loss = txt.readout(ys, txt.xor_targets(s["conds"]))[1]
    loss.backward()
    return float(loss), {k: p.grad.numpy() for k, p in task.params.items()}


@pytest.mark.parametrize("tree", TREES)
def test_loss_and_gradients_on_jax_grid_match_jax(setup, tree):
    """The loss and the two ff weights' gradients (the four rows) through
    the replay and its kernel-mode reverse sweep on JAX's frozen grid,
    against ``jax.value_and_grad`` of JAX's replay and readout: within 1e-4
    plus four times the port's own spread under a 1e-7 nudge (measured:
    loss 3.7e-7 / 5.0e-6 rel, gradients <= 9.5e-6 / 4.9e-6 rel L2 on the
    jax.random / krng tree, spreads <= 5.4e-6)."""
    s = setup
    conds = jnp.asarray(CONDS)

    def jloss(p):
        return jxt.readout(jax_replay(s, p, tree), jxt.xor_targets(conds))[1]

    want_loss, want = jax.value_and_grad(jloss)(s["jtask"].params)
    loss, grads = _port_loss_grads(s, tree)
    loss_n, grads_n = _port_loss_grads(s, tree, 1.0 + 1e-7)
    spread = abs(loss_n - loss) / abs(loss)
    assert abs(loss - float(want_loss)) <= (1e-4 + 4 * spread) * abs(float(want_loss))
    for k, g in grads.items():
        assert np.isfinite(g).all() and np.abs(g).sum() > 0, k
        tol = 1e-4 + 4 * rel_l2(grads_n[k], g)
        assert rel_l2(g, want[k]) < tol, (k, rel_l2(g, want[k]), tol)


def test_train_step_matches_jax(setup):
    """One train step on JAX's frozen grid (the jax.random tree): the JAX
    package's ``make_train_step`` body (``jax.value_and_grad`` of the
    rollout and readout, ``mask_grads``, its RMSprop update) against the
    port's ``make_train_step(task, stochastic=True, adaptive=True)`` given
    that grid and the lanes' keys. JAX's own jitted step lands on another
    grid than its selection jitted alone (an ulp in an error estimate parts
    the grids; its loss 0.39954 against 0.39828 here), so its selection is
    not what is held.
    Loss rel 1e-5, parameters abs 1e-4 (measured 3.7e-7 and 9.5e-7)."""
    s = setup
    jtask, conds = s["jtask"], jnp.asarray(CONDS)

    def jloss(p):
        return jxt.readout(jax_replay(s, p, "jax"), jxt.xor_targets(conds))[1]

    params = jax.tree_util.tree_map(jnp.array, jtask.params)
    want_loss, grads = jax.value_and_grad(jloss)(params)
    updates, _ = jtask.optimizer.update(j_mask_grads(grads, jtask.grad_mask),
                                        jtask.optimizer.init(params), params)
    params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    task = port_task(jtask)
    step = txt.make_train_step(task, stochastic=True, adaptive=True)
    grid = tuple(torch.as_tensor(x) for x in s["grid"]["jax"][:3])
    rec = step(s["conds"], grid=grid, keys=lane_key_words(s["keys"]))
    assert float(rec["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    assert rec["stats"].naccept.tolist() == s["grid"]["jax"][1].tolist()
    for k, p in task.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), atol=1e-4,
                                   err_msg=k)


def test_selection_budget_at_full_width_runs_out_in_both_packages():
    """At the task's full 1000 points over 1 s the selection's budget runs
    out before the end of the second in the JAX package as in the port:
    at the task's max_steps 2048 every lane stops at 0.28-0.30 s in both
    (``tools/xor_adaptive_budget.py``; ROADMAP.md section C), and the
    replay extrapolates the last accepted step to 1 s. Held here at
    max_steps 256 on the jax.random tree, where both stop early too: the
    batch's accepted count within 2% of JAX's, each lane's reached time
    within 5% of JAX's plus twice the port's own spread under a 1e-7 nudge
    of the weights (measured: accepted 877 against 872; lanes at 0.0380 /
    0.0364 / 0.0354 / 0.0345 s against 0.0362 / 0.0360 / 0.0358 / 0.0349 s,
    where a nudge moves the port's own lanes by up to 0.0030 s)."""
    T_full, M_cut = 1000, 256
    jtask = jxt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), time_steps=T_full)
    task = port_task(jtask, time_steps=T_full)
    sc, kv = txt.drift_inputs(task, torch.as_tensor(CONDS))
    a_drift, jfc, kv_all = jax_lanes(jtask)
    s = dict(jtask=jtask, task=task, a_drift=a_drift, jfc=jfc, kv_all=kv_all,
             keys=jax.random.split(jax.random.PRNGKey(5), B))
    _, na_j, nr_j, t_j = jax_select(s, jtask.params, "jax", M_cut)
    cfg = tsa.select_config(task.ts, max_steps=M_cut, brownian="jax", drift="f32")

    def port(scale):
        st, na, nr, ok = xs.xor_sde_select(torch.zeros(B, 72), _words(s, "jax"), _pf(s, scale),
                                           sc, kv, cfg)
        return (st[torch.arange(B), na.long()].numpy(), na.numpy().astype(float),
                nr.numpy().astype(float), ok)

    t_port, na, nr, ok = port(1.0)
    spread = np.abs(port(1.0 + 1e-7)[0] - t_port)
    assert not ok.any() and np.all(t_j < float(task.ts[-1]))
    assert np.all(na + nr == M_cut) and np.all(na_j + nr_j == M_cut)
    assert abs(na.sum() - na_j.sum()) <= 0.02 * na_j.sum(), (na, na_j)
    assert np.all(np.abs(t_port - t_j) <= 0.05 * t_j + 2 * spread), (t_port, t_j, spread)


def test_solver_settings_are_checked(setup):
    s = setup
    model = tsa.XORSDE(_pf(s), s["sc"], s["kv"])
    y0, keys = torch.zeros(B, 72), lane_key_words(s["keys"])
    with pytest.raises(ValueError, match="network model"):
        tsa.sdeint_adaptive_batch(model, y0, s["task"].ts, keys, select_bf16=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsa.sdeint_adaptive_batch(model, y0, s["task"].ts, keys, bptt_every=32)
    with pytest.raises(ValueError, match="kernel"):
        tsa.sdeint_adaptive_batch(model, y0, s["task"].ts, keys, fused_pass=True, brownian="jax")
    with pytest.raises(ValueError, match="float32"):
        xs.xor_sde_select(y0, _words(s, "jax"), _pf(s), s["sc"], s["kv"],
                          _cfg(s, "jax")._replace(drift="select16"))
    with pytest.raises(ValueError, match="n_real"):
        xs.xor_sde_replay_fwd(y0, torch.zeros(3, B), torch.zeros(3, B), torch.zeros(3, B),
                              torch.zeros(3, B), 4, _pf(s), s["sc"], s["kv"])
    with pytest.raises(ValueError, match="chunk"):
        xs.xor_sde_replay_bwd(torch.zeros(4, B, 72), torch.zeros(4, B, 72), torch.zeros(3, B),
                              torch.zeros(3, B), torch.zeros(3, B), 3, 0, _pf(s), s["sc"],
                              s["kv"])
    with pytest.raises(ValueError, match="raw key"):
        txt.batched_rollout(s["task"].params, s["task"], s["conds"], stochastic=True,
                            adaptive=True)
