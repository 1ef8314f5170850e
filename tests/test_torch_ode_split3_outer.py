"""Port parity: the f32-exact dopri5 engine in outer mode (the three-term
split's emit-mode reverse sweep of ``kernels.network_ode``, the step-batched
weight VJPs of ``solvers.fused.ode_outer_arg_grads`` through
``prepare_premixed_split`` and ``odeint_dopri5_fused(..., split2=False)``
with ``arg_grads="outer"``) against ``columnflow.solvers.fused.
odeint_dopri5_fused(..., prepare=prepare_premixed_split, arg_grads="outer")``
in interpret mode, as ``columnflow/tasks/parity.py:429-484`` calls it below
the split2 tier; and the shape routes that pick the one-block kernels or the
teams on the card.

Size: columns (2, 1), 2 inputs, batch 4, 60 grid points, max_steps 512
(rounded to 660), as ``tests/test_torch_ode_fused.py``. At this size
"auto" takes kernel mode on both sides (the weights are far below 1 MiB),
so both run outer mode by being told so: the JAX solver with
``arg_grads="outer"``, the port's task with its 1 MiB threshold patched to
0 (the ``outer`` fixture). Tolerances are stated at each test with the
value measured here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from columnflow import solvers as jsolvers
from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import network as jn
from columnflow.solvers import fused as jf
from columnflow.tasks import parity as jpt
from columnflow.train import mask_grads as j_mask_grads
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import frozen_grid_from_jax, network_from_jax
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.models import network as tn
from columnflow_torch.solvers import fused
from columnflow_torch.solvers.fused import ode_outer_arg_grads, odeint_dopri5_fused
from columnflow_torch.tasks import parity as tpt
from test_torch_ode_fused import _jax_drift, jax_select

T, B, N_IN, M = 60, 4, 2, 512
STIMS = np.array([[0.0, 15.0], [15.0, 0.0], [15.0, 15.0], [0.0, 0.0]], np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def setup():
    jtask = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                           n_inputs=N_IN, time_steps=T, max_steps=M)
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=N_IN, time_steps=T, max_steps=M,
                          device="cpu")
    params, _ = network_from_jax({k: np.asarray(v) for k, v in jtask.params.items()}, jtask.net)
    with torch.no_grad():
        for k, p in task.params.items():
            p.copy_(params[k])
    model = tpt.sde_model(task.params, task, torch.as_tensor(STIMS))
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    drift, jkv = _jax_drift(jtask)
    jpw = jn.premix_network_weights(jtask.params, jtask.net)
    jfc = jn.build_network_fused_consts(jtask.net)
    st, stats = jax_select(jtask, jtask.params)
    n = int(stats[0])
    step = jax.jit(lambda t0, h, y, pw_: jf._step_with_coeffs(
        drift, t0, h, y, jn.prepare_premixed_split(pw_, jfc, jkv)))
    y, ys = jnp.zeros((B, 3 * task.net.num_pops)), []
    for k in range(n):
        ys.append(np.asarray(y))
        y, _ = step(st[k], st[k + 1] - st[k], y, jpw)
    return dict(jtask=jtask, task=task, pw=pw, sc=model.sc, kv=model.kv, drift=drift,
                jargs=(jpw, jfc, jkv), P=task.net.num_pops, jgrid=(np.asarray(st),
                                                                   np.asarray(stats)),
                n=n, jys=np.stack(ys), w3=tn.prepare_premixed_split(pw, model.sc.fc)[0])


@pytest.fixture
def outer(monkeypatch):
    """"auto" resolves to "outer" for any weights (the JAX side is told
    arg_grads="outer")."""
    monkeypatch.setattr(fused, "OUTER_ARG_BYTES", 0)


def _states(P, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-5, 25, (B, P)), rng.uniform(0, 5, (B, P)),
                           rng.uniform(0, 50, (B, P))], axis=1).astype(np.float32)


def test_state_vjp_on_the_three_term_split_is_the_state_part_of_the_full_vjp(setup):
    """``step_vjp(..., weights=False)`` on the three-term split equals the
    state cotangent of ``step_vjp(..., weights=True)`` bit for bit, for one
    step and for steps batched on a leading axis. (It read wT_hi and wT_mid
    alone before: the two-term state VJP, 1.7e-4 rel L2 away here.)"""
    s = setup
    P = s["P"]
    y = torch.as_tensor(_states(P, 5))
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        ybar, cbar = torch.randn(y.shape, generator=gen), torch.randn((5,) + y.shape, generator=gen)
        t0, h = torch.tensor(0.0295), torch.tensor(2e-4)
        full, _, _ = no.step_vjp(t0, h, y, ybar, cbar, s["w3"], s["sc"], s["kv"])
        state = no.step_vjp(t0, h, y, ybar, cbar, s["w3"], s["sc"], s["kv"], weights=False)
        assert torch.equal(state, full)
        two_term = no.step_vjp(t0, h, y, ybar, cbar, {k: v for k, v in s["w3"].items()
                                                      if k != "wT_lo"}, s["sc"], s["kv"],
                               weights=False)
        assert not torch.equal(two_term, full)
    ys = torch.stack([y, y * 1.01])
    ybs, cbs = torch.randn(ys.shape), torch.randn((2, 5) + y.shape)
    t0s, hs = torch.tensor([0.02, 0.03])[:, None, None], torch.tensor([1e-4, 2e-4])[:, None, None]
    full, _, _ = no.step_vjp(t0s, hs, ys, ybs, cbs, s["w3"], s["sc"], s["kv"])
    assert torch.equal(no.step_vjp(t0s, hs, ys, ybs, cbs, s["w3"], s["sc"], s["kv"],
                                   weights=False), full)


def _jax_emit(s, jpw, cobar):
    """The JAX package's emit-mode reverse-sweep kernel on the three-term
    split (interpret mode) over JAX's accepted steps in one chunk: (ybar0,
    ybar_steps)."""
    n = s["n"]
    func, prep, dyn, _ = jf._flatten_for_kernel(s["drift"], (jpw,) + s["jargs"][1:], (1, 2),
                                                jn.prepare_premixed_split)
    S = (B, 3 * s["P"])
    call = pl.pallas_call(
        jf._make_bwd_chunk_kernel(func, prep, len(dyn), n, (), emit_steps=True),
        out_shape=(jax.ShapeDtypeStruct(S, jnp.float32),
                   jax.ShapeDtypeStruct((n,) + S, jnp.float32)),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 2 + [jf._VMEM()] * (3 + len(dyn)),
        out_specs=(jf._VMEM(), jf._VMEM()), interpret=True)
    return call(jnp.asarray(s["jgrid"][0][:n + 1]), jnp.array([n], jnp.int32),
                jnp.asarray(s["jys"]), jnp.asarray(cobar), jnp.zeros(S, jnp.float32), *dyn)


def test_emit_sweep_on_jax_grid(setup):
    """The three-term emit-mode sweep (ybar0 and every ybar_steps[k])
    against the JAX package's emit kernel on JAX's states, rel L2 <= 3e-2
    (measured ybar0 4.6e-4, ybar_steps 9.9e-4). The state VJP rounds each
    transposed product to bf16 (``split3_cotangent``), so the sweep is
    bf16-grade: either side's own result moves when the weights move by one
    part in 1e7, and that spread is asserted beside it (measured: the port
    6.8e-4 and 1.0e-3, JAX 5.6e-4 and 9.0e-4)."""
    s = setup
    gen = np.random.default_rng(9)
    cobar = gen.normal(size=(s["n"], 5, B, 3 * s["P"])).astype(np.float32)
    want_yb, want_steps = _jax_emit(s, s["jargs"][0], cobar)
    st = torch.as_tensor(s["jgrid"][0][:s["n"] + 1].copy())
    args = (torch.as_tensor(s["jys"]), torch.as_tensor(cobar), st)
    yb, steps = no.ode_replay_bwd_emit(*args, s["w3"], s["sc"], s["kv"])
    assert torch.equal(steps[-1], torch.zeros_like(steps[-1]))
    err = (rel_l2(yb, want_yb), rel_l2(steps, want_steps))
    nudged = {k: v * (1.0 + 1e-7) for k, v in s["pw"].items()}
    w3n = tn.prepare_premixed_split(nudged, s["sc"].fc)[0]
    yb_n, steps_n = no.ode_replay_bwd_emit(*args, w3n, s["sc"], s["kv"])
    spread = (rel_l2(yb_n, yb), rel_l2(steps_n, steps))
    jyb_n, jsteps_n = _jax_emit(s, {k: v * (1.0 + 1e-7) for k, v in s["jargs"][0].items()},
                                cobar)
    jspread = (rel_l2(jyb_n, want_yb), rel_l2(jsteps_n, want_steps))
    assert max(err) < 3e-2, (err, spread, jspread)
    assert all(1e-7 < x < 3e-2 for x in spread + jspread), (spread, jspread)


def test_step_batched_outer_vjps_match_jax_vmap(setup):
    """The weight VJPs of nine replay steps where the stimulus is on, as
    ``_outer_arg_grads`` takes them (``jax.vmap`` of ``jax.vjp`` of the step
    through ``prepare_premixed_split``, ``columnflow/solvers/fused.py:
    660-669``), against the port's batched ``step_vjp`` on the three-term
    split: per step rel L2 <= 5e-3 (measured: wT <= 3.0e-3, iwT <= 7.3e-4)
    and summed <= 3e-3 (measured: wT 1.4e-3, iwT 2.1e-4); and
    ``ode_outer_arg_grads`` with ``prepare_premixed_split`` equals the
    port's per-step sum in any block size (rel 1e-6: float32 sums in
    another order).

    Not 1e-3: each of a step's 21 product cotangents is rounded to bf16 and
    added in bf16, and a rounding flips between XLA's float32 sums and the
    port's float64 sums (2^-9 of that entry, carried through the bf16
    accumulators); either side's own per-step wT moves by up to 1.8e-3
    (the port) and 2.3e-3 (JAX) under a 1e-7 nudge of the weights,
    asserted beside it."""
    s = setup
    jpw, jfc, jkv = s["jargs"]
    n, k0 = 9, s["n"] - 12
    st = s["jgrid"][0][k0:k0 + n + 1].copy()
    ys = s["jys"][k0:k0 + n]
    rng = np.random.default_rng(4)
    ybs = rng.normal(size=ys.shape).astype(np.float32)
    cobar = rng.normal(size=(n, 5) + ys.shape[1:]).astype(np.float32)

    def one(t0, t1, y, yb, cb):
        _, vjp = jax.vjp(lambda pw: jf._step_with_coeffs(
            s["drift"], t0, t1 - t0, y, jn.prepare_premixed_split(pw, jfc, jkv)), jpw)
        return vjp((yb, cb))[0]

    want = jax.vmap(one)(jnp.asarray(st[:-1]), jnp.asarray(st[1:]), jnp.asarray(ys),
                         jnp.asarray(ybs), jnp.asarray(cobar))
    stt = torch.as_tensor(st)
    t0s, hs = stt[:-1, None, None], (stt[1:] - stt[:-1])[:, None, None]

    def port(pw):
        w3 = tn.prepare_premixed_split(pw, s["sc"].fc)[0]
        return no.step_vjp(t0s, hs, torch.as_tensor(ys), torch.as_tensor(ybs),
                           torch.as_tensor(cobar), w3, s["sc"], s["kv"])[1:]

    gw, giw = port(s["pw"])
    gw_n, _ = port({k: v * (1.0 + 1e-7) for k, v in s["pw"].items()})
    per_step = max(max(rel_l2(gw[k], want["wT"][k]), rel_l2(giw[k], want["iwT"][k]))
                   for k in range(n))
    spread = max(rel_l2(gw_n[k], gw[k]) for k in range(n))
    assert per_step < 5e-3 and 1e-4 < spread < 5e-3, (per_step, spread)
    assert rel_l2(gw.sum(0), np.asarray(want["wT"]).sum(0)) < 3e-3
    assert rel_l2(giw.sum(0), np.asarray(want["iwT"]).sum(0)) < 3e-3
    for block in (None, 1, 4):
        got_w, got_iw = ode_outer_arg_grads(torch.as_tensor(ys), torch.as_tensor(ybs),
                                            torch.as_tensor(cobar), stt, s["pw"], s["sc"],
                                            s["kv"], prepare=tn.prepare_premixed_split,
                                            block=block)
        assert rel_l2(got_w, gw.sum(0)) < 1e-6 and rel_l2(got_iw, giw.sum(0)) < 1e-6, block


def _jax_outer_loss(jtask, params):
    """The exact engine's loss through ``columnflow.solvers.fused.
    odeint_dopri5_fused`` built as ``columnflow/tasks/parity.py:443-484``
    below the split2 tier, with arg_grads="outer"."""
    drift, kv = _jax_drift(jtask)
    fc = jn.build_network_fused_consts(jtask.net)
    pw = jn.premix_network_weights(params, jtask.net)
    ys = jf.odeint_dopri5_fused(drift, jnp.zeros((B, 3 * jtask.net.num_pops)), jtask.ts, pw, fc,
                                kv, max_steps=M, nondiff_args=(1, 2),
                                prepare=jn.prepare_premixed_split, arg_grads="outer",
                                interpret=True)
    out = jpt.readout(jnp.transpose(ys, (1, 0, 2)), params, jtask.net)
    return jnp.mean(jnp.abs(out - jpt.parity_targets(jnp.asarray(STIMS))))


def _port_loss_and_grads(s, scale=1.0):
    task = s["task"]
    params = {k: (p.detach() * scale).requires_grad_(True) for k, p in task.params.items()}
    stims = torch.as_tensor(STIMS)
    ys = tpt.batched_rollout(params, task, stims, grid=frozen_grid_from_jax(*s["jgrid"]))
    loss = torch.mean(torch.abs(tpt.readout(ys, params, task.net) - tpt.parity_targets(stims)))
    grads = torch.autograd.grad(loss, list(params.values()))
    masked = {k: (g * m).numpy() for (k, m), g in zip(task.grad_mask.items(), grads)}
    return float(loss.detach()), masked


def test_outer_mode_loss_and_gradients_match_jax_outer_mode(setup, outer):
    """The whole engine in outer mode on JAX's frozen grid against JAX's
    outer mode: loss rel 1e-5 (measured 0.0), each masked gradient within
    rel L2 3e-2 plus twice the port's own spread under a 1e-7 nudge of the
    weights (measured: input 2.8e-3, feedforward 1.1e-2, lateral 9.0e-3,
    output 2.9e-4, beside spreads of 2.8e-3, 6.1e-3, 1.2e-2, 6.5e-5): the
    emit sweep and every weight cotangent of the outer pass round to bf16,
    as the kernel-mode sweep does (slice 3)."""
    s = setup
    jtask = s["jtask"]
    want_loss, want_g = jax.value_and_grad(lambda p: _jax_outer_loss(jtask, p))(jtask.params)
    loss, grads = _port_loss_and_grads(s)
    _, grads_n = _port_loss_and_grads(s, np.float32(1.0 + 1e-7))
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for k, g in grads.items():
        want = np.asarray(want_g[k]) * np.asarray(jtask.grad_mask[k])
        spread = rel_l2(grads_n[k], g)
        assert np.isfinite(g).all() and 1e-7 < spread < 3e-2, (k, spread)
        assert rel_l2(g, want) < 3e-2 + 2 * spread, (k, rel_l2(g, want), spread)


def test_outer_mode_matches_the_ports_kernel_mode(setup, monkeypatch):
    """Outer and kernel mode sum the same per-step VJPs in another order:
    the masked gradients within rel L2 1e-5 (measured <= 2.3e-7), the loss
    equal. The outer run goes through the emit sweep (its plain version is
    reached, the kernel-mode sweep's is not)."""
    s = setup
    loss_k, grads_k = _port_loss_and_grads(s)
    called = []
    emit_plain, bwd_plain = no._ode_replay_bwd_emit_plain, no._ode_replay_bwd_plain
    monkeypatch.setattr(no, "_ode_replay_bwd_emit_plain",
                        lambda *a: called.append("emit") or emit_plain(*a))
    monkeypatch.setattr(no, "_ode_replay_bwd_plain",
                        lambda *a: called.append("kernel") or bwd_plain(*a))
    monkeypatch.setattr(fused, "OUTER_ARG_BYTES", 0)
    loss_o, grads_o = _port_loss_and_grads(s)
    assert called == ["emit"]
    assert loss_o == loss_k
    for k, g in grads_o.items():
        if not np.any(grads_k[k]):
            assert not np.any(g), k
            continue
        assert rel_l2(g, grads_k[k]) < 1e-5, (k, rel_l2(g, grads_k[k]))


@pytest.mark.parametrize("columns,n_in,arg_grads,want", [
    (13, 4, "auto", "kernel"), (63, 4, "auto", "kernel"), (64, 4, "auto", "outer"),
    (104, 4, "auto", "outer"), (2 * 13, 4, "outer", "outer"), (104, 4, "kernel", "kernel")])
def test_exact_engine_resolves_arg_grads_as_jax(columns, n_in, arg_grads, want, monkeypatch):
    """``odeint_dopri5_fused(split2=False)`` takes the weight gradients
    outside the sweep where ``columnflow/solvers/fused.py:569-576`` does
    ("auto": more than 1 MiB of wT and iwT, 64 columns and up with 4
    inputs), and honours an explicit mode at any width. A rule, not a
    solve: the replay's autograd.Function is replaced by a recorder."""
    P = 8 * columns
    picked = []
    for name in ("_ODEReplay", "_ODEReplayOuter"):
        monkeypatch.setattr(fused, name, type(name, (), {"apply": staticmethod(
            lambda *a, _n=name: picked.append(_n) or torch.zeros(1, 5, B, 3 * P))}))
    monkeypatch.setattr(fused, "ode_select", lambda y0, pw, sc, kv, cfg: (
        torch.linspace(0.0, 1e-3, cfg.max_steps + 1), torch.tensor([1, 0, 1])))
    pw = {"wT": torch.zeros(P, P), "iwT": torch.zeros(n_in, P)}
    odeint_dopri5_fused(pw, None, torch.zeros(4, B, n_in), torch.zeros(B, 3 * P),
                        torch.linspace(0.0, 1e-3, 3), arg_grads=arg_grads)
    assert picked == ["_ODEReplayOuter" if want == "outer" else "_ODEReplay"]


def test_train_step_matches_jax_outer_train_step(setup, outer, monkeypatch):
    """One ``make_train_step(task)`` step in outer mode on JAX's frozen grid
    against JAX's ``make_train_step(task, use_fused=True)`` with its
    ``odeint_dopri5_fused`` told ``arg_grads="outer"``, the weights moved
    across by ``convert.network_from_jax``: loss rel 1e-5 (measured 0.0),
    the skip decision equal, each masked gradient (JAX's from the same
    loss under ``jax.grad``, jitted) within rel L2 3e-2 plus twice the
    larger of the two sides' spreads under a 1e-7 nudge (measured <= 4.2e-2,
    feedforward, beside spreads of 6.1e-3 for the port and 3.3e-2 for JAX's
    jitted gradient), and the updated parameters within one Adam step (lr
    0.1, so an entry that moved the other way would be 0.2 apart) of JAX's
    (measured <= 7.9e-3, feedforward, in 14 of 576 entries)."""
    s = setup
    jtask = s["jtask"]
    orig = jsolvers.odeint_dopri5_fused
    monkeypatch.setattr(jsolvers, "odeint_dopri5_fused",
                        lambda *a, **k: orig(*a, **{**k, "arg_grads": "outer"}))
    stims = jnp.asarray(STIMS)

    @jax.jit
    def grads_of(p):
        def loss(p):
            ys = jpt.batched_rollout(p, jtask, stims, use_fused=True)
            return jnp.mean(jnp.abs(jpt.readout(ys, p, jtask.net) - jpt.parity_targets(stims)))

        return j_mask_grads(jax.grad(loss)(p), jtask.grad_mask)

    params = jax.tree_util.tree_map(jnp.array, jtask.params)
    before = {k: np.array(v) for k, v in params.items()}
    want = {k: np.asarray(v) for k, v in grads_of(params).items()}
    want_n = {k: np.asarray(v) for k, v in grads_of(
        {k: v * (1.0 + 1e-7) for k, v in params.items()}).items()}
    step = jpt.make_train_step(jtask, use_fused=True)
    new, _, want_loss, _, _, want_ok = step(params, jtask.optimizer.init(params), stims)
    new = {k: np.asarray(v) for k, v in new.items()}
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=N_IN, time_steps=T, max_steps=M,
                          device="cpu")
    grid = frozen_grid_from_jax(*s["jgrid"])

    def port_step(scale):
        p, _ = network_from_jax({k: v * scale for k, v in before.items()}, jtask.net)
        with torch.no_grad():
            for k, q in task.params.items():
                q.copy_(p[k])
        out = tpt.make_train_step(task)(torch.as_tensor(STIMS), grid=grid)
        return out, {k: q.grad.detach().numpy().copy() for k, q in task.params.items()}

    _, grads_n = port_step(np.float32(1.0 + 1e-7))
    task.optimizer.state.clear()
    out, grads = port_step(1.0)
    assert float(out["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    assert out["ok"] == bool(want_ok)
    for k, g in grads.items():
        if not np.any(want[k]):
            assert not np.any(g), k
            continue
        spread = max(rel_l2(grads_n[k], g), rel_l2(want_n[k], want[k]))
        assert np.isfinite(g).all()
        assert rel_l2(g, want[k]) < 3e-2 + 2 * spread, (k, rel_l2(g, want[k]), spread)
    moved, _ = network_from_jax(new, jtask.net)
    for k, p in task.params.items():
        assert float((p.detach() - moved[k]).abs().max()) <= 0.1 * 1.001, k


@pytest.mark.parametrize("columns,B,fwd,bwd", [
    (13, 4, "block", "block"), (17, 4, "block", "block"), (18, 4, "block", "team"),
    (23, 4, "block", "team"), (24, 4, "team", "team"), (63, 4, "team", "team"),
    (64, 4, "team", "team"), (104, 4, "team", "team"), (312, 4, "team", "team"),
    (13, 16, "block", "team")])
def test_routes_follow_the_byte_count(columns, B, fwd, bwd):
    """``ode_fwd_route`` takes the one-block replay (B7) where its shared
    memory fits the 232,448 bytes a block may use, else the team (B7t-team):
    one block through 23 columns at 4 inputs. The one-block sweep (B8) fits
    through 17 columns at 4 lanes (``bwd``: "block" there, "team" past it;
    16 lanes leave it at 13 columns), but ``ode_bwd_route`` now takes the
    cluster team for the batch wherever its plan fits (every width through
    63 columns at 4 lanes, and 13 columns at 16), and the byte count picks
    between B8 and the 8-block B8t-team only where that plan does not fit.
    ``tests/test_torch_cuda.py`` holds ``ode_block_bytes`` against the
    library's own count."""
    P, n_in = 8 * columns, 4
    assert no.ode_fwd_route(P, n_in) == fwd
    one_block = no.ode_block_bytes(P, n_in, B, True) <= 232448
    assert ("block" if one_block else "team") == bwd
    plan = no.ode_team_plan(P, n_in, B, 3, no.KSWEEP)
    if plan.fits:
        want = "streamed" if plan.stream else "resident"
    else:
        want = "block" if one_block else "team8"
    assert no.ode_bwd_route(P, n_in, B) == want
    if columns <= 63 or (columns, B) == (13, 16):
        assert want in ("resident", "streamed")


def test_split3_emit_wrapper_checks_its_tensors(setup):
    s = setup
    with pytest.raises(ValueError, match="wT_lo must be torch.bfloat16"):
        no.ode_replay_bwd_emit(torch.zeros(3, B, 3 * s["P"]), torch.zeros(3, 5, B, 3 * s["P"]),
                               torch.zeros(4), {**s["w3"], "wT_lo": s["w3"]["wT_lo"].float()},
                               s["sc"], s["kv"])
    assert all(v == 0 for v in no.LAUNCHES.values())  # plain versions count nothing
