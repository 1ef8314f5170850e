"""Port parity: the two-term split (``prepare_premixed_split2``) with its
exact weight gradients, against the JAX package in interpret mode:

- the deterministic ``fused-split2`` tier in kernel mode (the plain version
  of B8s, ``kernels.network_ode.ode_replay_bwd_split2``, the weight
  cotangents in the reverse sweep) against
  ``columnflow.solvers.fused.odeint_dopri5_fused(..., prepare=
  prepare_premixed_split2, arg_grads="kernel")``;
- the stochastic-adaptive replay on per-lane grids in kernel mode (the plain
  version of B4s, ``kernels.network_sde.replay2_bwd``) against
  ``sdeint_fused`` with ``prepare_premixed_split2``, ``vjp_drift=None`` and
  ``arg_grads="kernel"``;
- the exact split2 outer pass (``solvers.fused.outer_arg_grads_split2``)
  against the JAX package's outer mode (``_outer_sde_arg_grads`` with
  ``vjp_step=None``: ``jax.vjp`` of one SRA1 step through
  ``prepare_premixed_split2``, step by step);
- one train step of each new command line's step against the JAX package's
  ``make_train_step``.

Size: columns (2, 1), 2 inputs, batch 4, 60 grid points, max_steps 512; the
deterministic grid is JAX's selection (``test_torch_ode_split2.build_setup``),
the per-lane grids JAX's XLA selection on the jax.random tree
(``test_torch_sde_jaxtree.build_setup``). At this size "auto" takes kernel
mode on both sides; outer mode is forced on both (the ``outer`` fixture,
``arg_grads="outer"`` on the JAX side). Both sides take the JAX package's
parameters (``convert.network_from_jax``).

Every weight cotangent of the two-term split rounds to bf16, and so does the
state cotangent of each transposed product (``split2_cotangent``), so a
gradient is determined to the grade at which a 1e-7 nudge of the weights
moves it: where a tolerance adds twice that spread, the spread is measured
in the test. Each tolerance is stated at its test with the value measured
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.models import network as jn
from columnflow.solvers import fused as jf
from columnflow.solvers import sde_adaptive as jsa
from columnflow.tasks import parity as jpt
from columnflow.train import mask_grads as j_mask_grads
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import frozen_grid_from_jax, lane_key_words, network_from_jax
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.models import network as tn
from columnflow_torch.solvers import fused as tf
from columnflow_torch.solvers import sde_adaptive as tsa
from columnflow_torch.tasks import parity as tpt
from test_torch_ode_fused import _jax_drift
from test_torch_ode_split2 import build_setup as build_ode_setup
from test_torch_sde_jaxtree import B, M, N_IN, STIMS, T
from test_torch_sde_jaxtree import build_setup as build_sde_setup
from test_torch_sde_lanes_outer import _lanes_grid, _weights


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).reshape(-1, want.shape[-1]).max(0), 1e-30)
    return float((np.abs(got - want) / scale).max())


def _states(P, rng):
    return np.concatenate([rng.uniform(-5, 25, (B, P)), rng.uniform(0, 5, (B, P)),
                           rng.uniform(0, 50, (B, P))], axis=1).astype(np.float32)


def _nudged(pw, scale=1.0 + 1e-7):
    return {k: v * scale for k, v in pw.items()}


def _w2(model):
    """The two-term split of the model's weights, contiguous (as the
    wrappers take it)."""
    w2 = tn.prepare_premixed_split2({k: v.detach() for k, v in model.pw.items()}, model.sc.fc)[0]
    return {k: v.contiguous() for k, v in w2.items()}


@pytest.fixture(scope="module")
def ode():
    return build_ode_setup()


@pytest.fixture(scope="module")
def sde():
    return build_sde_setup()


@pytest.fixture
def outer(monkeypatch):
    """"auto" resolves to "outer" for any weights on the port's side."""
    monkeypatch.setattr(tf, "OUTER_ARG_BYTES", 0)


# -- (a) one step's two-term weight VJP --------------------------------------------


def _jax_sde_step_vjp(s, t0, h, y, i1, i10, c, jpw):
    """``jax.vjp`` of one SRA1 step of the lanes (per-lane t0, h, noise
    (B, 1)) through ``prepare_premixed_split2``: (y, wT, iwT) cotangents."""
    step = jf._make_sde_step(s["drift"](jn.network_drift_premixed), s["a_diff"], "srk",
                             safe_h=True)
    kv = jnp.moveaxis(s["kv_all"], 0, 1)

    def f(y_, wT, iwT):
        pw2 = jn.prepare_premixed_split2({"wT": wT, "iwT": iwT}, s["jfc"])[0]
        return step(t0, h, y_, i1, i10, (pw2, s["jfc"], kv))

    _, vjp = jax.vjp(f, y, jpw["wT"], jpw["iwT"])
    return vjp(c)


def _sde_step_case(s, rng, trial):
    P = s["P"]
    y = _states(P, rng)
    c = rng.normal(size=(B, 3 * P)).astype(np.float32)
    t0 = rng.uniform(0.02, 0.05, (B, 1)).astype(np.float32)  # the stimulus is on from 0.03
    h = np.full((B, 1), 2e-4 * (trial + 1), np.float32)
    i1 = rng.normal(0, 1e-2, (B, 1)).astype(np.float32)
    i10 = (h * (0.5 * i1 + np.sqrt(h / 12) * rng.normal(size=(B, 1)))).astype(np.float32)
    return t0, h, y, i1, i10, c


@pytest.mark.parametrize("kind", ["ode", "sde"])
def test_one_step_two_term_weight_vjp_matches_jax(request, kind):
    """One step's VJP through ``prepare_premixed_split2`` with its weight
    cotangents, three draws each: the dopri5 replay step (``step_vjp``, the
    seven drift VJPs B8s forms per step) against ``jax.vjp`` of
    ``_step_with_coeffs``, and the SRA1 step (``step_vjp_split2(...,
    weights=True)``, the two B4s and the outer pass form per step) against
    ``jax.vjp`` of the JAX package's SRA1 step. The state cotangent within
    rel L2 1e-4; d wT and d iwT within 1e-3, or, where a bf16 rounding of a
    product's contracted cotangent flips between XLA's float32 sums and the
    port's float64 ones, 5e-3 plus twice the port's own spread under a 1e-7
    nudge of the weights. Measured: ODE state <= 3.8e-6, d wT and d iwT <=
    4.1e-5; SDE state <= 2.7e-6, d wT <= 9.6e-5, d iwT <= 2.8e-6 (iwT's
    cotangent is 0 where the stimulus is off at every lane's time)."""
    s = request.getfixturevalue(kind)
    rng = np.random.default_rng(17)
    if kind == "ode":
        jpw, jfc, jkv = s["jargs"]
        w2n = tn.prepare_premixed_split2(_nudged(s["pw"]), s["sc"].fc)[0]
    else:
        jpw, m = s["jpw"], s["model"]
        pw = {k: v.detach() for k, v in m.pw.items()}
        w2 = tn.prepare_premixed_split2(pw, m.sc.fc)[0]
        w2n = tn.prepare_premixed_split2(_nudged(pw), m.sc.fc)[0]
    for trial in range(3):
        if kind == "ode":
            y = _states(s["P"], rng)
            t0, h = np.float32(0.0295 + 0.002 * trial), np.float32(2e-4)
            ybar = rng.normal(size=y.shape).astype(np.float32)
            cbar = rng.normal(size=(5,) + y.shape).astype(np.float32)
            _, vjp = jax.vjp(lambda yy, pw_: jf._step_with_coeffs(
                s["drift"], t0, h, yy, jn.prepare_premixed_split2(pw_, jfc, jkv)),
                jnp.asarray(y), jpw)
            want_y, want_pw = vjp((jnp.asarray(ybar), jnp.asarray(cbar)))
            want = (want_y, want_pw["wT"], want_pw["iwT"])
            args = tuple(torch.as_tensor(x) for x in (t0, h, y, ybar, cbar))
            got = no.step_vjp(*args, s["w2"], s["sc"], s["kv"])
            got_n = no.step_vjp(*args, w2n, s["sc"], s["kv"])
        else:
            t0, h, y, i1, i10, c = _sde_step_case(s, rng, trial)
            want = _jax_sde_step_vjp(s, *(jnp.asarray(x) for x in (t0, h, y, i1, i10, c)), jpw)
            args = tuple(torch.as_tensor(x) for x in (t0, h, y, i10, c))
            got = ns.step_vjp_split2(*args, w2, m.sc, m.kv, weights=True)
            got_n = ns.step_vjp_split2(*args, w2n, m.sc, m.kv, weights=True)
            state = ns.step_vjp_split2(*args, w2, m.sc, m.kv)
            assert torch.equal(state, got[0])  # the state cotangent is the same either way
        assert rel_l2(got[0], want[0]) < 1e-4
        for g, gn, w in zip(got[1:], got_n[1:], want[1:]):
            if not np.any(np.asarray(w)):
                assert not torch.any(g)
                continue
            err, spread = rel_l2(g, w), rel_l2(gn, g)
            assert err < 1e-3 or err < 5e-3 + 2 * spread, (kind, trial, err, spread)


# -- (b) B8s: the deterministic split2 tier in kernel mode --------------------------


def _jax_ode_loss(jtask, params, arg_grads):
    """The split2 tier's loss through ``columnflow.solvers.fused.
    odeint_dopri5_fused`` as ``columnflow/tasks/parity.py:443-484`` builds
    it, with ``arg_grads`` given."""
    drift, kv = _jax_drift(jtask)
    fc = jn.build_network_fused_consts(jtask.net)
    pw = jn.premix_network_weights(params, jtask.net)
    pw3 = jn.prepare_premixed_split(pw, fc)[0]
    ys = jf.odeint_dopri5_fused(drift, jnp.zeros((B, 3 * jtask.net.num_pops)), jtask.ts, pw, fc,
                                kv, max_steps=M, nondiff_args=(1, 2),
                                prepare=jn.prepare_premixed_split2, select_func=drift,
                                select_args=(pw3, fc, kv), arg_grads=arg_grads, interpret=True)
    ys = jnp.transpose(ys, (1, 0, 2))
    out = jpt.readout(ys, params, jtask.net)
    return jnp.mean(jnp.abs(out - jpt.parity_targets(jnp.asarray(STIMS)))), ys


def _port_ode_grads(s, scale=1.0):
    """(loss, ys, masked gradients) of the port's split2 tier on JAX's grid."""
    task = s["task"]
    params = {k: (p.detach() * scale).requires_grad_(True) for k, p in task.params.items()}
    stims = torch.as_tensor(STIMS)
    ys = tpt.batched_rollout(params, task, stims, grid=frozen_grid_from_jax(*s["jgrid"]),
                             split2=True)
    loss = torch.mean(torch.abs(tpt.readout(ys, params, task.net) - tpt.parity_targets(stims)))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss), ys.detach(), {k: (g * task.grad_mask[k]).numpy()
                                      for k, g in zip(params, grads)}


def test_b8s_sweep_on_jax_grid_matches_jax_kernel_mode(ode, monkeypatch):
    """The tier in kernel mode on JAX's frozen grid (the replay B7 split2,
    the sweep B8s: plain versions) against the JAX solve with
    ``arg_grads="kernel"``: ys within 2e-5 of each component's largest
    magnitude (measured 1.1e-5; the split2 replay's grade,
    ``test_torch_ode_split2.test_replay_split2_on_jax_grid``), loss rel 1e-5
    (measured 9.5e-8), masked gradients rel L2 within 3e-2 plus twice the
    port's own 1e-7-nudge spread (measured: input 1.2e-3, feedforward
    7.1e-3, lateral 1.4e-2, output 7.2e-4, beside spreads of 1.7e-3,
    7.7e-3, 6.9e-3 and 3.3e-4); the sweep ran B8s's plain version."""
    s = ode
    jtask = s["jtask"]
    assert tf.resolve_arg_grads(s["pw"]) == "kernel"
    seen = []
    orig = tf.ode_replay_bwd_split2
    monkeypatch.setattr(tf, "ode_replay_bwd_split2",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    (want_loss, want_ys), want_g = jax.value_and_grad(
        lambda p: _jax_ode_loss(jtask, p, "kernel"), has_aux=True)(jtask.params)
    loss, ys, grads = _port_ode_grads(s)
    _, _, grads_n = _port_ode_grads(s, 1.0 + 1e-7)
    assert len(seen) == 2
    assert scaled(ys, want_ys) < 2e-5
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for k, g in grads.items():
        want = np.asarray(want_g[k]) * np.asarray(jtask.grad_mask[k])
        spread = rel_l2(grads_n[k], g)
        assert np.isfinite(g).all()
        assert rel_l2(g, want) < 3e-2 + 2 * spread, (k, rel_l2(g, want), spread)


def test_b8s_kernel_mode_matches_the_ports_outer_mode(ode, monkeypatch):
    """Kernel mode (B8s) and outer mode (B8', ``ode_outer_arg_grads`` on the
    two-term split) take the same per-step VJPs and fold: the masked
    gradients agree within rel L2 1e-5 (the float32 sum over steps runs in
    another order; measured <= 1.8e-7)."""
    s = ode
    _, _, kernel = _port_ode_grads(s)
    monkeypatch.setattr(tf, "OUTER_ARG_BYTES", 0)
    assert tf.resolve_arg_grads(s["pw"]) == "outer"
    _, _, outer_g = _port_ode_grads(s)
    for k, g in kernel.items():
        if not np.any(g):
            assert not np.any(outer_g[k])
            continue
        assert rel_l2(outer_g[k], g) < 1e-5, (k, rel_l2(outer_g[k], g))


# -- (c) B4s: the split2 replay on per-lane grids in kernel mode --------------------


def _jax_lanes_loss(s, ht, dw, i10, n_real, g, arg_grads):
    def loss(pw):
        ys = jf.sdeint_fused(
            s["drift"](jn.network_drift_premixed), s["a_diff"], jnp.zeros((B, 3 * s["P"])), None,
            None, pw, s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1), method="srk",
            noise_shape=(B, 1), ts_steps=jnp.asarray(ht.numpy()),
            noise_pack=(jnp.asarray(dw.numpy()), jnp.asarray(i10.numpy())),
            n_real=n_real, nondiff_args=(1, 2), prepare=jn.prepare_premixed_split2,
            arg_grads=arg_grads, interpret=True)
        return jnp.mean(ys * g)

    return loss


def _port_lanes_loss(s, ht, dw, i10, n_real, g, scale=1.0, bptt_every=None):
    m = s["model"]
    pw = {k: (v.detach() * scale).clone().requires_grad_(True) for k, v in m.pw.items()}
    ys = tf.sdeint_fused(pw, m.sc, m.kv, torch.zeros(B, 3 * s["P"]), ht, (dw, i10),
                         n_real=n_real, bptt_every=bptt_every, prepare="split2", vjp_drift=None)
    loss = torch.mean(ys * torch.as_tensor(g))
    loss.backward()
    return float(loss), {k: v.grad.numpy() for k, v in pw.items()}


@pytest.mark.parametrize("bptt_every", [None, 3])
def test_b4s_sweep_on_jax_lanes_grid_matches_jax_kernel_mode(sde, bptt_every, monkeypatch):
    """The adaptive replay over JAX's frozen per-lane grids (the XLA
    selection's, jax.random noise) on the two-term split in kernel mode
    (B3 and B4s: plain versions) against the JAX package's replay with
    ``prepare_premixed_split2`` and no substitute (its kernel-mode sweep in
    interpret mode). bptt 3 is a 6-half-step window: the sweep's chunk is 6
    and the cotangent is zeroed after every 6th half step. Loss rel 1e-5,
    the wT / iwT gradients rel L2 within 3e-2 plus twice the port's own
    1e-7-nudge spread (measured: 2.6e-4 / 3.9e-5 untruncated, 1.1e-3 /
    1.5e-6 with bptt 3, beside spreads <= 2.1e-4)."""
    s = sde
    m = s["model"]
    assert tf.sde_tier(m.pw, "split2", None, "auto", True) == "split2-kernel"
    seen = []
    orig = tf.replay2_bwd
    monkeypatch.setattr(tf, "replay2_bwd", lambda *a, **k: seen.append(1) or orig(*a, **k))
    st, na, nr = (jnp.asarray(x) for x in s["grid"][:3])
    P = s["P"]

    def loss_jax(pw):
        ys = jsa._replay_pass_fused_batch(
            "sra1", True, s["drift"](jn.network_drift_premixed), s["a_diff"],
            jnp.zeros((B, 3 * P)), s["jtask"].ts, st, na, M, s["keys"],
            (pw, s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1)), "jax", 20, s["jtask"].ts[0],
            s["jtask"].ts[-1], interpret=True, nondiff_args=(1, 2),
            prepare=jn.prepare_premixed_split2, bptt_every=bptt_every)
        out = jpt.readout(ys, s["jtask"].params, s["jtask"].net)
        return jnp.mean(jnp.abs(out - jpt.parity_targets(jnp.asarray(STIMS))))

    want_loss, want_g = jax.value_and_grad(loss_jax)(s["jpw"])
    grads = []
    for scale in (1.0, 1.0 + 1e-7):
        pw = {k: (v.detach() * scale).clone().requires_grad_(True) for k, v in m.pw.items()}
        model = tsa.PremixedNetworkSDE(pw, m.sc, m.kv)
        ys = tsa.sdeint_adaptive_batch(
            model, torch.zeros(B, 3 * P), s["task"].ts, lane_key_words(s["keys"]), max_steps=M,
            bptt_every=bptt_every, grid=tuple(torch.as_tensor(np.array(x)) for x in s["grid"][:3]),
            fused_pass=False, select_bf16=False, prepare="split2", grad_bf16=False)
        out = tpt.readout(ys, s["task"].params, s["task"].net)
        loss = torch.mean(torch.abs(out - tpt.parity_targets(torch.as_tensor(STIMS))))
        loss.backward()
        grads.append({k: v.grad.numpy() for k, v in pw.items()})
        if scale == 1.0:
            assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert len(seen) == 2
    for k in ("wT", "iwT"):
        spread = rel_l2(grads[1][k], grads[0][k])
        err = rel_l2(grads[0][k], want_g[k])
        assert np.isfinite(grads[0][k]).all()
        assert err < 3e-2 + 2 * spread, (k, err, spread)


def test_b4s_plain_sweep_folds_chunks_as_the_three_term_one(sde):
    """``_replay2_bwd_plain`` sums the steps' cotangents chunk by chunk and
    truncates as ``_replay3_bwd_plain`` does: one chunk of every step, or
    chunks of 2 and truncation every 4 steps, give the same state cotangent
    and gradients to float32 reassociation (rel 1e-6) when no truncation
    cuts, and the truncated sweep's state cotangent is the last window's."""
    s = sde
    m = s["model"]
    P, n = s["P"], 8
    gen = torch.Generator().manual_seed(3)
    ys = torch.rand(n, B, 3 * P, generator=gen) * 20
    ysbar = torch.randn(n, B, 3 * P, generator=gen)
    t0s = (torch.arange(n) * 1e-3 + 0.03)[:, None].expand(n, B).contiguous()
    hs, i10 = torch.full((n, B), 1e-3), torch.zeros(n, B)
    w2 = _w2(m)
    one = ns.replay2_bwd(ys, ysbar, t0s, hs, i10, n, 0, n, w2, m.sc, m.kv)
    two = ns.replay2_bwd(ys, ysbar, t0s, hs, i10, n, 0, 2, w2, m.sc, m.kv)
    assert torch.equal(one[0], two[0])
    assert rel_l2(two[1], one[1]) < 1e-6 and rel_l2(two[2], one[2]) < 1e-6
    cut = ns.replay2_bwd(ys, ysbar, t0s, hs, i10, n, 4, 2, w2, m.sc, m.kv)
    assert torch.equal(cut[0], torch.zeros_like(cut[0]))  # step 0 is a multiple of 4
    last = ns.replay2_bwd(ys[:4], ysbar[:4], t0s[:4], hs[:4], i10[:4], 4, 0, 2, w2, m.sc, m.kv)
    assert rel_l2(last[1], cut[1] - ns.replay2_bwd(ys[4:], ysbar[4:], t0s[4:], hs[4:], i10[4:],
                                                   4, 0, 2, w2, m.sc, m.kv)[1]) < 1e-5


# -- (d) the exact split2 outer pass --------------------------------------------------


def _jax_outer_steps(s, t0s, hs, ys_prev, i10, seeds, jpw):
    """The JAX package's outer mode per step (``_outer_sde_arg_grads``,
    ``vjp_step=None``): ``jax.vmap`` over the steps of ``jax.vjp`` of one
    lanes SRA1 step through ``prepare_premixed_split2`` for its seed ->
    per-step (wT, iwT) cotangents."""
    step = jf._make_sde_step(s["drift"](jn.network_drift_premixed), s["a_diff"], "srk",
                             safe_h=True)
    kv = jnp.moveaxis(s["kv_all"], 0, 1)

    def one(t0k, hk, yk, i10k, seedk):
        def f(wT, iwT):
            pw2 = jn.prepare_premixed_split2({"wT": wT, "iwT": iwT}, s["jfc"])[0]
            return step(t0k, hk, yk, jnp.zeros_like(i10k), i10k, (pw2, s["jfc"], kv))

        _, vjp = jax.vjp(f, jpw["wT"], jpw["iwT"])
        return vjp(seedk)

    return jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (t0s, hs, ys_prev, i10, seeds)))


def test_outer_arg_grads_split2_matches_jax_outer_mode(sde, monkeypatch):
    """The outer pass over the real steps of JAX's lanes grid (states from
    the split2 replay, random seeds), on the lanes' own (n, B) step times:
    each step's (wT, iwT) cotangents against JAX's outer mode's within rel
    L2 5e-3 (measured <= 2.3e-3), their sums within 3e-3 (measured 1.8e-3 /
    3.9e-7), and the pass in blocks of 1, 4 and 256 steps (sub-blocks of
    one step too) equal to the port's per-step sum within rel 1e-6 (float32
    reassociation)."""
    s = sde
    m = s["model"]
    ht, dw, i10, n_real = _lanes_grid(s, pad=0)
    n = n_real
    t0s = ht[:, :n].T.contiguous()
    hs = (ht[:, 1:n + 1] - ht[:, :n]).T.contiguous()
    pw = {k: v.detach().contiguous() for k, v in m.pw.items()}
    w2 = tn.prepare_premixed_split2(pw, m.sc.fc)[0]
    ys = ns.replay_fwd(torch.zeros(B, 3 * s["P"]), t0s, hs, dw[:n].contiguous(),
                       i10[:n].contiguous(), n, w2, m.sc, m.kv)[:-1].contiguous()
    seeds = torch.randn(ys.shape, generator=torch.Generator().manual_seed(6))
    want_w, want_iw = (np.asarray(x) for x in _jax_outer_steps(
        s, t0s[..., None].numpy(), hs[..., None].numpy(), ys.numpy(), i10[:n, :, None].numpy(),
        seeds.numpy(), s["jpw"]))
    per_w, per_iw = [], []
    for k in range(n):
        _, g_w, g_iw = ns.step_vjp_split2(t0s[k, :, None], hs[k, :, None], ys[k],
                                          i10[k, :, None], seeds[k], w2, m.sc, m.kv,
                                          weights=True)
        per_w.append(g_w)
        per_iw.append(g_iw)
    errs = []
    for got, want in ((per_w, want_w), (per_iw, want_iw)):
        for k in range(n):
            if np.any(want[k]):
                errs.append(rel_l2(got[k], want[k]))
            else:  # iwT's cotangent is 0 while the stimulus is off at every lane's time
                assert not torch.any(got[k]), k
    assert errs and max(errs) < 5e-3, max(errs)
    sum_w, sum_iw = torch.stack(per_w).sum(0), torch.stack(per_iw).sum(0)
    assert rel_l2(sum_w, want_w.sum(0)) < 3e-3 and rel_l2(sum_iw, want_iw.sum(0)) < 3e-3
    for block, sub_steps in ((1, None), (4, None), (256, None), (256, 1)):
        if sub_steps:
            monkeypatch.setattr(tf, "OUTER_SUB_BYTES", 4 * s["P"] ** 2 * sub_steps)
        got_w, got_iw = tf.outer_arg_grads_split2(ys, seeds, t0s, hs, i10[:n].contiguous(), pw,
                                                  m.sc, m.kv, block=block)
        assert rel_l2(got_w, sum_w) < 1e-6 and rel_l2(got_iw, sum_iw) < 1e-6, block


def test_split2_outer_tier_matches_its_kernel_mode_and_jax(sde, monkeypatch):
    """A linear functional of the whole lanes replay (JAX's frozen grids,
    6 padding rows past n_real) and its gradients in the port's two split2
    tiers: "split2-outer" (B3, B4, ``outer_arg_grads_split2``) against
    "split2-kernel" (B3, B4s) within rel L2 1e-5 (measured <= 1.2e-7), and
    against the JAX package's ``arg_grads="outer"``: loss rel 1e-5 (measured
    7.8e-8), the gradients within 1e-3 plus twice the larger of the two
    sides' own 1e-7-nudge spreads (measured 1.3e-4 / 1.8e-5 beside spreads
    of 6.2e-5 / 4.8e-5)."""
    s = sde
    ht, dw, i10, n_real = _lanes_grid(s)
    g = _weights(s, ht.shape[1] - 1)
    _, kernel = _port_lanes_loss(s, ht, dw, i10, n_real, g)
    monkeypatch.setattr(tf, "OUTER_ARG_BYTES", 0)
    assert tf.sde_tier(s["model"].pw, "split2", None, "auto", True) == "split2-outer"
    seen = []
    orig = tf.outer_arg_grads_split2
    monkeypatch.setattr(tf, "outer_arg_grads_split2",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    loss, grads = _port_lanes_loss(s, ht, dw, i10, n_real, g)
    _, grads_n = _port_lanes_loss(s, ht, dw, i10, n_real, g, 1.0 + 1e-7)
    assert len(seen) == 2
    jloss = _jax_lanes_loss(s, ht, dw, i10, n_real, jnp.asarray(g), "outer")
    want_loss, want_g = jax.value_and_grad(jloss)(s["jpw"])
    _, want_gn = jax.value_and_grad(jloss)(_nudged(s["jpw"]))
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for k in ("wT", "iwT"):
        assert rel_l2(grads[k], kernel[k]) < 1e-5, (k, rel_l2(grads[k], kernel[k]))
        spread = max(rel_l2(grads_n[k], grads[k]), rel_l2(want_gn[k], want_g[k]))
        err = rel_l2(grads[k], want_g[k])
        assert np.isfinite(grads[k]).all()
        assert err < 1e-3 + 2 * spread, (k, err, spread)


# -- (e) one train step of each new command line's step -----------------------------


@pytest.fixture(scope="module")
def jax_split2_runs():
    """The JAX package's train step of each new path at this size, jitted:
    the deterministic split2 tier (kernel mode: "auto" at this size), the
    stochastic-adaptive split2 replay in kernel mode, and the same with its
    ``sdeint_fused`` told ``arg_grads="outer"``: the parameters before,
    the loss and skip decision, and the masked gradients at the parameters
    and at a 1e-7 nudge of them; the lanes' keys and frozen grids."""
    from columnflow.config import ColumnConfig as JaxConfig

    task = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                          n_inputs=N_IN, time_steps=T, max_steps=M)
    stims = jnp.asarray(STIMS)
    keys_root = jax.random.PRNGKey(31)
    paths = {"deterministic": dict(use_fused=True, split2=True),
             "adaptive-kernel": dict(use_fused=True, stochastic=True, adaptive=True, split2=True),
             "adaptive-outer": dict(use_fused=True, stochastic=True, adaptive=True, split2=True)}
    orig = jf.sdeint_fused
    runs = {}
    for name, flags in paths.items():
        key = {"key": keys_root} if flags.get("stochastic") else {}
        if name == "adaptive-outer":
            jf.sdeint_fused = lambda *a, **k: orig(*a, **{**k, "arg_grads": "outer"})
        try:
            @jax.jit
            def grads_of(p, flags=flags, key=key):
                def loss(p):
                    ys = jpt.batched_rollout(p, task, stims, **key, **flags)
                    return jnp.mean(jnp.abs(jpt.readout(ys, p, task.net)
                                            - jpt.parity_targets(stims)))

                return j_mask_grads(jax.grad(loss)(p), task.grad_mask)

            params = jax.tree_util.tree_map(jnp.array, task.params)
            rec = dict(before={k: np.array(v) for k, v in params.items()},
                       grads={k: np.asarray(v) for k, v in grads_of(params).items()},
                       grads_nudged={k: np.asarray(v)
                                     for k, v in grads_of(_nudged(params)).items()})
            step = jpt.make_train_step(task, **flags)
            extra = (keys_root,) if key else ()
            _, _, loss, _, _, ok = step(params, task.optimizer.init(params), stims, *extra)
            runs[name] = dict(rec, loss=float(loss), ok=bool(ok))
        finally:
            jf.sdeint_fused = orig
    keys = jax.random.split(keys_root, B)
    ode_grid = build_ode_setup()["jgrid"]
    return task, runs, keys, build_sde_setup(keys=keys, stims=STIMS)["grid"][:3], ode_grid


@pytest.mark.parametrize("name", ["deterministic", "adaptive-kernel", "adaptive-outer"])
def test_train_step_matches_jax(jax_split2_runs, name, monkeypatch):
    """``make_train_step(task, split2=True)`` (``--engine fused-split2``:
    B7 split2 and B8s in kernel mode at this size) and ``make_train_step(
    task, stochastic=True, adaptive=True, split2=True)`` (``--stochastic
    --adaptive --engine fused-split2``: B4s in kernel mode; with outer mode
    forced, the exact ``outer_arg_grads_split2``, as from 64 columns) on
    JAX's frozen grids and lane keys against the JAX package's jitted step:
    loss rel 1e-5 (measured <= 9.5e-8), the skip decision equal, each masked
    gradient within rel L2 3e-2 plus twice the larger of the two sides'
    spreads under a 1e-7 nudge (measured: deterministic <= 3.8e-2,
    feedforward, beside JAX's jitted spread of 2.5e-2, as the three-term
    engine's ``test_torch_ode_split3_outer``; stochastic <= 2.1e-4 beside
    spreads up to 1.9e-3)."""
    jtask, runs, keys, lanes_grid, ode_grid = jax_split2_runs
    rec = runs[name]
    if name == "adaptive-outer":
        monkeypatch.setattr(tf, "OUTER_ARG_BYTES", 0)
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=N_IN, time_steps=T, max_steps=M,
                          device="cpu")
    if name == "deterministic":
        flags, args = dict(split2=True), dict(grid=frozen_grid_from_jax(*ode_grid))
    else:
        flags = dict(stochastic=True, adaptive=True, split2=True)
        args = dict(lane_words=lane_key_words(keys),
                    grid=tuple(torch.as_tensor(np.array(x)) for x in lanes_grid))

    def port_step(scale):
        params, _ = network_from_jax({k: v * scale for k, v in rec["before"].items()}, jtask.net)
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
        out = tpt.make_train_step(task, **flags)(torch.as_tensor(STIMS), **args)
        return out, {k: p.grad.detach().numpy().copy() for k, p in task.params.items()}

    out, grads = port_step(1.0)
    _, grads_n = port_step(np.float32(1.0 + 1e-7))
    assert float(out["loss"]) == pytest.approx(rec["loss"], rel=1e-5)
    assert out["ok"] == rec["ok"]
    for k, g in grads.items():
        want = rec["grads"][k]
        if not np.any(want):
            assert not np.any(g), k
            continue
        spread = max(rel_l2(grads_n[k], g), rel_l2(rec["grads_nudged"][k], want))
        assert np.isfinite(g).all()
        assert rel_l2(g, want) < 3e-2 + 2 * spread, (k, rel_l2(g, want), spread)


# -- routes and wrappers ----------------------------------------------------------------


@pytest.mark.parametrize("columns", [3, 13, 32, 63])
def test_two_term_sweeps_always_take_the_team(columns):
    """There is no one-block two-term kernel-mode sweep: B8s and B4s run
    every width on one team of 8 blocks; the three-term routes keep their
    byte counts."""
    P = 8 * columns
    for lanes in (1, 4, 16):
        assert no.ode_bwd_route(P, 4, lanes, terms=2) == "team"
        assert ns.sde3_bwd_route(P, 4, lanes, terms=2) == "team"
        assert no.ode_bwd_route(P, 4, lanes) == no.ode_bwd_route(P, 4, lanes, terms=3)
    with pytest.raises(ValueError, match="terms"):
        no.ode_bwd_route(P, 4, 4, terms=1)
    with pytest.raises(ValueError, match="terms"):
        ns.sde3_bwd_route(P, 4, 4, terms=4)


def test_two_term_sweep_wrappers_check_their_tensors(ode, sde):
    s = ode
    n, P = 3, s["P"]
    with pytest.raises(ValueError, match="wT_hi must be torch.bfloat16"):
        no.ode_replay_bwd_split2(torch.zeros(n, B, 3 * P), torch.zeros(n, 5, B, 3 * P),
                                 torch.zeros(n + 1), {**s["w2"], "wT_hi": s["w2"]["wT_hi"].float()},
                                 s["sc"], s["kv"])
    with pytest.raises(ValueError, match="cobar has shape"):
        no.ode_replay_bwd_split2(torch.zeros(n, B, 3 * P), torch.zeros(n - 1, 5, B, 3 * P),
                                 torch.zeros(n + 1), s["w2"], s["sc"], s["kv"])
    m = sde["model"]
    w2 = _w2(m)
    z = torch.zeros(n, B, 3 * P)
    t = torch.zeros(n, B)
    with pytest.raises(ValueError, match="chunk"):
        ns.replay2_bwd(z, z, t, t, t, n, 0, 0, w2, m.sc, m.kv)
    with pytest.raises(ValueError, match="n_real"):
        ns.replay2_bwd(z, z, t, t, t, n + 1, 0, 1, w2, m.sc, m.kv)
    with pytest.raises(ValueError, match="hs has shape"):
        ns.replay2_bwd(z, z, t, t[:, :1].contiguous(), t, n, 0, 1, w2, m.sc, m.kv)
    with pytest.raises(ValueError, match="t0s has shape"):  # per-lane grids only
        ns.replay2_bwd(z, z, t[:, 0].contiguous(), t, t, n, 0, 1, w2, m.sc, m.kv)
    assert no.LAUNCHES["ode_replay_bwd_split2"] == 0 and ns.LAUNCHES["sde2_bwd"] == 0
