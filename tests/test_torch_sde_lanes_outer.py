"""Port parity: the three-term replay in outer mode on per-lane grids (the
adaptive replay's f32-exact engine from 64 columns, ``solvers.fused`` tier
"split-outer" with ``ts_steps``, and with the gradbf16 substitute for the
weight VJPs: ``--grad-bf16`` without ``--split2`` at any width),
against ``columnflow.solvers.fused.sdeint_fused`` with ``ts_steps``,
``prepare_premixed_split`` and ``arg_grads="outer"`` (its Pallas kernels in
interpret mode), and the whole stochastic-adaptive train step on them
against ``columnflow.tasks.parity.make_train_step``; the choice of the
kernel-mode reverse sweep's kernel by shape (``sde3_bwd_route``).

Size: columns (2, 1), 2 inputs, batch 4, 60 grid points; the per-lane grids
are JAX's XLA selection (``test_torch_sde_jaxtree.build_setup``) and its
jax.random noise. At this size the weights hold 2.7 KB, so the port goes to
outer mode with ``OUTER_ARG_BYTES`` at 0 (the ``outer`` fixture) and JAX is
told ``arg_grads="outer"``.

Tolerances, each measured here and stated at its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import network as jn
from columnflow.solvers import fused as jf
from columnflow.tasks import parity as jpt
from columnflow.train import mask_grads as j_mask_grads
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import lane_key_words, network_from_jax
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.solvers import fused as tf
from columnflow_torch.solvers import sde_adaptive as tsa
from columnflow_torch.tasks import parity as tpt
from test_torch_sde_jaxtree import B, STIMS, T, build_setup
from test_torch_sde_split3 import rel_l2, setup  # noqa: F401  (setup is a fixture)
from test_torch_sde_split3_outer import outer  # noqa: F401  (a fixture)


def _lanes_grid(s, pad=6):
    """The replay's half-step grid of JAX's frozen selection: ts_steps (B,
    n + 1) and the noise (n, B), n = n_real + ``pad`` (rows past a lane's
    own count, and past n_real for every lane, are h == 0 padding)."""
    st = torch.as_tensor(s["grid"][0])
    ht, dw, i10 = tsa._replay_grid(st, s["words"], s["t0"], s["t1"], 20, "jax")
    n_real = 2 * int(np.max(s["grid"][1]))
    n = n_real + pad
    return ht[:, :n + 1].contiguous(), dw[:, :n].T.contiguous(), i10[:, :n].T.contiguous(), n_real


def _weights(s, n, seed=4):
    """A fixed linear functional of the trajectory (n + 1, B, 3P)."""
    return np.random.default_rng(seed).normal(size=(n + 1, B, 3 * s["P"])).astype(np.float32)


def _jax_loss(s, ht, dw, i10, n_real, g, vjp):
    def loss(pw):
        ys = jf.sdeint_fused(
            s["drift"](jn.network_drift_premixed), s["a_diff"], jnp.zeros((B, 3 * s["P"])), None,
            None, pw, s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1), method="srk",
            noise_shape=(B, 1), ts_steps=jnp.asarray(ht.numpy()),
            noise_pack=(jnp.asarray(dw.numpy()), jnp.asarray(i10.numpy())),
            n_real=n_real, nondiff_args=(1, 2), prepare=jn.prepare_premixed_split,
            arg_grads="outer", interpret=True,
            vjp_drift=s["drift"](jn.network_drift_premixed_gradbf16) if vjp else None,
            vjp_diffusion=s["a_diff"] if vjp else None)
        return jnp.mean(ys * g)

    return loss


def _port_loss(s, ht, dw, i10, n_real, g, vjp, scale=1.0):
    m = s["model"]
    pw = {k: (v.detach() * scale).clone().requires_grad_(True) for k, v in m.pw.items()}
    ys = tf.sdeint_fused(pw, m.sc, m.kv, torch.zeros(B, 3 * s["P"]), ht, (dw, i10),
                         n_real=n_real, prepare="split", vjp_drift=vjp)
    loss = torch.mean(ys * torch.as_tensor(g))
    loss.backward()
    return float(loss), {k: v.grad.numpy() for k, v in pw.items()}


@pytest.mark.parametrize("vjp", [None, "gradbf16"])
def test_lanes_outer_tier_matches_jax_outer_mode(setup, outer, vjp):
    """A linear functional of the whole lanes replay (JAX's frozen grids,
    the longest lane's 2 x naccept real half steps and 6 padding rows) and
    its gradients, the port's outer tier on the lanes' own step times
    against JAX's ``arg_grads="outer"``, exact (vjp None) and with the
    gradbf16 substitute: loss rel 1e-5 (measured 1.6e-6), the wT / iwT
    gradients rel L2 within 1e-3 plus twice the larger of the two sides'
    own spreads under a 1e-7 nudge of the weights (measured 1.3e-4 / 2.1e-5
    exact and 3.7e-5 / 2.2e-5 with the substitute, the spreads up to
    6.7e-5). The functional weights the rows past n_real too: they hold the
    carried state, and their cotangents reach it on both sides."""
    s = setup
    ht, dw, i10, n_real = _lanes_grid(s)
    tier = tf.sde_tier(s["model"].pw, "split", vjp, "auto", True)
    assert tier == "split-outer"
    g = _weights(s, ht.shape[1] - 1)
    jloss = _jax_loss(s, ht, dw, i10, n_real, jnp.asarray(g), vjp)
    want_loss, want_g = jax.value_and_grad(jloss)(s["jpw"])
    _, want_gn = jax.value_and_grad(jloss)({k: v * (1.0 + 1e-7) for k, v in s["jpw"].items()})
    loss, grads = _port_loss(s, ht, dw, i10, n_real, g, vjp)
    _, grads_n = _port_loss(s, ht, dw, i10, n_real, g, vjp, 1.0 + 1e-7)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for k in ("wT", "iwT"):
        spread = max(rel_l2(grads_n[k], grads[k]), rel_l2(want_gn[k], want_g[k]))
        assert np.isfinite(grads[k]).all()
        assert rel_l2(grads[k], want_g[k]) < 1e-3 + 2 * spread, (k, rel_l2(grads[k], want_g[k]),
                                                                 spread)


def test_lanes_outer_pass_takes_the_lanes_own_times(setup, outer, monkeypatch):
    """The outer pass of the lanes tier gets the (n_real, B) step times and
    sizes the kernels stepped on, and the states before each step and the
    seeds of the real steps only."""
    s = setup
    ht, dw, i10, n_real = _lanes_grid(s)
    seen = {}
    orig = tf.outer_arg_grads_split3

    def spy(ys_prev, seeds, t0s, hs, *rest, **kw):
        seen.update(ys=ys_prev.shape, seeds=seeds.shape, t0s=t0s.clone(), hs=hs.clone())
        return orig(ys_prev, seeds, t0s, hs, *rest, **kw)

    monkeypatch.setattr(tf, "outer_arg_grads_split3", spy)
    _port_loss(s, ht, dw, i10, n_real, _weights(s, ht.shape[1] - 1), None)
    want_t0 = ht[:, :n_real].T
    assert seen["ys"] == seen["seeds"] == (n_real, B, 3 * s["P"])
    assert torch.equal(seen["t0s"], want_t0)
    assert torch.equal(seen["hs"], (ht[:, 1:n_real + 1] - ht[:, :n_real]).T)
    assert (seen["hs"] == 0).any()  # the shorter lanes' padding inside n_real


@pytest.fixture(scope="module")
def jax_adaptive_runs():
    """One JAX train step of ``--stochastic --adaptive`` (and with
    ``--grad-bf16``) at this size with its replay's weight gradients taken
    outside the sweep, its lanes' keys and frozen grids, and its masked
    gradients at the parameters and at a 1e-7 nudge of them."""
    keys_root = jax.random.PRNGKey(31)
    task = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                          n_inputs=2, time_steps=T, max_steps=512)
    stims = jnp.asarray(STIMS)
    orig = jf.sdeint_fused
    runs = {}
    jf.sdeint_fused = lambda *a, **k: orig(*a, **{**k, "arg_grads": "outer"})
    try:
        for name, flags in (("exact", {}), ("gradbf16", {"grad_bf16": True})):
            @jax.jit
            def grads_of(p, flags=flags):
                def loss(p):
                    ys = jpt.batched_rollout(p, task, stims, key=keys_root, use_fused=True,
                                             stochastic=True, adaptive=True, **flags)
                    out = jpt.readout(ys, p, task.net)
                    return jnp.mean(jnp.abs(out - jpt.parity_targets(stims)))

                return j_mask_grads(jax.grad(loss)(p), task.grad_mask)

            params = jax.tree_util.tree_map(jnp.array, task.params)
            nudged = {k: v * (1.0 + 1e-7) for k, v in params.items()}
            rec = dict(before={k: np.array(v) for k, v in params.items()},
                       grads={k: np.asarray(v) for k, v in grads_of(params).items()},
                       grads_nudged={k: np.asarray(v) for k, v in grads_of(nudged).items()})
            step = jpt.make_train_step(task, use_fused=True, stochastic=True, adaptive=True,
                                       **flags)
            _, _, loss, _, _, ok = step(params, task.optimizer.init(params), stims, keys_root)
            runs[name] = dict(rec, loss=float(loss), ok=bool(ok))
    finally:
        jf.sdeint_fused = orig
    keys = jax.random.split(keys_root, B)
    return task, runs, keys, build_setup(keys=keys, stims=STIMS)["grid"][:3]


@pytest.mark.parametrize("name", ["exact", "gradbf16"])
def test_adaptive_train_step_in_outer_mode_matches_jax(jax_adaptive_runs, outer, name):
    """``make_train_step(task, stochastic=True, adaptive=True)`` (and with
    ``grad_bf16``) in outer mode on JAX's frozen grids and lane keys against
    JAX's step: loss rel 1e-5 (measured: equal), the skip decision equal,
    each masked gradient within rel L2 1e-3 plus twice the larger of the two
    sides' own spreads under a 1e-7 nudge of the weights (measured up to
    3.7e-4, feedforward, beside JAX's own spread of 2.0e-3)."""
    jtask, runs, keys, grid = jax_adaptive_runs
    rec = runs[name]
    flags = dict(stochastic=True, adaptive=True, grad_bf16=name == "gradbf16")
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=512,
                          device="cpu")

    def port_step(scale):
        params, _ = network_from_jax({k: v * scale for k, v in rec["before"].items()}, jtask.net)
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
        out = tpt.make_train_step(task, **flags)(
            torch.as_tensor(STIMS), lane_key_words(keys),
            grid=tuple(torch.as_tensor(np.array(x)) for x in grid))
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
        assert rel_l2(g, want) < 1e-3 + 2 * spread, (k, rel_l2(g, want), spread)


def test_gradbf16_substitute_on_the_uniform_grid_raises():
    """The JAX package's fixed-grid step never passes ``vjp_drift``: the
    substitute is ported on per-lane grids only."""
    pw = {"wT": torch.empty(24, 24, device="meta"), "iwT": torch.empty(2, 24, device="meta")}
    with pytest.raises(NotImplementedError, match="uniform grid"):
        tf.sde_tier(pw, "split", "gradbf16", "auto", False)
    assert tf.sde_tier(pw, "split", "gradbf16", "auto", True) == "split-outer"
    assert tf.sde_tier(pw, "split", "gradbf16", "outer", True) == "split-outer"


@pytest.mark.parametrize("cols,lanes,want", [
    (13, 4, "block"), (19, 4, "block"), (20, 4, "team"), (24, 4, "team"), (32, 4, "team"),
    (63, 4, "team"),
    # The edge moves with the batch: fewer lanes fit more columns.
    (21, 2, "block"), (24, 2, "team"), (13, 1, "block"), (19, 8, "team"), (13, 8, "block")])
def test_kernel_mode_sweep_is_chosen_by_shape(cols, lanes, want):
    """``replay3_bwd`` takes the one-block B4't where the three-term weights,
    iwT, the drift's scratch for every lane and the sweep's eight (B, 3P)
    buffers fit a block's 227 KB of shared memory (4 inputs, 4 lanes:
    through 19 columns), B4't-team otherwise."""
    assert ns.sde3_bwd_route(8 * cols, 4, lanes) == want


def test_kernel_mode_sweep_route_counts_the_kernels_bytes():
    """The route's byte count is ``cf_sde3_bwd``'s: ``setup_floats`` of
    csrc/split3_drift.cuh for B lanes, 8 B 3P floats, 4 B lane scalars and
    two (n_in, P) accumulators, against 232,448 bytes."""
    def floats(P, n_in, nb):
        setup = (3 * P * P + 1) // 2 + n_in * P + 5 * nb * P + nb * 16 + 1 + 2 * (512 // 32)
        return setup + 8 * nb * 3 * P + 4 * nb + 2 * n_in * P

    for P in range(8, 8 * 64, 8):
        for nb in (1, 2, 4, 8):
            fits = 4 * floats(P, 4, nb) <= ns.SMEM_BLOCK_BYTES
            assert ns.sde3_bwd_route(P, 4, nb) == ("block" if fits else "team"), (P, nb)
    assert ns.SMEM_BLOCK_BYTES == 232448


def test_team_route_runs_the_plain_sweep_on_the_cpu(setup, monkeypatch):
    """On CPU tensors either route is the plain version."""
    s = setup
    m = s["model"]
    P, n = s["P"], 6
    gen = torch.Generator().manual_seed(5)
    ys = torch.rand(n, B, 3 * P, generator=gen) * 20
    ysbar = torch.randn(n, B, 3 * P, generator=gen)
    t0s, hs, i10 = torch.arange(n) * 1e-3, torch.full((n,), 1e-3), torch.zeros(n, B)
    pw = {k: v.detach().contiguous() for k, v in m.pw.items()}
    want = ns._replay3_bwd_plain(ys, ysbar, t0s, hs, i10, n, 0, 2, pw, m.sc, m.kv)
    for route in ("block", "team"):
        monkeypatch.setattr(ns, "sde3_bwd_route", lambda *a, route=route: route)
        got = ns.replay3_bwd(ys, ysbar, t0s, hs, i10, n, 0, 2, pw, m.sc, m.kv)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
