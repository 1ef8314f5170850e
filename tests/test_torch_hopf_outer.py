"""Port parity: the Hopf MLP drift in outer mode, ``arg_grads="outer"``
(the emit-mode reverse sweep ``kernels.hopf_ode.hopf_replay_bwd_emit`` and
the step-batched parameter VJPs ``solvers.fused.hopf_outer_arg_grads``),
against the JAX package's emit kernel (``_make_bwd_chunk_kernel(...,
emit_steps=True)``), ``jax.vmap`` of ``jax.vjp`` of ``_step_with_coeffs``
(what ``_outer_arg_grads`` computes) and ``odeint_dopri5_fused(...,
arg_grads="outer")``; and the rule that sends an MLP past 1 MiB there.

Size: the MLP at sizes (3, 16, 16, 16, 2), 8 lanes, 100 grid points over
2.5 s, max_steps 512, as ``test_torch_hopf_model.py`` (whose helpers build
the inputs). The JAX kernels run in interpret mode; on the CPU the port runs
its plain versions. The port replays JAX's frozen grid, so both sides step
alike; the port's products are float64 sums rounded once, JAX's float32
HIGHEST products, an ulp or two apart per layer. Tolerances are stated at
each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from columnflow.models import hopf as jh
from columnflow.solvers import fused as jf
from columnflow_torch.convert import frozen_grid_from_jax, hopf_params_from_jax
from columnflow_torch.kernels import hopf_ode as ho
from columnflow_torch.models import hopf as th
from columnflow_torch.solvers import fused as tf
from columnflow_torch.tasks import bifurcation as tbt
from columnflow_torch.train.optim import torch_rmsprop
from test_torch_hopf_model import B, M, T, inputs, jax_drift, jax_params, jax_select, rel_l2

WIDE = (3, 512, 512, 512, 2)
WIDE_STD = 0.1 * (100 / 512) ** 0.5  # the reference's std scaled by the fan-in


@pytest.fixture(scope="module")
def outer():
    """JAX's parameters and grid, the port's replay of that grid and random
    cotangents on its dense rows."""
    jp = jax_params()
    ts, dt, y0, mu = inputs()
    params = hopf_params_from_jax([{k: np.asarray(v) for k, v in layer.items()} for layer in jp])
    tmu = ho.MuTable(torch.as_tensor(mu), 0.0, dt)
    st_j, stats_j = (np.asarray(x) for x in jax_select(jp, mu, y0, ts, dt))
    st, n = frozen_grid_from_jax(st_j, stats_j)
    st = st[:n + 1].contiguous()
    ys, co = ho.hopf_replay_fwd(torch.as_tensor(y0), st, params, tmu)
    cobar = torch.as_tensor(np.random.default_rng(21).normal(0, 1, co.shape).astype(np.float32))
    return dict(jp=jp, params=params, ts=ts, dt=dt, y0=y0, mu=mu, tmu=tmu, grid=(st_j, stats_j),
                st=st, n=n, ys=ys, cobar=cobar)


def _jax_emit(s):
    """The JAX package's emit-mode reverse-sweep kernel (interpret mode) over
    the n accepted steps in one chunk, on the port's states: (ybar0,
    ybar_steps)."""
    n, S = s["n"], (B, 2)
    func, prep, dyn, _ = jf._flatten_for_kernel(jax_drift(s["dt"]), (s["jp"], jnp.asarray(s["mu"])),
                                                (1,))
    call = pl.pallas_call(
        jf._make_bwd_chunk_kernel(func, prep, len(dyn), n, (), emit_steps=True),
        out_shape=(jax.ShapeDtypeStruct(S, jnp.float32),
                   jax.ShapeDtypeStruct((n,) + S, jnp.float32)),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 2 + [jf._VMEM()] * (3 + len(dyn)),
        out_specs=(jf._VMEM(), jf._VMEM()), interpret=True)
    return call(jnp.asarray(s["st"].numpy()), jnp.array([n], jnp.int32),
                jnp.asarray(s["ys"].numpy()), jnp.asarray(s["cobar"].numpy()),
                jnp.zeros(S, jnp.float32), *dyn)


def _emit(s):
    return ho.hopf_replay_bwd_emit(s["ys"], s["cobar"], s["st"], s["params"], s["tmu"])


def test_emit_sweep_matches_jax_emit_kernel(outer):
    """The emit-mode sweep against JAX's emit kernel on the same states and
    cotangents: ybar0 and every ybar_steps row within rtol = atol = 1e-6,
    and the last step receives nothing from later steps."""
    s = outer
    want_yb, want_steps = (np.asarray(x) for x in _jax_emit(s))
    yb, steps = _emit(s)
    assert s["n"] >= 5 and steps.shape == (s["n"], B, 2)
    assert torch.equal(steps[-1], torch.zeros_like(steps[-1]))
    np.testing.assert_allclose(steps.numpy(), want_steps, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(yb.numpy(), want_yb, rtol=1e-6, atol=1e-6)


def test_emit_sweep_state_is_the_kernel_mode_sweeps(outer):
    """The emit sweep's state arithmetic is the kernel-mode sweep's without
    the parameter cotangents: ybar0 is the same bits."""
    s = outer
    yb, steps = _emit(s)
    yb_k, _ = ho.hopf_replay_bwd(s["ys"], s["cobar"], s["st"], s["params"], s["tmu"])
    assert torch.equal(yb, yb_k)
    # ybar_steps[k] is the carry entering step k: the sweep over the steps
    # after k ends at it.
    k = s["n"] // 2
    yb_tail, _ = ho.hopf_replay_bwd(s["ys"][k + 1:], s["cobar"][k + 1:], s["st"][k + 1:],
                                    s["params"], s["tmu"])
    assert torch.equal(steps[k], yb_tail)


def _jax_step_vjps(s, ybar_steps):
    """``_outer_arg_grads``' per-step VJPs: ``jax.vmap`` of ``jax.vjp`` of
    ``_step_with_coeffs`` with respect to the parameters."""
    func, mu = jax_drift(s["dt"]), jnp.asarray(s["mu"])
    st = jnp.asarray(s["st"].numpy())

    def one(t0, t1, y, yb, cb):
        _, vjp = jax.vjp(lambda p: jf._step_with_coeffs(func, t0, t1 - t0, y, (p, mu)), s["jp"])
        return vjp((yb, cb))[0]

    return jax.vmap(one)(st[:-1], st[1:], jnp.asarray(s["ys"].numpy()),
                         jnp.asarray(ybar_steps.numpy()), jnp.asarray(s["cobar"].numpy()))


def test_step_batched_vjps_match_jax_vmap(outer):
    """The port's step-batched ``hopf_step_vjp`` (every accepted step in one
    batch, each with its own cotangents) against ``jax.vmap`` of
    ``jax.vjp``: per step and tensor rel L2 <= 1e-4 (one step's VJP, as
    ``test_torch_hopf_model.py`` holds it); and each batched step is the
    same bits as that step taken alone."""
    s = outer
    _, ybar_steps = _emit(s)
    want = _jax_step_vjps(s, ybar_steps)
    st = s["st"]
    t0s, hs = st[:-1, None, None], (st[1:] - st[:-1])[:, None, None]
    _, flat = ho.hopf_step_vjp(t0s, hs, s["ys"], ybar_steps, s["cobar"], s["params"], s["tmu"])
    assert flat.shape == (s["n"], ho.pack_params(s["params"]).numel())
    for k in range(s["n"]):
        got = ho.unpack_params(flat[k], s["params"])
        for i, (layer, layer_j) in enumerate(zip(got, want)):
            for key in ("w", "b"):
                assert rel_l2(layer[key].numpy(), layer_j[key][k]) < 1e-4, (k, i, key)
    for k in (0, s["n"] // 2, s["n"] - 1):
        _, alone = ho.hopf_step_vjp(st[k], st[k + 1] - st[k], s["ys"][k], ybar_steps[k],
                                    s["cobar"][k], s["params"], s["tmu"])
        assert torch.equal(flat[k], alone), k


@pytest.mark.parametrize("block", [1, 3, None])
def test_outer_arg_grads_sum_the_steps(outer, block):
    """``hopf_outer_arg_grads`` in blocks of 1, 3 and the default against
    the float64 sum of the per-step VJPs: rel L2 <= 1e-6 per tensor (float32
    sums in another order); against the sum of JAX's per-step VJPs and the
    kernel-mode sweep's cotangents: <= 1e-4."""
    s = outer
    _, ybar_steps = _emit(s)
    st = s["st"]
    t0s, hs = st[:-1, None, None], (st[1:] - st[:-1])[:, None, None]
    _, flat = ho.hopf_step_vjp(t0s, hs, s["ys"], ybar_steps, s["cobar"], s["params"], s["tmu"])
    exact = ho.unpack_params(flat.double().sum(0), s["params"])
    got = tf.hopf_outer_arg_grads(s["ys"], ybar_steps, s["cobar"], st, s["params"], s["tmu"],
                                  block=block)
    jsum = [{k: np.asarray(v).sum(0) for k, v in layer.items()}
            for layer in _jax_step_vjps(s, ybar_steps)]
    _, kernel = ho.hopf_replay_bwd(s["ys"], s["cobar"], st, s["params"], s["tmu"])
    for g, e, j, kk in zip(got, exact, jsum, kernel):
        for key in ("w", "b"):
            assert g[key].dtype == torch.float32 and g[key].shape == e[key].shape
            assert rel_l2(g[key].numpy(), e[key].numpy()) < 1e-6, key
            assert rel_l2(g[key].numpy(), j[key]) < 1e-4, key
            assert rel_l2(g[key].numpy(), kk[key].numpy()) < 1e-6, key


def _linear_loss_weights():
    return np.random.default_rng(23).normal(0, 1, (T, B, 2)).astype(np.float32)


def _port_loss_grads(s, mode, grid):
    params = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
              for layer in s["params"]]
    y0 = torch.as_tensor(s["y0"]).requires_grad_(True)
    ys = tf.hopf_odeint_dopri5_fused(params, torch.as_tensor(s["mu"]), s["dt"], y0,
                                     torch.tensor(s["ts"]), max_steps=M, grid=grid,
                                     arg_grads=mode)
    loss = (ys * torch.as_tensor(_linear_loss_weights())).sum()
    loss.backward()
    return float(loss), [y0.grad] + [layer[k].grad for layer in params for k in ("w", "b")]


def test_outer_mode_solve_matches_jax_outer_mode(outer):
    """``hopf_odeint_dopri5_fused(..., arg_grads="outer")`` on JAX's grid
    against ``odeint_dopri5_fused(..., arg_grads="outer", interpret=True)``
    for a linear loss of every output: loss rel 1e-5, the gradients of y0
    and of every parameter tensor rel L2 1e-4; against the port's kernel
    mode on the same grid: loss equal, gradients rel L2 1e-6 (only the
    order of the float32 sum over the steps differs)."""
    s = outer
    W = jnp.asarray(_linear_loss_weights())

    def jloss(y0, p):
        ys = jf.odeint_dopri5_fused(jax_drift(s["dt"]), y0, jnp.asarray(s["ts"]), p,
                                    jnp.asarray(s["mu"]), max_steps=M, nondiff_args=(1,),
                                    arg_grads="outer", interpret=True)
        return jnp.sum(ys * W)

    loss_j, (gy_j, gp_j) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(s["y0"]), s["jp"])
    want = [np.asarray(gy_j)] + [np.asarray(layer[k]) for layer in gp_j for k in ("w", "b")]
    grid = frozen_grid_from_jax(*s["grid"])
    loss_o, grads_o = _port_loss_grads(s, "outer", grid)
    loss_k, grads_k = _port_loss_grads(s, "kernel", grid)
    assert loss_o == pytest.approx(float(loss_j), rel=1e-5)
    assert loss_o == loss_k
    for i, (g, w, g_k) in enumerate(zip(grads_o, want, grads_k)):
        assert rel_l2(g.numpy(), w) < 1e-4, i
        assert rel_l2(g.numpy(), g_k.numpy()) < 1e-6, i


def test_outer_backward_runs_the_emit_sweep(outer, monkeypatch):
    """Outer mode's backward is the emit sweep and the outer pass, never the
    kernel-mode sweep; kernel mode's is the kernel-mode sweep alone."""
    s = outer
    calls = []
    for name in ("hopf_replay_bwd", "hopf_replay_bwd_emit", "hopf_outer_arg_grads"):
        fn = getattr(tf, name)
        monkeypatch.setattr(tf, name, lambda *a, _f=fn, _n=name, **k: (calls.append(_n),
                                                                       _f(*a, **k))[1])
    grid = frozen_grid_from_jax(*s["grid"])
    _port_loss_grads(s, "outer", grid)
    assert calls == ["hopf_replay_bwd_emit", "hopf_outer_arg_grads"]
    calls.clear()
    _port_loss_grads(s, "kernel", grid)
    assert calls == ["hopf_replay_bwd"]


def test_task_step_in_outer_mode_equals_kernel_mode(outer, monkeypatch):
    """``make_train_step`` on a hand-built ``HopfTask``: with the 1 MiB
    rule's threshold at 0 ("auto" then takes outer mode, as it does past
    1 MiB) the step's loss equals kernel mode's and its gradients agree
    within rel L2 1e-6 on JAX's grid."""
    s = outer
    target = np.random.default_rng(24).normal(0, 1, (T, B, 2)).astype(np.float32)
    target[0] = s["y0"]  # the step starts from true_y[0]
    true_y = torch.cat([torch.as_tensor(target), torch.as_tensor(s["mu"])[..., None]], dim=-1)

    def step(threshold):
        monkeypatch.setattr(tf, "OUTER_ARG_BYTES", threshold)
        params = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
                  for layer in s["params"]]
        ts = torch.tensor(s["ts"])
        opt, _ = torch_rmsprop([p for layer in params for p in layer.values()], lr=1e-3,
                               alpha=0.99)
        task = tbt.HopfTask(params, ts, s["dt"], opt, M)
        rec = tbt.make_train_step(task)(true_y, grid=frozen_grid_from_jax(*s["grid"]))
        return float(rec["loss"]), [p.grad for layer in params for p in layer.values()]

    assert tf.hopf_arg_grads(s["params"]) == "kernel"
    loss_k, grads_k = step(1 << 20)
    loss_o, grads_o = step(0)
    assert loss_o == loss_k
    for g, g_k in zip(grads_o, grads_k):
        assert rel_l2(g.numpy(), g_k.numpy()) < 1e-6


def test_wide_mlp_takes_outer_mode_and_converts():
    """The 3-512-512-512-2 MLP (2,113,544 B, past 1 MiB): "auto" resolves to
    "outer" as JAX's rule does (``columnflow/solvers/fused.py:571-574``),
    "kernel" there raises naming B8hw; ``hopf_params_from_jax`` carries the
    JAX MLP across exactly; the reference width stays in kernel mode."""
    jp = jh.build_hopf_mlp(jax.random.PRNGKey(3), WIDE, init_std=WIDE_STD)
    diff_bytes = sum(v.dtype.itemsize * int(np.prod(v.shape)) for layer in jp
                     for v in layer.values())
    assert diff_bytes == 2_113_544 > (1 << 20)
    params = hopf_params_from_jax([{k: np.asarray(v) for k, v in layer.items()} for layer in jp])
    for layer, layer_j in zip(params, jp):
        for k in ("w", "b"):
            assert layer[k].dtype == torch.float32
            assert np.array_equal(layer[k].numpy(), np.asarray(layer_j[k]))
    assert tf.hopf_arg_grads(params) == "outer"
    assert tf.hopf_arg_grads(params, "outer") == "outer"
    with pytest.raises(NotImplementedError, match="B8hw"):
        tf.hopf_arg_grads(params, "kernel")
    assert ho._kernel_ready(params, 32) == 512
    ref = th.build_hopf_mlp(torch.Generator().manual_seed(0))
    assert tf.hopf_arg_grads(ref) == "kernel"
    assert tf.hopf_arg_grads(ref, "outer") == "outer"
    w = torch.cat([layer["w"].reshape(-1) for layer in params])
    assert abs(float(w.std()) - WIDE_STD) < 0.01 * WIDE_STD


def test_outer_block_is_sized_by_bytes(monkeypatch):
    """The default block of ``hopf_outer_arg_grads``: 128 steps at the
    reference width, 16 at width 512 (one step's (B, H, H) float64 product
    is 67 MB at 32 lanes), so a block's temporaries stay near
    ``OUTER_BLOCK_BYTES``."""
    calls = []
    for sizes, want in (((3, 100, 100, 100, 2), 128), (WIDE, 16)):
        params = th.build_hopf_mlp(torch.Generator().manual_seed(0), sizes=sizes)
        n = 20
        ys = torch.zeros(n, 32, 2)
        st = torch.arange(n + 1, dtype=torch.float32) * 1e-3
        mu = ho.MuTable(torch.zeros(4, 32), 0.0, 1.0)
        calls.clear()

        def counting(t0, h, y, *a, **k):
            calls.append(y.shape[0])
            return None, ho.pack_params(params).expand(y.shape[0], -1)

        monkeypatch.setattr(tf, "hopf_step_vjp", counting)
        tf.hopf_outer_arg_grads(ys, ys, torch.zeros(n, 5, 32, 2), st, params, mu)
        assert calls == [min(want, n)] + ([n - want] if n > want else []), (sizes, calls)
