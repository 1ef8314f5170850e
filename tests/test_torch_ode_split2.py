"""Port parity: the ``fused-split2`` tier of ``columnflow_torch`` (the
two-term split's weight cotangent in ``models.network``, the split2 replay
and the emit-mode reverse sweep of ``kernels.network_ode``,
``solvers.fused.ode_outer_arg_grads`` and ``odeint_dopri5_fused(...,
split2=True)``) against ``columnflow.solvers.fused.odeint_dopri5_fused``
called as ``columnflow/tasks/parity.py:443-484`` calls it for the tier:
``prepare=prepare_premixed_split2``, ``select_func`` = the three-term drift
on ``select_args=(pw3, fc, kvals)``, and ``arg_grads="outer"``, in
interpret mode.

Size: columns (2, 1), 2 inputs, batch 4, 60 grid points, max_steps 512
(rounded to 660), as ``tests/test_torch_ode_fused.py``. At this size the
JAX task itself would take kernel mode (its weights are far below 1 MiB),
so both sides run outer mode: the JAX solver is called with
``arg_grads="outer"``, and the port's task with its 1 MiB threshold
patched to 0 (the ``outer`` fixture). The selection of the tier is the
f32-exact engine's (three-term split), so JAX's frozen grid comes from the
same selection call as there (``jax_select``), and the replay, the sweep,
the loss and the gradients are held on it. Tolerances are stated at each
test with the value measured here.
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
from columnflow.solvers import fused as jf
from columnflow.tasks import parity as jpt
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import frozen_grid_from_jax, network_from_jax
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.models import network as tn
from columnflow_torch.solvers import fused
from columnflow_torch.solvers.fused import (
    ode_outer_arg_grads,
    odeint_dopri5_fused,
    resolve_arg_grads,
)
from columnflow_torch.tasks import parity as tpt
from test_torch_ode_fused import _jax_drift, jax_select

T, B, N_IN, M = 60, 4, 2, 512
STIMS = np.array([[0.0, 15.0], [15.0, 0.0], [15.0, 15.0], [0.0, 0.0]], np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).reshape(-1, want.shape[-1]).max(0), 1e-30)
    return float((np.abs(got - want) / scale).max())


def _port_params(task, jparams, jnet):
    params, _ = network_from_jax(jparams, jnet)
    with torch.no_grad():
        for k, p in task.params.items():
            p.copy_(params[k])


def build_setup():
    """The JAX task and its port at this file's size, JAX's frozen grid (the
    three-term selection) and JAX's split2 replay on it
    (``test_torch_split2_kernel_mode`` uses it too)."""
    jtask = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                           n_inputs=N_IN, time_steps=T, max_steps=M)
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=N_IN, time_steps=T, max_steps=M,
                          device="cpu")
    _port_params(task, {k: np.asarray(v) for k, v in jtask.params.items()}, jtask.net)
    model = tpt.sde_model(task.params, task, torch.as_tensor(STIMS))
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    drift, jkv = _jax_drift(jtask)
    jpw = jn.premix_network_weights(jtask.params, jtask.net)
    jfc = jn.build_network_fused_consts(jtask.net)
    st, stats = jax_select(jtask, jtask.params)
    n = int(stats[0])
    step = jax.jit(lambda t0, h, y, pw_: jf._step_with_coeffs(
        drift, t0, h, y, jn.prepare_premixed_split2(pw_, jfc, jkv)))
    y, ys, co = jnp.zeros((B, 3 * task.net.num_pops)), [], []
    for k in range(n):
        ys.append(np.asarray(y))
        y, c = step(st[k], st[k + 1] - st[k], y, jpw)
        co.append(np.asarray(c))
    return dict(jtask=jtask, task=task, model=model, pw=pw, sc=model.sc, kv=model.kv,
                drift=drift, jargs=(jpw, jfc, jkv), P=task.net.num_pops,
                jgrid=(np.asarray(st), np.asarray(stats)), n=n, jys=np.stack(ys),
                jco=np.stack(co), w2=tn.prepare_premixed_split2(pw, model.sc.fc)[0])


@pytest.fixture(scope="module")
def setup():
    return build_setup()


def test_split2_weight_cotangent_rounding_points_equal_jax():
    """Seven ``matmul_split2`` products sharing one ``prepare_premixed_split2``
    (a replay step's seven drift evaluations): ``split2_accumulate`` in the
    reverse pass's order and ``split2_fold`` equal ``jax.vjp`` bit for bit.
    Accumulating in forward order, or folding each product on its own,
    gives another float32 value in most entries."""
    rng = np.random.default_rng(11)
    xs = rng.uniform(0, 60, (7, 4, 24)).astype(np.float32)
    cs = rng.normal(size=(7, 4, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 24)) * 3).astype(np.float32)

    def seven(w_):
        d = jn.prepare_premixed_split2({"wT": w_, "iwT": w_[:2]}, None)[0]
        return tuple(jn.matmul_split2(jnp.asarray(x), d["wT_hi"], d["wT_mid"]) for x in xs)

    _, vjp = jax.vjp(seven, jnp.asarray(w))
    want = np.asarray(vjp(tuple(jnp.asarray(c) for c in cs))[0])
    acc = None
    for i in range(6, -1, -1):
        acc = tn.split2_accumulate(acc, torch.as_tensor(xs[i]), torch.as_tensor(cs[i]))
    np.testing.assert_array_equal(tn.split2_fold(acc).numpy(), want)
    fwd = None
    for i in range(7):
        fwd = tn.split2_accumulate(fwd, torch.as_tensor(xs[i]), torch.as_tensor(cs[i]))
    assert (tn.split2_fold(fwd).numpy() != want).mean() > 0.3
    # Step-batched: a leading axis keeps separate accumulators.
    batched = tn.split2_fold(tn.split2_accumulate(None, torch.as_tensor(xs[:2]),
                                                  torch.as_tensor(cs[:2])))
    for i in range(2):
        one = tn.split2_fold(tn.split2_accumulate(None, torch.as_tensor(xs[i]),
                                                  torch.as_tensor(cs[i])))
        assert torch.equal(batched[i], one)


def test_step_weight_vjp_matches_jax_vjp_of_the_step(setup):
    """The replay step's VJP through ``prepare_premixed_split2``, as
    ``_outer_arg_grads`` takes it per step (``columnflow/solvers/fused.py:
    660-669``): state, wT and iwT cotangents rel L2 <= 1e-3 (measured over
    three draws: state <= 8.8e-6, wT <= 1.6e-4, iwT <= 4.0e-5), and at most
    3% of the wT entries differ at all (XLA's exp/tanh against torch's flip
    a bf16 rounding now and then; measured 2 to 8 of 576)."""
    s = setup
    jpw, jfc, jkv = s["jargs"]
    t0, h = np.float32(0.0295), np.float32(2e-4)
    rng0 = np.random.default_rng(5)
    P = s["P"]
    y = np.concatenate([rng0.uniform(-5, 25, (B, P)), rng0.uniform(0, 5, (B, P)),
                        rng0.uniform(0, 50, (B, P))], axis=1).astype(np.float32)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        ybar = rng.normal(size=y.shape).astype(np.float32)
        cbar = rng.normal(size=(5,) + y.shape).astype(np.float32)
        _, vjp = jax.vjp(lambda yy, pw: jf._step_with_coeffs(
            s["drift"], t0, h, yy, jn.prepare_premixed_split2(pw, jfc, jkv)), jnp.asarray(y), jpw)
        want_y, want_pw = vjp((jnp.asarray(ybar), jnp.asarray(cbar)))
        got_y, got_w, got_iw = no.step_vjp(torch.tensor(t0), torch.tensor(h), torch.as_tensor(y),
                                           torch.as_tensor(ybar), torch.as_tensor(cbar), s["w2"],
                                           s["sc"], s["kv"])
        assert rel_l2(got_y, want_y) < 1e-3
        assert rel_l2(got_w, want_pw["wT"]) < 1e-3
        assert rel_l2(got_iw, want_pw["iwT"]) < 1e-3
        want_w = np.asarray(want_pw["wT"])
        differ = np.abs(got_w.numpy() - want_w) > 1e-6 * np.abs(want_w).max()
        assert differ.mean() < 0.03, int(differ.sum())
        got_state = no.step_vjp(torch.tensor(t0), torch.tensor(h), torch.as_tensor(y),
                                torch.as_tensor(ybar), torch.as_tensor(cbar), s["w2"], s["sc"],
                                s["kv"], weights=False)
        assert torch.equal(got_state, got_y)


def test_outer_arg_grads_in_blocks_equal_the_sum_of_steps(setup):
    """``ode_outer_arg_grads`` batches the steps; each step keeps its own
    bf16 accumulators, so any block size gives the per-step VJPs summed
    (rel 1e-6: the float32 sum over steps runs in another order)."""
    s = setup
    n, k0 = 9, s["n"] - 12  # steps where the stimulus is on (iwT's cotangent is not 0)
    st = torch.as_tensor(s["jgrid"][0][k0:k0 + n + 1].copy())
    ys = torch.as_tensor(s["jys"][k0:k0 + n])
    gen = torch.Generator().manual_seed(4)
    ybs = torch.randn(ys.shape, generator=gen)
    cobar = torch.randn((n, 5) + tuple(ys.shape[1:]), generator=gen)
    want_w, want_iw = torch.zeros_like(s["pw"]["wT"]), torch.zeros_like(s["pw"]["iwT"])
    for k in range(n):
        _, gw, giw = no.step_vjp(st[k], st[k + 1] - st[k], ys[k], ybs[k], cobar[k], s["w2"],
                                 s["sc"], s["kv"])
        want_w, want_iw = want_w + gw, want_iw + giw
    for block in (1, 4, 16):
        got_w, got_iw = ode_outer_arg_grads(ys, ybs, cobar, st, s["pw"], s["sc"], s["kv"],
                                            block=block)
        assert rel_l2(got_w, want_w) < 1e-6 and rel_l2(got_iw, want_iw) < 1e-6, block


def test_replay_split2_on_jax_grid(setup):
    """ys and the dense rows of every accepted step on JAX's grid, with the
    two-term split, on each state component's largest magnitude: ys and
    rows 1-4 within 2e-5 (measured: ys 1.2e-5; rows 1.2e-5, 6.5e-6, 5.9e-6,
    1.2e-5), the last row (a cancelling sum of seven stage derivatives)
    within 5e-5 (measured 4.1e-5).

    Not 1e-5: the split2 drift keeps the rates' second bf16 term, which is
    2^-8 of the first, so a rate an ulp apart (XLA's exp/tanh against
    torch's) moves a product by up to 2^-16 of its size where the three-term
    split moves it by 2^-24 (tests/test_torch_network.py holds one split2
    drift to 2^-15 of its scale). The exact engine's replay on the same grid
    holds 4.4e-6 (tests/test_torch_ode_fused.py)."""
    s = setup
    n = s["n"]
    ys, co = no.ode_replay_fwd_split2(torch.zeros(B, 3 * s["P"]),
                                      torch.as_tensor(s["jgrid"][0][:n + 1]), s["w2"], s["sc"],
                                      s["kv"])
    assert tuple(co.shape) == (n, 5, B, 3 * s["P"])
    assert scaled(ys, s["jys"]) < 2e-5
    scale = np.maximum(np.abs(s["jys"]).reshape(-1, s["jys"].shape[-1]).max(0), 1e-30)
    for r in range(5):
        err = float((np.abs(co[:, r].numpy() - s["jco"][:, r]) / scale).max())
        assert err < (5e-5 if r == 4 else 2e-5), r


def _jax_emit(s, jpw, cobar):
    """The JAX package's emit-mode reverse-sweep kernel (interpret mode) over
    JAX's accepted steps in one chunk: (ybar0, ybar_steps)."""
    n = s["n"]
    func, prep, dyn, _ = jf._flatten_for_kernel(s["drift"], (jpw,) + s["jargs"][1:], (1, 2),
                                                jn.prepare_premixed_split2)
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
    """The emit-mode sweep (ybar0 and every ybar_steps[k]) against the JAX
    package's emit kernel on JAX's states, rel L2 <= 3e-2 (measured ybar0
    5.7e-4, ybar_steps 1.0e-3). The state VJP through the two-term split
    rounds both transposed products to bf16 (``split2_cotangent``), so the
    sweep is bf16-grade: either side's own result moves when the weights
    move by one part in 1e7, and that spread is asserted beside it
    (measured: the port 5.7e-4 and 9.2e-4, JAX 7.1e-4 and 1.1e-3)."""
    s = setup
    gen = np.random.default_rng(9)
    cobar = gen.normal(size=(s["n"], 5, B, 3 * s["P"])).astype(np.float32)
    want_yb, want_steps = _jax_emit(s, s["jargs"][0], cobar)
    st = torch.as_tensor(s["jgrid"][0][:s["n"] + 1])
    args = (torch.as_tensor(s["jys"]), torch.as_tensor(cobar), st)
    yb, steps = no.ode_replay_bwd_emit(*args, s["w2"], s["sc"], s["kv"])
    assert torch.equal(steps[-1], torch.zeros_like(steps[-1]))
    err = (rel_l2(yb, want_yb), rel_l2(steps, want_steps))
    nudged = {k: v * (1.0 + 1e-7) for k, v in s["pw"].items()}
    w2n = tn.prepare_premixed_split2(nudged, s["sc"].fc)[0]
    yb_n, steps_n = no.ode_replay_bwd_emit(*args, w2n, s["sc"], s["kv"])
    spread = (rel_l2(yb_n, yb), rel_l2(steps_n, steps))
    jyb_n, jsteps_n = _jax_emit(s, {k: v * (1.0 + 1e-7) for k, v in s["jargs"][0].items()},
                                cobar)
    jspread = (rel_l2(jyb_n, want_yb), rel_l2(jsteps_n, want_steps))
    assert max(err) < 3e-2, (err, spread, jspread)
    assert all(1e-7 < x < 3e-2 for x in spread + jspread), (spread, jspread)


def _jax_loss(jtask, params):
    """The tier's loss through ``columnflow.solvers.fused.odeint_dopri5_fused``
    built as ``columnflow/tasks/parity.py:443-484``, with arg_grads="outer"."""
    drift, kv = _jax_drift(jtask)
    fc = jn.build_network_fused_consts(jtask.net)
    pw = jn.premix_network_weights(params, jtask.net)
    pw3 = jn.prepare_premixed_split(pw, fc)[0]
    ys = jf.odeint_dopri5_fused(drift, jnp.zeros((B, 3 * jtask.net.num_pops)), jtask.ts, pw, fc,
                                kv, max_steps=M, nondiff_args=(1, 2),
                                prepare=jn.prepare_premixed_split2, select_func=drift,
                                select_args=(pw3, fc, kv), arg_grads="outer", interpret=True)
    ys = jnp.transpose(ys, (1, 0, 2))
    out = jpt.readout(ys, params, jtask.net)
    return jnp.mean(jnp.abs(out - jpt.parity_targets(jnp.asarray(STIMS)))), ys


@pytest.fixture
def outer(monkeypatch):
    """The port's task at 3 columns in outer mode: "auto" resolves to
    "outer" for any weights (the JAX side is told arg_grads="outer")."""
    monkeypatch.setattr(fused, "OUTER_ARG_BYTES", 0)


def test_solve_loss_and_outer_gradients_on_jax_grid(setup, outer):
    """The whole tier on JAX's frozen grid against the JAX solve: ys within
    2e-5 of each component's largest magnitude (measured 1.1e-5; why not
    1e-5: ``test_replay_split2_on_jax_grid``), loss rel <= 1e-5 (measured
    9.5e-8), masked gradients rel L2 <= 3e-2 (measured: input 1.2e-3,
    feedforward 7.1e-3, lateral 1.4e-2, output 7.2e-4), with the port's own
    spread under a 1e-7 nudge of the weights asserted beside them (measured
    1.7e-3, 7.7e-3, 6.9e-3, 3.3e-4): the emit sweep and every weight
    cotangent of the outer pass round to bf16 (``split2_cotangent``,
    ``split2_accumulate``), so the gradient is determined to that grade."""
    s = setup
    jtask, task = s["jtask"], s["task"]
    (want_loss, want_ys), want_g = jax.value_and_grad(
        lambda p: _jax_loss(jtask, p), has_aux=True)(jtask.params)
    grid = frozen_grid_from_jax(*s["jgrid"])
    stims = torch.as_tensor(STIMS)

    def loss_of(params):
        ys = tpt.batched_rollout(params, task, stims, grid=grid, split2=True)
        return torch.mean(torch.abs(tpt.readout(ys, params, task.net)
                                    - tpt.parity_targets(stims))), ys

    loss, ys = loss_of(task.params)
    assert scaled(ys.detach(), want_ys) < 2e-5
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    grads = torch.autograd.grad(loss, list(task.params.values()))
    nudged = {k: (p.detach() * (1.0 + 1e-7)).requires_grad_(True)
              for k, p in task.params.items()}
    grads_n = torch.autograd.grad(loss_of(nudged)[0], list(nudged.values()))
    for (k, m), g, gn in zip(task.grad_mask.items(), grads, grads_n):
        err = rel_l2(g * m, np.asarray(want_g[k]) * np.asarray(jtask.grad_mask[k]))
        spread = rel_l2(gn * m, (g * m).numpy())
        assert err < 3e-2, (k, err)
        assert 1e-7 < spread < 3e-2, (k, spread)


def test_split2_step_with_its_own_selection(outer):
    """One train step of the tier with the port's own selection (the
    three-term selection on a split taken outside, as ``select_args``):
    finite loss and gradients, masked entries untouched."""
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(2),
                          columns_per_area=(2, 1), n_inputs=N_IN, time_steps=T, max_steps=M,
                          device="cpu")
    w0 = {k: p.detach().clone() for k, p in task.params.items()}
    out = tpt.make_train_step(task, split2=True)(torch.as_tensor(STIMS))
    assert np.isfinite(float(out["loss"])) and out["ok"]
    stats = out["stats"]
    assert bool(stats.success) and 0 < int(stats.naccept) <= 660
    for k, p in task.params.items():
        off = ~task.grad_mask[k].bool()
        assert torch.isfinite(p.grad).all(), k
        assert bool((p.grad[off] == 0).all()), k
        assert torch.equal(p.detach()[off], w0[k][off]), k


@pytest.mark.parametrize("columns,n_in,mode", [
    (63, 4, "kernel"), (64, 4, "outer"), (65, 4, "outer"), (104, 4, "outer"), (13, 4, "kernel"),
    (3, 2, "kernel")])
def test_arg_grads_rule_matches_jax(columns, n_in, mode):
    """``resolve_arg_grads`` against ``columnflow/solvers/fused.py:571-574``
    on the parity tier's arguments (pw differentiable, fc and the knots
    data): "outer" when the differentiable leaves exceed 1 MiB. wT and iwT
    both count, so with 4 inputs 63 columns give "kernel" and 64 columns
    "outer" (wT alone is exactly 1 MiB there). A rule, not a solve: the
    arguments are zeros of the tier's shapes."""
    P = 8 * columns
    jpw = {"wT": jnp.zeros((P, P)), "iwT": jnp.zeros((n_in, P))}
    jfc = {"bg": np.zeros(P, np.float32), "adapt": np.zeros(P, np.float32), "tau_syn": 1.0}
    _, _, dyn, diff_idx = jf._flatten_for_kernel(lambda *a: None, (jpw, jfc, jnp.zeros((4, B, n_in))),
                                                 (1, 2))
    nbytes = sum(dyn[i].dtype.itemsize * int(np.prod(dyn[i].shape)) for i in diff_idx)
    want = "outer" if nbytes > (1 << 20) else "kernel"
    pw = {"wT": torch.zeros(P, P), "iwT": torch.zeros(n_in, P)}
    assert resolve_arg_grads(pw) == want
    assert resolve_arg_grads(pw, "kernel") == "kernel" and resolve_arg_grads(pw, "outer") == "outer"
    assert want == mode


def test_kernel_mode_split2_raises_naming_its_item(setup, monkeypatch):
    """Kernel mode on the two-term split (B8s; "auto" at this size) resolves
    and runs: the solve through ``ode_replay_bwd_split2`` and the
    ``--split2`` training run. Only an unknown mode still raises."""
    s = setup
    y0 = torch.zeros(B, 3 * s["P"])
    seen = []
    orig = fused.ode_replay_bwd_split2
    monkeypatch.setattr(fused, "ode_replay_bwd_split2",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    pw = {k: v.clone().requires_grad_(True) for k, v in s["pw"].items()}
    ys = odeint_dopri5_fused(pw, s["sc"], s["kv"], y0, torch.linspace(0, 0.01, 5), split2=True)
    ys.sum().backward()
    assert seen and all(torch.isfinite(p.grad).all() for p in pw.values())
    with pytest.raises(ValueError, match="arg_grads"):
        odeint_dopri5_fused(s["pw"], s["sc"], s["kv"], y0, torch.linspace(0, 0.01, 5),
                            split2=True, arg_grads="inner")
    _, hist = tpt.train_parity(smoke=True, device="cpu", columns_per_area=(2, 1), n_inputs=2,
                               time_steps=T, max_steps=M, split2=True)
    assert all(np.isfinite(h["loss"]) for h in hist if "loss" in h)


def test_split2_wrappers_check_their_tensors(setup):
    s = setup
    st = torch.linspace(0.0, 1e-3, 4)
    with pytest.raises(ValueError, match="wT_mid must be torch.bfloat16"):
        no.ode_replay_fwd_split2(torch.zeros(B, 3 * s["P"]), st,
                                 {**s["w2"], "wT_mid": s["w2"]["wT_mid"].float()}, s["sc"],
                                 s["kv"])
    with pytest.raises(ValueError, match="cobar has shape"):
        no.ode_replay_bwd_emit(torch.zeros(3, B, 3 * s["P"]), torch.zeros(2, 5, B, 3 * s["P"]),
                               torch.zeros(4), s["w2"], s["sc"], s["kv"])
    assert all(v == 0 for v in no.LAUNCHES.values())  # plain versions count nothing
