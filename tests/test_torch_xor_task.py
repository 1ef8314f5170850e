"""Port parity: two training steps of ``columnflow_torch.tasks.xor`` on each
of its two default engines against ``columnflow.tasks.xor.make_train_step(
task, use_fused=True[, stochastic=True])``, the training run's evaluation
against the JAX package's ``eval_fn``, and the command line that selects
the engine (the stochastic-adaptive step's parity is
``tests/test_torch_xor_adaptive.py``).

Size: the XOR network, the four conditions, 60 grid points, max_steps 512,
as the JAX package's XOR tests. The JAX fused dopri5 solve runs in interpret
mode (``columnflow.solvers.odeint_dopri5_fused`` is wrapped for the test; the
fused SDE chooses interpret mode on the CPU itself). Before each step the
port takes JAX's parameters; the deterministic step replays the grid JAX's
selection kernel freezes for them, the stochastic step takes the Brownian
integrals JAX's key gives (``columnflow.solvers.sde._brownian_pack``).

Tolerances: loss rel 1e-5; masked gradients rel L2 1e-3 (stochastic) and,
deterministic, 1e-4 plus four times the spread the port's own gradient
shows when the weights move by one part in 1e7 (measured: ff_w1 1.3e-4
against JAX beside a spread of 6.3e-5 in the first step; the readout at the
last grid point differentiates through the stimulus' onset, which amplifies
float32 rounding; ROADMAP.md section C); parameters abs 1e-4 after each
RMSprop step. RMSprop's
first step is -lr g / (sqrt(0.05) |g| + 1e-8), +-2.24 lr on every trained
entry whatever the gradient's size, and the second step's update is a ratio
of the two gradients, so the parameters follow the gradients' relative
error, scaled by lr.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import columnflow.solvers as jsolvers
from columnflow.config import ColumnConfig as JaxConfig
from columnflow.solvers.sde import _brownian_pack
from columnflow.tasks import xor as jxt
from columnflow.train import mask_grads as j_mask_grads
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import frozen_grid_from_jax, xor_network_from_jax
from columnflow_torch.solvers.sde import brownian_pack
from columnflow_torch.tasks import xor as txt
from test_torch_xor_model import jax_sde, jax_xor_select, port_task, rel_l2

REPO = Path(__file__).resolve().parent.parent
T, M = 60, 512
# Not the table order, so that the port's readout follows the batch's order.
CONDS = np.asarray(jxt.xor_conditions())[[2, 0, 3, 1]]


@pytest.fixture(scope="module")
def interpret_fused():
    """The JAX package's fused dopri5 in interpret mode (its batched_rollout
    imports it at call time)."""
    orig = jsolvers.odeint_dopri5_fused
    jsolvers.odeint_dopri5_fused = functools.partial(orig, interpret=True)
    yield
    jsolvers.odeint_dopri5_fused = orig


def _jax_run(stochastic):
    task = jxt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), time_steps=T, max_steps=M)
    step = jxt.make_train_step(task, use_fused=True, stochastic=stochastic)
    conds = jnp.asarray(CONDS)

    @jax.jit
    def grads_of(p, key):
        def loss(p):
            ys = jxt.batched_rollout(p, task, conds, use_fused=True, stochastic=stochastic,
                                     key=key)
            return jxt.readout(ys, jxt.xor_targets(conds))[1]

        return j_mask_grads(jax.grad(loss)(p), task.grad_mask)

    params = jax.tree_util.tree_map(jnp.array, task.params)
    opt_state = task.optimizer.init(params)
    records = []
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        before = {k: np.array(v) for k, v in params.items()}
        if stochastic:
            _, i1, i10, _, _ = _brownian_pack(key, task.ts, (4, 1), jnp.float32)
            drive = dict(noise=(torch.as_tensor(np.array(i1)), torch.as_tensor(np.array(i10))))
        else:
            drive = dict(grid=frozen_grid_from_jax(*jax_xor_select(task, params, CONDS)))
        grads = {k: np.asarray(v) for k, v in grads_of(params, key).items()}
        params, opt_state, loss = step(params, opt_state, conds, key if stochastic else None)
        records.append(dict(before=before, drive=drive, grads=grads, loss=float(loss),
                            after={k: np.array(v) for k, v in params.items()}))
    return task, records


@pytest.fixture(scope="module")
def jax_det_run(interpret_fused):
    return _jax_run(stochastic=False)


@pytest.fixture(scope="module")
def jax_sde_run():
    return _jax_run(stochastic=True)


def _load(task, jtask, before, eps=0.0):
    params, _ = xor_network_from_jax({k: v * (1.0 + eps) for k, v in before.items()}, jtask.net)
    with torch.no_grad():
        for k, p in task.params.items():
            p.copy_(params[k])


def _nudge_spread(task, jtask, rec):
    """The rel L2 by which the port's masked gradient moves when the
    weights move by one part in 1e7 (on the same frozen grid)."""
    grads = []
    for eps in (0.0, 1e-7):
        _load(task, jtask, rec["before"], eps)
        task.optimizer.zero_grad(set_to_none=True)
        ys = txt.batched_rollout(task.params, task, torch.as_tensor(CONDS), **rec["drive"])
        txt.readout(ys, txt.xor_targets(torch.as_tensor(CONDS)))[1].backward()
        grads.append({k: p.grad * task.grad_mask[k] for k, p in task.params.items()})
    return {k: rel_l2(grads[1][k], grads[0][k]) for k in grads[0]}


def _port_steps(jtask, records, stochastic, grad_tol):
    task = port_task(jtask)
    step = txt.make_train_step(task, stochastic=stochastic)
    masks = {k: v.bool().expand_as(task.params[k]) for k, v in task.grad_mask.items()}
    for i, rec in enumerate(records):
        spread = None if stochastic else _nudge_spread(task, jtask, rec)
        _load(task, jtask, rec["before"])
        out = step(torch.as_tensor(CONDS), **rec["drive"])
        assert float(out["loss"]) == pytest.approx(rec["loss"], rel=1e-5), i
        if not stochastic:
            assert int(out["stats"].naccept) == rec["drive"]["grid"][1]
            assert bool(out["stats"].success)
        for k, p in task.params.items():
            assert torch.isfinite(p.grad).all() and bool((p.grad[~masks[k]] == 0).all()), k
            tol = grad_tol if spread is None else grad_tol + 4 * spread[k]
            assert rel_l2(p.grad, rec["grads"][k]) < tol, (i, k, spread)
            np.testing.assert_allclose(p.detach().numpy(), rec["after"][k], atol=1e-4,
                                       err_msg=f"step {i} {k}")


def test_two_deterministic_train_steps_match_jax(jax_det_run):
    _port_steps(*jax_det_run, stochastic=False, grad_tol=1e-4)


def test_two_stochastic_train_steps_match_jax(jax_sde_run):
    _port_steps(*jax_sde_run, stochastic=True, grad_tol=1e-3)


def test_evaluation_matches_jax_eval_fn():
    """The port evaluates through the fused deterministic forward (one
    controller over the four conditions, the knot stimulus); the JAX
    package's ``eval_fn`` through the unfused per-sample ``odeint`` (its own
    controller per condition, the dense stimulus table). Both solve at rtol
    1e-7: final rates and loss rel 1e-4."""
    jtask = jxt.build_task(JaxConfig.load(), jax.random.PRNGKey(1), time_steps=T, max_steps=M)
    conds = jnp.asarray(jxt.xor_conditions())
    final_j, loss_j = jax.jit(lambda p, c: jxt.readout(
        jxt.batched_rollout(p, jtask, c, differentiable=False), jxt.xor_targets(c)))(
        jtask.params, conds)
    final, loss = txt.evaluate(port_task(jtask), torch.as_tensor(np.asarray(conds)))
    assert rel_l2(final, final_j) < 1e-4
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-4)


def _run_off(ys, limit):
    """The first grid point where a state component is not finite or past
    ``limit`` in magnitude (None if there is none)."""
    bad = ~np.isfinite(ys) | (np.abs(ys) > limit)
    idx = np.nonzero(bad.reshape(bad.shape[0], -1).any(1))[0]
    return int(idx[0]) if idx.size else None


def test_stochastic_rollout_after_two_port_steps_runs_off_where_jax_does():
    """The XOR stochastic result of the command line (``--samples 40
    --stochastic --fused`` ends at loss 0.60776, acc 0.25 on the card): the
    weights after two stochastic port steps at the full 1000 points (seed
    0, as ``train_xor`` draws them), then both packages' fixed-grid SDE
    forward on one fresh Brownian pack. Measured: both trajectories pass
    1e2 at grid point 458, 1e3 at 506 and 1e4 at 507 (the state reaches
    |y| ~ 7e4 in both), and agree to 2e-5 of each component's scale before
    the run-off. So the run-off is the JAX package's own SRA1 behaviour at
    h = 1 ms with these weights, not a port fault (ROADMAP.md section C).
    Held: the same run-off point at each limit, and 5e-5 of scale (the SDE
    trajectory's tolerance) up to the first."""
    gen = torch.Generator().manual_seed(0)
    task = txt.build_task(ColumnConfig.load(), gen, device="cpu")
    step = txt.make_train_step(task, stochastic=True)
    conds_all = torch.as_tensor(jxt.xor_conditions())
    for _ in range(2):
        conds = conds_all[torch.randperm(4, generator=gen)]
        _, i1, i10, _, _ = brownian_pack(gen, task.ts, (4, 1))
        step(conds, (i1, i10))
    _, i1, i10, _, _ = brownian_pack(gen, task.ts, (4, 1))
    ys = txt.batched_rollout(task.params, task, conds_all, differentiable=False,
                             stochastic=True, noise=(i1, i10)).transpose(0, 1).numpy()
    jtask = jxt.build_task(JaxConfig.load(), jax.random.PRNGKey(0))
    jparams = {k: jnp.asarray(p.detach().numpy()) for k, p in task.params.items()}
    want = np.asarray(jax_sde(jtask, jparams, (jnp.asarray(i1.numpy()), jnp.asarray(i10.numpy())),
                              np.asarray(jxt.xor_conditions())))
    offs = {lim: (_run_off(ys, lim), _run_off(want, lim)) for lim in (1e2, 1e3, 1e4)}
    assert all(a == b for a, b in offs.values()), offs
    first = offs[1e2][1] or ys.shape[0]
    scale = np.maximum(np.abs(want[:first]).reshape(-1, 72).max(0), 1e-30)
    assert float((np.abs(ys[:first] - want[:first]) / scale).max()) < 5e-5


@pytest.mark.parametrize("stochastic", [False, True])
def test_train_xor_on_cpu_returns_finite_history(stochastic):
    params, hist = txt.train_xor(nr_samples=8, time_steps=T, max_steps=M, seed=0,
                                 stochastic=stochastic, device="cpu")
    assert len(hist) == 2
    assert all(np.isfinite([h["loss"], h["test_loss"]]).all() for h in hist)
    assert all(len(h["final_fr"]) == 4 and 0.0 <= h["acc"] <= 1.0 for h in hist)
    target = np.tile([0, 0, 1, 1, 0, 0, 0, 0], 2).astype(bool)
    assert bool((params["ff_w0"].detach()[:, ~torch.as_tensor(target)] == 0).all())


@pytest.mark.parametrize("fused_pass", [False, True])
def test_train_xor_adaptive_on_cpu_returns_finite_history(fused_pass):
    """One step of the stochastic-adaptive run on the plain versions: every
    lane's selection reaches the end of the 60 points within the 2048-step
    budget, and the history records each lane's counts."""
    params, hist = txt.train_xor(nr_samples=4, time_steps=T, seed=0, stochastic=True,
                                 adaptive=True, fused_pass=fused_pass, device="cpu")
    assert len(hist) == 1
    for h in hist:
        assert np.isfinite([h["loss"], h["test_loss"]]).all() and all(h["success"])
        assert len(h["naccept"]) == len(h["nreject"]) == 4 and min(h["naccept"]) > 0
    assert all(torch.isfinite(p).all() for p in params.values())


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        txt.train_xor(nr_samples=4, time_steps=T)


def _parse(argv):
    """The keywords ``main`` hands ``train_xor`` for a command line."""
    seen = {}
    orig = txt.train_xor
    txt.train_xor = lambda **kw: (seen.update(kw), ({}, [{"loss": 0.0, "acc": 0.0}]))[1]
    try:
        txt.main(argv)
    finally:
        txt.train_xor = orig
    return seen


@pytest.mark.parametrize("argv,stochastic", [
    ([], False), (["--fused"], False), (["--engine", "fused"], False),
    (["--engine", "auto"], False), (["--fused", "--engine", "xla"], False),
    (["--stochastic"], True), (["--stochastic", "--fused"], True),
    (["--stochastic", "--engine", "fused"], True)])
def test_command_line_selects_the_step(argv, stochastic):
    seen = _parse(argv + ["--smoke", "--device", "cpu"])
    assert seen["stochastic"] is stochastic and seen["smoke"] and seen["device"] == "cpu"


@pytest.mark.parametrize("argv,fused_pass", [
    (["--stochastic", "--adaptive"], False), (["--stochastic", "--adaptive", "--fused"], False),
    (["--stochastic", "--adaptive", "--engine", "fused"], False),
    (["--stochastic", "--adaptive", "--fused", "--fused-pass"], True),
    (["--stochastic", "--adaptive", "--fused", "--fused-pass", "--engine", "xla"], True)])
def test_command_line_selects_the_adaptive_step(argv, fused_pass):
    seen = _parse(argv + ["--smoke", "--device", "cpu"])
    assert seen["stochastic"] and seen["adaptive"] and seen["fused_pass"] is fused_pass


@pytest.mark.parametrize("argv", [
    ["--fused-pass"], ["--fused", "--fused-pass"], ["--stochastic", "--fused", "--fused-pass"],
    ["--stochastic", "--adaptive", "--fused-pass"],
    ["--stochastic", "--adaptive", "--engine", "fused", "--fused-pass"], ["--adaptive"],
    ["--adaptive", "--fused"]])
def test_command_lines_the_jax_package_refuses_or_ignores_are_value_errors(argv):
    # --fused-pass without --stochastic --adaptive --fused: the JAX package's
    # batched_rollout raises (columnflow/tasks/xor.py:98-100); --adaptive
    # without --stochastic: it would run the deterministic step.
    with pytest.raises(ValueError, match="--fused-pass|--adaptive"):
        _parse(argv + ["--smoke", "--device", "cpu"])


@pytest.mark.parametrize("argv,item", [
    (["--engine", "xla"], "A7"), (["--stochastic", "--engine", "xla"], "A7"),
    (["--method", "kvaerno3"], "A7"), (["--fused", "--method", "tsit5"], "A7"),
    (["--stochastic", "--adaptive", "--engine", "xla"], "A7"),
    (["--stochastic", "--adaptive", "--method", "tsit5"], "A7"),
    (["--checkpoint-out", "ck"], "A9"), (["--resume", "ck"], "A9"),
    (["--metrics-out", "m.jsonl"], "A9"), (["--profile-dir", "prof"], "A9")])
def test_unported_command_lines_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        _parse(argv + ["--smoke", "--device", "cpu"])


def test_command_line_has_no_tolerance_options():
    # The JAX package's fused path runs 1e-7 / 1e-9 whatever its --rtol and
    # --atol say; the port offers no option that would be ignored.
    for flag in ("--rtol", "--atol"):
        with pytest.raises(SystemExit):
            txt.main([flag, "1e-5", "--smoke", "--device", "cpu"])


def test_new_modules_import_neither_jax_nor_columnflow():
    modules = ["columnflow_torch.models.xor", "columnflow_torch.kernels.xor_ode",
               "columnflow_torch.kernels.xor_sde", "columnflow_torch.tasks.xor",
               "columnflow_torch.solvers.fused", "columnflow_torch.solvers.sde_adaptive",
               "columnflow_torch.data"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'columnflow'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
