"""Port parity: the Hopf train step of ``columnflow_torch.tasks.bifurcation``
against ``columnflow.tasks.bifurcation`` (``rollout`` on the fused engine,
``smooth_l1``, ``torch_rmsprop``), its validation forward, the training run
and the command line.

Size: the MLP at sizes (3, 16, 16, 16, 2), 8 trajectories of JAX's
``make_hopf_dataset`` as one batch, 100 grid points over 2.5 s, max_steps
512. The JAX fused dopri5 runs in interpret mode (``columnflow.solvers.
odeint_dopri5_fused`` is wrapped for the module; ``rollout`` imports it at
call time). The port takes JAX's parameters and replays the grid JAX's
selection kernel freezes for them.

Tolerances: loss rel 1e-5; gradients rel L2 1e-3, or 1e-4 plus four times
the spread the port's own gradient shows when the weights move by one part
in 1e7 (on the same grid); the parameters after one RMSprop step abs 1e-4.
RMSprop's first step is -lr g / (sqrt(0.01) |g| + 1e-8): +-10 lr on every
entry whose gradient is well above 1e-7, whatever its size.
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
from columnflow import data as jdata
from columnflow.ops.losses import smooth_l1 as j_smooth_l1
from columnflow.tasks import bifurcation as jbt
from columnflow.train import torch_rmsprop as j_rmsprop
from columnflow_torch.convert import frozen_grid_from_jax, hopf_params_from_jax
from columnflow_torch.tasks import bifurcation as tbt
from columnflow_torch.train.optim import torch_rmsprop
from test_torch_hopf_model import jax_params, jax_select, rel_l2

REPO = Path(__file__).resolve().parent.parent
T, B, M, SPAN = 100, 8, 512, 2.5


@pytest.fixture(scope="module")
def interpret_fused():
    """The JAX package's fused dopri5 in interpret mode."""
    orig = jsolvers.odeint_dopri5_fused
    jsolvers.odeint_dopri5_fused = functools.partial(orig, interpret=True)
    yield
    jsolvers.odeint_dopri5_fused = orig


def jax_task(params, ts):
    return jbt.HopfTask(params, ts, float(ts[1] - ts[0]), j_rmsprop(1e-3, alpha=0.99), M)


def port_task(params_np, ts):
    params = hopf_params_from_jax(params_np)
    for layer in params:
        for p in layer.values():
            p.requires_grad_(True)
    optimizer, _ = torch_rmsprop([p for layer in params for p in layer.values()], lr=1e-3,
                                 alpha=0.99)
    ts_t = torch.as_tensor(np.array(ts))
    return tbt.HopfTask(params, ts_t, float((ts_t[1] - ts_t[0]).item()), optimizer, M)


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


@pytest.fixture(scope="module")
def jax_run(interpret_fused):
    ts = jnp.linspace(0.0, SPAN, T)
    true_y = np.asarray(jdata.make_hopf_dataset(jax.random.PRNGKey(3), B, ts, max_steps=M))
    params = jax_params()
    task = jax_task(params, ts)
    y0, mu, target = true_y[0, :, :2], true_y[:, :, 2], true_y[:, :, :2]

    def loss_fn(p):
        return j_smooth_l1(jbt.rollout(p, task, jnp.asarray(y0), jnp.asarray(mu),
                                       use_fused=True), jnp.asarray(target))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    opt_state = task.optimizer.init(params)
    updates, _ = task.optimizer.update(grads, opt_state, params)
    after = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    st, stats = jax_select(params, mu, y0, np.asarray(ts), task.dt)
    return dict(ts=ts, true_y=true_y, params=_np(params), loss=float(loss), grads=_np(grads),
                after=_np(after), grid=(np.asarray(st), np.asarray(stats)), task=task)


def _grads(task):
    return [{k: p.grad.detach().clone() for k, p in layer.items()} for layer in task.params]


def _load(task, params_np, eps=0.0):
    with torch.no_grad():
        for layer, src in zip(task.params, params_np):
            for k, p in layer.items():
                p.copy_(torch.as_tensor(src[k] * (1.0 + eps)))


def test_train_step_matches_jax(jax_run):
    """One train step on JAX's frozen grid: loss, the eight gradients, the
    selection's stats, and the parameters after the RMSprop update."""
    r = jax_run
    task = port_task(r["params"], r["ts"])
    step = tbt.make_train_step(task)
    true_y = torch.as_tensor(r["true_y"])
    grid = frozen_grid_from_jax(*r["grid"])
    spread = []
    for eps in (1e-7, 0.0):
        _load(task, r["params"], eps)
        task.optimizer.zero_grad(set_to_none=True)
        pred = tbt.rollout(task.params, task, true_y[0, :, :2], true_y[:, :, 2], grid=grid)
        tbt.smooth_l1(pred, true_y[:, :, :2]).backward()
        spread.append(_grads(task))
    spread = [{k: rel_l2(a[k], b[k]) for k in a} for a, b in zip(*spread)]
    _load(task, r["params"])
    out = step(true_y, grid=grid)
    assert float(out["loss"]) == pytest.approx(r["loss"], rel=1e-5)
    assert int(out["stats"].naccept) == grid[1] and bool(out["stats"].success)
    for i, (layer, want) in enumerate(zip(task.params, r["grads"])):
        for k, p in layer.items():
            err = rel_l2(p.grad, want[k])
            assert err < 1e-3 or err < 1e-4 + 4 * spread[i][k], (i, k, err, spread[i][k])
            np.testing.assert_allclose(p.detach().numpy(), r["after"][i][k], atol=1e-4,
                                       err_msg=f"layer {i} {k}")


def test_rollout_without_grid_selects_and_succeeds(jax_run):
    r = jax_run
    task = port_task(r["params"], r["ts"])
    true_y = torch.as_tensor(r["true_y"])
    ys, stats = tbt.rollout(task.params, task, true_y[0, :, :2], true_y[:, :, 2],
                            differentiable=False, return_stats=True)
    assert ys.shape == (T, B, 2) and not ys.requires_grad
    assert bool(stats.success) and abs(int(stats.naccept) - int(r["grid"][1][0])) <= 1
    assert torch.equal(ys[0], true_y[0, :, :2])


def test_validation_loss_matches_jax(jax_run):
    """The validation forward (one held-out trajectory, its own selection on
    both sides) against the JAX package's ``val_fn`` on the fused engine."""
    r = jax_run
    task = port_task(r["params"], r["ts"])
    val = r["true_y"][:, 3:4]
    want = j_smooth_l1(jbt.rollout(r["task"].params, r["task"], jnp.asarray(val[0, :, :2]),
                                   jnp.asarray(val[:, :, 2]), differentiable=False,
                                   use_fused=True), jnp.asarray(val[:, :, :2]))
    got = tbt.validation_loss(task, torch.as_tensor(val))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_train_bifurcation_on_cpu_returns_finite_history():
    ts = np.asarray(jnp.linspace(0.0, SPAN, T))
    ds = np.asarray(jdata.make_hopf_dataset(jax.random.PRNGKey(0), 20, jnp.asarray(ts),
                                            max_steps=M))
    params, hist = tbt.train_bifurcation(nr_samples=16, batch_size=8, time_points=T,
                                         total_time=SPAN, max_steps=M, dataset=ds,
                                         device="cpu")
    assert len(hist) == 2 and "val_loss" in hist[0] and "val_loss" not in hist[1]
    assert all(np.isfinite(h["loss"]) for h in hist) and np.isfinite(hist[0]["val_loss"])
    assert [tuple(layer["w"].shape) for layer in params] == [(100, 3), (100, 100), (100, 100),
                                                             (2, 100)]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbt.train_bifurcation(nr_samples=8, batch_size=8, time_points=T)


def test_make_dp_train_step_raises():
    with pytest.raises(NotImplementedError, match="A10"):
        tbt.make_dp_train_step(None)


@pytest.fixture
def one_torch_thread():
    """Run the test on one PyTorch intra-op thread, then restore the count.
    The smoke run is thousands of small (8, 100) products and elementwise
    ops: alone it takes ~6 s on 8 threads (~5 s on one), but beside five
    busy processes (the suite's other xdist workers) each op's eight
    OpenMP threads wait for one another on an oversubscribed CPU and it took
    148 s (one thread: 3.8 s), near the suite's 150 s budget per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_command_line_smoke_on_cpu(capsys, one_torch_thread):
    tbt.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("final loss ") and np.isfinite(float(out.split()[-1]))


def _parse(argv):
    """The keywords ``main`` hands ``train_bifurcation`` for a command line."""
    seen = {}
    orig = tbt.train_bifurcation
    tbt.train_bifurcation = lambda **kw: (seen.update(kw), ({}, [{"loss": 0.0}]))[1]
    try:
        tbt.main(argv)
    finally:
        tbt.train_bifurcation = orig
    return seen


@pytest.mark.parametrize("argv,want", [
    (["--smoke"], dict(nr_samples=16, batch_size=8, time_points=100, total_time=2.5,
                       max_steps=512)),
    ([], dict(nr_samples=5000, batch_size=32)),
    (["--samples", "64", "--batch-size", "16", "--seed", "3", "--adjoint", "replay"],
     dict(nr_samples=64, batch_size=16, seed=3))])
def test_command_line_hands_the_reference_settings(argv, want):
    seen = _parse(argv + ["--device", "cpu"])
    assert {k: seen[k] for k in want} == want and seen["device"] == "cpu"


@pytest.mark.parametrize("argv,item", [
    (["--adjoint", "backsolve"], "A7/A8"), (["--metrics-out", "m.jsonl"], "A9"),
    (["--profile-dir", "prof"], "A9"), (["--checkpoint-out", "ck"], "A9"),
    (["--resume", "ck"], "A9")])
def test_unported_command_lines_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        _parse(argv + ["--smoke", "--device", "cpu"])


def test_new_modules_import_neither_jax_nor_columnflow():
    modules = ["columnflow_torch.models.hopf", "columnflow_torch.kernels.hopf_ode",
               "columnflow_torch.solvers.dopri", "columnflow_torch.tasks.bifurcation",
               "columnflow_torch.solvers.fused", "columnflow_torch.data",
               "columnflow_torch.convert", "columnflow_torch.ops.interp"]
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
