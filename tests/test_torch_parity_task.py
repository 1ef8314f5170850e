"""Port parity: two training steps of ``columnflow_torch.tasks.parity``
against ``columnflow.tasks.parity.make_train_step`` with the flagship flags
(stochastic, adaptive, fused, fused_pass, select_bf16, grad_bf16, split2,
bptt_every 32, clip_grad_norm 1.0, loss_scale 1e-6), at the JAX tests'
size: columns (2, 1), 2 inputs, 60 grid points, max_steps 512, batch 2.

The port replays JAX's frozen step grids (a selection cannot be held
pathwise across implementations, tests/test_torch_sde_adaptive.py) with
JAX's lane keys; before each step it takes JAX's parameters
(``convert.network_from_jax``). Tolerances: loss rel 1e-4, grad norm rel
1e-3, the skip decision equal, updated parameters abs 1e-5 on entries
whose JAX gradient exceeds 1e-3 of its group's largest (Adam's first step
is +-lr sign(g), so entries with near-zero gradients may flip sign).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import network as jn
from columnflow.models.column import Stimulus as JStim
from columnflow.ops.interp import interp_knots as j_knots
from columnflow.ops.interp import step_table_knots as j_step_knots
from columnflow.solvers import sde_adaptive as jsa
from columnflow.tasks import parity as jpt
from columnflow.train import mask_grads as j_mask_grads
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import lane_key_words, network_from_jax
from columnflow_torch.tasks import parity as tpt

REPO = Path(__file__).resolve().parent.parent
T, B, M = 60, 2, 512
FLAGS = dict(use_fused=True, stochastic=True, adaptive=True, fused_pass=True,
             select_bf16=True, grad_bf16=True, split2=True)
STEP = dict(bptt_every=32, clip_grad_norm=1.0, loss_scale=1e-6)


def _jax_grid(task, params, stims, keys):
    """The frozen grids JAX's batched rollout selects for these inputs."""
    dt, n_in, P = task.dt, 2, task.net.num_pops
    fc = jn.build_network_fused_consts(task.net)
    kts, _ = j_step_knots(T, dt, jnp.zeros(n_in), jnp.zeros(n_in))
    pw16 = jn.premix_select16(jn.premix_network_weights(params, task.net))
    kv_all = jax.vmap(lambda s: j_step_knots(T, dt, jnp.zeros_like(s), s)[1])(stims)

    def s_drift(t, y, pw, fc, kv):
        return jn.network_drift_premixed_select16(
            t, y, pw, fc, JStim(0.0, dt, kv), interp_fn=lambda t_, a, b, v: j_knots(t_, kts, v))

    a_diff = lambda t, y, pw, fc, kv: jnp.full_like(y, jn.NETWORK_NOISE_STD)  # noqa: E731
    ts = np.asarray(task.ts)
    h0 = float((ts[-1] - ts[0]) / (4.0 * T))

    def one(y0_b, key_b, kv_b):
        return jsa._adaptive_pass_fused(s_drift, a_diff, y0_b, key_b, float(ts[0]),
                                        float(ts[-1]), 1e-3, 1e-3, h0, M, 20, "pi", "sra1",
                                        (pw16, fc, kv_b), interpret=True)

    st, na, nr, _ = jax.vmap(one)(jnp.zeros((B, 1, 3 * P)), keys, kv_all[:, :, None, :])
    return tuple(torch.as_tensor(np.asarray(x)) for x in (st, na, nr))


@pytest.fixture(scope="module")
def jax_run():
    task = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                          n_inputs=2, time_steps=T, max_steps=M)
    step = jpt.make_train_step(task, **FLAGS, **STEP)
    # Two odd-parity patterns (both targets 0): a batch of the two
    # fixed-position patterns has one even and one odd lane, and then the
    # output-weight gradient, which dominates the grad norm, is the
    # difference of two nearly equal readouts (0.0059 from readouts near
    # 5 Hz), which magnifies the float32 rounding of the solve ~10^3-fold.
    stims = jnp.asarray([[0.0, 15.0], [15.0, 0.0]])

    @jax.jit
    def grads_of(p, key):
        def loss(p):
            ys = jpt.batched_rollout(p, task, stims, key=key, adaptive_bptt_every=32, **FLAGS)
            out = jpt.readout(ys, p, task.net)
            return jnp.mean(jnp.abs(out - jpt.parity_targets(stims))) * STEP["loss_scale"]

        g = jax.grad(loss)(p)
        return j_mask_grads(jax.tree_util.tree_map(lambda x: x / STEP["loss_scale"], g),
                            task.grad_mask)

    params = jax.tree_util.tree_map(jnp.array, task.params)
    opt_state = task.optimizer.init(params)
    records = []
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        keys = jax.random.split(key, B)
        before = {k: np.array(v) for k, v in params.items()}
        grid = _jax_grid(task, params, stims, keys)
        grads = {k: np.asarray(v) for k, v in grads_of(params, key).items()}
        params, opt_state, loss, out, gnorm, ok = step(params, opt_state, stims, key)
        records.append(dict(before=before, keys=keys, grid=grid, grads=grads, loss=float(loss),
                            gnorm=float(gnorm), ok=bool(ok),
                            after={k: np.array(v) for k, v in params.items()}))
    return task, np.asarray(stims), records


def test_two_train_steps_match_jax(jax_run):
    jtask, stims, records = jax_run
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=M,
                          device="cpu")
    step = tpt.make_train_step(task, **STEP)
    masks = {k: v.bool() for k, v in task.grad_mask.items()}
    for i, rec in enumerate(records):
        params, _ = network_from_jax(rec["before"], jtask.net)
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
        out = step(torch.as_tensor(stims), lane_key_words(rec["keys"]), grid=rec["grid"])
        assert float(out["loss"]) == pytest.approx(rec["loss"], rel=1e-4), i
        assert float(out["gnorm"]) == pytest.approx(rec["gnorm"], rel=1e-3), i
        assert out["ok"] == rec["ok"]
        for k, p in task.params.items():
            g = p.grad
            assert torch.isfinite(g).all()
            assert bool((g[~masks[k]] == 0).all()), k
            gj = np.abs(rec["grads"][k])
            big = gj > 1e-3 * gj.max()
            np.testing.assert_allclose(p.detach().numpy()[big], rec["after"][k][big], atol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_port_step_with_its_own_selection_is_finite():
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(2),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=M,
                          device="cpu")
    step = tpt.make_train_step(task, **STEP)
    stims = torch.tensor([[0.0, 15.0], [15.0, 15.0]])
    w0 = {k: p.detach().clone() for k, p in task.params.items()}
    out = step(stims, torch.tensor([[1, 2], [3, 2**32 - 1]]))
    assert np.isfinite(float(out["loss"])) and out["ok"]
    assert bool(out["stats"].success.all())
    for k, p in task.params.items():
        off = ~task.grad_mask[k].bool()
        assert bool((p.grad[off] == 0).all()), k
        assert torch.equal(p.detach()[off], w0[k][off]), k


def test_train_parity_on_cpu_returns_finite_history():
    params, hist = tpt.train_parity(smoke=True, device="cpu", columns_per_area=(2, 1),
                                    n_inputs=2, time_steps=T, max_steps=M, bptt_every=32,
                                    clip_grad_norm=1.0, loss_scale=1e-6)
    assert len(hist) == 3 and "acc" in hist[-1]
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist[:-1])
    assert all(torch.isfinite(p).all() for p in params.values())


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.train_parity(smoke=True, columns_per_area=(2, 1), n_inputs=2)


def test_unported_modes_raise():
    from columnflow_torch.models.network import build_column_network
    from columnflow_torch.solvers.sde_adaptive import _noise_backend

    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=M,
                          device="cpu")
    # The flagship's flags select nothing in the port: no other mode exists.
    with pytest.raises(TypeError, match="select_bf16"):
        tpt.make_train_step(task, select_bf16=False)
    with pytest.raises(NotImplementedError, match="random_fan_in"):
        build_column_network(ColumnConfig.load(), torch.Generator(), random_fan_in=True)
    with pytest.raises(TypeError, match="brownian"):
        _noise_backend(torch.zeros(1, 4, dtype=torch.int64), 0.0, 1.0, 20, brownian="jax")


def test_new_modules_import_neither_jax_nor_columnflow():
    modules = ["columnflow_torch.models.network", "columnflow_torch.solvers.krng",
               "columnflow_torch.solvers.sde_adaptive", "columnflow_torch.solvers.fused",
               "columnflow_torch.kernels.network_sde", "columnflow_torch.tasks.parity",
               "columnflow_torch.ops.arith"]
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
