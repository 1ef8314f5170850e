"""Port parity: one WTA training step of ``columnflow_torch.tasks.wta``
against the JAX step, composed from the JAX package's own functions
(vmapped SRA1 ``sdeint``, ``huber_trajectory_loss_wta``, ``mask_grads``,
``global_norm``, ``torch_rmsprop`` + ``exponential_lr``).

Both sides start from the same parameters and get the same stimuli, targets
and Brownian packs; three consecutive steps cover the lr schedule. The port
runs with ``use_fused=True`` (the ``torch.autograd.Function`` with the plain
versions of the kernels) and ``use_fused=False`` (autograd through the
pure-torch ``sdeint``). Tolerances: loss rtol 1e-4, masked recurrent
gradient rtol 2e-3 on the 4 trainable entries, updated weights rtol 1e-3,
grad norm rtol 1e-3; float32 on both sides, in another summation order,
with XLA's tanh a few ulp off torch's. Entries outside the mask must have a
gradient of exactly 0 and keep their values bit for bit.
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
from columnflow.data import wta_stim_three_phases as jax_stim
from columnflow.models import Stimulus as JaxStimulus
from columnflow.models import build_wta as jax_build_wta
from columnflow.models import wta_diffusion as jax_diffusion
from columnflow.models import wta_drift as jax_drift
from columnflow.models.wta import wta_lat_in_mask
from columnflow.ops.losses import huber_trajectory_loss_wta as jax_loss
from columnflow.solvers import sdeint as jax_sdeint
from columnflow.train import exponential_lr, mask_grads
from columnflow.train import global_norm as jax_global_norm
from columnflow.train import torch_rmsprop as jax_rmsprop
from columnflow_torch.config import ColumnConfig
from columnflow_torch.tasks import wta

REPO = Path(__file__).resolve().parent.parent
T, B, STEPS, LR = 300, 3, 3, 10.0


def _jax_steps(jparams, stims, true, packs):
    """The JAX training step, run STEPS times; returns per-step records."""
    ts = jnp.linspace(0.0, T * wta.DT, T)
    dt = float(ts[1] - ts[0])
    _, jarea = jax_build_wta(JaxConfig.load(), jax.random.PRNGKey(0))
    mask = jnp.asarray(wta_lat_in_mask())

    @jax.jit
    def value_and_grad(p, i1, i10):
        def loss(p):
            def one(table, a, b):
                stim = JaxStimulus(0.0, dt, table)
                z = jnp.zeros_like(a)
                return jax_sdeint(
                    lambda t, y: jax_drift(t, y, p, jarea, stim),
                    lambda t, y: jax_diffusion(t, y, p, jarea, stim),
                    jnp.zeros(48), ts, jax.random.PRNGKey(0), method="srk",
                    noise="scalar", additive=True, noise_pack=(a, b, z, z))

            tables = jax.vmap(lambda s: jax_stim(s, T))(jnp.asarray(stims))
            ys = jax.vmap(one)(tables, i1.T, i10.T)
            return jax_loss(ys, jnp.asarray(true), p["output_weights"])

        return jax.value_and_grad(loss)(p)

    opt = jax_rmsprop(exponential_lr(LR, 0.99), alpha=0.9)
    params, opt_state, out = jparams, None, []
    opt_state = opt.init(params)
    for i1, i10 in packs:
        loss, grads = value_and_grad(params, jnp.asarray(i1), jnp.asarray(i10))
        grads = mask_grads(grads, {"recurrent_weights": mask, "output_weights": None})
        gnorm = jax_global_norm(grads)[0]
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda a, b: a + b, params, updates)
        out.append(dict(loss=float(loss), gnorm=float(gnorm),
                        grad=np.asarray(grads["recurrent_weights"]),
                        w=np.asarray(params["recurrent_weights"]),
                        ow=np.asarray(params["output_weights"])))
    return out


@pytest.fixture(scope="module")
def matched_inputs():
    jparams, _ = jax_build_wta(JaxConfig.load(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    stims = np.stack([rng.uniform(15, 25, B), rng.uniform(25, 45, B)], -1).astype(np.float32)
    true = rng.uniform(0.0, 1.5, (B, T, 2)).astype(np.float32)
    h = np.diff(np.asarray(jnp.linspace(0.0, T * wta.DT, T))).astype(np.float32)[:, None]
    packs = []
    for _ in range(STEPS):
        z1, z2 = rng.normal(size=(2, T - 1, B)).astype(np.float32)
        i1 = (np.sqrt(h) * z1).astype(np.float32)
        packs.append((i1, (h * (0.5 * i1 + np.sqrt(h / 12) * z2)).astype(np.float32)))
    return jparams, stims, true, packs, _jax_steps(jparams, stims, true, packs)


@pytest.mark.parametrize("use_fused", [True, False])
def test_train_steps_match_jax(matched_inputs, use_fused):
    jparams, stims, true, packs, want = matched_inputs
    task = wta.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          lr=LR, time_steps=T, device="cpu")
    with torch.no_grad():
        for k, p in task.params.items():
            p.copy_(torch.from_numpy(np.array(jparams[k])))
    step = wta.make_train_step(task, use_fused=use_fused)
    mask = wta_lat_in_mask().astype(bool)
    w_prev = np.asarray(jparams["recurrent_weights"])
    for i, (i1, i10) in enumerate(packs):
        loss, gnorm = step(torch.from_numpy(true), torch.from_numpy(stims),
                           noise=(torch.from_numpy(i1), torch.from_numpy(i10)))
        ref = want[i]
        grad = task.params["recurrent_weights"].grad.numpy()
        w = task.params["recurrent_weights"].detach().numpy()
        np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(grad[mask], ref["grad"][mask], rtol=2e-3)
        assert np.all(grad[~mask] == 0.0)
        np.testing.assert_allclose(w, ref["w"], rtol=1e-3)
        np.testing.assert_array_equal(w[~mask], w_prev[~mask])
        np.testing.assert_allclose(task.params["output_weights"].detach().numpy(),
                                   ref["ow"], rtol=1e-3)
        np.testing.assert_allclose(float(gnorm), ref["gnorm"], rtol=1e-3)
        w_prev = w
    assert task.scheduler.get_last_lr()[0] == pytest.approx(LR * 0.99 ** STEPS)


def test_first_rmsprop_step_moves_output_weights_by_lr_over_sqrt_point_one():
    """torch RMSprop's first step is -lr * g / sqrt(0.1 g^2) = -31.6 sign(g)
    at lr 10, alpha 0.9: the output weights are trained too, like in the JAX
    package (their mask is None)."""
    task = wta.build_task(ColumnConfig.load(), torch.Generator().manual_seed(1),
                          time_steps=60, device="cpu")
    ow0 = task.params["output_weights"].detach().clone()
    step = wta.make_train_step(task, use_fused=True)
    stims = torch.tensor([[20.0, 35.0], [30.0, 18.0]])
    step(torch.full((2, 60, 2), 0.5), stims, generator=torch.Generator().manual_seed(2))
    moved = (task.params["output_weights"].detach() - ow0).abs()
    assert torch.allclose(moved, torch.full((8,), 10.0 / 0.1 ** 0.5), rtol=1e-5)


def test_train_wta_on_cpu_returns_finite_history():
    params, hist = wta.train_wta(nr_samples=14, batch_size=8, time_steps=60,
                                 lr=0.01, device="cpu")
    assert len(hist) == 3
    assert all(np.isfinite([h["loss"], h["val_loss"], h["grad_norm"]]).all() for h in hist)
    assert torch.isfinite(params["recurrent_weights"]).all()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from columnflow_torch import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wta.train_wta(nr_samples=14, batch_size=8, time_steps=60)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("flag", ["--metrics-out", "--profile-dir", "--checkpoint-out",
                                  "--resume"])
def test_command_line_refuses_the_jax_flags_naming_a9(flag):
    """The JAX parser's flags (``columnflow/tasks/wta.py:414-418``) are
    accepted and raise naming the ROADMAP item, not argparse's exit 2."""
    with pytest.raises(NotImplementedError, match="A9"):
        wta.main([flag, "m.out", "--smoke", "--device", "cpu"])


def test_port_imports_neither_jax_nor_columnflow():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "columnflow_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'columnflow'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "columnflow_torch.tasks.wta" in modules and len(modules) >= 15
