"""Port parity: training steps of ``columnflow_torch.tasks.parity``
against ``columnflow.tasks.parity.make_train_step`` on each ported path,
and the command line that selects between them.

Fixed-grid SDE (``--stochastic``) and the XLA selection's adaptive step
(``--stochastic --adaptive`` below 104 columns): one step each at 3
columns, batch 4, 60 grid points, on JAX's noise pack, and, adaptive,
JAX's frozen grids and lane keys (``test_torch_sde_jaxtree.build_setup``);
tolerances at ``test_stochastic_step_matches_jax``.

Stochastic: the flagship flags
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

Deterministic: ``make_train_step(task, use_fused=True)`` (fused dopri5, the
default of both command lines), batch 4, the same size. The port replays
the grid JAX's selection kernel freezes for the same parameters
(``convert.frozen_grid_from_jax``; the selection itself is held in
tests/test_torch_ode_fused.py). Tolerances: loss rel 1e-5, the skip decision
equal, grad norm rel 1e-2: the reverse sweep rounds every transposed
product to bf16 on both sides, which leaves either side's own gradient
determined to ~1e-2 (measured there). Updated parameters: abs 1e-5 on entries
whose JAX gradient exceeds 1e-5 and 1e-2 of its group's largest (18
entries over the two steps). This network's gradients are small (norm
~1e-4), and below ~1e-6 Adam's first step lr g / (|g| + 1e-8) leaves the
sign regime and passes the gradient's ~1e-2 relative noise on to the
update (measured up to 7.9e-3 on such entries). The second step's update
lr m / (sqrt(v) + 1e-8) depends on the ratio of the two steps' gradients, so
the same noise moves it by up to 5.1e-5 (measured); it is held to 2e-4.
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
from columnflow_torch.convert import frozen_grid_from_jax, lane_key_words, network_from_jax
from columnflow_torch.tasks import parity as tpt

REPO = Path(__file__).resolve().parent.parent
T, B, M = 60, 2, 512
B_SDE = 4
FLAGS = dict(use_fused=True, stochastic=True, adaptive=True, fused_pass=True,
             select_bf16=True, grad_bf16=True, split2=True)
STEP = dict(bptt_every=32, clip_grad_norm=1.0, loss_scale=1e-6)
PORT_FLAGS = {k: v for k, v in FLAGS.items() if k != "use_fused"}


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
    step = tpt.make_train_step(task, **PORT_FLAGS, **STEP)
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


SDE_STIMS = np.array([[0.0, 15.0], [15.0, 0.0], [15.0, 15.0], [0.0, 0.0]], np.float32)
SDE_MODES = {"fixed_grid": dict(stochastic=True),
             "xla_selection": dict(stochastic=True, adaptive=True)}


@pytest.fixture(scope="module")
def jax_sde_runs():
    """One JAX train step of each of the two stochastic steps of this slice
    at 13 columns' flags (``--stochastic`` and ``--stochastic --adaptive``),
    with what the port needs to repeat it: the fixed grid's noise pack
    (``_brownian_pack`` of the step's key), or the lanes' keys and JAX's
    frozen grids (its XLA selection on the jax.random tree); and JAX's
    masked gradients at the parameters and at a 1e-7 nudge of them."""
    from columnflow.solvers.sde import _brownian_pack
    from test_torch_sde_jaxtree import build_setup

    task = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                          n_inputs=2, time_steps=T, max_steps=M)
    stims = jnp.asarray(SDE_STIMS)
    key = jax.random.PRNGKey(30)
    runs = {}
    for name, flags in SDE_MODES.items():
        @jax.jit
        def grads_of(p, flags=flags):
            def loss(p):
                ys = jpt.batched_rollout(p, task, stims, key=key, use_fused=True, **flags)
                return jnp.mean(jnp.abs(jpt.readout(ys, p, task.net) - jpt.parity_targets(stims)))

            return j_mask_grads(jax.grad(loss)(p), task.grad_mask)

        params = jax.tree_util.tree_map(jnp.array, task.params)
        nudged = {k: v * (1.0 + 1e-7) for k, v in params.items()}
        rec = dict(before={k: np.array(v) for k, v in params.items()},
                   grads={k: np.asarray(v) for k, v in grads_of(params).items()},
                   grads_nudged={k: np.asarray(v) for k, v in grads_of(nudged).items()})
        step = jpt.make_train_step(task, use_fused=True, **flags)
        _, _, loss, _, gnorm, ok = step(params, task.optimizer.init(params), stims, key)
        rec.update(loss=float(loss), gnorm=float(gnorm), ok=bool(ok))
        if "adaptive" in flags:
            keys = jax.random.split(key, B_SDE)
            rec["keys"] = keys
            rec["grid"] = build_setup(keys=keys, stims=SDE_STIMS)["grid"][:3]
        else:
            _, i1, i10, _, _ = _brownian_pack(key, task.ts, (B_SDE, 1), jnp.float32)
            rec["noise"] = (np.asarray(i1), np.asarray(i10))
        runs[name] = rec
    return task, runs


@pytest.mark.parametrize("mode", list(SDE_MODES))
def test_stochastic_step_matches_jax(jax_sde_runs, mode):
    """The port's step against JAX's on JAX's noise (and, adaptive, JAX's
    frozen grids and lane keys): loss rel 1e-5, the skip decision equal,
    each masked gradient within rel L2 3e-2 (the kernel-mode precedent)
    plus twice the larger of the two sides' own spreads under a 1e-7 nudge
    of the weights. Measured: fixed grid <= 3.5e-3 (feedforward; the
    spreads up to 1.6e-3), the XLA selection's step <= 4.3e-4 (JAX's own
    spread up to 3.6e-3); losses 1e-7 apart."""
    jtask, runs = jax_sde_runs
    rec = runs[mode]
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=M,
                          device="cpu")

    def port_step(scale):
        params, _ = network_from_jax({k: v * scale for k, v in rec["before"].items()}, jtask.net)
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
        step = tpt.make_train_step(task, **SDE_MODES[mode])
        if "grid" in rec:
            out = step(torch.as_tensor(SDE_STIMS), lane_key_words(rec["keys"]),
                       grid=tuple(torch.as_tensor(np.array(x)) for x in rec["grid"]))
        else:
            out = step(torch.as_tensor(SDE_STIMS), noise=tuple(torch.as_tensor(x)
                                                               for x in rec["noise"]))
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
        spread = max(_rel(grads_n[k], g), _rel(rec["grads_nudged"][k], want))
        assert np.isfinite(g).all()
        assert _rel(g, want) < 3e-2 + 2 * spread, (k, _rel(g, want), spread)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def test_port_step_with_its_own_selection_is_finite():
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(2),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=M,
                          device="cpu")
    step = tpt.make_train_step(task, **PORT_FLAGS, **STEP)
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
                                    n_inputs=2, time_steps=T, max_steps=M, **PORT_FLAGS,
                                    bptt_every=32, clip_grad_norm=1.0, loss_scale=1e-6)
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
    # The JAX package's solver flags, checked as its batched_rollout checks
    # them; a flag it would ignore is refused too.
    with pytest.raises(ValueError, match="select_bf16"):
        tpt.make_train_step(task, select_bf16=True)
    with pytest.raises(TypeError, match="use_fused"):
        tpt.make_train_step(task, use_fused=True)
    with pytest.raises(ValueError, match="bptt_every"):
        tpt.make_train_step(task, bptt_every=32)
    with pytest.raises(ValueError, match="tree key words"):
        tpt.make_train_step(task, stochastic=True, adaptive=True)(torch.zeros(2, 2))
    with pytest.raises(ValueError, match="noise pack"):
        tpt.make_train_step(task, stochastic=True)(torch.zeros(2, 2))
    with pytest.raises(NotImplementedError, match="random_fan_in"):
        build_column_network(ColumnConfig.load(), torch.Generator(), random_fan_in=True)
    with pytest.raises(ValueError, match="brownian"):
        _noise_backend(torch.zeros(1, 4, dtype=torch.int64), 0.0, 1.0, 20, brownian="xla")


def test_new_modules_import_neither_jax_nor_columnflow():
    modules = ["columnflow_torch.models.network", "columnflow_torch.solvers.krng",
               "columnflow_torch.solvers.sde_adaptive", "columnflow_torch.solvers.fused",
               "columnflow_torch.kernels.network_sde", "columnflow_torch.tasks.parity",
               "columnflow_torch.ops.arith", "columnflow_torch.solvers.rk",
               "columnflow_torch.kernels.network_ode", "columnflow_torch.kernels._build",
               "columnflow_torch.convert", "columnflow_torch.solvers.jrandom",
               "columnflow_torch.solvers.brownian"]
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


# ---------------------------------------------------------------------------
# The deterministic step and the command line
# ---------------------------------------------------------------------------

DET_STIMS = np.array([[0.0, 15.0], [15.0, 0.0], [15.0, 15.0], [0.0, 0.0]], np.float32)


@pytest.fixture(scope="module")
def jax_det_run():
    from test_torch_ode_fused import jax_select

    task = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                          n_inputs=2, time_steps=T, max_steps=M)
    step = jpt.make_train_step(task, use_fused=True)
    stims = jnp.asarray(DET_STIMS)

    @jax.jit
    def grads_of(p):
        def loss(p):
            ys = jpt.batched_rollout(p, task, stims, use_fused=True)
            return jnp.mean(jnp.abs(jpt.readout(ys, p, task.net) - jpt.parity_targets(stims)))

        return j_mask_grads(jax.grad(loss)(p), task.grad_mask)

    params = jax.tree_util.tree_map(jnp.array, task.params)
    opt_state = task.optimizer.init(params)
    records = []
    for _ in range(2):
        before = {k: np.array(v) for k, v in params.items()}
        grid = frozen_grid_from_jax(*jax_select(task, params))
        grads = {k: np.asarray(v) for k, v in grads_of(params).items()}
        params, opt_state, loss, out, gnorm, ok = step(params, opt_state, stims)
        records.append(dict(before=before, grid=grid, grads=grads, loss=float(loss),
                            gnorm=float(gnorm), ok=bool(ok),
                            after={k: np.array(v) for k, v in params.items()}))
    return task, records


def test_two_deterministic_train_steps_match_jax(jax_det_run):
    jtask, records = jax_det_run
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=M,
                          device="cpu")
    step = tpt.make_train_step(task)
    masks = {k: v.bool() for k, v in task.grad_mask.items()}
    held = 0
    for i, rec in enumerate(records):
        params, _ = network_from_jax(rec["before"], jtask.net)
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
        out = step(torch.as_tensor(DET_STIMS), grid=rec["grid"])
        assert float(out["loss"]) == pytest.approx(rec["loss"], rel=1e-5), i
        assert float(out["gnorm"]) == pytest.approx(rec["gnorm"], rel=1e-2), i
        assert out["ok"] == rec["ok"]
        assert int(out["stats"].naccept) == rec["grid"][1] and bool(out["stats"].success)
        for k, p in task.params.items():
            g = p.grad
            assert torch.isfinite(g).all()
            assert bool((g[~masks[k]] == 0).all()), k
            gj = np.abs(rec["grads"][k])
            big = gj > max(1e-2 * gj.max(), 1e-5)
            held += int(big.sum())
            np.testing.assert_allclose(p.detach().numpy()[big], rec["after"][k][big],
                                       atol=(1e-5, 2e-4)[i], err_msg=f"step {i} {k}")
    assert held >= 8  # entries in Adam's sign regime, held to 1e-5


def test_deterministic_step_with_its_own_selection():
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(2),
                          columns_per_area=(2, 1), n_inputs=2, time_steps=T, max_steps=M,
                          device="cpu")
    w0 = {k: p.detach().clone() for k, p in task.params.items()}
    out = tpt.make_train_step(task)(torch.as_tensor(DET_STIMS))
    assert np.isfinite(float(out["loss"])) and out["ok"]
    stats = out["stats"]
    assert bool(stats.success) and 0 < int(stats.naccept) <= 660
    assert tuple(stats.step_times.shape) == (661,)
    for k, p in task.params.items():
        off = ~task.grad_mask[k].bool()
        assert bool((p.grad[off] == 0).all()), k
        assert torch.equal(p.detach()[off], w0[k][off]), k


def test_train_parity_deterministic_on_cpu_returns_finite_history():
    params, hist = tpt.train_parity(smoke=True, device="cpu", columns_per_area=(2, 1),
                                    n_inputs=2, time_steps=T, max_steps=M)
    assert len(hist) == 3 and "acc" in hist[-1]
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist[:-1])
    assert all(isinstance(h["naccept"], int) for h in hist[:-1])
    assert all(torch.isfinite(p).all() for p in params.values())


FLAGSHIP_ARGV = ["--stochastic", "--adaptive", "--fused", "--fused-pass", "--select-bf16",
                 "--grad-bf16", "--split2"]


def _parse(argv):
    """The namespace ``main`` hands ``resolve_mode`` for a command line."""
    seen = {}
    orig = tpt.train_parity
    tpt.train_parity = lambda **kw: (seen.update(kw), ({}, [{"loss": 0.0}, {"acc": 0.0}]))[1]
    try:
        tpt.main(argv)
    finally:
        tpt.train_parity = orig
    return seen


@pytest.mark.parametrize("argv,stochastic,split2", [
    ([], False, False), (["--fused"], False, False), (["--engine", "fused"], False, False),
    (["--engine", "auto"], False, False),
    (["--engine", "fused", "--columns-per-area", "64,32,8"], False, False),
    (FLAGSHIP_ARGV, True, True), (FLAGSHIP_ARGV + ["--columns-per-area", "64,32,8"], True, True),
    # The fused-split2 tier: auto from 104 through 312 columns, or pinned.
    (["--columns-per-area", "64,32,8"], False, True),
    (["--engine", "fused-split2", "--columns-per-area", "64,32,8"], False, True),
    (["--fused", "--split2", "--columns-per-area", "64,32,8"], False, True),
    (["--columns-per-area", "192,96,24"], False, True),
    (["--fused", "--columns-per-area", "64,32,8"], False, False),
    # The f32-exact engine past 17 columns: auto through 103 columns (B7t-team
    # from 24, B8t-team from 18), pinned from 104 through 312 (outer mode).
    (["--columns-per-area", "12,4,2"], False, False),
    (["--columns-per-area", "16,6,2"], False, False),
    (["--columns-per-area", "16,8,8"], False, False),
    (["--columns-per-area", "32,24,7"], False, False),
    (["--engine", "fused", "--columns-per-area", "192,96,24"], False, False),
    # The split2 tier below 64 columns takes its weight gradients in the
    # reverse-sweep kernel (B8s): pinned at 13 and 32 columns.
    (["--engine", "fused-split2"], False, True),
    (["--fused", "--split2"], False, True),
    (["--engine", "fused-split2", "--columns-per-area", "16,8,8"], False, True)])
def test_command_line_selects_the_step(argv, stochastic, split2, capsys):
    seen = _parse(argv + ["--smoke", "--device", "cpu"])
    assert seen["stochastic"] is stochastic and seen["split2"] is split2
    assert seen["smoke"] and seen["device"] == "cpu"


FIXED = dict(stochastic=True)
XLA_SELECTION = dict(stochastic=True, adaptive=True)
BENCH = dict(stochastic=True, adaptive=True, select_bf16=True, grad_bf16=True, split2=True)


@pytest.mark.parametrize("argv,mode", [
    # The fixed-grid SDE step: --stochastic alone, with --fused, or the
    # engine named (auto picks the fused engine below 104 columns).
    (["--stochastic"], FIXED), (["--stochastic", "--fused"], FIXED),
    (["--stochastic", "--engine", "auto"], FIXED),
    # The stochastic-adaptive step with the XLA selection (jax.random tree)
    # and the three-term replay below 104 columns...
    (["--stochastic", "--adaptive"], XLA_SELECTION),
    (["--stochastic", "--adaptive", "--fused"], XLA_SELECTION),
    (["--stochastic", "--adaptive", "--fused", "--select-bf16"],
     dict(XLA_SELECTION, select_bf16=True)),
    # ... and bench.py's primary configuration at 104 columns: --engine auto
    # adds the bf16 tiers and split2, as the explicit flags do.
    (["--stochastic", "--adaptive", "--columns-per-area", "64,32,8"], BENCH),
    (["--stochastic", "--adaptive", "--fused", "--select-bf16", "--grad-bf16", "--split2",
      "--columns-per-area", "64,32,8"], BENCH),
    (["--stochastic", "--adaptive", "--batch-size", "8", "--columns-per-area", "64,32,8"], BENCH),
    (FLAGSHIP_ARGV, dict(BENCH, fused_pass=True)),
    # From 64 through 312 columns --stochastic is the fused fixed-grid SDE
    # too (resolve_engine: use_fused, no split2), its weight gradients taken
    # outside the sweep (arg_grads "auto" -> "outer").
    (["--stochastic", "--columns-per-area", "64,32,8"], FIXED),
    (["--stochastic", "--columns-per-area", "192,96,24"], FIXED),
    # --fused-pass without --split2 replays on the three-term split with
    # the gradbf16 weight gradients outside (B4t lanes, then the substitute);
    # --fused-pass without --select-bf16 selects on the three-term split
    # (B5t).
    (FLAGSHIP_ARGV[:-1], dict(BENCH, fused_pass=True, split2=False)),
    (FLAGSHIP_ARGV[:3] + ["--fused-pass", "--grad-bf16", "--split2"],
     dict(XLA_SELECTION, fused_pass=True, grad_bf16=True, split2=True)),
    # The f32-exact engine pinned at bench.py's width (the exact outer
    # tier on per-lane grids), with B5t, and with the gradbf16 substitute.
    (["--stochastic", "--adaptive", "--engine", "fused", "--columns-per-area", "64,32,8"],
     XLA_SELECTION),
    (["--stochastic", "--adaptive", "--fused", "--fused-pass", "--columns-per-area", "64,32,8"],
     dict(XLA_SELECTION, fused_pass=True)),
    (["--stochastic", "--adaptive", "--fused", "--grad-bf16", "--columns-per-area", "64,32,8"],
     dict(XLA_SELECTION, grad_bf16=True)),
    (["--stochastic", "--adaptive", "--fused", "--grad-bf16"], dict(XLA_SELECTION, grad_bf16=True)),
    # Kernel mode past one block's capacity (B4't-team): 32 columns.
    (["--stochastic", "--columns-per-area", "16,8,8"], FIXED),
    # The split2 replay without the gradbf16 substitute: in kernel mode
    # through 63 columns (B4s), the exact outer pass from 64; with
    # --fused-pass and no --select-bf16, B5t selects and B4s sweeps.
    (["--stochastic", "--adaptive", "--fused", "--split2"], dict(XLA_SELECTION, split2=True)),
    (["--stochastic", "--adaptive", "--fused", "--split2", "--columns-per-area", "64,32,8"],
     dict(XLA_SELECTION, split2=True)),
    (["--stochastic", "--adaptive", "--engine", "fused-split2", "--columns-per-area", "16,8,8"],
     dict(XLA_SELECTION, split2=True)),
    (["--stochastic", "--adaptive", "--fused", "--fused-pass", "--split2"],
     dict(XLA_SELECTION, fused_pass=True, split2=True)),
    (["--stochastic", "--adaptive", "--columns-per-area", "16,8,8"], XLA_SELECTION)])
def test_command_line_resolves_the_stochastic_steps(argv, mode):
    seen = _parse(argv + ["--smoke", "--device", "cpu"])
    want = {k: bool(mode.get(k, False)) for k in tpt.Flags._fields}
    assert {k: seen[k] for k in tpt.Flags._fields} == want


@pytest.mark.parametrize("argv,exc,item", [
    (["--split2"], ValueError, "requires --fused"),
    (["--columns-per-area", "256,128,32"], NotImplementedError, "A7"),
    (["--engine", "xla"], NotImplementedError, "A7"),
    (["--method", "tsit5"], NotImplementedError, "A7"),
    # An explicit flag without --fused is the XLA engine; --fused-pass alone
    # is refused, as the JAX package's batched_rollout refuses it.
    (["--select-bf16"], NotImplementedError, "A7"),
    (["--fused-pass", "--fused"], ValueError, "fused_pass requires"),
    (["--adaptive"], ValueError, "adaptive applies"),
    # Past 312 columns the fixed-grid step resolves to the XLA engine (A7),
    # and so does the stochastic-adaptive step past 8 lanes at 104 columns.
    (["--stochastic", "--columns-per-area", "192,96,25"], NotImplementedError, "A7"),
    (["--stochastic", "--adaptive", "--batch-size", "16", "--columns-per-area", "64,32,8"],
     NotImplementedError, "A7"),
    # The JAX package's other flags are accepted and raise, naming their item.
    (["--random-fan-in"], NotImplementedError, "A3"),
    (["--random-fan-in", "--legacy-host-rng"], NotImplementedError, "A3"),
    (["--legacy-host-rng"], NotImplementedError, "A3"),
    (["--position-invariant"], NotImplementedError, "A6b"),
    (["--reference-rails"], NotImplementedError, "A6b"),
    (["--metrics-out", "m.jsonl"], NotImplementedError, "A9"),
    (["--profile-dir", "prof"], NotImplementedError, "A9"),
    (["--checkpoint-out", "ck"], NotImplementedError, "A9"),
    (["--resume", "ck"], NotImplementedError, "A9"),
    (["--eval", "ck.npz"], NotImplementedError, "A9"),
    (["--eval-demo"], NotImplementedError, "A9")])
def test_unported_command_lines_raise(argv, exc, item):
    # Past 312 columns auto picks XLA (A7).
    with pytest.raises(exc, match=item):
        _parse(argv + ["--smoke", "--device", "cpu"])


def test_command_line_has_no_tolerance_options():
    # The fused path runs 1e-7 / 1e-9 whatever the task says, as the JAX
    # package's does; the port offers no option that would be ignored.
    for flag in ("--rtol", "--atol"):
        with pytest.raises(SystemExit):
            tpt.main([flag, "1e-5", "--smoke", "--device", "cpu"])
