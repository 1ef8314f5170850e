"""Port parity: the stochastic-adaptive selection's step budget at 13 columns
(``--stochastic --adaptive`` at the reference width, columns (8, 4, 1), 4
inputs, 1000 grid points over 1 s): the port's XLA selection on the
``jax.random`` tree (``kernels.network_sde._select_plain``, the float32
drift) against the JAX package's (``columnflow.solvers.sde_adaptive.
_adaptive_pass``) on the JAX package's weights, four lanes.

At the command line's max_steps 3072 both stop every lane at ~0.38 s of the
1 s (JAX 2592-2604 accepted steps, t = 0.375-0.379 s; the port 2612-2626,
t = 0.378-0.385 s): the budget runs out in the JAX package as in the port
(ROADMAP.md section C). The test runs the same selections with max_steps
512, where both stop early too, to stay inside the suite's time budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import network as jn
from columnflow.models.column import Stimulus as JStim
from columnflow.ops.interp import interp_knots as j_knots
from columnflow.ops.interp import step_table_knots as j_step_knots
from columnflow.solvers import sde_adaptive as jsa
from columnflow.tasks import parity as jpt
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import lane_key_words, network_from_jax
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.solvers import sde_adaptive as tsa
from columnflow_torch.tasks import parity as tpt

CPA, N_IN, T, B, M = (8, 4, 1), 4, 1000, 4, 512
STIMS = np.array([[0, 15, 0, 15], [15, 0, 0, 0], [15, 15, 15, 0], [0, 0, 0, 0]], np.float32)


def _jax_selection(jtask, keys):
    """JAX's XLA selection (``_adaptive_pass``, float32 drift, PI
    controller, rtol = atol = 1e-3, levy depth 20) of each lane: accepted,
    rejected, the time reached."""
    dt, P = jtask.dt, jtask.net.num_pops
    jfc = jn.build_network_fused_consts(jtask.net)
    kts, _ = j_step_knots(T, dt, jnp.zeros(N_IN), jnp.zeros(N_IN))
    jpw = jn.premix_network_weights(jtask.params, jtask.net)
    kv_all = jax.vmap(lambda s: j_step_knots(T, dt, jnp.zeros_like(s), s)[1])(jnp.asarray(STIMS))

    def drift(t, y, pw, fc, kv):
        return jn.network_drift_premixed(t, y, pw, fc, JStim(0.0, dt, kv),
                                         interp_fn=lambda t_, a, b, v: j_knots(t_, kts, v))

    def a_diff(t, y, pw, fc, kv):
        return jnp.full_like(y, jn.NETWORK_NOISE_STD)

    def one_pass(y0_b, key_b, kv_b):
        (stp, ee, wi, dbl, _, t0_, t1_, tree, i10_draw, h0) = jsa._setup(
            "sra1", y0_b, jtask.ts, key_b, None, 20, brownian="jax")
        c = jsa._adaptive_pass(stp, ee, wi, drift, a_diff, y0_b, t0_, t1_, tree, i10_draw, 1e-3,
                               1e-3, h0, M, (jpw, jfc, kv_b), controller="pi", doubling=dbl)
        return c.naccept, c.nreject, c.t1

    out = jax.jit(jax.vmap(one_pass))(jnp.zeros((B, 1, 3 * P)), keys, kv_all[:, :, None, :])
    return tuple(np.asarray(x) for x in out)


def test_selection_budget_at_13_columns_matches_jax():
    """Both selections spend max_steps 512 before the end of the second in
    every lane, and agree: the batch's accepted count within 2% of JAX's
    (measured 1763 against 1745, 1.0%) and each lane's reached time within
    5% of JAX's plus twice the port's own spread under a 1e-7 nudge of the
    weights. Measured: JAX 437 / 432 / 440 / 436 accepted, t = 0.0651 /
    0.0612 / 0.0657 / 0.0641 s; the port 439 / 433 / 440 / 451, t = 0.0654
    / 0.0627 / 0.0650 / 0.0682 s. The last lane is 6.3% apart, where the
    nudge alone moves the port's lanes by up to 4.6% (0.0682 -> 0.0651 s):
    the grids part where an error estimate an ulp apart flips a decision
    (ROADMAP.md section C, slice 7), so a lane's time cannot hold 5% alone."""
    jtask = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=CPA,
                           n_inputs=N_IN, time_steps=T, max_steps=M)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    na_j, nr_j, t_j = _jax_selection(jtask, keys)
    params, _ = network_from_jax({k: np.asarray(v) for k, v in jtask.params.items()}, jtask.net)
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=CPA, n_inputs=N_IN, time_steps=T, max_steps=M,
                          device="cpu")
    with torch.no_grad():
        for k, p in task.params.items():
            p.copy_(params[k])
    model = tpt.sde_model(task.params, task, torch.as_tensor(STIMS))
    cfg = tsa.select_config(task.ts, max_steps=M, brownian="jax", drift="f32")
    words = tsa._sde_key_words(lane_key_words(keys), "jax")

    def port(scale):
        pw = {k: v.detach().contiguous() * scale for k, v in model.pw.items()}
        st, na, nr, ok = ns._select_plain(torch.zeros(B, 3 * task.net.num_pops), words, pw,
                                          model.sc, model.kv, cfg)
        return (st[torch.arange(B), na.long()].numpy(), na.numpy().astype(float),
                nr.numpy().astype(float), ok)

    t_port, na, nr, ok = port(1.0)
    t_nudged = port(1.0 + 1e-7)[0]
    spread = np.abs(t_nudged - t_port)
    assert not ok.any() and np.all(t_j < float(task.ts[-1]))  # both stop early
    assert np.all(na + nr == M) and np.all(na_j + nr_j == M)
    assert abs(na.sum() - na_j.sum()) <= 0.02 * na_j.sum(), (na, na_j)
    assert np.all(np.abs(t_port - t_j) <= 0.05 * t_j + 2 * spread), (t_port, t_j, spread)
