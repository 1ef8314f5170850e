#!/usr/bin/env python
"""Where the fixed-grid stochastic parity forward runs off at 104 columns,
in both packages, on the same weights and noise.

SRA1 on the uniform 1 ms grid of 1 s, batch 4, the three-term split:
the port's plain forward (``columnflow_torch.kernels.network_sde.
_replay3_fwd_plain``) and the JAX package's ``sdeint_fused`` (Pallas in
interpret mode), once on the port's seed weights and once on the JAX
package's (``build_task(..., PRNGKey(0))``). Prints, for each, the first
grid point where |y| passes 1e2, 1e3, 1e4 and 1e6 on either side, the
largest |y|, and the two trajectories' distance before the run-off (in
each state component's largest magnitude). Forward only, one process,
about 1 GB of memory; on a CPU about 20 s per weight set:

    JAX_PLATFORMS=cpu python tools/fixedgrid_runoff.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from columnflow.config import ColumnConfig as JaxConfig  # noqa: E402
from columnflow.models import network as jn  # noqa: E402
from columnflow.models.column import Stimulus as JStim  # noqa: E402
from columnflow.ops.interp import interp_knots as j_knots  # noqa: E402
from columnflow.ops.interp import step_table_knots as j_step_knots  # noqa: E402
from columnflow.solvers import fused as jf  # noqa: E402
from columnflow.tasks import parity as jpt  # noqa: E402
from columnflow_torch.config import ColumnConfig  # noqa: E402
from columnflow_torch.convert import network_from_jax  # noqa: E402
from columnflow_torch.kernels import network_sde as ns  # noqa: E402
from columnflow_torch.models.network import build_column_network  # noqa: E402
from columnflow_torch.solvers import fused as tf  # noqa: E402
from columnflow_torch.solvers.sde import brownian_pack  # noqa: E402
from columnflow_torch.tasks import parity as tpt  # noqa: E402

CPA, B, T = (64, 32, 8), 4, 1000
STIMS = np.array([[0, 15, 0, 15], [15, 0, 0, 0], [15, 15, 15, 0], [0, 0, 0, 0]], np.float32)


def first_over(ys, thr):
    m = np.abs(ys).reshape(ys.shape[0], -1).max(1)
    idx = np.nonzero(m > thr)[0]
    return int(idx[0]) if len(idx) else None


def main():
    jtask = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=CPA,
                           n_inputs=4, time_steps=T)
    task = tpt.build_task(ColumnConfig.load(), torch.Generator().manual_seed(0),
                          columns_per_area=CPA, device="cpu")
    P = task.net.num_pops
    jfc = jn.build_network_fused_consts(jtask.net)
    dt = jtask.dt
    kts, _ = j_step_knots(T, dt, jnp.zeros(4), jnp.zeros(4))
    kv_all = jax.vmap(lambda s: j_step_knots(T, dt, jnp.zeros_like(s), s)[1])(jnp.asarray(STIMS))

    def drift(t, y, pw, fc, kv):
        return jn.network_drift_premixed(t, y, pw, fc, JStim(0.0, dt, kv),
                                         interp_fn=lambda t_, a, b, v: j_knots(t_, kts, v))

    def diffusion(t, y, pw, fc, kv):
        return jnp.full_like(y, jn.NETWORK_NOISE_STD)

    _, i1, i10, _, _ = brownian_pack(torch.Generator().manual_seed(5), task.ts, (B, 1))
    t0s, h = tf.uniform_step_times(task.ts, (B, 3 * P))
    n = t0s.shape[0]
    port_params, _ = build_column_network(ColumnConfig.load(), torch.Generator().manual_seed(0),
                                          columns_per_area=CPA, n_inputs=4, device="cpu")
    for label, params_np in (("port seed weights",
                              {k: v.detach().numpy() for k, v in port_params.items()}),
                             ("JAX seed weights",
                              {k: np.asarray(v) for k, v in jtask.params.items()})):
        params, _ = network_from_jax(params_np, jtask.net)
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
        model = tpt.sde_model(task.params, task, torch.as_tensor(STIMS))
        pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
        ys_p = ns._replay3_fwd_plain(torch.zeros(B, 3 * P), t0s, torch.full_like(t0s, h),
                                     i1.reshape(n, B), i10.reshape(n, B), n, pw, model.sc,
                                     model.kv).numpy()
        jpw = {k: jnp.asarray(v.numpy()) for k, v in pw.items()}
        ys_j = np.asarray(jf.sdeint_fused(
            drift, diffusion, jnp.zeros((B, 3 * P)), jtask.ts, None, jpw, jfc,
            jnp.moveaxis(kv_all, 0, 1), method="srk", noise_shape=(B, 1),
            noise_pack=(jnp.asarray(i1.numpy()), jnp.asarray(i10.numpy())), nondiff_args=(1, 2),
            prepare=jn.prepare_premixed_split, interpret=True))
        print(label)
        for thr in (1e2, 1e3, 1e4, 1e6):
            print(f"  first grid point with |y| > {thr:g}: port {first_over(ys_p, thr)}, "
                  f"JAX {first_over(ys_j, thr)}")
        print(f"  max |y|: port {np.abs(ys_p).max():.3g}, JAX {np.abs(ys_j).max():.3g}")
        k = min(first_over(ys_j, 1e2) or T, first_over(ys_p, 1e2) or T)
        scale = np.maximum(np.abs(ys_j[:k]).reshape(-1, 3 * P).max(0), 1e-30)
        print(f"  distance before grid point {k}: "
              f"{float((np.abs(ys_p[:k] - ys_j[:k]) / scale).max()):.3g} of scale")


if __name__ == "__main__":
    main()
