#!/usr/bin/env python
"""Where the XOR stochastic-adaptive selection stops at its full width, in
both packages, on the same weights and keys.

The four conditions as 4 lanes, 1000 grid points over 1 s, max_steps 2048
(``columnflow/tasks/xor.py:69-75``), the JAX package's weights
(``build_task(cfg, PRNGKey(0))``) and lane keys ``jax.random.split(
PRNGKey(5), 4)``. On each tree (``jax.random``; krng, which ``--fused-pass``
draws from) the JAX package's XLA selection (``_adaptive_pass``, the grid
handed to the jitted pass as an argument, as ``tests/
test_torch_xor_adaptive.py`` does) and the port's (``kernels.xor_sde.
_xor_select_plain``, the CUDA kernel's plain version). Prints, per lane,
the accepted and rejected counts and the time reached, and whether the
lane reached 1 s. Then, on the jax.random tree, the loss of each
package's whole rollout at 1 s (JAX's ``batched_rollout`` with its
interpret-mode replay, the port's ``batched_rollout`` on its own
selection): the replay extrapolates each lane's last accepted step to 1 s,
so both readouts are far from the targets. One process; on a CPU about
five minutes:

    JAX_PLATFORMS=cpu python tools/xor_adaptive_budget.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

from columnflow.config import ColumnConfig as JaxConfig  # noqa: E402
from columnflow.tasks import xor as jxt  # noqa: E402
from columnflow_torch.convert import lane_key_words  # noqa: E402
from columnflow_torch.kernels import xor_sde as xs  # noqa: E402
from columnflow_torch.solvers import sde_adaptive as tsa  # noqa: E402
from columnflow_torch.tasks import xor as txt  # noqa: E402
from test_torch_xor_adaptive import CONDS, _pf, jax_lanes, jax_select  # noqa: E402
from test_torch_xor_model import port_task  # noqa: E402

T, B, M = 1000, 4, 2048


def main():
    jax.config.update("jax_threefry_partitionable", True)
    jtask = jxt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), time_steps=T)
    task = port_task(jtask, time_steps=T)
    conds = torch.as_tensor(CONDS)
    sc, kv = txt.drift_inputs(task, conds)
    a_drift, jfc, kv_all = jax_lanes(jtask)
    s = dict(jtask=jtask, task=task, a_drift=a_drift, jfc=jfc, kv_all=kv_all,
             keys=jax.random.split(jax.random.PRNGKey(5), B))
    for tree in ("jax", "kernel"):
        st_j, na_j, nr_j, t1_j = jax_select(s, jtask.params, tree, M)
        cfg = tsa.select_config(task.ts, max_steps=M, brownian=tree, drift="f32")
        words = tsa._sde_key_words(lane_key_words(s["keys"]), tree)
        st, na, nr, ok = xs._xor_select_plain(torch.zeros(B, 72), words, _pf(s), sc, kv, cfg)
        reached = st[torch.arange(B), na.long()].numpy()
        print(f"{tree} tree, max_steps {M}:")
        print(f"  JAX  accepted {na_j.tolist()} rejected {nr_j.tolist()} "
              f"reached {np.round(t1_j, 4).tolist()} s")
        print(f"  port accepted {na.tolist()} rejected {nr.tolist()} "
              f"reached {np.round(reached, 4).tolist()} s, success {ok.tolist()}")
        print(f"  batch accepted: port {int(na.sum())}, JAX {int(na_j.sum())} "
              f"({abs(int(na.sum()) - int(na_j.sum())) / int(na_j.sum()):.2%} apart)")
    jconds = jnp.asarray(CONDS)
    ys_j = jxt.batched_rollout(jtask.params, jtask, jconds, stochastic=True, adaptive=True,
                               use_fused=True, key=jax.random.PRNGKey(5),
                               differentiable=False)
    loss_j = float(jxt.readout(ys_j, jxt.xor_targets(jconds))[1])
    ys = txt.batched_rollout(task.params, task, conds, differentiable=False, stochastic=True,
                             adaptive=True, keys=lane_key_words(s["keys"]))
    loss = float(txt.readout(ys, txt.xor_targets(conds))[1])
    print(f"loss at 1 s (jax.random tree): JAX {loss_j:.6g}, port {loss:.6g}; largest |y| "
          f"JAX {float(jnp.abs(ys_j).max()):.4g}, port {float(ys.abs().max()):.4g}")


if __name__ == "__main__":
    main()
