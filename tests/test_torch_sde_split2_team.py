"""B3 and B4 as cluster teams (``kernels.network_sde`` ``replay_fwd`` and
``replay_bwd`` on the card): what the CPU can check of them.

- The team's shape (``sde2_replay_plan``): the cluster size, the route
  (resident or streamed weights) at 13, 32, 63, 104 and 312 columns and the
  blocks that 1-8 lanes take; the shared-memory bytes a block asks for,
  under the 232,448 a block can use at every width from 1 through 312
  columns and 0-16 inputs, and the tiling the streamed ring needs.
- ``sde2_pack``'s per-block layout of the two split2 terms.
- The kernels' summation order, emulated in float64 with numpy: the
  forward products (each column's rows summed lane by lane, every L-th row
  in order, then a butterfly over the L lanes) and the VJP products (each
  row's columns block by block, every Lv-th word in order, a butterfly over
  the Lv lanes, then the blocks' partials in rank order), on the split2
  terms of the parity network at 104 and 312 columns for 64 rate and 64
  cotangent vectors from a numpy seed, against the plain versions' float64
  matmul. Every product is exact in float64, so the two sums differ only in
  the last bits of a float64; rounded to float32 they agree bit for bit on
  all of these vectors (the test counts the entries that do not: 0).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.models import network as nw
from columnflow_torch.ops.transfer import compute_firing_rate

SMEM = 232448
N_VEC = 64


@pytest.mark.parametrize("columns,C,route", [(13, 8, "resident"), (32, 16, "resident"),
                                             (63, 8, "resident"), (104, 16, "resident"),
                                             (312, 16, "streamed")])
@pytest.mark.parametrize("lanes", [1, 4, 8])
def test_cluster_size_and_route(columns, C, route, lanes):
    P = 8 * columns
    plan = ns.sde2_replay_plan(P, 4)
    assert (plan.C, plan.nc, plan.stream) == (C, P // C, route == "streamed")
    assert ns.sde2_replay_route(P, 4) == route
    # one block per SM: 1-8 lanes take at most 128 of the H100's 132
    assert lanes * plan.C <= 128


def test_shared_memory_fits_at_every_width():
    for columns in range(1, 313):
        P = 8 * columns
        for n_in in (0, 1, 4, 16):
            for stream in (False, True):
                p = ns.sde2_replay_plan(P, n_in, stream)
                row = 4 * p.rw
                assert p.bytes <= SMEM, (columns, n_in, stream, p)
                assert p.rw % 2 == 1 and 2 * p.nw >= p.nc
                assert p.nw * p.L <= 512 and 32 % p.L == 0 and 32 % p.Lv == 0
                assert p.fixed % 16 == 0 and (P * row) % 16 == 0
                if p.stream:
                    assert p.S >= min(2, p.T) and p.R % p.L == 0 and p.R % (512 // p.Lv) == 0
                    assert (p.R * row) % 16 == 0 and p.T * p.R >= P > (p.T - 1) * p.R
                    assert p.bytes == p.fixed + p.S * p.R * row
                else:
                    assert (p.R, p.T, p.S) == (P, 1, 1) and p.bytes == p.fixed + P * row
                    assert not stream


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        ns.sde2_replay_plan(100, 4)  # P not a multiple of 8
    with pytest.raises(ValueError):
        ns.sde2_replay_plan(104, 17)


def test_pack_layout():
    gen = torch.Generator().manual_seed(3)
    for columns in (13, 32):
        P = 8 * columns
        w2 = {k: torch.randn(P, P, generator=gen).to(torch.bfloat16) for k in ("wT_hi", "wT_mid")}
        plan = ns.sde2_replay_plan(P, 4)
        pk = ns.sde2_pack(w2, P, plan)
        assert pk.dtype == torch.int32 and tuple(pk.shape) == (plan.C, P, plan.rw)
        half = pk.view(torch.bfloat16)  # (C, P, 2 rw)
        for r in range(plan.C):
            cols = slice(r * plan.nc, (r + 1) * plan.nc)
            assert torch.equal(half[r, :, :plan.nc], w2["wT_hi"][:, cols])
            lo = 2 * plan.nw
            assert torch.equal(half[r, :, lo:lo + plan.nc], w2["wT_mid"][:, cols])
            assert not half[r, :, plan.nc:lo].any() and not half[r, :, lo + plan.nc:].any()


def _butterfly(acc):
    """The xor butterfly of shuffles over the lanes axis 0: each lane adds
    its partner's value at distances L/2 .. 1; every lane ends with the same
    float64 (addition commutes), returned."""
    L, idx, off = acc.shape[0], np.arange(acc.shape[0]), acc.shape[0] // 2
    while off:
        acc = acc + acc[idx ^ off]
        off //= 2
    return acc[0]


def emulate_forward(plan, x, W):
    """x (N, P), W (P, P) float64: the team's float64 sums x W, column by
    column: lane l of a column pair sums the rows k = l mod L in order."""
    P, L = W.shape[0], plan.L
    acc = np.zeros((L, x.shape[0], P))
    for i in range(-(-P // L)):
        k = np.arange(L) + L * i
        ok = k < P
        kk = np.where(ok, k, 0)
        prod = x[:, kk].T[:, :, None] * W[kk][:, None, :]
        acc = acc + np.where(ok[:, None, None], prod, 0.0)
    return _butterfly(acc)


def emulate_vjp(plan, c, W):
    """c (N, P), W (P, P) float64: the team's float64 sums c W^T, row by
    row: block r sums its own columns, lane l of a row the words j / 2 = l
    mod Lv in order (two columns a word), a butterfly over the Lv lanes,
    then the owner adds the blocks' partials in rank order."""
    P, C, nc, nwd, Lv = W.shape[0], plan.C, plan.nc, plan.nw, plan.Lv
    total = np.zeros((c.shape[0], P))
    for r in range(C):
        acc = np.zeros((Lv, c.shape[0], P))
        for i in range(-(-nwd // Lv)):
            q = np.arange(Lv) + Lv * i
            for half in (0, 1):
                j = 2 * q + half
                ok = (q < nwd) & (j < nc)
                jj = np.where(ok, r * nc + j, 0)
                prod = c[:, jj].T[:, :, None] * W[:, jj].T[:, None, :]
                acc = acc + np.where(ok[:, None, None], prod, 0.0)
        total = total + _butterfly(acc)
    return total


def _split2_inputs(columns):
    cpa = {104: (64, 32, 8), 312: (192, 96, 24)}[columns]
    params, net = nw.build_column_network(ColumnConfig.load(), torch.Generator().manual_seed(0),
                                          columns_per_area=cpa, n_inputs=4)
    fc = nw.build_network_fused_consts(net)
    w2 = nw.prepare_premixed_split2(nw.premix_network_weights(params, net), fc)[0]
    rng = np.random.default_rng(columns)
    P = net.num_pops
    v_minus_a = rng.uniform(-40.0, 40.0, (N_VEC, P)).astype(np.float32)
    fr = compute_firing_rate(torch.from_numpy(v_minus_a))
    x_hi, x_mid = nw.split2_terms(fr)
    c = torch.from_numpy((rng.standard_normal((N_VEC, P)) * 10.0 ** rng.uniform(-3, 3, (N_VEC, 1)))
                         .astype(np.float32))
    return P, w2, x_hi, x_mid, c


@pytest.mark.parametrize("columns", [104, 312])
def test_summation_order_rounds_as_the_plain_matmul(columns):
    P, w2, x_hi, x_mid, c = _split2_inputs(columns)
    plan = ns.sde2_replay_plan(P, 4)
    W_hi, W_mid = w2["wT_hi"].double(), w2["wT_mid"].double()
    mismatches = {}
    for name, x, W in (("x_hi W_hi", x_hi, W_hi), ("x_hi W_mid", x_hi, W_mid),
                       ("x_mid W_hi", x_mid, W_hi)):
        got = emulate_forward(plan, x.double().numpy(), W.numpy()).astype(np.float32)
        want = torch.matmul(x.double(), W).float().numpy()
        mismatches[name] = int((got != want).sum())
    for name, W in (("c W_hi^T", W_hi), ("c W_mid^T", W_mid)):
        got = emulate_vjp(plan, c.double().numpy(), W.numpy()).astype(np.float32)
        want = torch.matmul(c.double(), W.T).float().numpy()
        mismatches[name] = int((got != want).sum())
    assert mismatches == dict.fromkeys(mismatches, 0), mismatches


def test_routes_are_checked_before_the_device():
    P, B = 104, 2
    y0 = torch.zeros(B, 3 * P)
    grid = torch.zeros(4, B)
    with pytest.raises(ValueError, match="route"):
        ns.replay_fwd(y0, grid, grid, grid, grid, 4, {}, None, torch.zeros(2, B, 4),
                      route="block")
