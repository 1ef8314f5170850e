"""B3t-team and B4t as cluster teams (``kernels.network_sde`` ``replay3_fwd``
and ``replay3_bwd_emit`` on the card, csrc/sde3_replay_team.cu): what the
CPU can check of them.

- The teams' shape (``sde3_team_plan``: the replay's plan for B3t-team,
  ``SDE_SWEEP`` for B4t) and route (``sde3_team_route``): the cluster
  size, route and the float32 slice at 3, 13, 24, 32, 63, 104 and 312
  columns for 1, 4 and 8 lanes, with the H100's cluster capacity given (7
  clusters of 16, 15 of 8 at 104 columns: 8 lanes take clusters of 8), and
  clusters of 8 wherever the occupancy reader holds fewer clusters of 16
  than lanes.
- The shared-memory bytes at every width from 1 through 312 columns with
  0, 4 and 16 inputs, clusters of 8 and 16, resident or the ring forced:
  under the 232,448 a block can use, B4t's VJP slot and the chunk sums of
  the 8-block team's order beside the weights.
- The packing against ``prepare_premixed_split``: the bf16 terms per block
  where the plan holds them, the float32 wT per block where it says f32,
  and wT's words split as the kernels split them (``t3_split_w``) equal to
  the three terms.
- The kernels' float64 sum orders, emulated in numpy: the drift's chunks
  (team8's) on the six products, and B4t's VJP (each block's columns,
  every Lv-th in order, a butterfly, the blocks in rank order) on the three
  transposed products, at 104 and 312 columns on clusters of 16 and 8,
  against the plain versions' float64 matmul, rounded to float32: 0
  entries differ.
- A bad ``route`` raises before any device is touched; CPU tensors take the
  plain versions on every route.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.models import network as nw
from test_torch_ode_team16 import _split3_inputs, emulate_chunks, emulate_vjp

SMEM = 232448
_CPA = {3: (2, 1, 0), 13: (8, 4, 1), 32: (16, 8, 8), 104: (64, 32, 8), 312: (192, 96, 24)}


def h100_clusters(C):
    """The H100's capacity for a team of one block an SM at 104 columns
    (cudaOccupancyMaxActiveClusters on the card): 7 clusters of 16, 15 of 8."""
    return 7 if C == 16 else 15


# (columns, lanes) -> (route, C, f32) of both kernels with 4 inputs and
# h100_clusters: clusters of 16 where 16 divides P and 7 lanes' clusters or
# fewer are asked for; the float32 wT where the bf16 terms' slice would
# stream and wT's stays resident (63 columns on clusters of 8, 104 on 16);
# resident through 104 columns on clusters of 16, streamed at 312 and at
# 104 on clusters of 8.
TEAM_ROUTES = {}
for _cols in (3, 13, 24, 32, 63, 104, 312):
    for _lanes in (1, 4, 8):
        _C = 16 if (8 * _cols) % 16 == 0 and _lanes <= 7 else 8
        _res = _cols <= 63 or (_cols == 104 and _C == 16)
        TEAM_ROUTES[_cols, _lanes] = ("resident" if _res else "streamed", _C,
                                      _cols == 63 or (_cols == 104 and _C == 16))


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("columns,lanes", sorted(TEAM_ROUTES))
def test_cluster_size_route_and_slice(columns, lanes, bwd):
    P = 8 * columns
    route, C = ns.sde3_team_route(P, 4, lanes, bwd, h100_clusters)
    want_route, want_C, want_f32 = TEAM_ROUTES[columns, lanes]
    assert (route, C) == (want_route, want_C)
    plan = ns.sde3_team_plan(P, 4, bwd, C=C)
    assert (plan.C, plan.nc, plan.NT, plan.NB, plan.LB, plan.ipt) == (C, P // C, 3, 1, 1, 1)
    assert plan.fits and plan.stream == (route == "streamed") and plan.f32 == want_f32
    assert plan.bytes <= SMEM
    # B3t-team's plan is the dopri5 replay's; B4t's adds the VJP's (3, C, nc)
    # float64 partials to the exchange slot
    replay = no.ode_team_plan(P, 4, 1, 3, no.REPLAY, C=C)
    if bwd:
        assert plan.slot == -(-max(4 * P * plan.xs, 8 * 3 * P) // 16) * 16 > replay.slot
        assert plan.L == replay.L and plan.fixed > replay.fixed
    else:
        assert plan == replay


def test_cluster_of_8_where_the_card_holds_fewer_clusters_of_16():
    P = 832
    for bwd in (False, True):
        assert ns.sde3_team_route(P, 4, 4, bwd, lambda C: 7) == ("resident", 16)
        assert ns.sde3_team_route(P, 4, 7, bwd, lambda C: 7) == ("resident", 16)
        assert ns.sde3_team_route(P, 4, 8, bwd, lambda C: 7) == ("streamed", 8)
        assert ns.sde3_team_route(P, 4, 4, bwd, lambda C: 3 if C == 16 else 16)[1] == 8
        assert ns.sde3_team_route(104, 4, 1, bwd, lambda C: 100)[1] == 8  # 16 does not divide P


def _invariants(p, P, stream, bwd):
    assert p.bytes <= SMEM and p.fits and p.ipt == 1 and p.LB == 1, p
    G = no._t3_chunks(P)
    assert 1 <= G <= 8 and p.nc * G <= 512
    # the chunk sums of team8's order (G, 6, nc float64) before the weights,
    # and for B4t the VJP partials in each exchange slot
    assert p.fixed >= p.slots * p.slot + 8 * G * 6 * p.nc
    assert p.slot >= (8 * 3 * P if bwd else 4 * P * p.xs)
    v = p.Lv if p.f32 else max(1, p.Lv // 2)
    assert p.L * p.Lv == 32 and p.rw % v == 0 and (p.rw // v) % 2 == 1
    assert (p.rw >= p.nc) if p.f32 else (2 * p.rw >= 3 * p.nc)
    assert p.fixed % 16 == 0 and (P * 4 * p.rw) % 16 == 0
    if p.stream:
        assert p.S >= min(2, p.T) and p.R % p.L == 0 and p.R % 8 == 0
        assert (p.R * 4 * p.rw) % 16 == 0 and p.T * p.R >= P > (p.T - 1) * p.R
        assert p.bytes == p.fixed + p.S * p.R * 4 * p.rw
    else:
        assert (p.R, p.T, p.S, p.slots) == (P, 1, 1, 2) and not stream
        assert p.bytes == p.fixed + P * 4 * p.rw


@pytest.mark.parametrize("bwd", [False, True])
def test_shared_memory_fits_at_every_width(bwd):
    """Every width from 1 through 312 columns, 0, 4 and 16 inputs, clusters
    of 8 and (where 16 divides P) 16, resident or the ring forced: the plan
    fits a block; the float32 slice only where it is resident and the bf16
    terms' would not be."""
    f32 = set()
    for columns in range(1, 313):
        P = 8 * columns
        for C in (8, 16):
            if P % C:
                continue
            for n_in in (0, 4, 16):
                for stream in (False, True):
                    p = ns.sde3_team_plan(P, n_in, bwd, stream, C)
                    _invariants(p, P, stream, bwd)
                    if p.f32:
                        f32.add((columns, C, n_in))
                        bf16 = p.fixed + P * 4 * no._t3_row_words(p.nc, 3, p.Lv, False)
                        assert bf16 > SMEM and p.fixed + P * 4 * p.rw <= SMEM
    # with 4 inputs, clusters of 16: the float32 wT from 90 through 104
    # columns (even), for B4t's larger exchange slots too
    assert {c for c, C, n_in in f32 if C == 16 and n_in == 4} == set(range(90, 105, 2))


def _network(columns):
    params, net = nw.build_column_network(ColumnConfig.load(), torch.Generator().manual_seed(0),
                                          columns_per_area=_CPA[columns], n_inputs=4)
    fc = nw.build_network_fused_consts(net)
    pw = {k: v.contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    return net.num_pops, pw, fc


def _split_as_the_kernels(words):
    """wT's float32 words split as csrc/ode_team.cuh t3_split_w splits each:
    hi = bf16(w), mid = bf16(w - hi), lo = bf16((w - hi) - mid), each to
    nearest."""
    w = words.view(torch.float32)
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


@pytest.mark.parametrize("columns,bwd", [(32, False), (32, True), (104, False), (104, True)])
def test_pack_against_prepare_premixed_split(columns, bwd):
    """The slices the wrappers hand the kernels (``_sde3_pack``): at 32
    columns the three bf16 terms per block, at 104 (clusters of 16) the
    float32 wT per block, whose words split as the kernels split them give
    ``prepare_premixed_split``'s terms bit for bit."""
    P, pw, fc = _network(columns)
    sc = ns.SDEConsts(fc=fc, knot_ts=(0.0, 1.0))
    w3 = nw.prepare_premixed_split(pw, fc)[0]
    plan = ns.sde3_team_plan(P, 4, bwd)
    assert plan.f32 == (columns == 104)
    pk = ns._sde3_pack(pw, sc, P, plan)
    assert pk.dtype == torch.int32 and tuple(pk.shape) == (plan.C, P, plan.rw)
    nc = plan.nc
    terms = ("wT_hi", "wT_mid", "wT_lo")
    for r in range(plan.C):
        cols = slice(r * nc, (r + 1) * nc)
        if plan.f32:
            assert torch.equal(pk[r, :, :nc].view(torch.float32), pw["wT"][:, cols])
            assert not pk[r, :, nc:].any()
            for got, name in zip(_split_as_the_kernels(pk[r, :, :nc].contiguous()), terms):
                assert torch.equal(got, w3[name][:, cols]), name
        else:
            half = pk[r].view(torch.bfloat16)
            for t, name in enumerate(terms):
                assert torch.equal(half[:, t * nc:(t + 1) * nc], w3[name][:, cols])
            assert not half[:, 3 * nc:].float().any()


@pytest.mark.parametrize("columns,C", [(104, 16), (104, 8), (312, 16), (312, 8)])
def test_sum_orders_round_as_the_plain_matmul(columns, C):
    """The drift's products in team8's chunk order (the six of the
    three-term split) and B4t's VJP order (the three transposed ones, on
    the SDE_SWEEP plan's C, nc and Lv) emulated in float64 with numpy for 64
    rate and 64 cotangent vectors, against the plain versions' float64
    matmul, rounded to float32: 0 entries differ. At 312 columns (to keep
    the test quick) the drift's columns of four blocks and the VJP's every
    fourth row."""
    P, w3, (x_hi, x_mid, x_lo), c = _split3_inputs(columns)
    plan = ns.sde3_team_plan(P, 4, True, C=C)
    G = no._t3_chunks(P)
    nc = P // 16
    blocks = range(16) if columns == 104 else (0, 5, 10, 15)
    cols = np.concatenate([np.arange(r * nc, (r + 1) * nc) for r in blocks])
    rows = np.arange(0, P, 1 if columns == 104 else 4)
    W = {k: w3[k].double() for k in ("wT_hi", "wT_mid", "wT_lo")}
    mismatches = {}
    if C == 16:  # the chunk order does not depend on the cluster size
        products = (("x_hi W_lo", x_hi, "wT_lo"), ("x_mid W_mid", x_mid, "wT_mid"),
                    ("x_lo W_hi", x_lo, "wT_hi"), ("x_hi W_mid", x_hi, "wT_mid"),
                    ("x_mid W_hi", x_mid, "wT_hi"), ("x_hi W_hi", x_hi, "wT_hi"))
        for name, x, k in products:
            got = emulate_chunks(G, x.double().numpy(), W[k].numpy()[:, cols]).astype(np.float32)
            want = torch.matmul(x.double(), W[k]).float().numpy()[:, cols]
            mismatches[name] = int((got != want).sum())
    for k in ("wT_hi", "wT_mid", "wT_lo"):
        got = emulate_vjp(plan, c.double().numpy(), W[k].numpy()[rows]).astype(np.float32)
        want = torch.matmul(c.double(), W[k].T).float().numpy()[:, rows]
        mismatches[f"c {k}^T"] = int((got != want).sum())
    assert mismatches == dict.fromkeys(mismatches, 0), mismatches


def _cpu_inputs(lanes):
    P, pw, fc = _network(13)
    B, n = 2, 6
    sc = ns.SDEConsts(fc=fc, knot_ts=(0.0, 0.5, 1.0))
    rng = np.random.default_rng(3)
    kv = torch.from_numpy(rng.uniform(0.0, 20.0, (3, B, 4)).astype(np.float32))
    y0 = torch.from_numpy(rng.uniform(-5.0, 5.0, (B, 3 * P)).astype(np.float32))
    hs = torch.from_numpy(rng.uniform(2e-4, 1e-3, (n, B) if lanes else (n,)).astype(np.float32))
    t0s = (torch.cumsum(hs, 0) - hs + 0.3).contiguous()
    i1 = torch.from_numpy(rng.normal(0.0, 0.02, (n, B)).astype(np.float32))
    i10 = torch.from_numpy(rng.normal(0.0, 1e-5, (n, B)).astype(np.float32))
    ysbar = torch.from_numpy(rng.normal(size=(n, B, 3 * P)).astype(np.float32))
    return pw, sc, kv, y0, t0s, hs, i1, i10, ysbar, n


@pytest.mark.parametrize("lanes", [False, True])
def test_routes_checked_before_the_device_and_plain_on_cpu(lanes):
    """A bad route raises before any device is touched; on CPU tensors
    every route runs the plain versions (bit for bit with
    ``_replay3_fwd_plain`` / ``_replay3_bwd_emit_plain``) and launches
    nothing."""
    pw, sc, kv, y0, t0s, hs, i1, i10, ysbar, n = _cpu_inputs(lanes)
    for bad in ("block", "team16", "Resident"):
        with pytest.raises(ValueError, match="route"):
            ns.replay3_fwd(y0, t0s, hs, i1, i10, n, pw, sc, kv, route=bad)
        with pytest.raises(ValueError, match="route"):
            ns.replay3_bwd_emit(y0[None], ysbar, t0s, hs, i10, n, 0, pw, sc, kv, route=bad)
    before = dict(ns.LAUNCHES)
    want_ys = ns._replay3_fwd_plain(y0, t0s, hs, i1, i10, n - 1, pw, sc, kv)
    bwd = (want_ys[:-1].contiguous(), ysbar, t0s, hs, i10, n - 1, 2, pw, sc, kv)
    want_b = ns._replay3_bwd_emit_plain(*bwd)
    for route in (None,) + ns.SPLIT3_ROUTES:
        assert torch.equal(ns.replay3_fwd(y0, t0s, hs, i1, i10, n - 1, pw, sc, kv, route=route),
                           want_ys), route
        got = ns.replay3_bwd_emit(*bwd, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want_b)), route
    assert ns.LAUNCHES == before
