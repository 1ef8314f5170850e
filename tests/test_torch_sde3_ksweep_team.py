"""B4't, the SDE's kernel-mode reverse sweep on the three-term split, as one
cluster team for the batch (``kernels.network_sde.replay3_bwd`` on the card,
``cf_sde3_bwd_ksweep``, ``sde3_ksweep16_kernel`` in csrc/ode_team.cuh):
what the CPU can check of it.

- The team's shape (``network_ode.ode_team_plan(..., SDE_KSWEEP)``) at
  B4't's shapes, 13-19 columns for 1, 4 and 8 lanes: the cluster size, the
  forward lanes a thread, the slice resident, the accumulators and the
  chunk partial in shared memory; its bytes are the dopri5 sweep's plan's
  (``KSWEEP``) plus the chunk partials of d wT and d iwT and the lanes'
  step times; and at every width from 1 through 63 columns, the plan's
  invariants and at most 232,448 bytes a block wherever it fits.
- ``sde3_bwd_route``: the team wherever its plan fits, on either split:
  every width of kernel mode (1-63 columns) at 4 lanes, past where the one
  block held the batch (B4't-team's 20-63 columns); at 20, 24, 32, 48 and
  63 columns for 1, 4 and 8 lanes on two and three terms the plan's
  cluster, forward lanes a thread, ring, slots and accumulators; "team"
  (the 8-block B4't-team, or B4s) only where the plan does not fit (8
  lanes at the odd widths from 33 columns).
- Each lane's stimulus at its own time: the kernel's knot interpolation
  (``t3_knot`` at ``t3_time``, float32 operation for operation) emulated
  with numpy for lanes at different times, against ``interp_knots`` of the
  plain version's per-lane (B, 1) times: bit for bit.
- The chunked weight-cotangent sums (truncation every 5 steps, chunks of 4,
  padding steps): the kernel's loop (each step's folded cotangents into a
  chunk partial, the partial into the sums at each chunk's first step)
  emulated with numpy on the per-step cotangents of ``step_vjp_split3``,
  against ``_replay3_bwd_plain``, and of ``step_vjp_split2(...,
  weights=True)`` against ``_replay2_bwd_plain`` (B4s): bit for bit.
- A bad ``route`` raises before any device is touched; CPU tensors take the
  plain version on every route and launch nothing (``replay3_bwd`` and
  ``replay2_bwd``).

The kernel itself runs only on the card (``tests/test_torch_cuda.py -k
"sde3_ksweep or sde_ksweep"``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.models import network as nw
from columnflow_torch.ops.interp import interp_knots, knot_constants

SMEM = 232448
_A16 = no._align16

# (columns, lanes) -> (C, LB, slots) of B4't's team plan with 4 inputs (the
# slice resident, the accumulators and the chunk partial in shared memory at
# every one), and the default route; whether the one-block B4't held the
# batch (its route before the cluster team took every width)
SDE_KSWEEP_PLANS = {
    (13, 1): ((8, 1, 2), "resident", True), (13, 4): ((8, 1, 2), "resident", True),
    (13, 8): ((8, 4, 2), "resident", True),
    (16, 1): ((16, 1, 2), "resident", True), (16, 4): ((16, 1, 2), "resident", True),
    (16, 8): ((16, 1, 2), "resident", True),
    (17, 1): ((8, 1, 2), "resident", True), (17, 4): ((8, 4, 2), "resident", True),
    (17, 8): ((8, 4, 2), "resident", False),
    (19, 1): ((8, 1, 2), "resident", True), (19, 4): ((8, 4, 2), "resident", True),
    (19, 8): ((8, 4, 2), "resident", False),
}


@pytest.mark.parametrize("columns,lanes", sorted(SDE_KSWEEP_PLANS))
def test_sde3_ksweep_plan_and_route(columns, lanes):
    P = 8 * columns
    (C, LB, slots), route, block = SDE_KSWEEP_PLANS[columns, lanes]
    p = no.ode_team_plan(P, 4, lanes, 3, no.SDE_KSWEEP)
    assert p.fits and not p.stream and p.accs and p.ipt == 1 and p.bytes <= SMEM
    assert (p.C, p.nc, p.NT, p.NB, p.LB, p.slots) == (C, P // C, 3, lanes, LB, slots)
    assert ns.sde3_bwd_route(P, 4, lanes) == route
    # the team is the default also where the one-block B4't did not hold the batch
    assert ns.sde3_block_fits(P, 4, lanes) == block
    # the bytes: the dopri5 sweep's plan of the same shape, plus the chunk
    # partials (P nc and n_in nc floats) and the lanes' four step times
    k = no.ode_team_plan(P, 4, lanes, 3, no.KSWEEP)
    assert k[:14] == p[:14] and k.accs
    nc = p.nc
    extra = (_A16(4 * 4 * nc) + _A16(4 * 4 * lanes)
             + _A16(4 * 5 * P * nc) - _A16(4 * 4 * P * nc))
    assert p.fixed - k.fixed == extra and p.bytes - k.bytes == extra
    assert no.t3k_planes(3, no.SDE_KSWEEP) == 5 and no.t3k_planes(3, no.KSWEEP) == 4


@pytest.mark.parametrize("lanes", [1, 4, 8, 16])
def test_sde3_ksweep_shared_memory_fits_at_every_width(lanes):
    """Wherever the team's plan fits (1-63 columns, 0, 4 and 16 inputs,
    resident and streamed), its invariants with five planes of weight
    cotangents and at most 232,448 bytes a block; at 4 lanes it takes every
    width the one-block B4't took."""
    from test_torch_ode_ksweep_team import _invariants

    for columns in range(1, 64):
        P = 8 * columns
        for n_in in (0, 4, 16):
            for stream in (False, True):
                p = no.ode_team_plan(P, n_in, lanes, 3, no.SDE_KSWEEP, stream)
                if p.fits:
                    _invariants(p, P, n_in, stream, planes=5)
                    assert p.fixed >= 4 * (3 * n_in * p.nc + 4 * lanes)
    if lanes == 4:
        assert all(ns.sde3_bwd_route(8 * c, 4, 4) == "resident" for c in range(1, 20))
        assert all(ns.sde3_bwd_route(8 * c, 4, 4) == (
            "streamed" if c % 2 and c >= 51 else "resident") for c in range(20, 64))


# (terms, columns, lanes) -> (C, LB, stream, slots, accs) of the team's plan
# with 4 inputs where the 8-block teams of B4't-team and B4s ran before
WIDE_PLANS = {
    (3, 20, 1): (16, 1, False, 2, True), (3, 20, 4): (16, 1, False, 2, True),
    (3, 20, 8): (16, 4, False, 2, True), (3, 24, 4): (16, 1, False, 2, True),
    (3, 32, 1): (16, 1, False, 2, True), (3, 32, 4): (16, 1, False, 2, True),
    (3, 32, 8): (16, 4, False, 2, False), (3, 48, 4): (16, 4, False, 2, False),
    (3, 48, 8): (16, 4, False, 1, False), (3, 63, 1): (8, 1, False, 1, False),
    (3, 63, 4): (8, 4, True, 1, False),
    (2, 13, 4): (8, 1, False, 2, True), (2, 20, 4): (16, 1, False, 2, True),
    (2, 24, 4): (16, 1, False, 2, True), (2, 32, 1): (16, 1, False, 2, True),
    (2, 32, 4): (16, 1, False, 2, True), (2, 32, 8): (16, 4, False, 2, True),
    (2, 48, 4): (16, 4, False, 2, False), (2, 63, 1): (8, 1, False, 2, False),
    (2, 63, 4): (8, 4, False, 1, False),
}


@pytest.mark.parametrize("terms,columns,lanes", sorted(WIDE_PLANS))
def test_sde_ksweep_plan_and_route_past_one_block(terms, columns, lanes):
    """The plan at the widths the 8-block teams ran (B4't-team from 20
    columns, B4s at every width): its shape, at most 232,448 bytes a block,
    the work tensor's planes where the accumulators leave shared memory, and
    the route that the wrappers take by shape."""
    P = 8 * columns
    C, LB, stream, slots, accs = WIDE_PLANS[terms, columns, lanes]
    p = no.ode_team_plan(P, 4, lanes, terms, no.SDE_KSWEEP)
    assert p.fits and p.ipt == 1 and p.bytes <= SMEM
    assert (p.C, p.nc, p.NT, p.NB, p.LB, p.stream, p.slots, p.accs) == (
        C, P // C, terms, lanes, LB, stream, slots, accs)
    assert ns.sde3_bwd_route(P, 4, lanes, terms) == ("streamed" if stream else "resident")
    assert no.t3k_planes(terms, no.SDE_KSWEEP) == terms + 2
    # the dopri5 sweep's plan of the same shape differs only past its head
    k = no.ode_team_plan(P, 4, lanes, terms, no.KSWEEP)
    assert k[:12] == p[:12]


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("lanes", [1, 4, 8])
def test_sde_ksweep_plan_fits_every_kernel_mode_width(terms, lanes):
    """From 13 through 63 columns the team's plan fits, within 232,448 bytes
    a block, its invariants held, wherever a thread forms the forward
    products of at most four lanes: everywhere at 1 and 4 lanes; at 8 lanes
    not at the odd widths from 33 columns (clusters of 8 with 33-63
    populations a block leave one lane group), where the route is the
    8-block team's ("team")."""
    from test_torch_ode_ksweep_team import _invariants

    for columns in range(13, 64):
        P = 8 * columns
        p = no.ode_team_plan(P, 4, lanes, terms, no.SDE_KSWEEP)
        refused = lanes == 8 and columns % 2 == 1 and columns >= 33
        assert p.fits != refused, columns
        route = ns.sde3_bwd_route(P, 4, lanes, terms)
        if refused:
            assert route == "team"
            continue
        _invariants(p, P, 4, p.stream, planes=terms + 2)
        assert p.bytes <= SMEM and p.ipt == 1 and p.LB in (1, 4)
        assert route == ("streamed" if p.stream else "resident")


def test_sde3_ksweep_plan_refuses_what_the_kernel_does_not_take():
    for NT in (1, 4):
        with pytest.raises(ValueError, match="two or three terms"):
            no.ode_team_plan(104, 4, 4, NT, no.SDE_KSWEEP)
    with pytest.raises(ValueError, match="multiple of 8"):
        no.ode_team_plan(100, 4, 4, 3, no.SDE_KSWEEP)
    with pytest.raises(ValueError, match="cluster"):
        no.ode_team_plan(104, 4, 4, 3, no.SDE_KSWEEP, C=8)
    # a resident team where the plan streams raises before any launch
    with pytest.raises(ValueError, match="streamed"):
        ns._sde3_ksweep_route("resident", 8 * 63, 4, 4)
    assert ns._sde3_ksweep_route(None, 104, 4, 4)[0] == "resident"
    assert ns._sde3_ksweep_route("block", 104, 4, 4) == ("block", None)
    route, plan = ns._sde3_ksweep_route(None, 8 * 32, 4, 4)
    assert route == "resident" and plan.C == 16 and not plan.stream
    assert ns._sde3_ksweep_route("team", 8 * 32, 4, 4) == ("team", None)
    route, plan = ns._sde3_ksweep_route("streamed", 104, 4, 4)
    assert route == "streamed" and plan.stream and plan.NT == 3


def _t3_knot(kv, knot_ts, b, t):
    """csrc/ode_team.cuh t3_knot for lane b at its time t, float32 operation
    for operation: out = v0, then per segment frac = min(max((t - c0) /
    span, 0), 1) and out = out + frac (v_k - v_{k-1})."""
    c0, span = knot_constants(knot_ts)
    f = np.float32
    out = kv[0, b].copy()
    for k in range(1, len(knot_ts)):
        frac = np.minimum(np.maximum((f(t) - f(c0[k - 1])) / f(span[k - 1]), f(0.0)), f(1.0))
        out = out + frac * (kv[k, b] - kv[k - 1, b])
    return out


def test_lanes_read_the_stimulus_at_their_own_times():
    """Four lanes at different times (before the first knot, on knots,
    between them, past the last): the kernel's per-lane interpolation
    against ``interp_knots`` at the plain version's (B, 1) times, and
    against each lane's own scalar lookup: 0 entries apart."""
    rng = np.random.default_rng(3)
    knot_ts = (0.0, 0.1, 0.35, 0.6, 1.0)
    B, n_in = 4, 4
    kv = rng.uniform(-5.0, 25.0, (len(knot_ts), B, n_in)).astype(np.float32)
    kvt = torch.from_numpy(kv)
    parted = 0
    for trial in range(200):
        t = rng.uniform(-0.1, 1.1, B).astype(np.float32)
        if trial % 5 == 0:
            t[rng.integers(B)] = np.float32(knot_ts[rng.integers(len(knot_ts))])
        want = interp_knots(torch.from_numpy(t)[:, None], knot_ts, kvt).numpy()
        got = np.stack([_t3_knot(kv, knot_ts, b, t[b]) for b in range(B)])
        parted += int((got != want).sum())
        for b in range(B):  # each lane alone: its row of the batched lookup
            alone = interp_knots(torch.tensor(float(t[b])), knot_ts, kvt[:, b]).numpy()
            parted += int((alone != want[b]).sum())
    assert parted == 0


def _setup(columns=13, B=4, n=12, lanes=True, seed=0, terms=3):
    cpa = {3: (2, 1), 13: (8, 4, 1)}[columns]
    gen = torch.Generator().manual_seed(seed)
    params, net = nw.build_column_network(ColumnConfig.load(), gen, columns_per_area=cpa,
                                          n_inputs=4)
    fc = nw.build_network_fused_consts(net)
    pw = {k: v.detach().contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    P = net.num_pops
    rng = np.random.default_rng(seed + 1)
    knot_ts = (0.0, 0.3, 0.32, 1.0)
    kv = torch.from_numpy(rng.uniform(0.0, 20.0, (len(knot_ts), B, 4)).astype(np.float32))
    sc = ns.SDEConsts(fc=fc, knot_ts=knot_ts)
    if lanes:  # each lane its own steps, crossing the knot at 0.3 at other times
        hs = rng.uniform(2e-4, 1e-2, (n, B)).astype(np.float32)
        t0s = (np.cumsum(hs, 0) - hs + 0.27).astype(np.float32)
    else:
        hs = np.full(n, 5e-3, np.float32)
        t0s = (0.28 + 5e-3 * np.arange(n)).astype(np.float32)
    h = hs if lanes else np.broadcast_to(hs[:, None], (n, B))
    dw = rng.standard_normal((n, B)).astype(np.float32) * np.sqrt(h)
    i10 = (h * (0.5 * dw + np.sqrt(h / 12.0) * rng.standard_normal((n, B)))).astype(np.float32)
    t0s, hs, dw, i10 = (torch.from_numpy(np.ascontiguousarray(x)) for x in (t0s, hs, dw, i10))
    n_real = n - 2  # the last two steps are padding
    if lanes:  # and lane 1 ends early: h = dw = i10 = 0 within n_real
        hs[n_real - 3:, 1] = 0.0
        dw[n_real - 3:, 1] = 0.0
        i10[n_real - 3:, 1] = 0.0
    y0 = torch.from_numpy(np.concatenate([rng.uniform(-20.0, 30.0, (B, P)),
                                          rng.uniform(0.0, 5.0, (B, P)),
                                          rng.uniform(0.0, 40.0, (B, P))], 1).astype(np.float32))
    w2 = {k: v.contiguous() for k, v in nw.prepare_premixed_split2(pw, fc)[0].items()}
    if terms == 3:
        ys = ns._replay3_fwd_plain(y0, t0s, hs, dw, i10, n_real, pw, sc, kv)
    else:
        ys = ns._replay_fwd_plain(y0, t0s, hs, dw, i10, n_real, w2, sc, kv)
    ysbar = torch.from_numpy(rng.standard_normal((n, B, 3 * P)).astype(np.float32))
    return dict(P=P, pw=pw, w2=w2, sc=sc, kv=kv, t0s=t0s, hs=hs, i10=i10, n_real=n_real,
                ys_prev=ys[:-1].contiguous(), ysbar=ysbar, B=B)


@pytest.mark.parametrize("lanes", [True, False])
def test_chunked_weight_cotangents_as_the_kernel_sums_them(lanes):
    """The kernel's loop over steps n_real-1..0 (the carry zeroed after
    every step k with k % 5 == 0, chunks of 4): each step's folded weight
    cotangents (``step_vjp_split3``, the per-step values the team forms)
    added in float32 to a chunk partial, the partial added to the sums at
    each chunk's first step (k % 4 == 0) and zeroed, emulated with numpy,
    against ``_replay3_bwd_plain``: ybar, d wT and d iwT bit for bit, and
    the sums over more than one chunk."""
    s = _setup(lanes=lanes)
    stride, chunk, B = 5, 4, s["B"]
    w3 = nw.prepare_premixed_split(s["pw"], s["sc"].fc)[0]
    f = np.float32
    ybar = torch.zeros_like(s["ys_prev"][0])
    dw, cw = np.zeros((s["P"],) * 2, f), np.zeros((s["P"],) * 2, f)
    diw, ciw = np.zeros((4, s["P"]), f), np.zeros((4, s["P"]), f)
    folds = 0
    for k in range(s["n_real"] - 1, -1, -1):
        t0, h = ns._lane_times(s["t0s"], s["hs"], k, B)
        ybar, g_w, g_iw = ns.step_vjp_split3(t0, h, s["ys_prev"][k], s["i10"][k, :, None],
                                             ybar + s["ysbar"][k], w3, s["sc"], s["kv"])
        if k % stride == 0:
            ybar = torch.zeros_like(ybar)
        sw, siw = cw + g_w.numpy(), ciw + g_iw.numpy()
        if k % chunk == 0:
            dw, diw = dw + sw, diw + siw
            folds += 1
        cw = np.zeros_like(cw) if k % chunk == 0 else sw
        ciw = np.zeros_like(ciw) if k % chunk == 0 else siw
    want = ns._replay3_bwd_plain(s["ys_prev"], s["ysbar"], s["t0s"], s["hs"], s["i10"],
                                 s["n_real"], stride, chunk, s["pw"], s["sc"], s["kv"])
    assert folds == 3 and bool(want[1].abs().sum() > 0) and bool(want[2].abs().sum() > 0)
    assert torch.equal(ybar, want[0])
    assert np.array_equal(dw, want[1].numpy()) and np.array_equal(diw, want[2].numpy())


def test_two_term_chunked_weight_cotangents_as_the_kernel_sums_them():
    """B4s's loop, as the three-term one above, on the two-term split: each
    step's folded weight cotangents (``step_vjp_split2(..., weights=True)``,
    whose two-term drift and VJP the team forms) added in float32 to a chunk
    partial, the partial added to the sums at each chunk's first step,
    emulated with numpy on per-lane grids, against ``_replay2_bwd_plain``:
    ybar, d wT and d iwT bit for bit."""
    s = _setup(terms=2)
    stride, chunk, B = 5, 4, s["B"]
    f = np.float32
    ybar = torch.zeros_like(s["ys_prev"][0])
    dw, cw = np.zeros((s["P"],) * 2, f), np.zeros((s["P"],) * 2, f)
    diw, ciw = np.zeros((4, s["P"]), f), np.zeros((4, s["P"]), f)
    folds = 0
    for k in range(s["n_real"] - 1, -1, -1):
        t0, h = ns._lane_times(s["t0s"], s["hs"], k, B)
        ybar, g_w, g_iw = ns.step_vjp_split2(t0, h, s["ys_prev"][k], s["i10"][k, :, None],
                                             ybar + s["ysbar"][k], s["w2"], s["sc"], s["kv"],
                                             weights=True)
        if k % stride == 0:
            ybar = torch.zeros_like(ybar)
        sw, siw = cw + g_w.numpy(), ciw + g_iw.numpy()
        if k % chunk == 0:
            dw, diw = dw + sw, diw + siw
            folds += 1
        cw = np.zeros_like(cw) if k % chunk == 0 else sw
        ciw = np.zeros_like(ciw) if k % chunk == 0 else siw
    want = ns._replay2_bwd_plain(s["ys_prev"], s["ysbar"], s["t0s"], s["hs"], s["i10"],
                                 s["n_real"], stride, chunk, s["w2"], s["sc"], s["kv"])
    assert folds == 3 and bool(want[1].abs().sum() > 0) and bool(want[2].abs().sum() > 0)
    assert torch.equal(ybar, want[0])
    assert np.array_equal(dw, want[1].numpy()) and np.array_equal(diw, want[2].numpy())


def test_sde2_routes_checked_before_the_device_and_plain_on_cpu():
    """``replay2_bwd``: a bad route (the three-term sweep's "block", the
    dopri5 sweeps' "team8") raises before any device is touched; on CPU
    tensors every route (and the default) runs ``_replay2_bwd_plain``, bit
    for bit, and launches nothing."""
    s = _setup(columns=3, n=8, terms=2)
    args = (s["ys_prev"], s["ysbar"], s["t0s"], s["hs"], s["i10"], s["n_real"], 3, 2, s["w2"],
            s["sc"], s["kv"])
    for bad in ("block", "team8", "ksweep", "Resident"):
        with pytest.raises(ValueError, match="route"):
            ns.replay2_bwd(*args, route=bad)
    before = dict(ns.LAUNCHES)
    want = ns._replay2_bwd_plain(*args)
    assert ns.SDE2_BWD_ROUTES == ("resident", "streamed", "team")
    for route in (None,) + ns.SDE2_BWD_ROUTES:
        got = ns.replay2_bwd(*args, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), route
    assert ns.LAUNCHES == before and "sde2_bwd_ksweep" in ns.LAUNCHES


def test_sde3_routes_checked_before_the_device_and_plain_on_cpu():
    """``replay3_bwd``: a bad route raises before any device is touched; on
    CPU tensors every route (and the default) runs the plain version, bit
    for bit, and launches nothing."""
    s = _setup(columns=3, n=8)
    args = (s["ys_prev"], s["ysbar"], s["t0s"], s["hs"], s["i10"], s["n_real"], 3, 2, s["pw"],
            s["sc"], s["kv"])
    for bad in ("team8", "ksweep", "Resident", "lanes"):
        with pytest.raises(ValueError, match="route"):
            ns.replay3_bwd(*args, route=bad)
    before = dict(ns.LAUNCHES)
    want = ns._replay3_bwd_plain(*args)
    for route in (None,) + ns.SDE3_BWD_ROUTES:
        got = ns.replay3_bwd(*args, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), route
    assert ns.LAUNCHES == before and "sde3_bwd_ksweep" in ns.LAUNCHES
