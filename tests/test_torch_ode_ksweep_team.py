"""The exact engine's kernel-mode reverse sweep (B8 at 13-17 columns,
B8t-team at 18-63) as one cluster team for the batch
(``kernels.network_ode.ode_replay_bwd`` on the card,
``cf_ode_replay_bwd_ksweep``): what the CPU can check of it.

- The team's shape (``ode_team_plan(..., KSWEEP)``) at 13, 17, 18, 24, 32
  and 63 columns for 1, 4 and 16 lanes: the cluster size, the populations a
  block owns, the items and forward lanes a thread holds, the slice
  resident or streamed, the accumulators in shared or device memory, the
  bytes a block asks for (at most 232,448); and at every width from 1
  through 312 columns with 0, 4 and 16 inputs, the plan's invariants
  wherever it fits.
- ``ode_bwd_route`` at those shapes: the team wherever its plan fits, the
  one-block B8 or the 8-block B8t-team elsewhere.
- The plan refuses the two-term split (B8s is not built on it), a P that is
  not a multiple of 8, and a cluster size of the caller's.
- A bad ``route`` raises before any device is touched; CPU tensors take the
  plain version on every route and launch nothing.
- The weight cotangents' contraction over the lanes in lane order (float64,
  each product exact) and the VJP's partial sums over a block's columns in
  rank order, emulated with numpy for four lanes at 13 and 32 columns,
  rounded to float32 as the plain version's float64 matmuls are: the
  entries that differ are counted (0).

The kernel itself runs only on the card (``tests/test_torch_cuda.py -k
ksweep``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.models import network as nw
from columnflow_torch.ops.transfer import compute_firing_rate

SMEM = 232448

# (columns, lanes) -> (C, LB, stream, accs, slots) of the kernel-mode sweep's
# plan with 4 inputs; None: the plan does not fit (more than four forward
# lanes a thread), and the route takes B8t-team
KSWEEP_PLANS = {
    (13, 1): (8, 1, False, True, 2), (13, 4): (8, 1, False, True, 2),
    (13, 16): (8, 4, False, False, 2),
    (17, 1): (8, 1, False, True, 2), (17, 4): (8, 4, False, True, 2), (17, 16): None,
    (18, 1): (16, 1, False, True, 2), (18, 4): (16, 1, False, True, 2),
    (18, 16): (16, 4, False, True, 2),
    (24, 1): (16, 1, False, True, 2), (24, 4): (16, 1, False, True, 2),
    (24, 16): (16, 4, False, True, 1),
    (32, 1): (16, 1, False, True, 2), (32, 4): (16, 1, False, True, 2),
    (32, 16): (16, 4, False, False, 1),
    (63, 1): (8, 1, False, False, 1), (63, 4): (8, 4, True, False, 1), (63, 16): None,
}


@pytest.mark.parametrize("columns,lanes", sorted(KSWEEP_PLANS))
def test_ksweep_plan_and_route(columns, lanes):
    P = 8 * columns
    plan = no.ode_team_plan(P, 4, lanes, 3, no.KSWEEP)
    want = KSWEEP_PLANS[columns, lanes]
    C = 16 if P % 16 == 0 else 8
    assert (plan.C, plan.nc, plan.NT, plan.NB) == (C, P // C, 3, lanes)
    route = no.ode_bwd_route(P, 4, lanes)
    if want is None:
        assert not plan.fits
        # B8's one block does not hold 16 lanes' states there either
        assert no.ode_block_bytes(P, 4, lanes, True) > SMEM and route == "team8"
        return
    assert plan.fits and plan.ipt == 1 and plan.bytes <= SMEM
    assert (plan.C, plan.LB, plan.stream, plan.accs, plan.slots) == want
    assert route == ("streamed" if plan.stream else "resident")


def test_ksweep_takes_every_kernel_mode_width_of_the_exact_engine():
    """The exact engine runs the kernel-mode sweep through 63 columns (its
    weights past 1 MiB take outer mode from 64); at 4 lanes the team takes
    every one of those widths, B8's one block none of them any more."""
    for columns in range(1, 64):
        assert no.ode_bwd_route(8 * columns, 4, 4) in ("resident", "streamed"), columns
    assert {no.ode_bwd_route(8 * c, 4, 4) for c in range(1, 51)} == {"resident"}
    assert no.ode_bwd_route(8 * 63, 4, 4) == "streamed"


def _invariants(p, P, n_in, stream):
    assert p.bytes <= SMEM and p.fits and p.ipt == 1 and p.NB * p.nc <= 512, p
    G8 = no._t3_chunks(P)
    # LB forward lanes a thread (1 or 4) cover the lanes with the 512 / (G8 nc)
    # thread groups a chunk-and-column layout leaves
    assert p.LB in (1, 4) and -(-p.NB // p.LB) <= 512 // (G8 * p.nc)
    assert p.G == -(-p.NB // p.LB) and p.gw == -(-p.LB * 3 // 2) * 2 and p.xs == p.G * p.gw
    # Lv threads a row: 512 / Lv rows cover P (one VJP pass a tile), or Lv = 1
    assert p.L * p.Lv == 32 and (512 // p.Lv >= P or p.Lv == 1)
    assert p.Lv == 32 or 512 // (2 * p.Lv) < P
    v = max(1, p.Lv // 2)
    assert p.rw % v == 0 and (p.rw // v) % 2 == 1 and 2 * p.rw >= 3 * p.nc
    # the slot holds the VJP's rate terms and partials, and the forward's
    # rate words and chunk sums
    assert p.slot >= 8 * P * p.NB + 8 * p.NB * p.nc * max(3 * p.C, 6 * G8)
    assert p.slot >= 4 * P * p.xs and p.slot % 16 == 0 and p.fixed % 16 == 0
    accs = 4 * 4 * P * p.nc
    assert p.fixed >= p.slots * p.slot + (accs if p.accs else 0) + 8 * n_in * p.nc
    if p.stream:
        assert p.S >= min(2, p.T) and p.R % 8 == 0 and p.R <= max(512 // p.Lv, 32)
        assert (p.R * 4 * p.rw) % 16 == 0 and p.T * p.R >= P > (p.T - 1) * p.R
        assert p.bytes == p.fixed + p.S * p.R * 4 * p.rw
    else:
        assert (p.R, p.T, p.S) == (P, 1, 1) and not stream
        assert p.bytes == p.fixed + P * 4 * p.rw


@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_ksweep_shared_memory_fits_at_every_width(lanes):
    fits = set()
    for columns in range(1, 313):
        P = 8 * columns
        for n_in in (0, 4, 16):
            for stream in (False, True):
                p = no.ode_team_plan(P, n_in, lanes, 3, no.KSWEEP, stream)
                if p.fits:
                    _invariants(p, P, n_in, stream)
                    if n_in == 4 and not stream:
                        fits.add(columns)
                else:
                    assert no.ode_bwd_route(P, n_in, lanes) in ("block", "team8")
    # 16 lanes: one item a thread and four forward lanes a thread hold
    # through 16 columns, and at the even widths (clusters of 16) through 32
    if lanes == 16:
        assert fits == set(range(1, 17)) | set(range(18, 33, 2))
    else:
        assert set(range(1, 64)) <= fits


def test_ksweep_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="B8s"):
        no.ode_team_plan(104, 4, 4, 2, no.KSWEEP)  # the two-term split
    with pytest.raises(ValueError, match="multiple of 8"):
        no.ode_team_plan(100, 4, 4, 3, no.KSWEEP)
    with pytest.raises(ValueError, match="cluster"):
        no.ode_team_plan(104, 4, 4, 3, no.KSWEEP, C=8)
    with pytest.raises(ValueError):
        no.ode_team_plan(104, 4, 0, 3, no.KSWEEP)
    # routes the team does not take at a shape raise before any launch
    with pytest.raises(ValueError, match="resident"):
        no._ksweep_route("resident", 504, 4, 4)  # 63 columns at 4 lanes stream
    with pytest.raises(ValueError, match="team8"):
        no._ksweep_route("streamed", 136, 4, 16)  # 17 columns at 16 lanes
    assert no._ksweep_route(None, 136, 4, 16) == ("team8", None)
    assert no._ksweep_route("block", 104, 4, 4) == ("block", None)
    assert no._ksweep_route(None, 104, 4, 4)[0] == "resident"


def _network(columns):
    cpa = {13: (8, 4, 1), 32: (16, 8, 8)}[columns]
    params, net = nw.build_column_network(ColumnConfig.load(), torch.Generator().manual_seed(0),
                                          columns_per_area=cpa, n_inputs=4)
    fc = nw.build_network_fused_consts(net)
    return net.num_pops, nw.premix_network_weights(params, net), fc


def test_routes_checked_before_the_device_and_plain_on_cpu():
    """A bad route raises before any device is touched; on CPU tensors every
    route runs the plain version (bit for bit with ``_ode_replay_bwd_plain``)
    and launches nothing."""
    P, pw, fc = _network(13)
    pw = {k: v.contiguous() for k, v in pw.items()}
    sc = no.SDEConsts(fc=fc, knot_ts=(0.0, 0.5, 1.0))
    rng = np.random.default_rng(5)
    B, n = 2, 3
    kv = torch.from_numpy(rng.uniform(0.0, 20.0, (3, B, 4)).astype(np.float32))
    y0 = torch.from_numpy(rng.uniform(-5.0, 5.0, (B, 3 * P)).astype(np.float32))
    st = torch.tensor([0.0, 1e-4, 3e-4, 6e-4], dtype=torch.float32)
    w3 = no._w3(pw, sc)
    ys, _ = no._ode_replay_fwd_plain(y0, st, w3, sc, kv)
    cobar = torch.from_numpy(rng.standard_normal((n, 5, B, 3 * P)).astype(np.float32))
    for bad in ("team", "team16", "Resident", "ksweep"):
        with pytest.raises(ValueError, match="route"):
            no.ode_replay_bwd(ys, cobar, st, pw, sc, kv, route=bad)
    before = dict(no.LAUNCHES)
    want = no._ode_replay_bwd_plain(ys, cobar, st, w3, sc, kv)
    for route in (None,) + no.ODE_BWD_ROUTES:
        got = no.ode_replay_bwd(ys, cobar, st, pw, sc, kv, route=route)
        assert all(torch.equal(g, x) for g, x in zip(got, want)), route
    assert no.LAUNCHES == before


def _butterfly(acc):
    L, idx, off = acc.shape[0], np.arange(acc.shape[0]), acc.shape[0] // 2
    while off:
        acc = acc + acc[idx ^ off]
        off //= 2
    return acc[0]


def emulate_vjp(plan, c, W):
    """c (NB, P), W (P, P) float64: the team's float64 sums c W^T for every
    lane and row: block r sums its own columns, thread l of a row the
    columns j = l mod Lv in order, a butterfly over the Lv threads, then the
    owner adds the blocks' partials in rank order."""
    C, nc, Lv = plan.C, plan.nc, plan.Lv
    total = np.zeros((c.shape[0], W.shape[0]))
    for r in range(C):
        acc = np.zeros((Lv, c.shape[0], W.shape[0]))
        for i in range(-(-nc // Lv)):
            j = np.arange(Lv) + Lv * i
            ok = j < nc
            jj = np.where(ok, r * nc + j, 0)
            prod = c[:, jj].T[:, :, None] * W[:, jj].T[:, None, :]
            acc = acc + np.where(ok[:, None, None], prod, 0.0)
        total = total + _butterfly(acc)
    return total


def emulate_weight_cotangent(x, c):
    """x, c (NB, P) float64: the entries x^T c summed over the lanes in lane
    order, each product exact."""
    s = np.zeros((x.shape[1], c.shape[1]))
    for b in range(x.shape[0]):
        s = s + x[b][:, None] * c[b][None, :]
    return s


@pytest.mark.parametrize("columns", [13, 32])
def test_ksweep_summation_order_rounds_as_the_plain_matmul(columns):
    """Four lanes, 64 batches of rates and cotangents from a numpy seed:
    the VJP's sums (each lane's rows over the blocks' columns) and the
    weight cotangents' contraction over the lanes, emulated in float64 and
    rounded to float32, against the plain version's float64 matmuls rounded
    the same way: 0 entries differ."""
    P, pw, fc = _network(columns)
    w3 = nw.prepare_premixed_split(pw, fc)[0]
    plan = no.ode_team_plan(P, 4, 4, 3, no.KSWEEP)
    rng = np.random.default_rng(columns + 11)
    mismatches = {}
    for batch in range(64):
        v_minus_a = rng.uniform(-40.0, 40.0, (4, P)).astype(np.float32)
        x = nw.split3_terms(compute_firing_rate(torch.from_numpy(v_minus_a)))
        c = torch.from_numpy((rng.standard_normal((4, P)) * 10.0 ** rng.uniform(-3, 3, (4, 1)))
                             .astype(np.float32))
        for k in ("wT_hi", "wT_mid", "wT_lo"):
            W = w3[k].double()
            got = emulate_vjp(plan, c.double().numpy(), W.numpy()).astype(np.float32)
            want = torch.matmul(c.double(), W.T).float().numpy()
            mismatches[k] = mismatches.get(k, 0) + int((got != want).sum())
        for t, xt in zip(("x_hi", "x_mid", "x_lo"), x):
            got = emulate_weight_cotangent(xt.double().numpy(), c.double().numpy())
            want = torch.matmul(xt.double().T, c.double()).float().numpy()
            mismatches[t] = mismatches.get(t, 0) + int((got.astype(np.float32) != want).sum())
    assert mismatches == dict.fromkeys(mismatches, 0), mismatches
