"""B6, B7t-team, B7 split2, B8' and B8't as cluster teams
(``kernels.network_ode`` ``ode_select``, ``ode_attempt``, ``ode_replay_fwd``,
``ode_replay_fwd_split2`` and ``ode_replay_bwd_emit`` on the card): what the
CPU can check of them.

- The team's shape (``ode_team_plan``): the cluster size, the route
  (resident, streamed or team8) at 13, 18, 32, 63, 104 and 312 columns for
  the selection's 1, 4, 8 and 16 lanes and the sweep's two and three terms;
  the shared-memory bytes a block asks for, under the 232,448 a block can
  use at every width from 1 through 312 columns, and the tiling the
  streamed ring needs.
- ``ode_team_pack``'s per-block layout of the splits' bf16 terms, and the
  kernels' exact float64 of a bf16 from its bits (the value times 2^-896)
  against the other operand times 2^896.
- The kernels' summation order, emulated in float64 with numpy: the forward
  products (each lane's column sums every L-th row in order, then a
  butterfly over the L lanes) and the VJP products (each row's sums over a
  block's columns, every Lv-th column in order, a butterfly over the Lv
  lanes, then the blocks' partials in rank order), on the three-term split
  of the parity network at 104 and 312 columns for 64 rate and 64
  cotangent vectors from a numpy seed, against the plain versions' float64
  matmul (at 312 columns on four blocks' columns and every fourth row).
  Every product is exact in float64, so the sums differ only in the last
  bits of a float64; rounded to float32 they agree bit for bit on all of
  these vectors (the test counts the entries that do not: 0).
- The replay's plan (``ode_team_plan(..., REPLAY)``) and route
  (``ode_replay_route``): the cluster size, route and the float32 slice at
  13, 24, 32, 63, 104 and 312 columns for 1, 4, 8 and 16 lanes on two and
  three terms, with the H100's cluster capacity given (7 clusters of 16,
  15 of 8 at 104 columns: 8 and 16 lanes take clusters of 8); the
  shared-memory bytes at every width from 1 through 312 columns with 0, 4
  and 16 inputs; the cluster of 8 wherever the occupancy reader holds fewer
  clusters of 16 than lanes; ``ode_replay_pack``'s layout of the float32
  wT; the replay's sum order (the 8-block team's: contiguous chunks of
  rows, each in order, the chunks' sums in order) emulated with numpy on
  the six products at 104 and 312 columns against the plain matmul,
  rounded to float32 (0 entries differ).
- A bad ``route`` raises before any device is touched; CPU tensors take the
  plain version of the replay on every route.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.models import network as nw
from columnflow_torch.ops.transfer import compute_firing_rate

SMEM = 232448
N_VEC = 64

# (columns, lanes) -> route of the selection with 4 inputs
SELECT_ROUTES = {
    (13, 1): "resident", (13, 4): "resident", (13, 8): "resident", (13, 16): "resident",
    (18, 1): "resident", (18, 4): "resident", (18, 8): "resident", (18, 16): "resident",
    (32, 1): "resident", (32, 4): "resident", (32, 8): "resident", (32, 16): "resident",
    (63, 1): "streamed", (63, 4): "streamed", (63, 8): "streamed", (63, 16): "streamed",
    (104, 1): "streamed", (104, 4): "streamed", (104, 8): "streamed", (104, 16): "streamed",
    (312, 1): "streamed", (312, 4): "streamed", (312, 8): "team8", (312, 16): "team8",
}
SWEEP_ROUTES = {(13, 2): "resident", (13, 3): "resident", (18, 2): "resident",
                (18, 3): "resident", (32, 2): "resident", (32, 3): "resident",
                (63, 2): "resident", (63, 3): "resident", (104, 2): "resident",
                (104, 3): "streamed", (312, 2): "streamed", (312, 3): "streamed"}


@pytest.mark.parametrize("columns,lanes", sorted(SELECT_ROUTES))
def test_selection_cluster_size_and_route(columns, lanes):
    P = 8 * columns
    plan = no.ode_team_plan(P, 4, lanes, 3, False)
    assert (plan.C, plan.nc, plan.NB) == (16 if P % 16 == 0 else 8, P // plan.C, lanes)
    # four lanes a thread where a thread owns one item, two where it owns two
    assert plan.LB == (4 if plan.ipt == 1 else 2)
    assert no.ode_team_route(P, 4, lanes, 3, False) == SELECT_ROUTES[columns, lanes]
    if plan.fits:
        # one cluster for the batch; a thread owns at most two (lane, population) items
        assert plan.ipt <= 2 and plan.bytes <= SMEM
        assert plan.G * plan.nc * plan.L <= 512 and lanes * plan.nc <= 512 * plan.ipt


@pytest.mark.parametrize("columns,terms", sorted(SWEEP_ROUTES))
def test_sweep_cluster_size_and_route(columns, terms):
    P = 8 * columns
    plan = no.ode_team_plan(P, 4, 1, terms, True)
    assert (plan.C, plan.NB, plan.LB, plan.ipt, plan.fits) == (16 if P % 16 == 0 else 8, 1, 1, 1,
                                                               True)
    assert no.ode_team_route(P, 4, 1, terms, True) == SWEEP_ROUTES[columns, terms]
    # the exchange slot holds the VJP's (NT, C, nc) float64 partials
    assert plan.slot >= 8 * terms * P and plan.bytes <= SMEM
    # four lanes take 4 clusters of C blocks: at most 64 of the H100's 132 SMs
    assert 4 * plan.C <= 64


def _invariants(p, P, stream):
    assert p.bytes <= SMEM, p
    v = max(1, p.Lv // 2)
    assert p.L * p.Lv == 32 and p.rw % v == 0 and (p.rw // v) % 2 == 1
    assert 2 * p.rw >= p.NT * p.nc
    assert p.xs % 2 == 0 and p.gw % 2 == 0 and p.gw >= p.LB * p.NT
    assert p.fixed % 16 == 0 and p.slot % 16 == 0 and (P * 4 * p.rw) % 16 == 0
    if p.stream:
        assert p.S >= min(2, p.T) and p.R % p.L == 0 and p.R % 8 == 0
        assert (p.R * 4 * p.rw) % 16 == 0 and p.T * p.R >= P > (p.T - 1) * p.R
        assert p.bytes == p.fixed + p.S * p.R * 4 * p.rw
    else:
        assert (p.R, p.T, p.S, p.slots) == (P, 1, 1, 2) and not stream
        assert p.bytes == p.fixed + P * 4 * p.rw


@pytest.mark.parametrize("kind", ["select4", "select16", "sweep2", "sweep3"])
def test_shared_memory_fits_at_every_width(kind):
    NB, NT, sweep = {"select4": (4, 3, False), "select16": (16, 3, False),
                     "sweep2": (1, 2, True), "sweep3": (1, 3, True)}[kind]
    for columns in range(1, 313):
        P = 8 * columns
        for n_in in (0, 4, 16):
            for stream in (False, True):
                p = no.ode_team_plan(P, n_in, NB, NT, sweep, stream)
                if p.fits:
                    _invariants(p, P, stream)
                else:
                    assert no.ode_team_route(P, n_in, NB, NT, sweep) == "team8"
    # the sweep takes every width; the selection of four lanes every width
    # where a thread owns at most two items (all but odd widths past 256
    # columns, where clusters of 8 leave a block more than 256 populations)
    fits = {c for c in range(1, 313) if no.ode_team_plan(8 * c, 4, NB, NT, sweep).fits}
    if kind.startswith("sweep"):
        assert fits == set(range(1, 313))
    elif kind == "select4":
        assert fits == set(range(1, 313)) - set(range(257, 313, 2))


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        no.ode_team_plan(100, 4, 4, 3, False)  # P not a multiple of 8
    with pytest.raises(ValueError):
        no.ode_team_plan(104, 17, 4, 3, False)
    with pytest.raises(ValueError):
        no.ode_team_plan(104, 4, 4, 3, True)  # the sweep holds one lane
    with pytest.raises(ValueError):
        no.ode_team_plan(104, 4, 1, 4, True)


def _network(columns):
    cpa = {13: (8, 4, 1), 32: (16, 8, 8), 104: (64, 32, 8), 312: (192, 96, 24)}[columns]
    params, net = nw.build_column_network(ColumnConfig.load(), torch.Generator().manual_seed(0),
                                          columns_per_area=cpa, n_inputs=4)
    fc = nw.build_network_fused_consts(net)
    return net.num_pops, nw.premix_network_weights(params, net), fc


@pytest.mark.parametrize("columns", [13, 32])
def test_pack_layout_against_the_split(columns):
    P, pw, fc = _network(columns)
    w3 = nw.prepare_premixed_split(pw, fc)[0]
    w2 = nw.prepare_premixed_split2(pw, fc)[0]
    for w, terms, sweep, NB in ((w3, ("wT_hi", "wT_mid", "wT_lo"), False, 4),
                                (w2, ("wT_hi", "wT_mid"), True, 1)):
        plan = no.ode_team_plan(P, 4, NB, len(terms), sweep)
        pk = no.ode_team_pack(w, P, plan)
        assert pk.dtype == torch.int32 and tuple(pk.shape) == (plan.C, P, plan.rw)
        half = pk.view(torch.bfloat16)  # (C, P, 2 rw)
        nc = plan.nc
        for r in range(plan.C):
            cols = slice(r * nc, (r + 1) * nc)
            for t, name in enumerate(terms):
                assert torch.equal(half[r, :, t * nc:(t + 1) * nc], w[name][:, cols])
            assert not half[r, :, len(terms) * nc:].float().any()


def _scaled(h):
    """The kernels' float64 of bf16 bits h (int64 tensor of 16-bit values):
    sign, exponent and mantissa placed in a double's, i.e. w 2^-896."""
    hi = ((h << 16) & 0x80000000) | ((h & 0x7FFF) << 13)
    return (hi << 32).view(torch.float64)


def test_scaled_bf16_products_are_exact():
    """Every bf16 weight (all 65536 bit patterns but the non-finite) times
    an operand scaled by 2^896 (finite float32 values, bf16 rate terms and
    cotangents from 1e-38 to 3e38) gives the unscaled float64 product bit
    for bit."""
    bits = torch.arange(65536, dtype=torch.int64)
    w = bits.to(torch.int16).view(torch.bfloat16)
    keep = torch.isfinite(w.float())
    w, ws = w[keep].double(), _scaled(bits[keep])
    assert torch.equal(ws * 2.0 ** 896, w)  # exact: a power of two
    rng = np.random.default_rng(7)
    ops = torch.from_numpy(np.concatenate([
        rng.standard_normal(64) * 10.0 ** rng.uniform(-38, 38, 64),
        [3.4e38, -3.4e38, 1.2e-38, 1e-45, 0.0, 1.0]]).astype(np.float32)).double()
    for x in ops:
        assert torch.equal((x * 2.0 ** 896) * ws, x * w), float(x)


def _butterfly(acc):
    """The xor butterfly of shuffles over the lanes axis 0: each lane adds
    its partner's value at distances L/2 .. 1; every lane ends with the same
    float64 (addition commutes), returned."""
    L, idx, off = acc.shape[0], np.arange(acc.shape[0]), acc.shape[0] // 2
    while off:
        acc = acc + acc[idx ^ off]
        off //= 2
    return acc[0]


def emulate_forward(L, x, W):
    """x (N, P), W (P, nc) float64: the team's float64 sums x W, column by
    column: lane l of a column sums the rows k = l mod L in order."""
    P = W.shape[0]
    acc = np.zeros((L, x.shape[0], W.shape[1]))
    for i in range(-(-P // L)):
        k = np.arange(L) + L * i
        ok = k < P
        kk = np.where(ok, k, 0)
        prod = x[:, kk].T[:, :, None] * W[kk][:, None, :]
        acc = acc + np.where(ok[:, None, None], prod, 0.0)
    return _butterfly(acc)


def emulate_vjp(plan, c, W):
    """c (N, P), W (rows, P) float64 (every row, or some): the team's
    float64 sums c W^T, row by row: block r sums its own columns, lane l of
    a row the columns j = l mod Lv in order, a butterfly over the Lv lanes,
    then the owner adds the blocks' partials in rank order."""
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


def _split3_inputs(columns):
    P, pw, fc = _network(columns)
    w3 = nw.prepare_premixed_split(pw, fc)[0]
    rng = np.random.default_rng(columns + 1)
    v_minus_a = rng.uniform(-40.0, 40.0, (N_VEC, P)).astype(np.float32)
    x = nw.split3_terms(compute_firing_rate(torch.from_numpy(v_minus_a)))
    c = torch.from_numpy((rng.standard_normal((N_VEC, P)) * 10.0 ** rng.uniform(-3, 3, (N_VEC, 1)))
                         .astype(np.float32))
    return P, w3, x, c


@pytest.mark.parametrize("columns", [104, 312])
def test_summation_order_rounds_as_the_plain_matmul(columns):
    """Every column and row at 104 columns; at 312 (to keep the test quick)
    the columns of four blocks of the sixteen and every fourth row."""
    P, w3, (x_hi, x_mid, x_lo), c = _split3_inputs(columns)
    blocks = range(16) if columns == 104 else (0, 5, 10, 15)
    rows = np.arange(0, P, 1 if columns == 104 else 4)
    W = {k: w3[k].double() for k in ("wT_hi", "wT_mid", "wT_lo")}
    products = (("x_hi W_lo", x_hi, "wT_lo"), ("x_mid W_mid", x_mid, "wT_mid"),
                ("x_lo W_hi", x_lo, "wT_hi"), ("x_hi W_mid", x_hi, "wT_mid"),
                ("x_mid W_hi", x_mid, "wT_hi"), ("x_hi W_hi", x_hi, "wT_hi"))
    mismatches = {}
    # the forward products' lanes per column: the selection's 4 and 16
    # lanes and the sweep's single one (each lane's sum is the same order)
    Ls = {no.ode_team_plan(P, 4, NB, 3, sweep).L for NB, sweep in ((4, False), (16, False),
                                                                   (1, True))}
    for L in sorted(Ls):
        plan = no.ode_team_plan(P, 4, 1, 3, True)
        for name, x, k in products:
            cols = np.concatenate([np.arange(r * plan.nc, (r + 1) * plan.nc) for r in blocks])
            got = np.concatenate([emulate_forward(L, x.double().numpy(),
                                                  W[k][:, r * plan.nc:(r + 1) * plan.nc].numpy())
                                  for r in blocks], axis=1).astype(np.float32)
            want = torch.matmul(x.double(), W[k]).float().numpy()[:, cols]
            mismatches[f"L={L} {name}"] = int((got != want).sum())
    for NT in (2, 3):
        plan = no.ode_team_plan(P, 4, 1, NT, True)
        for k in ("wT_hi", "wT_mid", "wT_lo")[:NT]:
            got = emulate_vjp(plan, c.double().numpy(), W[k].numpy()[rows]).astype(np.float32)
            want = torch.matmul(c.double(), W[k].T).float().numpy()[:, rows]
            mismatches[f"NT={NT} c {k}^T"] = int((got != want).sum())
    assert mismatches == dict.fromkeys(mismatches, 0), mismatches


def emulate_chunks(G, x, W):
    """x (N, P), W (P, nc) float64: the replay's float64 sums x W (team8's
    order, ``_t3_chunks``): the rows in G contiguous chunks, each summed in
    order, the chunks' sums added in chunk order."""
    P = W.shape[0]
    kc = -(-P // G)
    total = None
    for g in range(G):
        part = np.zeros((x.shape[0], W.shape[1]))
        for k in range(g * kc, min(P, (g + 1) * kc)):
            part = part + x[:, k:k + 1] * W[k][None, :]
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("columns", [104, 312])
def test_replay_chunk_order_rounds_as_the_plain_matmul(columns):
    """The replay's sum order (team8's: 4 chunks at 104 columns, 1 at 312)
    emulated in float64 with numpy on the three-term split's six products
    for 64 rate vectors (at 312 columns the columns of four blocks), against
    the plain versions' float64 matmul, rounded to float32: the entries that
    differ are counted (0)."""
    P, w3, (x_hi, x_mid, x_lo), _ = _split3_inputs(columns)
    G = no._t3_chunks(P)
    assert G == {104: 4, 312: 1}[columns]
    nc = P // 16
    cols = np.concatenate([np.arange(r * nc, (r + 1) * nc)
                           for r in (range(16) if columns == 104 else (0, 5, 10, 15))])
    W = {k: w3[k].double().numpy()[:, cols] for k in ("wT_hi", "wT_mid", "wT_lo")}
    products = (("x_hi W_lo", x_hi, "wT_lo"), ("x_mid W_mid", x_mid, "wT_mid"),
                ("x_lo W_hi", x_lo, "wT_hi"), ("x_hi W_mid", x_hi, "wT_mid"),
                ("x_mid W_hi", x_mid, "wT_hi"), ("x_hi W_hi", x_hi, "wT_hi"))
    mismatches = {}
    for name, x, k in products:
        got = emulate_chunks(G, x.double().numpy(), W[k]).astype(np.float32)
        want = torch.matmul(x.double(), w3[k].double()).float().numpy()[:, cols]
        mismatches[name] = int((got != want).sum())
    assert mismatches == dict.fromkeys(mismatches, 0), mismatches


@pytest.mark.parametrize("entry", ["select", "attempt", "emit"])
def test_routes_are_checked_before_the_device(entry):
    P, B = 104, 2
    y = torch.zeros(B, 3 * P)
    kv = torch.zeros(2, B, 4)
    cfg = no.ODESelectConfig(0.0, 1.0)
    t = torch.zeros(())
    with pytest.raises(ValueError, match="route"):
        if entry == "select":
            no.ode_select(y, {}, None, kv, cfg, route="block")
        elif entry == "attempt":
            no.ode_attempt(t, y, y, t, {}, None, kv, cfg, route="team16")
        else:
            no.ode_replay_bwd_emit(y[None], None, None, {}, None, kv, route="resident16")


def h100_clusters(C):
    """The H100's capacity for the replay teams at 104 columns (one block an
    SM, a cluster inside a GPC; cudaOccupancyMaxActiveClusters on the card):
    7 clusters of 16 blocks, 15 of 8."""
    return 7 if C == 16 else 15


# (columns, lanes, terms) -> (route, C, f32) of the replay with 4 inputs and
# h100_clusters: clusters of 16 where 16 divides P and 7 lanes' clusters or
# fewer are asked for; the three-term replay keeps the float32 wT where
# that slice stays resident and the bf16 terms' would not (63 columns on
# clusters of 8, 104 on clusters of 16); resident through 63 columns and
# at 104 with C = 16.
REPLAY_ROUTES = {}
for _cols in (13, 24, 32, 63, 104, 312):
    for _lanes in (1, 4, 8, 16):
        for _terms in (2, 3):
            _C = 16 if (8 * _cols) % 16 == 0 and _lanes <= 7 else 8
            _res = _cols <= 63 or (_cols == 104 and _C == 16)
            REPLAY_ROUTES[_cols, _lanes, _terms] = (
                "resident" if _res else "streamed", _C,
                _terms == 3 and (_cols == 63 or (_cols == 104 and _C == 16)))


@pytest.mark.parametrize("columns,lanes,terms", sorted(REPLAY_ROUTES))
def test_replay_cluster_size_and_route(columns, lanes, terms):
    P = 8 * columns
    route, C = no.ode_replay_route(P, 4, lanes, terms, h100_clusters)
    want_route, want_C, want_f32 = REPLAY_ROUTES[columns, lanes, terms]
    assert (route, C) == (want_route, want_C)
    assert no.ode_replay_cluster(P, lanes, h100_clusters) == C
    plan = no.ode_team_plan(P, 4, 1, terms, no.REPLAY, C=C)
    assert (plan.C, plan.nc, plan.NT, plan.NB, plan.LB, plan.ipt) == (C, P // C, terms, 1, 1, 1)
    assert plan.fits and plan.stream == (route == "streamed") and plan.f32 == want_f32
    # the exchange slot holds the rates' terms alone, no VJP partials (the
    # sweep's slot does)
    assert plan.slot == -(-4 * P * plan.xs // 16) * 16 and plan.bytes <= SMEM
    sweep = no.ode_team_plan(P, 4, 1, terms, no.SWEEP, C=C)
    assert plan.slot < sweep.slot and plan.L == sweep.L


def _replay_invariants(p, P, stream):
    assert p.bytes <= SMEM and p.fits and p.ipt == 1 and p.LB == 1, p
    # the chunk sums of team8's order (G, NP, nc float64) before the weights;
    # a thread for each (chunk, own column)
    G = no._t3_chunks(P)
    assert 1 <= G <= 8 and p.nc * G <= 512
    assert p.fixed >= 2 * p.slot + 8 * G * (6 if p.NT == 3 else 3) * p.nc
    v = p.Lv if p.f32 else max(1, p.Lv // 2)
    assert p.L * p.Lv == 32 and p.rw % v == 0 and (p.rw // v) % 2 == 1
    assert (p.rw >= p.nc) if p.f32 else (2 * p.rw >= p.NT * p.nc)
    assert p.xs % 2 == 0 and p.gw % 2 == 0 and p.gw >= p.NT and p.slot == -(-4 * P * p.xs // 16) * 16
    assert p.fixed % 16 == 0 and (P * 4 * p.rw) % 16 == 0
    if p.stream:
        assert p.S >= min(2, p.T) and p.R % p.L == 0 and p.R % 8 == 0
        assert (p.R * 4 * p.rw) % 16 == 0 and p.T * p.R >= P > (p.T - 1) * p.R
        assert p.bytes == p.fixed + p.S * p.R * 4 * p.rw
    else:
        assert (p.R, p.T, p.S, p.slots) == (P, 1, 1, 2) and not stream
        assert p.bytes == p.fixed + P * 4 * p.rw


@pytest.mark.parametrize("terms", [2, 3])
def test_replay_shared_memory_fits_at_every_width(terms):
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
                    p = no.ode_team_plan(P, n_in, 1, terms, no.REPLAY, stream, C)
                    _replay_invariants(p, P, stream)
                    if p.f32:
                        f32.add((columns, C, n_in))
                        assert terms == 3
                        bf16 = p.fixed + P * 4 * no._t3_row_words(p.nc, 3, p.Lv, False)
                        assert bf16 > SMEM and p.fixed + P * 4 * p.rw <= SMEM
    if terms == 3:
        # with 4 inputs: clusters of 16 from 90 through 104 columns (even; the
        # bf16 terms fit through 88, the float32 wT through 104), of 8 from 63
        # through 72
        assert {c for c, C, n_in in f32 if C == 16 and n_in == 4} == set(range(90, 105, 2))
        assert {c for c, C, n_in in f32 if C == 8 and n_in == 4} == set(range(63, 73))


def test_replay_cluster_of_8_where_the_card_holds_fewer_clusters_of_16():
    P = 832
    assert no.ode_replay_cluster(P, 4, lambda C: 7) == 16
    assert no.ode_replay_cluster(P, 7, lambda C: 7) == 16
    assert no.ode_replay_cluster(P, 8, lambda C: 7) == 8
    assert no.ode_replay_cluster(P, 4, lambda C: 3 if C == 16 else 16) == 8
    assert no.ode_replay_cluster(504, 1, lambda C: 100) == 8  # 16 does not divide P
    assert no.ode_replay_route(P, 4, 16, 3, h100_clusters) == ("streamed", 8)
    assert no.ode_replay_route(P, 4, 16, 2, h100_clusters) == ("streamed", 8)


def test_replay_pack_layout_against_wT():
    P, pw, fc = _network(104)
    plan = no.ode_team_plan(P, 4, 1, 3, no.REPLAY)
    assert plan.f32 and not plan.stream
    pk = no.ode_replay_pack(pw["wT"], P, plan)
    assert pk.dtype == torch.int32 and tuple(pk.shape) == (plan.C, P, plan.rw)
    words = pk.view(torch.float32)
    nc = plan.nc
    for r in range(plan.C):
        assert torch.equal(words[r, :, :nc], pw["wT"][:, r * nc:(r + 1) * nc])
        assert not words[r, :, nc:].any()


@pytest.mark.parametrize("split", ["split3", "split2"])
def test_replay_routes_checked_before_the_device_and_plain_on_cpu(split):
    """A bad route raises before any device is touched; on CPU tensors every
    route runs the plain version (bit for bit with ``_ode_replay_fwd_plain``)
    and launches nothing."""
    P, pw, fc = _network(13)
    pw = {k: v.contiguous() for k, v in pw.items()}
    sc = no.SDEConsts(fc=fc, knot_ts=(0.0, 0.5, 1.0))
    kv = torch.from_numpy(np.random.default_rng(3).uniform(0.0, 20.0, (3, 2, 4))
                          .astype(np.float32))
    y0 = torch.from_numpy(np.random.default_rng(4).uniform(-5.0, 5.0, (2, 3 * P))
                          .astype(np.float32))
    st = torch.tensor([0.0, 1e-4, 3e-4, 6e-4], dtype=torch.float32)
    w = {k: v.contiguous() for k, v in (nw.prepare_premixed_split if split == "split3"
                                         else nw.prepare_premixed_split2)(pw, fc)[0].items()}

    def call(route):
        if split == "split3":
            return no.ode_replay_fwd(y0, st, pw, sc, kv, route=route)
        return no.ode_replay_fwd_split2(y0, st, w, sc, kv, route=route)

    for bad in ("block", "team16", "Resident"):
        with pytest.raises(ValueError, match="route"):
            call(bad)
    before = dict(no.LAUNCHES)
    want = no._ode_replay_fwd_plain(y0, st, w, sc, kv)
    for route in (None,) + no.ODE_TEAM_ROUTES:
        got = call(route)
        assert all(torch.equal(g, x) for g, x in zip(got, want)), route
    assert no.LAUNCHES == before


def test_resident_route_refuses_a_streamed_shape():
    # chosen before the launch, by shape alone: a resident team at 104
    # columns does not fit, and team8 alone takes 16 lanes at 312 columns
    with pytest.raises(ValueError, match="resident"):
        no._team3("resident", 832, 4, 4, 3, False)
    with pytest.raises(ValueError, match="team8"):
        no._team3("streamed", 2496, 4, 16, 3, False)
    assert no._team3(None, 2496, 4, 16, 3, False) == ("team8", None)
    assert no._team3(None, 832, 4, 1, 3, True)[0] == "streamed"
    assert no._team3(None, 832, 4, 1, 2, True)[0] == "resident"
