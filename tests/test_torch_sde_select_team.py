"""The adaptive SDE selection as cluster teams (``kernels.network_sde``
``select_pass`` and ``select_attempt`` on the card, ``csrc/
sde_select_team.cu``): what the CPU can check of them.

- The team's shape (``sde_select_plan``) and the route chosen by shape
  before the launch (``sde_select_route``): the cluster size, the columns
  a block owns, the packed row's words and the resident or streamed slice
  at 13, 24, 32, 63, 104 and 312 columns for 1, 4 and 8 lanes and every
  drift (select16, f32 and the three-term split), with the card's cluster
  capacity given (7
  clusters of 16 on the H100 at 104 columns: 8 lanes take clusters of 8);
  the shared-memory bytes a block asks for, under the 232,448 a block can
  use, at every width from 13 through 312 columns.
- ``sde_select_pack``'s per-block layout against ``premix_select16``'s
  ``wT16``, the float32 ``wT`` and ``select_weights_split3``'s three terms.
- The kernels' exact float64 of a weight from its bits (bf16 and float32:
  the value times 2^-896) against the other operand times 2^896, over
  random, subnormal, zero and extreme values.
- The krng tree walked in parallel (each level's counter from t alone, a
  normal each, then one combine in the walk's arithmetic: sde_select.cuh
  ``draw_noise``) against ``solvers.krng.KernelBrownianTree`` at 10^4 times,
  bit for bit.
- The kernels' summation order emulated in float64 with numpy (each
  column's lane l sums the rows k = l mod L in order, a butterfly over the
  L lanes; the error norm's block sums, a shuffle tree and the warps in
  order, then the blocks' sums in rank order) against the plain versions'
  float64 matmul (for the split, each of its six products) and norm at 104
  columns for 64 vectors from a numpy seed:
  every product is exact in float64, so the sums differ only in the last
  bits of a float64, and rounded to float32 they agree bit for bit (the
  test counts the entries that do not: 0).
- A bad ``route`` raises before any device is touched; the plain version
  runs for CPU tensors whatever the route.

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
from columnflow_torch.solvers import krng

SMEM = 232448
N_VEC = 64


def h100_clusters(C):
    """The H100's capacity for the selection teams (one block an SM, a
    cluster inside a GPC): 7 clusters of 16 blocks, 16 of 8."""
    return 7 if C == 16 else 16


# (columns, lanes, drift) -> (route, C) with h100_clusters
ROUTES = {}
for _cols in (13, 24, 32, 63, 104, 312):
    for _lanes in (1, 4, 8):
        for _drift in ("select16", "f32", "split3"):
            _C = 16 if (8 * _cols) % 16 == 0 and _lanes <= 7 else 8
            _stream = (_cols == 312 or (_cols == 104 and _drift == "f32" and _C == 8)
                       or (_cols == 104 and _drift == "split3"))
            ROUTES[_cols, _lanes, _drift] = ("streamed" if _stream else "resident", _C)
WPT = {"select16": 1, "f32": 2, "split3": 3}


@pytest.mark.parametrize("columns,lanes,drift", sorted(ROUTES))
def test_cluster_size_and_route(columns, lanes, drift):
    P = 8 * columns
    route, C = ns.sde_select_route(P, 4, lanes, drift, h100_clusters)
    assert (route, C) == ROUTES[columns, lanes, drift]
    plan = ns.sde_select_plan(P, 4, drift, C)
    assert plan.fits and plan.stream == (route == "streamed") and plan.bytes <= SMEM
    assert (plan.C, plan.nc, plan.mode) == (C, P // C, ns.SELECT_DRIFTS[drift])
    assert (plan.wpt, plan.xw) == (WPT[drift], 3 if drift == "split3" else 1)
    # every owned population on a thread of its own; every column pair on L
    # lanes of one warp
    assert plan.nc <= 512 and plan.np * plan.L <= 512 and 32 % plan.L == 0
    # the packed row holds the block's columns, one a word (f32), two (a
    # bf16 term) or two of each of three terms
    assert 4 * plan.rw >= {"select16": 2, "f32": 4, "split3": 6}[drift] * plan.nc


def _invariants(p, P, stream):
    assert p.bytes <= SMEM, p
    v = (32 // p.L) * p.wpt
    assert p.rw % v == 0 and (p.rw // v) % 2 == 1 and p.rw >= p.np * p.wpt
    assert p.fixed % 16 == 0 and (P * 4 * p.rw) % 16 == 0
    assert p.fixed >= 16 * p.xw * P  # the two exchange slots of (P, xw) float64
    if p.stream:
        assert p.S >= min(2, p.T) and p.R % p.L == 0 and p.R % 8 == 0
        assert (p.R * 4 * p.rw) % 16 == 0 and p.T * p.R >= P > (p.T - 1) * p.R
        assert p.bytes == p.fixed + p.S * p.R * 4 * p.rw
    else:
        assert (p.R, p.T, p.S) == (P, 1, 1) and not stream
        assert p.bytes == p.fixed + P * 4 * p.rw


@pytest.mark.parametrize("drift", ["select16", "f32", "split3"])
def test_shared_memory_fits_at_every_width(drift):
    resident = {}
    for columns in range(13, 313):
        P = 8 * columns
        for C in (8, 16):
            if P % C:
                continue
            for n_in in (0, 4, 16):
                for stream in (False, True):
                    p = ns.sde_select_plan(P, n_in, drift, C, stream)
                    assert p.fits, (columns, C, n_in, stream)
                    _invariants(p, P, stream)
            resident[columns, C] = not ns.sde_select_plan(P, 4, drift, C).stream
    # with clusters of 16, select16 stays resident through 148 columns,
    # float32 through 112, the split through 88
    last = {"select16": 148, "f32": 112, "split3": 88}[drift]
    assert {c for c in range(13, 313) if resident.get((c, 16))} == set(range(14, last + 1, 2))


@pytest.mark.parametrize("columns", [1, 2, 3, 5, 8])
def test_narrow_widths_take_the_team(columns):
    # the team at every width its plan fits (from 13 columns it beats the
    # one-block kernel on the H100; below, no command line's width)
    for drift in ("select16", "f32", "split3"):
        C = 16 if columns % 2 == 0 else 8
        assert ns.sde_select_route(8 * columns, 4, 4, drift, h100_clusters) == ("resident", C)


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        ns.sde_select_plan(100, 4, "select16")  # P not a multiple of 8
    with pytest.raises(ValueError):
        ns.sde_select_plan(104, 4, "select16", 16)  # 16 does not divide 104
    with pytest.raises(ValueError):
        ns.sde_select_plan(832, 17, "f32")
    with pytest.raises(ValueError):
        ns.sde_select_plan(832, 4, "split2")
    with pytest.raises(ValueError):
        ns.sde_select_plan(832, 4, "f32", 4)


def _network(columns):
    cpa = {13: (8, 4, 1), 32: (16, 8, 8), 104: (64, 32, 8)}[columns]
    params, net = nw.build_column_network(ColumnConfig.load(), torch.Generator().manual_seed(0),
                                          columns_per_area=cpa, n_inputs=4)
    return net.num_pops, nw.premix_network_weights(params, net), net


@pytest.mark.parametrize("columns", [13, 32])
def test_pack_layout_against_the_weights(columns):
    P, pw, net = _network(columns)
    w16 = nw.premix_select16(pw)
    for drift, w0 in (("select16", w16["wT16"]), ("f32", pw["wT"].contiguous())):
        for C in (8, 16):
            if P % C:
                continue
            plan = ns.sde_select_plan(P, 4, drift, C)
            pk = ns.sde_select_pack(w0, P, plan)
            assert pk.dtype == torch.int32 and tuple(pk.shape) == (plan.C, P, plan.rw)
            vals = pk.view(w0.dtype)  # (C, P, rw) float32 or (C, P, 2 rw) bf16
            nc = plan.nc
            for r in range(C):
                assert torch.equal(vals[r, :, :nc], w0[:, r * nc:(r + 1) * nc])
                assert not vals[r, :, nc:].float().any()


@pytest.mark.parametrize("columns", [13, 32])
def test_pack_layout_of_the_split(columns):
    P, pw, net = _network(columns)
    fc = nw.build_network_fused_consts(net)
    w3 = ns.select_weights_split3(pw, ns.SDEConsts(fc, (0.0, 1.0)))
    terms = (w3["wT_hi"], w3["wT_mid"], w3["wT_lo"])
    for C in (8, 16):
        if P % C:
            continue
        plan = ns.sde_select_plan(P, 4, "split3", C)
        pk = ns.sde_select_pack(w3["w3"], P, plan)
        assert pk.dtype == torch.int32 and tuple(pk.shape) == (plan.C, P, plan.rw)
        half = pk.view(torch.bfloat16)  # (C, P, 2 rw)
        nc = plan.nc
        for r in range(C):
            for j in range(nc):  # column j: pair j // 2, its half j % 2, the term's word
                o, hf = divmod(j, 2)
                for t, W in enumerate(terms):
                    assert torch.equal(half[r, :, 6 * o + 2 * t + hf], W[:, r * nc + j])
            if nc % 2:  # the odd column's partner: zero in each term's word
                o = nc // 2
                assert not half[r, :, [6 * o + 1, 6 * o + 3, 6 * o + 5]].float().any()
            assert not half[r, :, 6 * plan.np:].float().any()


def _scaled_bf16(h):
    """t3_w: the bf16 bits h (int64 16-bit values) as a double's sign,
    exponent and mantissa."""
    hi = ((h << 16) & 0x80000000) | ((h & 0x7FFF) << 13)
    return (hi << 32).view(torch.float64)


def _scaled_f32(w):
    """t3_w32: the float32 bits w (int64 32-bit values) moved into a
    double: the sign, then the exponent and mantissa three bits down."""
    hi = (w & 0x80000000) | ((w & 0x7FFFFFFF) >> 3)
    lo = (w << 29) & 0xFFFFFFFF
    return ((hi << 32) | lo).view(torch.float64)


def _operands(rng):
    return torch.from_numpy(np.concatenate([
        rng.standard_normal(64) * 10.0 ** rng.uniform(-38, 38, 64),
        [3.4e38, -3.4e38, 1.2e-38, 1e-45, -1e-45, 0.0, -0.0, 1.0]]).astype(np.float32)).double()


def test_weight_placements_are_w_times_2_to_the_minus_896():
    rng = np.random.default_rng(7)
    # every bf16 bit pattern but the non-finite
    bits = torch.arange(65536, dtype=torch.int64)
    w = bits.to(torch.int16).view(torch.bfloat16)
    keep = torch.isfinite(w.float())
    wb, sb = w[keep].double(), _scaled_bf16(bits[keep])
    assert torch.equal(sb * 2.0 ** 896, wb)
    # float32: random magnitudes over the whole range, subnormals, +-0, the
    # extremes
    f = np.concatenate([
        rng.standard_normal(200_000) * 10.0 ** rng.uniform(-45, 38, 200_000),
        rng.integers(1, 2**23, 1000).astype(np.uint32).view(np.float32),  # subnormals
        [0.0, -0.0, 1.0, -1.0, 3.4028235e38, -3.4028235e38, 1.1754944e-38, 1e-45, -1e-45]])
    f = f.astype(np.float32)
    f = f[np.isfinite(f)]
    wf = torch.from_numpy(f)
    sf = _scaled_f32(torch.from_numpy(f.view(np.uint32).astype(np.int64)))
    assert torch.equal(sf * 2.0 ** 896, wf.double())
    # a product with an operand scaled by 2^896 is the unscaled product
    ops = _operands(rng)
    some = torch.cat([wf[:2000].double(), wf[-9:].double()])
    ssome = torch.cat([sf[:2000], sf[-9:]])
    for x in ops:
        assert torch.equal((x * 2.0 ** 896) * sb, x * wb), float(x)
        assert torch.equal((x * 2.0 ** 896) * ssome, x * some), float(x)


def _jt_code(t, t0, t1, lvl):
    """sde_select.cuh jt_code, every time at once: the counter of draw lvl
    (0 the right end; else bisection lvl - 1's midpoint on t's path), from
    t alone."""
    if lvl == 0:
        return torch.zeros(t.shape, dtype=torch.int64)
    t = torch.minimum(torch.maximum(t, t0), t1)
    tl, tr = torch.full_like(t, float(t0)), torch.full_like(t, float(t1))
    code = torch.zeros(t.shape, dtype=torch.int64)
    for _ in range(lvl - 1):
        tm = 0.5 * (tl + tr)
        left = t < tm
        tr, tl = torch.where(left, tm, tr), torch.where(left, tl, tm)
        code = torch.where(left, code * 2 + 1, code * 2 + 2)
    return code * 2 + 1


def _tree_combine(t, t0, t1, depth, z):
    """sde_select.cuh tree_combine<kKrng>: W(t) from the depth + 1 normals
    z[..., lvl]."""
    t = torch.minimum(torch.maximum(t, t0), t1)
    tl, tr = torch.full_like(t, float(t0)), torch.full_like(t, float(t1))
    wl = torch.zeros_like(t)
    wr = z[..., 0] * torch.sqrt(torch.clamp_min(t1 - t0, 0.0))
    for d in range(depth):
        tm = 0.5 * (tl + tr)
        wm = 0.5 * (wl + wr) + (0.5 * torch.sqrt(tr - tl)) * z[..., 1 + d]
        left = t < tm
        tr, wr = torch.where(left, tm, tr), torch.where(left, wm, wr)
        tl, wl = torch.where(left, tl, tm), torch.where(left, wl, wm)
    pos = tr > tl
    frac = torch.where(pos, (t - tl) / torch.where(pos, tr - tl, 1.0), 0.0)
    return wl + frac * (wr - wl)


@pytest.mark.parametrize("span", [(0.0, 1.0), (0.0, 0.999)])
def test_parallel_krng_walk_equals_the_tree(span):
    depth = 20
    t0, t1 = torch.tensor(span[0]), torch.tensor(span[1], dtype=torch.float32)
    rng = np.random.default_rng(11)
    t = np.concatenate([rng.uniform(span[0], span[1], 9990),
                        [span[0], span[1], 0.5, 0.25, 0.75, 1e-7, -0.1, 1.1, 0.999, 0.3]])
    t = torch.from_numpy(t.astype(np.float32))
    k0, k1 = 0x1234ABCD, 0x9E3779B9
    z = torch.stack([krng.normal2(k0, k1, _jt_code(t, t0, t1, lvl), 0)
                     for lvl in range(depth + 1)], dim=-1)
    got = _tree_combine(t, t0, t1, depth, z)
    want = krng.KernelBrownianTree(t0, t1, k0, k1, depth=depth).evaluate(t)
    assert torch.equal(got, want)


def _butterfly(acc):
    """The xor butterfly of shuffles over the lanes axis 0; every lane ends
    with the same float64, returned."""
    L, idx, off = acc.shape[0], np.arange(acc.shape[0]), acc.shape[0] // 2
    while off:
        acc = acc + acc[idx ^ off]
        off //= 2
    return acc[0]


def emulate_products(L, x, W):
    """x (N, P), W (P, nc) float64: the team's float64 sums x W, column by
    column: lane l of a column pair sums the rows k = l mod L in order."""
    P = W.shape[0]
    acc = np.zeros((L, x.shape[0], W.shape[1]))
    for i in range(-(-P // L)):
        k = np.arange(L) + L * i
        ok = k < P
        kk = np.where(ok, k, 0)
        prod = x[:, kk].T[:, :, None] * W[kk][:, None, :]
        acc = acc + np.where(ok[:, None, None], prod, 0.0)
    return _butterfly(acc)


def emulate_norm(q2, C, nc):
    """q2 (N, 3P) float64 (the float32 squares): the team's error-norm sum.
    Thread i < nc of block r adds its population's three components in
    order; the block sums (block_sum.cuh: a shuffle-down tree in each warp,
    then the warps in order); the C blocks' sums in rank order."""
    N, P = q2.shape[0], q2.shape[1] // 3
    total = np.zeros(N)
    for r in range(C):
        acc = np.zeros((N, 512))
        for c in range(3):
            acc[:, :nc] = acc[:, :nc] + q2[:, c * P + r * nc:c * P + (r + 1) * nc]
        warps = acc.reshape(N, 16, 32)
        off = 16
        while off:
            lanes = np.arange(32)
            warps = warps + warps[:, :, np.minimum(lanes + off, 31)] * (lanes + off < 32)
            off //= 2
        block = np.zeros(N)
        for w in range(16):
            block = block + warps[:, w, 0]
        total = total + block
    return total


def test_summation_order_rounds_as_the_plain_matmul_and_norm():
    P, pw, net = _network(104)
    w16 = nw.premix_select16(pw)
    rng = np.random.default_rng(105)
    v_minus_a = rng.uniform(-40.0, 40.0, (N_VEC, P)).astype(np.float32)
    fr = compute_firing_rate(torch.from_numpy(v_minus_a))
    mismatches = {}
    fc = nw.build_network_fused_consts(net)
    w3 = ns.select_weights_split3(pw, ns.SDEConsts(fc, (0.0, 1.0)))
    x_hi, x_mid, x_lo = nw.split3_terms(fr)
    split = {"x_hi W_lo": (x_hi, w3["wT_lo"]), "x_mid W_mid": (x_mid, w3["wT_mid"]),
             "x_lo W_hi": (x_lo, w3["wT_hi"]), "x_hi W_mid": (x_hi, w3["wT_mid"]),
             "x_mid W_hi": (x_mid, w3["wT_hi"]), "x_hi W_hi": (x_hi, w3["wT_hi"])}
    for drift, x, W in (("select16", fr.to(torch.bfloat16).float(), w16["wT16"].double()),
                        ("f32", fr, pw["wT"].double()),
                        *((f"split3 {k}", x.float(), W.double()) for k, (x, W) in split.items())):
        want = torch.matmul(x.double(), W).float().numpy()
        for C in (8, 16):
            plan = ns.sde_select_plan(P, 4, drift.split()[0], C)
            got = np.concatenate([
                emulate_products(plan.L, x.double().numpy(),
                                 W[:, r * plan.nc:(r + 1) * plan.nc].numpy())
                for r in range(C)], axis=1).astype(np.float32)
            mismatches[f"{drift} C={C} L={plan.L}"] = int((got != want).sum())
    # the error norm: float32 ratios q of the attempt's scale, their squares
    q = torch.from_numpy((rng.standard_normal((N_VEC, 3 * P))
                          * 10.0 ** rng.uniform(-3, 1, (N_VEC, 1))).astype(np.float32))
    q2 = (q * q).double()
    want = q2.sum(-1).float().numpy()
    for C in (8, 16):
        got = emulate_norm(q2.numpy(), C, P // C).astype(np.float32)
        mismatches[f"norm C={C}"] = int((got != want).sum())
    assert mismatches == dict.fromkeys(mismatches, 0), mismatches


def _cpu_args(P=104, N=2):
    y = torch.zeros(N, 3 * P)
    kv = torch.zeros(2, N, 4)
    col = torch.zeros(N, 1)
    words = torch.zeros(N, 4, dtype=torch.int64)
    return y, kv, col, words


@pytest.mark.parametrize("entry", ["select", "attempt"])
def test_routes_are_checked_before_the_device(entry):
    y, kv, col, words = _cpu_args()
    cfg = ns.SelectConfig(0.0, 1.0)
    with pytest.raises(ValueError, match="route"):
        if entry == "select":
            ns.select_pass(y, words, {}, None, kv, cfg, route="team8")
        else:
            ns.select_attempt(col, y, col, col, col, words, {}, None, kv, cfg, route="team16")


def test_team_routes_refuse_what_they_do_not_take(monkeypatch):
    # decided before the launch, by shape: the card's capacity is the only
    # input from the card
    monkeypatch.setattr(ns, "sde_select_max_clusters", lambda *a: h100_clusters(a[4]))
    kernel16 = ns.SelectConfig(0.0, 1.0, brownian="kernel", drift="select16")
    f32 = ns.SelectConfig(0.0, 1.0, brownian="jax", drift="f32")
    split3 = ns.SelectConfig(0.0, 1.0, brownian="kernel", drift="split3")
    assert ns._select_team(None, 832, 4, 4, kernel16)[0] == "resident"
    assert ns._select_team(None, 832, 4, 4, kernel16)[1].C == 16
    assert ns._select_team(None, 832, 4, 8, kernel16)[1].C == 8
    assert ns._select_team(None, 832, 4, 8, f32)[0] == "streamed"
    assert ns._select_team("streamed", 832, 4, 4, f32)[1].stream
    assert ns._select_team(None, 832, 4, 4, split3)[0] == "streamed"
    assert ns._select_team(None, 104, 4, 4, split3)[0] == "resident"
    assert ns._select_team(None, 24, 4, 4, split3)[0] == "resident"
    assert ns._select_team("block", 832, 4, 4, f32) == ("block", None)
    with pytest.raises(ValueError, match="resident"):
        ns._select_team("resident", 832, 4, 8, f32)
    with pytest.raises(ValueError, match="resident"):
        ns._select_team("resident", 832, 4, 4, split3)
    monkeypatch.setattr(ns, "sde_select_max_clusters", lambda *a: 0)
    with pytest.raises(RuntimeError, match="fits the card"):
        ns._select_team(None, 832, 4, 4, f32)


def test_cpu_tensors_take_the_plain_version_on_any_route(monkeypatch):
    calls = []
    monkeypatch.setattr(ns, "_select_plain", lambda *a: calls.append("select"))
    monkeypatch.setattr(ns, "_attempt_plain", lambda *a: calls.append("attempt"))
    P = 104
    y = torch.zeros(2, 3 * P)
    kv = torch.zeros(2, 2, 4)
    col = torch.zeros(2, 1)
    words = torch.zeros(2, 4, dtype=torch.int64)
    w16 = {"wT16": torch.zeros(P, P, dtype=torch.bfloat16),
           "iwT16": torch.zeros(4, P, dtype=torch.bfloat16)}
    fc = {"bg": torch.zeros(P), "adapt": torch.zeros(P)}
    sc = ns.SDEConsts(fc, torch.zeros(2))
    cfg = ns.SelectConfig(0.0, 1.0)
    before = dict(ns.LAUNCHES)
    for route in ns.SELECT_ROUTES:
        ns.select_pass(y, words, w16, sc, kv, cfg, route=route)
        ns.select_attempt(col, y, col, col, col, words, w16, sc, kv, cfg, route=route)
    assert calls == ["select", "attempt"] * 3
    assert ns.LAUNCHES == before
