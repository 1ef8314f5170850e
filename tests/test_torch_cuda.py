"""The CUDA kernels of ``columnflow_torch.kernels.column_step``,
``columnflow_torch.kernels.network_sde`` and
``columnflow_torch.kernels.network_ode`` against their plain PyTorch
versions, on the card.

These tests need a CUDA device and skip without one. The chip has no JAX, so
this file imports none, and it runs without the suite's conftest (which
configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Tolerances. Drift: 1e-6 of each component's sum of absolute terms (the
membrane derivative's 16 recurrent terms cancel; the kernel sums them in
lane order with fused multiply-adds, cuBLAS in its own order). Rollout: 1e-4
of each state component's largest magnitude over the run (the same
rounding carried over 1499 steps). Reverse sweep: 1e-4 of the state
cotangent's largest magnitude per component, 1e-4 relative L2 on the
weight cotangent.

Column-network SDE kernels, at the 104-column width (P = 832, state 2496).
One controller attempt: err rel 1e-5 and the same decision (both sum every
product exactly in float64, so only the rounding of the error's own sum
differs). The whole selection: both succeed, the first 10 accepted times
rel 1e-6, naccept within 10% (a selection is not held pathwise: an ulp in
an error estimate moves h and with it every later draw). Replay over 64
half steps: 1e-4 of each component's largest magnitude. Reverse sweep:
each step's seed and the carry rel L2 1e-4 (the cotangents pass through
bf16 roundings, and a rate an ulp apart can round one element a bf16 ulp,
2^-8, apart). B3 and B4 as cluster teams at 13, 32, 63, 104 (the weights
resident in shared memory) and 312 columns (streamed): bit for bit against
their plain versions on per-lane windows, one launch each; at 104 the
forced streamed ring and the yardstick (B3t-team's and B4t's bodies on the
two-term split) bit for bit with the resident teams; the team plan the
wrappers reckon equals the library's; bench.py's step at 104 columns runs
each of its kernels once and no plain version.

The selection as cluster teams (a cluster of 16 or 8 blocks per lane,
each block's weight columns in shared memory; select16 on both trees, f32
on the jax.random tree, the three-term split (B5t) on the krng tree) at 13,
32 and 104 columns, 4 lanes and 8 at 104,
on every route the shape admits: the whole selection (stats and accepted
times) and 16 single attempts bit for bit against the plain versions; the
plan the wrapper reckons equals the library's; the flagship, bench.py's and
the exact adaptive steps at 104 columns launch the team once and never the
one-block kernel.

The three-term sweeps as teams (B3t-team, B4t) at 104 and 312 columns on
short uniform and per-lane windows: bit for bit against their plain
versions, one launch each; the forward kernel picked by shape (the one-block
B3t at 13 columns, the team from 24); the 104-column fixed-grid step against
the same step on the CPU (loss rel 1e-5, gradients within the larger of 3e-2
and ten times the card's own nudge spread). The selection on the three-term
split (B5t) at 13 and 104 columns and B4't-team at 32 and 63 columns (and
against B4't at 13): bit for bit; the adaptive step's new tiers at 13
columns against the same step on the CPU (loss rel 1e-5, gradients within
the larger of 1e-3 and ten times the card's own nudge spread).

Column-network dopri5 kernels, at the reference width (13 columns, P = 104,
batch 4 under one controller, 200 grid points). Kernel and plain version sum
every product exactly and round every float32 operation alike, so they are
held bit for bit: the whole selection (accepted times and counts, 4 and 16
lanes), single attempts, the replay's states and dense rows, the reverse
sweep's state and weight cotangents (16 lanes: B8t-team); the split2 tier's
replay and emit-mode sweep; its train step against the same step on the CPU
(loss rel 1e-5, gradients rel L2 1e-3, as the exact step's). Past one block:
B7t-team at 24 columns, B8t-team at 18 and 32, B8't at 64, bit for bit; the
exact step at 32 (kernel mode) and 64 columns (outer mode) with one launch
of each of its kernels, against the CPU (loss rel 1e-5, gradients within the
larger of 1e-3 and ten times the CPU's own nudge spread). The two-term
split's kernel-mode sweeps, one team for the batch at every width: B8s
(after B7 split2) and B4s (after B3) at 13, 32 and 63 columns, bit for bit;
both kernel-mode steps at 13 columns against the CPU (loss rel 1e-5,
gradients within the larger of 1e-3 and ten times the card's own nudge
spread). The replays as cluster teams per lane (B7t-team, B7 split2:
``ode_replay16_kernel``, the 8-block team's sum order) at 13, 24, 32, 63,
104 and 312 columns, 4 lanes and 16 at 104 (clusters of 8), on every route
and team8: bit for bit with the plain version, one launch each; their plan
equals the library's; the exact and split2 steps launch them, never team8.

XOR kernels (the XOR network, the four conditions as one batch, 200 grid
points). Kernel and plain version sum every product in one order and round
every float32 operation alike, so they are held bit for bit: the dopri5
selection, single attempts, the replay and its kernel-mode sweep, the
uniform-grid SDE and its kernel-mode sweep; both train steps against the
same step on the CPU on the card's grid and noise (loss rel 1e-5, gradients
rel L2 1e-3), with exactly one launch of each of their kernels. The
stochastic-adaptive kernels, bit for bit as well: the whole selection on
either tree (max_steps 2048) and single attempts along its replay, the
lanes' replay and its kernel-mode sweep on that grid; the adaptive step
(either tree) against the same step on the CPU on the card's grid.

Hopf kernels (the MLP 3 -> 100 -> 100 -> 100 -> 2, 32 lanes of
``make_hopf_dataset`` under one controller, 200 grid points over 5 s).
Kernel and plain version sum every product exactly in float64 in one order
and round every float32 operation alike, so they are held bit for bit: the
selection, single attempts, the replay and its kernel-mode sweep; the train
step against the same step on the CPU on the card's grid (loss rel 1e-5,
gradients rel L2 1e-3), with exactly one launch of each kernel; the wrappers
refuse other widths and more than 32 lanes. Outer mode: the emit-mode sweep
B8ho bit for bit, its ybar0 the kernel-mode sweep's; at the 3-512-512-512-2
MLP (init std 0.1 sqrt(100/512), what "auto" sends to outer mode) the
selection, attempts, replay and emit-mode sweep bit for bit over 100 points
(2.5 s); the outer-mode step at the reference width and the wide
``make_train_step`` (10 points over 0.25 s: the CPU's plain versions take
~20 s a step there) against the CPU on the card's grid (loss rel 1e-5,
gradients rel L2 1e-3), one launch of each of their kernels, no plain
version reached.
"""

import pytest
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.data import make_parity_batch, sample_wta_mus, wta_stim_three_phases
from columnflow_torch.kernels import column_step as cs
from columnflow_torch.kernels import hopf_ode as ho
from columnflow_torch.kernels import network_ode as no
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.kernels import xor_ode as xo
from columnflow_torch.kernels import xor_sde as xs
from columnflow_torch.models import network as nw
from columnflow_torch.models.wta import build_wta
from columnflow_torch.ops.interp import step_table_knots
from columnflow_torch.ops.losses import huber_trajectory_loss_wta
from columnflow_torch.solvers.sde import brownian_pack
from columnflow_torch.solvers.sde_adaptive import _replay_grid, _sde_key_words, select_config
from columnflow_torch.tasks import bifurcation
from columnflow_torch.tasks import parity
from columnflow_torch.tasks import xor as xor_task
from columnflow_torch.tasks.wta import DT, linspace

# No gradient limit of a card-against-CPU step may exceed this rel L2 (a
# larger one would pass a wrong gradient); chip_smoke.py holds the same cap.
GRAD_TOL_CAP = 0.25

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest tests/test_torch_cuda.py -m cuda")
    return torch.device("cuda")


def _inputs(dev, B, T, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, area = build_wta(ColumnConfig.load(), gen, device=dev)
    consts, scalars = cs._area_consts(area)
    ts = linspace(0.0, T * DT, T, device=dev)
    stim = wta_stim_three_phases(sample_wta_mus(gen, B, device=dev), T)
    _, i1, i10, _, _ = brownian_pack(gen, ts, (B,))
    g = cs._diffusion_row(100.0, False, dev)
    return dict(params=params, area=area, w=params["recurrent_weights"], consts=consts,
                scalars=scalars, h=cs._grid_step(ts), g=g,
                stim_tb=stim.transpose(0, 1).contiguous(), i1=i1, i10=i10)


def _scaled_err(got, want):
    scale = want.abs().flatten(0, -2).amax(dim=0).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())


def _rel_l2_rows(got, want):
    """Largest relative L2 error of a row (a step's cotangent of every
    lane)."""
    diff = (got - want).flatten(1).norm(dim=1)
    return float((diff / want.flatten(1).norm(dim=1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("B", [15, 60])
def test_drift_kernel_matches_plain(dev, B):
    d = _inputs(dev, B, 100)
    y0 = torch.zeros(B, 48, device=dev)
    ys = cs._rollout_fwd_plain(d["h"], d["scalars"], d["w"], d["consts"], d["g"], y0,
                               d["stim_tb"], d["i1"], d["i10"])
    y = ys[60].clone()
    y[0, 4], y[0, 20] = 20.4375, 0.0  # population 4 of lane 0 at the singularity
    s = d["stim_tb"][60]
    before = cs.LAUNCHES["drift"]
    got = cs.drift(d["scalars"], y, s, d["w"], d["consts"])
    torch.cuda.synchronize()
    assert cs.LAUNCHES["drift"] == before + 1
    want = cs._drift_plain(d["scalars"], y, s, d["w"], d["consts"])
    assert torch.isfinite(got).all()
    scale = cs._drift_abs_terms(d["scalars"], y, s, d["w"], d["consts"]).clamp_min(1e-30)
    err = (got - want).abs() / scale
    assert float(err.max()) < 1e-6


@pytest.mark.parametrize("B,T", [(15, 1500), (60, 1500), (5, 2)])
def test_rollout_kernels_match_plain(dev, B, T):
    d = _inputs(dev, B, T, seed=1)
    y0 = torch.zeros(B, 48, device=dev)
    args = (d["h"], d["scalars"], d["w"], d["consts"], d["g"])
    ys = cs.rollout_fwd(*args, y0, d["stim_tb"], d["i1"], d["i10"])
    ys_plain = cs._rollout_fwd_plain(*args, y0, d["stim_tb"], d["i1"], d["i10"])
    torch.cuda.synchronize()
    assert torch.isfinite(ys).all()
    assert _scaled_err(ys, ys_plain) < 1e-4

    ys_req = ys_plain.transpose(0, 1).requires_grad_(True)
    true = torch.rand(B, T, 2, device=dev, generator=torch.Generator(dev).manual_seed(2))
    loss = huber_trajectory_loss_wta(ys_req, true, d["params"]["output_weights"])
    ysbar = torch.autograd.grad(loss, ys_req)[0].transpose(0, 1).contiguous()
    bwd_args = (*args, d["stim_tb"], d["i10"], ys_plain[:-1].contiguous(),
                ysbar[:-1].contiguous(), ysbar[-1].contiguous())
    before = dict(cs.LAUNCHES)
    cout, wbar = cs.rollout_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["rollout_bwd"] == before["rollout_bwd"] + 1
    assert cs.LAUNCHES["wbar_reduce"] == before["wbar_reduce"] + 1
    cout_p, wbar_p = cs._rollout_bwd_plain(*bwd_args)
    assert torch.isfinite(cout).all() and torch.isfinite(wbar).all()
    assert _scaled_err(cout, cout_p) < 1e-4
    assert float((wbar - wbar_p).norm() / wbar_p.norm()) < 1e-4


def test_autograd_function_on_cuda_matches_cpu(dev):
    B, T = 4, 300
    d = _inputs(dev, B, T, seed=3)
    rollout = cs.make_wta_rollout_diff(d["area"], linspace(0.0, T * DT, T, device=dev))
    tables = d["stim_tb"].transpose(0, 1)
    true = torch.full((B, T, 2), 0.5, device=dev)

    def loss_grad(w, tab, i1, i10, ow, tr, fn):
        w = w.clone().requires_grad_(True)
        loss = huber_trajectory_loss_wta(fn(w, tab, i1, i10), tr, ow)
        loss.backward()
        return loss.item(), w.grad

    before = dict(cs.LAUNCHES)
    lg, gg = loss_grad(d["w"], tables, d["i1"], d["i10"], d["params"]["output_weights"],
                       true, rollout)
    assert cs.LAUNCHES["rollout_fwd"] == before["rollout_fwd"] + 1
    assert cs.LAUNCHES["rollout_bwd"] == before["rollout_bwd"] + 1
    cpu = cs.make_wta_rollout_diff(cs.AreaParams(*[
        v.cpu() if torch.is_tensor(v) else v for v in d["area"]]),
        linspace(0.0, T * DT, T))
    lc, gc = loss_grad(d["w"].cpu(), tables.cpu(), d["i1"].cpu(), d["i10"].cpu(),
                       d["params"]["output_weights"].cpu(), true.cpu(), cpu)
    assert lg == pytest.approx(lc, rel=1e-4)
    assert float((gg.cpu() - gc).norm() / gc.norm()) < 1e-4


def test_cuda_tensors_never_reach_the_plain_version(dev, monkeypatch):
    d = _inputs(dev, 3, 10)

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(cs, "_drift_plain", boom)
    monkeypatch.setattr(cs, "_rollout_fwd_plain", boom)
    y0 = torch.zeros(3, 48, device=dev)
    cs.drift(d["scalars"], y0, d["stim_tb"][0], d["w"], d["consts"])
    cs.rollout_fwd(d["h"], d["scalars"], d["w"], d["consts"], d["g"], y0,
                   d["stim_tb"], d["i1"], d["i10"])
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="cpu"):
        cs.drift(d["scalars"], y0, d["stim_tb"][0].cpu(), d["w"], d["consts"])


# ---------------------------------------------------------------------------
# Column-network SDE kernels (selection, replay, reverse sweep)
# ---------------------------------------------------------------------------

FULL = (64, 32, 8)  # the 104-column flagship: P = 832, state 2496
STEP = dict(bptt_every=32, clip_grad_norm=1.0, loss_scale=1e-6)
# The 104-column flagship's flags (--fused-pass).
FLAGSHIP_FLAGS = dict(stochastic=True, adaptive=True, fused_pass=True, select_bf16=True,
                      grad_bf16=True, split2=True)


def _net_inputs(dev, cpa=FULL, n_in=4, B=4, T=1000, seed=0):
    """The parity network's kernel inputs: split2 and select16 weights,
    drift constants, knot values and tree key words of B lanes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, net = nw.build_column_network(ColumnConfig.load(), gen, columns_per_area=cpa,
                                          n_inputs=n_in, device=dev)
    fc = nw.build_network_fused_consts(net, device=dev)
    ts = linspace(0.0, T * parity.DT, T, device=dev)
    stims = make_parity_batch(gen, n_in, B, device=dev)
    kts, kv = step_table_knots(T, float(ts[1] - ts[0]), torch.zeros_like(stims), stims)
    pw = nw.premix_network_weights(params, net)
    keys = torch.randint(0, 2**32, (B, 2), generator=gen, device=dev, dtype=torch.int64)
    w2 = nw.prepare_premixed_split2(pw, fc)[0]
    return dict(gen=gen, P=net.num_pops, ts=ts, sc=ns.SDEConsts(fc, kts), kv=kv.contiguous(),
                w2={k: v.contiguous() for k, v in w2.items()}, w16=nw.premix_select16(pw),
                wf={"wT": pw["wT"].contiguous(), "iwT": pw["iwT"].contiguous()},
                words=_sde_key_words(keys), keys=keys)


def _states(gen, N, P, dev):
    """N network states (N, 3P) with v - a from the near-zero rate regime
    past the singularity (at 20.4375) into the linear branch."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(N, P, generator=gen, device=dev)

    a = u(0.0, 5.0)
    return torch.cat([a + u(-40.0, 40.0), a, u(0.0, 40.0)], dim=1)


def test_sde_attempt_kernel_matches_plain(dev):
    d = _net_inputs(dev)
    N, gen = 16, d["gen"]
    lane = torch.arange(N, device=dev) % 4
    words, kv = d["words"][lane].contiguous(), d["kv"][:, lane].contiguous()
    y1 = _states(gen, N, d["P"], dev)
    t1 = (0.9 * torch.rand(N, 1, generator=gen, device=dev)).contiguous()
    h = (1e-6 * 10.0 ** (torch.arange(N, device=dev)[:, None] % 4)).contiguous()  # 1e-6..1e-3
    err_prev = torch.full((N, 1), 0.7, device=dev)
    cfg = ns.SelectConfig(float(d["ts"][0]), float(d["ts"][-1]), h0=2.5e-4)
    w_t1 = ns._tree(words, cfg).evaluate(t1).contiguous()
    before = ns.LAUNCHES["sde_attempt"]
    got = ns.select_attempt(t1, y1, h, err_prev, w_t1, words, d["w16"], d["sc"], kv, cfg)
    torch.cuda.synchronize()
    assert ns.LAUNCHES["sde_attempt"] == before + 1
    want = ns._attempt_plain(t1, y1, h, err_prev, w_t1, words, d["w16"], d["sc"], kv, cfg)
    assert torch.isfinite(got.y_new).all()
    assert torch.equal(got.accept, want.accept)
    assert torch.equal(got.h, want.h) and torch.equal(got.t_new, want.t_new)
    assert float(((got.err - want.err).abs() / want.err.clamp_min(1e-30)).max()) < 1e-5
    assert float(((got.h_next - want.h_next).abs() / want.h_next).max()) < 1e-6
    assert float(((got.w1 - want.w1).abs()).max()) <= 1e-6 * float(want.w1.abs().max())
    assert _scaled_err(got.y_new, want.y_new) < 1e-5


def test_sde_select_kernel_matches_plain(dev):
    d = _net_inputs(dev, T=50)
    ts = d["ts"]
    cfg = select_config(ts, max_steps=4096)
    y0 = torch.zeros(4, 3 * d["P"], device=dev)
    before = ns.LAUNCHES["sde_select"]
    st, na, nr, ok = ns.select_pass(y0, d["words"], d["w16"], d["sc"], d["kv"], cfg)
    torch.cuda.synchronize()
    assert ns.LAUNCHES["sde_select"] == before + 1
    st_p, na_p, nr_p, ok_p = ns._select_plain(y0, d["words"], d["w16"], d["sc"], d["kv"], cfg)
    assert bool(ok.all()) and bool(ok_p.all())
    assert bool((st[torch.arange(4, device=dev), na.long()] == cfg.t_end).all())
    assert torch.allclose(st[:, :11], st_p[:, :11], rtol=1e-6, atol=0.0)
    assert bool(((na - na_p).abs() <= 0.1 * na_p).all()), (na, na_p)


@pytest.fixture(scope="module")
def replayed():
    """A 104-column replay from rest over 50 grid points on the grid the
    selection kernel chose, through the replay kernel: the states the
    per-chunk comparisons start from."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    d = _net_inputs(dev, T=50)
    ts = d["ts"]
    cfg = select_config(ts, max_steps=4096)
    y0 = torch.zeros(4, 3 * d["P"], device=dev)
    st, na, _, ok = ns.select_pass(y0, d["words"], d["w16"], d["sc"], d["kv"], cfg)
    assert bool(ok.all())
    ht, dw, i10 = _replay_grid(st, d["words"], cfg.t_start, cfg.t_end, cfg.depth)
    t0s = ht[:, :-1].T.contiguous()
    hs = (ht[:, 1:] - ht[:, :-1]).T.contiguous()
    dw, i10 = dw.T.contiguous(), i10.T.contiguous()
    n_real = 2 * int(na.max())
    ys = ns.replay_fwd(y0, t0s, hs, dw, i10, n_real, d["w2"], d["sc"], d["kv"])
    return d, ys, (t0s, hs, dw, i10), n_real


@pytest.mark.parametrize("where,stride", [(0.0, 0), (0.5, 16), (1.0, 0)])
def test_sde_replay_kernels_match_plain(dev, replayed, where, stride):
    """One truncation window (64 half steps) early, in the middle and at
    the end of the replay, from the kernel's own state there."""
    d, ys_full, grid, n_real = replayed
    n = 64
    k0 = min(int(where * n_real), n_real - n)
    t0s, hs, dw, i10 = (x[k0:k0 + n].contiguous() for x in grid)
    y0 = ys_full[k0].contiguous()
    fwd = (t0s, hs, dw, i10, n, d["w2"], d["sc"], d["kv"])
    before = dict(ns.LAUNCHES)
    ys = ns.replay_fwd(y0, *fwd)
    torch.cuda.synchronize()
    ys_p = ns._replay_fwd_plain(y0, *fwd)
    assert torch.isfinite(ys).all()
    assert _scaled_err(ys, ys_p) < 1e-4

    gen = torch.Generator(device=dev).manual_seed(5)
    ysbar = torch.randn(n, 4, 3 * d["P"], generator=gen, device=dev)
    bwd = (ys_p[:-1].contiguous(), ysbar, t0s, hs, i10, n, stride, d["w2"], d["sc"], d["kv"])
    ybar, seeds = ns.replay_bwd(*bwd)
    torch.cuda.synchronize()
    assert ns.LAUNCHES["sde_replay_fwd"] == before["sde_replay_fwd"] + 1
    assert ns.LAUNCHES["sde_replay_bwd"] == before["sde_replay_bwd"] + 1
    ybar_p, seeds_p = ns._replay_bwd_plain(*bwd)
    assert torch.isfinite(seeds).all() and torch.isfinite(ybar).all()
    assert _rel_l2_rows(seeds, seeds_p) < 1e-4
    if stride:
        assert bool((ybar == 0).all())  # step 0 is a truncation point
    else:
        assert _rel_l2_rows(ybar[None], ybar_p[None]) < 1e-4


def test_sde_replay_kernels_skip_the_padding(dev, replayed):
    d, ys_full, grid, n_real = replayed
    n, m = 64, 40
    t0s, hs, dw, i10 = (x[:n].contiguous() for x in grid)
    fwd = (t0s, hs, dw, i10, m, d["w2"], d["sc"], d["kv"])
    ys = ns.replay_fwd(ys_full[0].contiguous(), *fwd)
    assert torch.equal(ys[:m + 1], ys_full[:m + 1])
    assert torch.equal(ys[m + 1:], ys[m:m + 1].expand(n - m, -1, -1))
    ysbar = torch.ones(n, 4, 3 * d["P"], device=dev)
    ybar, seeds = ns.replay_bwd(ys[:-1].contiguous(), ysbar, t0s, hs, i10, m, 0, d["w2"],
                                d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert bool((seeds[m:] == 0).all()) and bool((seeds[:m] != 0).any())


# ---------------------------------------------------------------------------
# B3 and B4 as cluster teams (csrc/replay2_team.cuh)
# ---------------------------------------------------------------------------

TEAM_CPA = {13: (8, 4, 1), 24: (16, 6, 2), 32: (16, 8, 8), 63: (32, 24, 7),
            104: (64, 32, 8), 312: (192, 96, 24)}


def _team2_window(dev, columns, n):
    """A window of n per-lane half steps (the last two padding) at
    ``columns`` columns: the kernel inputs, start states from the rate
    regimes of ``_states`` and random cotangents of the step outputs."""
    d = _net_inputs(dev, cpa=TEAM_CPA[columns], T=1000)
    gen, B, P = d["gen"], 4, d["P"]
    t0s, hs, dw, i10 = _team_grid(dev, gen, B, P, n, True, d["ts"])
    y0 = _states(gen, B, P, dev)
    ysbar = torch.randn((n, B, 3 * P), generator=gen, device=dev)
    return d, (t0s, hs, dw, i10), y0, ysbar


@pytest.mark.parametrize("columns", [13, 32, 63, 104, 312])
def test_split2_team_kernels_equal_plain(dev, columns):
    """B3 and B4 (truncation every 5 steps) at 13, 32, 63, 104 (weights
    resident) and 312 columns (streamed) on a window of per-lane grids, 12
    half steps (8 at 312), the last two padding: ys, ybar and seeds bit for
    bit against the plain versions, one launch each."""
    n = 8 if columns == 312 else 12
    d, (t0s, hs, dw, i10), y0, ysbar = _team2_window(dev, columns, n)
    assert ns.sde2_replay_route(d["P"], 4) == ("streamed" if columns == 312 else "resident")
    before = dict(ns.LAUNCHES)
    fwd = (t0s, hs, dw, i10, n - 2, d["w2"], d["sc"], d["kv"])
    ys = ns.replay_fwd(y0, *fwd)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n - 2, 5, d["w2"], d["sc"], d["kv"])
    got = ns.replay_bwd(*bwd)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched == {"sde_replay_fwd": 1, "sde_replay_bwd": 1}
    assert torch.isfinite(ys).all() and torch.equal(ys, ns._replay_fwd_plain(y0, *fwd))
    assert bool(got[1][:n - 2].any()) and not bool(got[1][n - 2:].any())
    for g, w in zip(got, ns._replay_bwd_plain(*bwd)):
        assert torch.isfinite(g).all() and torch.equal(g, w)


@pytest.mark.parametrize("route", ["streamed", "team8"])
def test_split2_team_routes_equal_resident(dev, route):
    """At 104 columns the streamed ring (forced) and the yardstick (B3t-team's
    and B4t's bodies on the two-term split, "team8") give the resident
    teams' ys, ybar and seeds bit for bit."""
    n = 12
    d, (t0s, hs, dw, i10), y0, ysbar = _team2_window(dev, 104, n)
    fwd = (t0s, hs, dw, i10, n - 2, d["w2"], d["sc"], d["kv"])
    ys = ns.replay_fwd(y0, *fwd)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n - 2, 5, d["w2"], d["sc"], d["kv"])
    want = ns.replay_bwd(*bwd)
    key = {"streamed": "sde_replay_fwd", "team8": "sde2_fwd_team8"}[route]
    before = ns.LAUNCHES[key]
    assert torch.equal(ns.replay_fwd(y0, *fwd, route=route), ys)
    for g, w in zip(ns.replay_bwd(*bwd, route=route), want):
        assert torch.equal(g, w)
    torch.cuda.synchronize()
    assert ns.LAUNCHES[key] == before + 1


@pytest.mark.parametrize("columns", [13, 32, 63, 104, 150, 151, 312])
def test_split2_plan_is_the_librarys(dev, columns):
    """``sde2_replay_plan``, which the wrappers and ``sde2_replay_route``
    read, equals the plan the library launches with (``cf_sde2_plan``), and
    at least one team of each kernel fits the card."""
    import ctypes

    P, out = 8 * columns, (ctypes.c_longlong * 12)()
    for stream in (False, True):
        assert ns._lib().cf_sde2_plan(P, 4, int(stream), out) == 0
        assert tuple(out) == tuple(int(v) for v in ns.sde2_replay_plan(P, 4, stream)), stream
        plan = ns.sde2_replay_plan(P, 4, stream)
        for bwd in (False, True):
            assert ns.sde2_max_clusters(P, 4, plan.stream, bwd) >= 1


def test_bench_step_runs_the_teams_once(dev, monkeypatch):
    """bench.py's configuration at 104 columns (the jax.random tree's
    select16 selection, B3, B4 emit, the outer pass), over 20 grid points:
    one launch of each kernel, no plain version reached, finite loss."""
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_select_plain", "_attempt_plain", "_replay_fwd_plain", "_replay_bwd_plain"):
        monkeypatch.setattr(ns, name, boom)
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=FULL, n_inputs=4, time_steps=20,
                             max_steps=16384, device=dev)
    stims = make_parity_batch(torch.Generator(device=dev).manual_seed(1), 4, 4, device=dev)
    keys = torch.randint(0, 2**32, (4, 2), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int64).to(dev)
    before = dict(ns.LAUNCHES)
    rec = parity.make_train_step(task, stochastic=True, adaptive=True, select_bf16=True,
                                 grad_bf16=True, split2=True, **STEP)(stims, keys)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched == {"sde_select": 1, "sde_replay_fwd": 1, "sde_replay_bwd": 1}
    assert bool(torch.isfinite(rec["loss"])) and bool(rec["stats"].success.all())


def _parity_step(dev, cpa, grid=None, params=None, guard=None):
    kw = dict(columns_per_area=cpa, n_inputs=4, time_steps=60, max_steps=1024)
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             device=dev, **kw)
    if params is not None:
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    stims = torch.tensor([[0.0, 0.0, 0.0, 15.0], [0.0, 0.0, 15.0, 15.0],
                          [0.0, 15.0, 15.0, 15.0], [15.0, 15.0, 15.0, 15.0]], device=dev)
    words = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 2**32 - 1]], device=dev)
    rec = parity.make_train_step(task, **FLAGSHIP_FLAGS, **STEP)(stims, words, grid=grid)
    grads = {k: p.grad.detach().cpu() for k, p in task.params.items()}
    return rec, grads, params0, task


def test_parity_step_on_cuda_matches_cpu(dev):
    before = dict(ns.LAUNCHES)
    rec, grads, params0, task = _parity_step(dev, (8, 4, 1))
    torch.cuda.synchronize()
    for k in ("sde_select", "sde_replay_fwd", "sde_replay_bwd"):
        assert ns.LAUNCHES[k] == before[k] + 1, k
    st = rec["stats"]
    assert bool(st.success.all()) and bool(torch.isfinite(rec["loss"]))
    for k, g in grads.items():
        assert bool((g[~task.grad_mask[k].bool().cpu()] == 0).all()), k
    grid = tuple(x.cpu() for x in (st.step_times, st.naccept, st.nreject))
    rec_c, grads_c, _, _ = _parity_step(torch.device("cpu"), (8, 4, 1), grid=grid,
                                        params=params0)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-4)
    for k, g in grads.items():
        assert float((g - grads_c[k]).norm()) <= 1e-3 * float(grads_c[k].norm()) + 1e-30, k


def test_parity_kernels_never_reach_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_select_plain", "_attempt_plain", "_replay_fwd_plain", "_replay_bwd_plain"):
        monkeypatch.setattr(ns, name, boom)
    rec, _, _, _ = _parity_step(dev, (2, 1))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(rec["loss"]))


# ---------------------------------------------------------------------------
# The selection as cluster teams (csrc/sde_select_team.cu): select16 on both
# trees, f32 on the jax.random tree and the three-term split on the krng
# tree, at 13, 32 and 104 columns
# ---------------------------------------------------------------------------

SELECT_INSTANCES = (("select16", "jax"), ("select16", "kernel"), ("f32", "jax"),
                    ("split3", "kernel"))
SELECT_CPA = {13: (8, 4, 1), 32: (16, 8, 8), 104: FULL}


def _select_team_inputs(dev, columns, lanes, drift, tree, T):
    d = _net_inputs(dev, cpa=SELECT_CPA[columns], B=lanes)
    cfg = select_config(d["ts"][:T], max_steps=4096, brownian=tree, drift=drift)
    w = {"select16": d["w16"], "f32": d["wf"]}.get(drift)
    if drift == "split3":
        w = ns.select_weights_split3(d["wf"], d["sc"])
    return d, _sde_key_words(d["keys"], tree), cfg, w


@pytest.mark.parametrize("columns,lanes,route", [(13, 4, None), (13, 4, "streamed"),
                                                 (32, 4, None), (32, 4, "streamed"),
                                                 (104, 4, None), (104, 4, "streamed"),
                                                 (104, 8, None)])
@pytest.mark.parametrize("drift,tree", SELECT_INSTANCES)
def test_sde_select_team_equals_plain(dev, columns, lanes, route, drift, tree, monkeypatch):
    """The whole selection over 25 grid points (15 at 104 columns) on every
    route the shape admits (the team's resident slice, the ring forced; 8
    lanes at 104 columns take clusters of 8): the stats equal and the
    accepted times bit for bit, one team launch, neither the one-block
    kernel nor the plain version."""
    d, words, cfg, w = _select_team_inputs(dev, columns, lanes, drift, tree,
                                           15 if columns == 104 else 25)
    y0 = torch.zeros(lanes, 3 * d["P"], device=dev)
    want = ns._select_plain(y0, words, w, d["sc"], d["kv"], cfg)

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(ns, "_select_plain", boom)
    before = dict(ns.LAUNCHES)
    got = ns.select_pass(y0, words, w, d["sc"], d["kv"], cfg, route=route)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched == {"sde_select": 1}
    assert bool(got[3].all())
    for g, p in zip(got, want):
        assert torch.equal(g, p)


@pytest.mark.parametrize("columns", [13, 32, 104])
@pytest.mark.parametrize("route", [None, "streamed"])
@pytest.mark.parametrize("drift,tree", SELECT_INSTANCES)
def test_sde_attempt_team_equals_plain(dev, columns, route, drift, tree):
    """16 single attempts (a team each) from states in the rates' regimes,
    steps 1e-6 to 1e-3, bit for bit against the plain body."""
    d, _, _, w = _select_team_inputs(dev, columns, 4, drift, tree, 25)
    N, gen = 16, d["gen"]
    lane = torch.arange(N, device=dev) % 4
    words = _sde_key_words(d["keys"], tree)[lane].contiguous()
    kv = d["kv"][:, lane].contiguous()
    y1 = _states(gen, N, d["P"], dev)
    t1 = (0.9 * torch.rand(N, 1, generator=gen, device=dev)).contiguous()
    h = (1e-6 * 10.0 ** (torch.arange(N, device=dev)[:, None] % 4)).contiguous()
    err_prev = torch.full((N, 1), 0.7, device=dev)
    cfg = ns.SelectConfig(float(d["ts"][0]), float(d["ts"][-1]), h0=2.5e-4, brownian=tree,
                          drift=drift)
    w_t1 = ns._tree(words, cfg).evaluate(t1).contiguous()
    args = (t1, y1, h, err_prev, w_t1, words, w, d["sc"], kv, cfg)
    before = ns.LAUNCHES["sde_attempt"]
    got = ns.select_attempt(*args, route=route)
    torch.cuda.synchronize()
    assert ns.LAUNCHES["sde_attempt"] == before + 1
    for g, p in zip(got, ns._attempt_plain(*args)):
        assert torch.isfinite(g).all() and torch.equal(g, p)


@pytest.mark.parametrize("columns", [13, 24, 32, 63, 104, 312])
def test_sde_select_plan_is_the_librarys(dev, columns):
    import ctypes

    P = 8 * columns
    for drift in ("select16", "f32", "split3"):
        for C in (8, 16):
            if P % C:
                continue
            for stream in (False, True):
                plan = ns.sde_select_plan(P, 4, drift, C, stream)
                out = (ctypes.c_longlong * 15)()
                assert ns._lib().cf_sde_select_plan(P, 4, ns.SELECT_DRIFTS[drift], C,
                                                    int(stream), out) == 0
                assert tuple(int(v) for v in plan) == tuple(out), (columns, drift, C, stream)
    route, C = ns.sde_select_route(P, 4, 4, "select16", lambda c: ns.sde_select_max_clusters(
        P, 4, "jax", "select16", c, ns.sde_select_plan(P, 4, "select16", c).stream))
    assert C == (16 if P % 16 == 0 else 8) and route == ("streamed" if columns == 312
                                                         else "resident")


@pytest.mark.parametrize("path", ["flagship", "bench", "exact"])
def test_104_column_steps_launch_the_selection_team(dev, path, monkeypatch):
    """The flagship (--fused-pass: krng tree, select16), bench.py's
    configuration (jax.random tree, select16) and the exact adaptive step
    (jax.random tree, f32) at 104 columns over 20 grid points: one launch of
    the selection team, never the one-block kernel or a plain version."""
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_select_plain", "_attempt_plain"):
        monkeypatch.setattr(ns, name, boom)
    flags = {"flagship": FLAGSHIP_FLAGS,
             "bench": dict(stochastic=True, adaptive=True, select_bf16=True, grad_bf16=True,
                           split2=True),
             "exact": dict(stochastic=True, adaptive=True)}[path]
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=FULL, n_inputs=4, time_steps=20,
                             max_steps=16384, device=dev)
    stims = make_parity_batch(torch.Generator(device=dev).manual_seed(1), 4, 4, device=dev)
    keys = torch.randint(0, 2**32, (4, 2), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int64).to(dev)
    before = dict(ns.LAUNCHES)
    rec = parity.make_train_step(task, **flags, **STEP)(stims, keys)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched["sde_select"] == 1 and "sde_select_block" not in launched, launched
    assert bool(torch.isfinite(rec["loss"])) and bool(rec["stats"].success.all())


# ---------------------------------------------------------------------------
# The XLA selection on the jax.random tree, and the three-term sweeps
# ---------------------------------------------------------------------------


def _jax_inputs(dev, cpa, T):
    """The selection's inputs with the jax.random tree's key words and the
    drift its width takes: float32 below 104 columns, select16 from 104."""
    d = _net_inputs(dev, cpa=cpa, T=T)
    keys = torch.randint(0, 2**32, (4, 2), generator=d["gen"], device=dev, dtype=torch.int64)
    drift = "select16" if sum(cpa) >= 104 else "f32"
    cfg = select_config(d["ts"], max_steps=4096, brownian="jax", drift=drift)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, net = nw.build_column_network(ColumnConfig.load(), gen, columns_per_area=cpa,
                                          n_inputs=4, device=dev)
    pw = {k: v.detach().contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    w = d["w16"] if drift == "select16" else pw
    return d, _sde_key_words(keys, "jax"), cfg, w, pw


@pytest.mark.parametrize("cpa", [(8, 4, 1), (64, 32, 8)])
def test_jax_tree_selection_kernel_matches_plain_bit_for_bit(dev, cpa):
    d, words, cfg, w, _ = _jax_inputs(dev, cpa, T=50)
    y0 = torch.zeros(4, 3 * d["P"], device=dev)
    before = ns.LAUNCHES["sde_select"]
    got = ns.select_pass(y0, words, w, d["sc"], d["kv"], cfg)
    torch.cuda.synchronize()
    assert ns.LAUNCHES["sde_select"] == before + 1
    want = ns._select_plain(y0, words, w, d["sc"], d["kv"], cfg)
    assert bool(got[3].all())
    for g, p in zip(got, want):
        assert torch.equal(g, p)


def test_jax_tree_attempt_kernel_matches_plain_bit_for_bit(dev):
    d, words, cfg, w, _ = _jax_inputs(dev, (8, 4, 1), T=1000)
    N, gen = 16, d["gen"]
    lane = torch.arange(N, device=dev) % 4
    words, kv = words[lane].contiguous(), d["kv"][:, lane].contiguous()
    y1 = _states(gen, N, d["P"], dev)
    t1 = (0.9 * torch.rand(N, 1, generator=gen, device=dev)).contiguous()
    h = (1e-6 * 10.0 ** (torch.arange(N, device=dev)[:, None] % 4)).contiguous()
    err_prev = torch.full((N, 1), 0.7, device=dev)
    w_t1 = ns._tree(words, cfg).evaluate(t1).contiguous()
    got = ns.select_attempt(t1, y1, h, err_prev, w_t1, words, w, d["sc"], kv, cfg)
    want = ns._attempt_plain(t1, y1, h, err_prev, w_t1, words, w, d["sc"], kv, cfg)
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        assert torch.equal(g, p)


@pytest.mark.parametrize("lanes", [True, False])
def test_sde3_kernels_match_plain_bit_for_bit(dev, lanes):
    """B3t and B4't at 13 columns: per-lane grids (a selection's, with the
    jax.random tree's noise, the padding past the longest lane skipped) or
    the uniform grid (every lane the same times); B4't on its shape's route,
    the cluster team for the batch."""
    from columnflow_torch.solvers.fused import uniform_step_times

    d, words, cfg, w, pw = _jax_inputs(dev, (8, 4, 1), T=100)
    B, P = 4, d["P"]
    y0 = torch.zeros(B, 3 * P, device=dev)
    if lanes:
        st, na, _, _ = ns.select_pass(y0, words, w, d["sc"], d["kv"], cfg)
        ht, dw, i10 = _replay_grid(st, words, cfg.t_start, cfg.t_end, cfg.depth, "jax")
        t0s, hs = ht[:, :-1].T.contiguous(), (ht[:, 1:] - ht[:, :-1]).T.contiguous()
        dw, i10 = dw.T.contiguous(), i10.T.contiguous()
        n_real = 2 * int(na.max())
    else:
        t0s, h = uniform_step_times(d["ts"], (B, 3 * P))
        t0s = t0s.to(dev)
        hs = torch.full_like(t0s, h)
        _, dw, i10, _, _ = brownian_pack(d["gen"], d["ts"], (B, 1))
        dw, i10 = dw.reshape(-1, B).contiguous(), i10.reshape(-1, B).contiguous()
        n_real = t0s.shape[0]
    before = dict(ns.LAUNCHES)
    fwd = (t0s, hs, dw, i10, n_real, pw, d["sc"], d["kv"])
    ys = ns.replay3_fwd(y0, *fwd)
    ysbar = torch.randn((t0s.shape[0],) + tuple(y0.shape), generator=d["gen"], device=dev)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n_real, 16, 10, pw, d["sc"], d["kv"])
    got = ns.replay3_bwd(*bwd)
    torch.cuda.synchronize()
    assert ns.LAUNCHES["sde3_fwd"] == before["sde3_fwd"] + 1
    assert ns.LAUNCHES["sde3_bwd_ksweep"] == before["sde3_bwd_ksweep"] + 1
    assert torch.equal(ys, ns._replay3_fwd_plain(y0, *fwd))
    for g, p in zip(got, ns._replay3_bwd_plain(*bwd)):
        assert torch.isfinite(g).all() and torch.equal(g, p)


@pytest.mark.parametrize("adaptive", [False, True])
def test_stochastic_13_column_steps_on_cuda_match_cpu(dev, adaptive, monkeypatch):
    """The fixed-grid step (B3t, B4't on the uniform grid) and the XLA
    selection's step (the jax-tree selection, B3t, B4't on per-lane grids)
    through make_train_step, one launch of each kernel and no plain
    version; the same step on the CPU on the card's grid and noise: the
    loss within 1e-5, each gradient within the larger of 3e-2 and ten times
    the card's own spread under a 1e-7 nudge of the weights (over these 100
    points the fixed grid's input and lateral gradients move by 6% under
    such a nudge on the card)."""
    flags = dict(stochastic=True, adaptive=adaptive)

    def step_on(device, params=None, grid=None, noise=None):
        task = parity.build_task(ColumnConfig.load(),
                                 torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=(8, 4, 1), time_steps=100, max_steps=3072,
                                 device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        stims = torch.tensor(ODE_STIMS, device=device)
        keys = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 2**32 - 1]], device=device)
        if not adaptive and noise is None:
            _, i1, i10, _, _ = brownian_pack(torch.Generator(device=device).manual_seed(3),
                                             task.ts, (4, 1))
            noise = (i1, i10)
        rec = parity.make_train_step(task, **flags)(
            stims, keys if adaptive else None, grid=grid,
            noise=None if noise is None else tuple(x.to(device) for x in noise))
        return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}, task, noise

    gen0 = torch.Generator(device=dev).manual_seed(0)
    params0 = {k: p.detach().cpu().clone() for k, p in parity.build_task(
        ColumnConfig.load(), gen0, columns_per_area=(8, 4, 1), time_steps=100,
        device=dev).params.items()}

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    with monkeypatch.context() as m:
        for name in ("_select_plain", "_replay_fwd_plain", "_replay3_bwd_plain"):
            m.setattr(ns, name, boom)
        before = dict(ns.LAUNCHES)
        rec, grads, task, noise = step_on(dev)
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    want = {"sde3_fwd": 1, "sde3_bwd_ksweep": 1}
    if adaptive:
        want["sde_select"] = 1
    assert launched == want
    assert bool(torch.isfinite(rec["loss"]))
    grid = None
    if adaptive:
        st = rec["stats"]
        grid = tuple(x.cpu() for x in (st.step_times, st.naccept, st.nreject))
    rec_c, grads_c, _, _ = step_on(torch.device("cpu"), params=params0, grid=grid,
                                   noise=None if noise is None else tuple(x.cpu() for x in noise))
    _, grads_n, _, _ = step_on(dev, params={k: v * (1.0 + 1e-7) for k, v in params0.items()},
                               grid=None if grid is None else tuple(x.to(dev) for x in grid),
                               noise=noise)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        spread = float((grads_n[k] - g).norm()) / float(g.norm())
        err = float((g - grads_c[k]).norm()) / float(grads_c[k].norm())
        assert err <= max(3e-2, 10.0 * spread), (k, err, spread)


def _team_grid(dev, gen, B, P, n, lanes, ts):
    """A window of n steps: the uniform grid's first n steps, or per-lane
    grids with each lane's own step sizes (0.2-1 ms), with Brownian data of
    those steps; start states from the rate regimes of ``_states``."""
    from columnflow_torch.solvers.fused import uniform_step_times

    if lanes:
        hs = (2e-4 + 8e-4 * torch.rand(n, B, generator=gen, device=dev)).contiguous()
        t0s = (torch.cumsum(hs, 0) - hs + 0.3).contiguous()
        h = hs
    else:
        t0s, h0 = uniform_step_times(ts, (B, 3 * P))
        t0s = t0s[:n].to(dev).contiguous()
        hs = torch.full_like(t0s, h0)
        h = hs[:, None].expand(n, B)
    dw = torch.randn(n, B, generator=gen, device=dev) * h.sqrt()
    i10 = h * (0.5 * dw + (h / 12.0).sqrt() * torch.randn(n, B, generator=gen, device=dev))
    return t0s, hs, dw.contiguous(), i10.contiguous()


@pytest.mark.parametrize("cpa,lanes", [((64, 32, 8), False), ((64, 32, 8), True),
                                       ((192, 96, 24), False)])
def test_sde3_team_kernels_match_plain_bit_for_bit(dev, cpa, lanes):
    """B3t-team and B4t (the emit-mode sweep with truncation every 5 steps)
    at 104 and 312 columns on short windows, against their plain versions:
    bit for bit, one launch each."""
    d = _net_inputs(dev, cpa=cpa, T=1000)
    gen, B, P = d["gen"], 4, d["P"]
    params, net = nw.build_column_network(ColumnConfig.load(), gen, columns_per_area=cpa,
                                          n_inputs=4, device=dev)
    pw = {k: v.detach().contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    n = 8 if sum(cpa) > 104 else 16
    t0s, hs, dw, i10 = _team_grid(dev, gen, B, P, n, lanes, d["ts"])
    y0 = _states(gen, B, P, dev)
    before = dict(ns.LAUNCHES)
    fwd = (t0s, hs, dw, i10, n - 2, pw, d["sc"], d["kv"])
    ys = ns.replay3_fwd(y0, *fwd)
    ysbar = torch.randn((n, B, 3 * P), generator=gen, device=dev)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n - 2, 5, pw, d["sc"], d["kv"])
    got = ns.replay3_bwd_emit(*bwd)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched == {"sde3_fwd_team": 1, "sde3_bwd_emit": 1}
    assert torch.isfinite(ys).all() and torch.equal(ys, ns._replay3_fwd_plain(y0, *fwd))
    for g, p in zip(got, ns._replay3_bwd_emit_plain(*bwd)):
        assert torch.isfinite(g).all() and torch.equal(g, p)


def test_sde3_forward_takes_the_kernel_its_shape_picks(dev):
    """The one-block B3t at 13 columns, B3t-team at 64, by shape alone; both
    agree with the plain version bit for bit."""
    from columnflow_torch.solvers.fused import uniform_step_times

    for cpa, kernel in (((8, 4, 1), "sde3_fwd"), ((32, 24, 8), "sde3_fwd_team")):
        d = _net_inputs(dev, cpa=cpa, T=100)
        gen, B, P = d["gen"], 4, d["P"]
        assert ns.sde3_fwd_route(P, 4) == ("block" if kernel == "sde3_fwd" else "team")
        params, net = nw.build_column_network(ColumnConfig.load(), gen, columns_per_area=cpa,
                                              n_inputs=4, device=dev)
        pw = {k: v.detach().contiguous()
              for k, v in nw.premix_network_weights(params, net).items()}
        t0s, h = uniform_step_times(d["ts"], (B, 3 * P))
        t0s = t0s.to(dev)
        n = t0s.shape[0]
        dw = torch.randn(n, B, generator=gen, device=dev) * h ** 0.5
        fwd = (t0s, torch.full_like(t0s, h), dw, torch.zeros_like(dw), n, pw, d["sc"], d["kv"])
        before = ns.LAUNCHES[kernel]
        ys = ns.replay3_fwd(torch.zeros(B, 3 * P, device=dev), *fwd)
        torch.cuda.synchronize()
        assert ns.LAUNCHES[kernel] == before + 1
        assert torch.equal(ys, ns._replay3_fwd_plain(torch.zeros(B, 3 * P, device=dev), *fwd))


def test_fixed_grid_104_column_step_on_cuda_matches_cpu(dev, monkeypatch):
    """The fixed-grid step at 104 columns (outer mode) over 4 grid points
    through make_train_step: exactly one B3t-team and one B4t launch and no
    plain version; the same step on the CPU with the plain versions on the
    card's noise: loss rel 1e-5, each gradient within the larger of 3e-2
    and ten times the card's own spread under a 1e-7 nudge of the weights
    (gradients at this width are ill-conditioned, ROADMAP.md section C).
    From grid point 4 SRA1 at h = 1 ms runs off at this width, in the JAX
    package too (|y| ~ 1e3 at 4 ms, ~1e6 at 5 ms), so the horizon ends
    before it."""
    def step_on(device, params=None, noise=None):
        task = parity.build_task(ColumnConfig.load(),
                                 torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=(64, 32, 8), time_steps=4, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        if noise is None:
            _, i1, i10, _, _ = brownian_pack(torch.Generator(device=device).manual_seed(3),
                                             task.ts, (4, 1))
            noise = (i1, i10)
        rec = parity.make_train_step(task, stochastic=True)(
            torch.tensor(ODE_STIMS, device=device), noise=tuple(x.to(device) for x in noise))
        return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}, task, noise

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    with monkeypatch.context() as m:
        for name in ("_replay3_fwd_plain", "_replay3_bwd_emit_plain", "_replay3_bwd_plain"):
            m.setattr(ns, name, boom)
        before = dict(ns.LAUNCHES)
        rec, grads, task, noise = step_on(dev)
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched == {"sde3_fwd_team": 1, "sde3_bwd_emit": 1}
    assert bool(torch.isfinite(rec["loss"]))
    params0 = {k: p.detach().cpu().clone() for k, p in parity.build_task(
        ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
        columns_per_area=(64, 32, 8), time_steps=4, device=dev).params.items()}
    rec_c, grads_c, _, _ = step_on(torch.device("cpu"), params=params0,
                                   noise=tuple(x.cpu() for x in noise))
    _, grads_n, _, _ = step_on(dev, params={k: v * (1.0 + 1e-7) for k, v in params0.items()},
                               noise=noise)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        if not bool(grads_c[k].any()):  # the stimulus' weights before it is on
            assert not bool(g.any()), k
            continue
        spread = float((grads_n[k] - g).norm()) / float(g.norm())
        err = float((g - grads_c[k]).norm()) / float(grads_c[k].norm())
        assert err <= max(3e-2, 10.0 * spread), (k, err, spread)


# ---------------------------------------------------------------------------
# B3t-team and B4t as cluster teams per lane (csrc/sde3_replay_team.cu)
# ---------------------------------------------------------------------------


def _sde3_team_setup(dev, columns, B, lanes):
    """The parity network at ``columns`` (4 inputs), B lanes' knot values,
    a window of n half steps from t = 0.3 s: the uniform grid's (t0s, hs
    (n,), h = 50 us) or per-lane grids (20-100 us), with Brownian data of
    those steps; and start states from the rates' working range
    (``_states``)."""
    cpa = {13: (8, 4, 1), 32: (16, 8, 8), 104: (64, 32, 8), 312: (192, 96, 24)}[columns]
    d = _net_inputs(dev, cpa=cpa, B=B, T=1000)
    gen = d["gen"]
    params, net = nw.build_column_network(ColumnConfig.load(), gen, columns_per_area=cpa,
                                          n_inputs=4, device=dev)
    pw = {k: v.detach().contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    n = 24 if columns == 312 else 72
    if lanes:
        hs = (2e-5 + 8e-5 * torch.rand(n, B, generator=gen, device=dev)).contiguous()
        h = hs
    else:
        hs = torch.full((n,), 5e-5, device=dev)
        h = hs[:, None].expand(n, B)
    t0s = (torch.cumsum(hs, 0) - hs + 0.3).contiguous()
    dw = torch.randn(n, B, generator=gen, device=dev) * h.sqrt()
    i10 = h * (0.5 * dw + (h / 12.0).sqrt() * torch.randn(n, B, generator=gen, device=dev))
    return d, pw, n, (t0s, hs, dw.contiguous(), i10.contiguous()), _states(gen, B, d["P"], dev)


@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("columns", [13, 32, 104, 312])
def test_sde3_cluster_teams_equal_plain(dev, columns, B, lanes):
    """B3t-team and B4t as cluster teams at 13, 32, 104 and 312 columns,
    1, 4 and 8 lanes (clusters of 8 where 16 does not divide P or the card
    holds fewer clusters of 16 than lanes), on the uniform and per-lane
    grids, over 72 half steps (24 at 312) with n_real two short, the sweep
    with truncation every 64 steps and none. From the zero state (where
    every step of the main path starts): on the shape's route, on the other
    one and on team8, the states, seeds and carry bit for bit against the
    plain versions (so every route equals the others), one launch of the
    route's kernel each and nothing else. From ``_states``'s high rates the
    windows run off (|y| ~ 1e4-1e5 within a dozen steps at 104 and 312
    columns), where team8's sum order and the card's float64 matmul of the
    plain version part on a near-tie now and then; there every route is
    held bit for bit against team8."""
    d, pw, n, grid, y_hi = _sde3_team_setup(dev, columns, B, lanes)
    P = d["P"]
    y0 = torch.zeros_like(y_hi)
    fwd = (*grid, n - 2, pw, d["sc"], d["kv"])
    want_ys = ns._replay3_fwd_plain(y0, *fwd)
    ysbar = torch.randn((n, B, 3 * P), generator=d["gen"], device=dev)
    ys_hi = ns.replay3_fwd(y_hi, *fwd, route="team8")
    bwd_hi = (ys_hi[:-1].contiguous(), ysbar, grid[0], grid[1], grid[3], n - 2, 64, pw, d["sc"],
              d["kv"])
    seeds_hi = ns.replay3_bwd_emit(*bwd_hi, route="team8")
    for bwd in (False, True):
        plan = ns._sde3_team(None, P, 4, B, bwd)
        route = "streamed" if plan.stream else "resident"
        assert plan.C == (16 if P % 16 == 0 and B <= 7 else 8)
        for r in list(dict.fromkeys([route, "streamed"])) + ["team8"]:
            key = ("sde3_bwd_emit" if bwd else "sde3_fwd_team") + ("_team8" if r == "team8"
                                                                    else "")
            for stride in ((0, 64) if bwd else (None,)):
                before = dict(ns.LAUNCHES)
                if bwd:
                    args = (want_ys[:-1].contiguous(), ysbar, grid[0], grid[1], grid[3], n - 2,
                            stride, pw, d["sc"], d["kv"])
                    got = ns.replay3_bwd_emit(*args, route=r)
                    want = ns._replay3_bwd_emit_plain(*args)
                else:
                    got, want = (ns.replay3_fwd(y0, *fwd, route=r),), (want_ys,)
                torch.cuda.synchronize()
                launched = {k: ns.LAUNCHES[k] - before[k] for k in before
                            if ns.LAUNCHES[k] != before[k]}
                assert launched == {key: 1}, (r, launched)
                for g, x in zip(got, want):
                    assert torch.isfinite(g).all() and torch.equal(g, x), (bwd, r, stride)
            if bwd:
                got, want = ns.replay3_bwd_emit(*bwd_hi, route=r), seeds_hi
            else:
                got, want = (ns.replay3_fwd(y_hi, *fwd, route=r),), (ys_hi,)
            for g, x in zip(got, want):
                assert torch.equal(g, x), (bwd, r, "high rates")


@pytest.mark.parametrize("columns", [13, 24, 32, 63, 94, 104, 312])
def test_sde3_team_plan_is_the_librarys(dev, columns):
    """``sde3_team_plan`` (the wrappers' and ``sde3_team_route``'s) equals the
    library's (``cf_ode_team_plan`` with REPLAY and SDE_SWEEP) on clusters
    of 8 and (where 16 divides P) 16, resident and streamed; the card holds
    at least one cluster of each (``cf_sde3_max_clusters``)."""
    import ctypes

    P, out = 8 * columns, (ctypes.c_longlong * 23)()
    for bwd in (False, True):
        for C in (8, 16):
            if P % C:
                continue
            for stream in (False, True):
                use = no.SDE_SWEEP if bwd else no.REPLAY
                assert no._lib().cf_ode_team_plan(P, 4, 1, 3, use, C, int(stream), out) == 0
                plan = ns.sde3_team_plan(P, 4, bwd, stream, C)
                assert tuple(out) == tuple(int(v) for v in plan), (bwd, C, stream)
                assert ns.sde3_max_clusters(P, 4, C, plan.stream, bwd) >= 1


@pytest.mark.parametrize("case", ["exact104", "fixed104", "kernel32", "adaptive32",
                                  "split2_32"])
def test_sde3_steps_launch_the_cluster_teams(dev, monkeypatch, case):
    """The exact stochastic-adaptive step (``--stochastic --adaptive --engine
    fused`` at 104 columns, 10 points), the fixed-grid step at 104 columns,
    and at 32 columns the kernel-mode steps: ``--stochastic``,
    ``--stochastic --adaptive`` and ``--stochastic --adaptive --engine
    fused-split2``: with the plain versions made to raise, each launches its
    forward (B3t-team, or B3 on two terms) once and its sweep once, the
    cluster teams (B4t at 104 columns; at 32 B4't and B4s as one cluster
    team for the batch, ``sde3_bwd_ksweep`` and ``sde2_bwd_ksweep``), never
    team8 or the 8-block teams."""
    flags = {"exact104": dict(stochastic=True, adaptive=True, bptt_every=32, loss_scale=1e-6),
             "fixed104": dict(stochastic=True), "kernel32": dict(stochastic=True),
             "adaptive32": dict(stochastic=True, adaptive=True),
             "split2_32": dict(stochastic=True, adaptive=True, split2=True)}[case]
    cpa = (16, 8, 8) if case.endswith("32") else (64, 32, 8)
    want = {"exact104": {"sde_select": 1, "sde3_fwd_team": 1, "sde3_bwd_emit": 1},
            "fixed104": {"sde3_fwd_team": 1, "sde3_bwd_emit": 1},
            "kernel32": {"sde3_fwd_team": 1, "sde3_bwd_ksweep": 1},
            "adaptive32": {"sde_select": 1, "sde3_fwd_team": 1, "sde3_bwd_ksweep": 1},
            "split2_32": {"sde_select": 1, "sde_replay_fwd": 1, "sde2_bwd_ksweep": 1}}[case]

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_select_plain", "_replay3_fwd_plain", "_replay3_bwd_emit_plain",
                 "_replay3_bwd_plain", "_replay_fwd_plain", "_replay2_bwd_plain"):
        monkeypatch.setattr(ns, name, boom)
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=cpa, time_steps=10, max_steps=16384, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    stims = torch.tensor(ODE_STIMS, device=dev)
    keys, noise = None, None
    if flags.get("adaptive"):
        keys = torch.randint(0, 2**32, (4, 2), generator=gen, device=dev, dtype=torch.int64)
    else:
        _, i1, i10, _, _ = brownian_pack(gen, task.ts, (4, 1))
        noise = (i1, i10)
    before = dict(ns.LAUNCHES)
    rec = parity.make_train_step(task, **flags)(stims, keys, noise=noise)
    torch.cuda.synchronize()
    launched = {k: ns.LAUNCHES[k] - before[k] for k in before if ns.LAUNCHES[k] != before[k]}
    assert launched == want, launched
    assert bool(torch.isfinite(rec["loss"]))


def _krng_inputs(dev, cpa, T):
    """The in-kernel pass's inputs on the three-term split (B5t): the krng
    tree's key words, ``select_weights_split3`` of the network's weights."""
    d = _net_inputs(dev, cpa=cpa, T=T)
    keys = torch.randint(0, 2**32, (4, 2), generator=d["gen"], device=dev, dtype=torch.int64)
    params, net = nw.build_column_network(ColumnConfig.load(),
                                          torch.Generator(device=dev).manual_seed(0),
                                          columns_per_area=cpa, n_inputs=4, device=dev)
    pw = {k: v.detach().contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    cfg = select_config(d["ts"], max_steps=4096, brownian="kernel", drift="split3")
    return d, _sde_key_words(keys, "kernel"), cfg, ns.select_weights_split3(pw, d["sc"]), pw


@pytest.mark.parametrize("cpa,T", [((8, 4, 1), 100), ((64, 32, 8), 10)])
def test_split3_selection_kernels_match_plain_bit_for_bit(dev, cpa, T):
    """B5t (the selection on the three-term split, krng tree) at 13 and 104
    columns: the whole selection over T grid points and 8 single attempts
    from states in the rates' regimes, bit for bit against the plain
    versions, one launch each."""
    d, words, cfg, w3, _ = _krng_inputs(dev, cpa, T)
    P, gen = d["P"], d["gen"]
    y0 = torch.zeros(4, 3 * P, device=dev)
    before = dict(ns.LAUNCHES)
    got = ns.select_pass(y0, words, w3, d["sc"], d["kv"], cfg)
    N = 8
    lane = torch.arange(N, device=dev) % 4
    w_r, kv = words[lane].contiguous(), d["kv"][:, lane].contiguous()
    y1 = _states(gen, N, P, dev)
    t1 = (0.9 * cfg.t_end * torch.rand(N, 1, generator=gen, device=dev)).contiguous()
    h = (1e-6 * 10.0 ** (torch.arange(N, device=dev)[:, None] % 4)).contiguous()
    err_prev = torch.full((N, 1), 0.7, device=dev)
    w_t1 = ns._tree(w_r, cfg).evaluate(t1).contiguous()
    att = ns.select_attempt(t1, y1, h, err_prev, w_t1, w_r, w3, d["sc"], kv, cfg)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched == {"sde_select": 1, "sde_attempt": 1}
    assert bool(got[3].all())
    for g, p in zip(got, ns._select_plain(y0, words, w3, d["sc"], d["kv"], cfg)):
        assert torch.equal(g, p)
    for g, p in zip(att, ns._attempt_plain(t1, y1, h, err_prev, w_t1, w_r, w3, d["sc"], kv, cfg)):
        assert torch.isfinite(g).all() and torch.equal(g, p)


@pytest.mark.parametrize("cpa,lanes", [((16, 8, 8), False), ((16, 8, 8), True),
                                       ((32, 24, 7), False), ((32, 24, 7), True)])
def test_sde3_bwd_team_matches_plain_bit_for_bit(dev, cpa, lanes):
    """B4't-team (the kernel-mode sweep on one team of 8 blocks, now the
    yardstick behind route "team") at 32 and 63 columns, past one block's
    capacity, on 12-step windows (the last two steps padding, truncation
    every 5 steps, chunk 4): ybar, d wT and d iwT bit for bit against the
    plain version, one launch; the shape's own route there is the cluster
    team for the batch."""
    d = _net_inputs(dev, cpa=cpa, T=1000)
    gen, B, P = d["gen"], 4, d["P"]
    assert ns.sde3_bwd_route(P, 4, B) in ("resident", "streamed")
    params, net = nw.build_column_network(ColumnConfig.load(), gen, columns_per_area=cpa,
                                          n_inputs=4, device=dev)
    pw = {k: v.detach().contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    n = 12
    t0s, hs, dw, i10 = _team_grid(dev, gen, B, P, n, lanes, d["ts"])
    ys = ns.replay3_fwd(_states(gen, B, P, dev), t0s, hs, dw, i10, n - 2, pw, d["sc"], d["kv"])
    ysbar = torch.randn((n, B, 3 * P), generator=gen, device=dev)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n - 2, 5, 4, pw, d["sc"], d["kv"])
    before = dict(ns.LAUNCHES)
    got = ns.replay3_bwd(*bwd, route="team")
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched == {"sde3_bwd_team": 1}
    want = ns._replay3_bwd_plain(*bwd)
    assert bool(got[1].any())  # ybar is zeroed after step 0; d iwT is 0 before the stimulus
    for g, p in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, p)


@pytest.mark.parametrize("lanes", [False, True])
def test_sde3_bwd_team_equals_the_one_block_sweep(dev, lanes, monkeypatch):
    """At 13 columns every kernel-mode sweep fits: B4't-team, the one-block
    B4't (route "block") and the cluster team for the batch (the shape's
    route) agree bit for bit over 40 steps (truncation every 16, chunk
    10)."""
    d = _net_inputs(dev, cpa=(8, 4, 1), T=1000)
    gen, B, P = d["gen"], 4, d["P"]
    assert ns.sde3_bwd_route(P, 4, B) == "resident" and ns.sde3_block_fits(P, 4, B)
    params, net = nw.build_column_network(ColumnConfig.load(), gen, columns_per_area=(8, 4, 1),
                                          n_inputs=4, device=dev)
    pw = {k: v.detach().contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    n = 40
    t0s, hs, dw, i10 = _team_grid(dev, gen, B, P, n, lanes, d["ts"])
    ys = ns.replay3_fwd(_states(gen, B, P, dev), t0s, hs, dw, i10, n, pw, d["sc"], d["kv"])
    ysbar = torch.randn((n, B, 3 * P), generator=gen, device=dev)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n, 16, 10, pw, d["sc"], d["kv"])
    before = dict(ns.LAUNCHES)
    block = ns.replay3_bwd(*bwd, route="block")
    monkeypatch.setattr(ns, "sde3_bwd_route", lambda *a: "team")
    team = ns.replay3_bwd(*bwd)
    cluster = ns.replay3_bwd(*bwd, route="resident")
    assert ns.LAUNCHES["sde3_bwd"] == before["sde3_bwd"] + 1
    assert ns.LAUNCHES["sde3_bwd_team"] == before["sde3_bwd_team"] + 1
    assert ns.LAUNCHES["sde3_bwd_ksweep"] == before["sde3_bwd_ksweep"] + 1
    torch.cuda.synchronize()
    for a, b, c in zip(team, block, cluster):
        assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.parametrize("flags", [dict(grad_bf16=True), dict(fused_pass=True),
                                   dict(outer=True)])
def test_lanes_outer_adaptive_step_on_cuda_matches_cpu(dev, flags, monkeypatch):
    """The stochastic-adaptive step at 13 columns over 50 grid points on the
    tiers this slice ports: ``grad_bf16`` (outer mode at any width: B3t,
    then B4t lanes as teams of 13 populations per block, then the gradbf16
    substitute), ``fused_pass`` (B5t, then B3t and B4't), and the exact
    outer tier on per-lane grids (weights forced to outer mode). One launch
    of each kernel of the path and no plain version; the same step on the
    CPU on the card's grid: loss rel 1e-5, each gradient within the larger
    of 1e-3 and ten times the card's own spread under a 1e-7 nudge."""
    from columnflow_torch.solvers import fused as sf

    flags = dict(flags)
    if flags.pop("outer", False):
        monkeypatch.setattr(sf, "OUTER_ARG_BYTES", 0)
    keys = torch.randint(0, 2**32, (4, 2), generator=torch.Generator().manual_seed(4),
                         dtype=torch.int64)

    def step_on(device, params=None, grid=None):
        task = parity.build_task(ColumnConfig.load(),
                                 torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=(8, 4, 1), time_steps=50, device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        rec = parity.make_train_step(task, stochastic=True, adaptive=True, **flags)(
            torch.tensor(ODE_STIMS, device=device), keys.to(device), grid=grid)
        return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    params0 = {k: p.detach().cpu().clone() for k, p in parity.build_task(
        ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
        columns_per_area=(8, 4, 1), time_steps=50, device=dev).params.items()}
    with monkeypatch.context() as m:
        for name in ("_select_plain", "_replay3_fwd_plain", "_replay3_bwd_emit_plain",
                     "_replay3_bwd_plain"):
            m.setattr(ns, name, boom)
        before = dict(ns.LAUNCHES)
        rec, grads = step_on(dev, params0)
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    kernel_mode = "fused_pass" in flags
    assert launched == {"sde_select": 1, "sde3_fwd": 1,
                        ("sde3_bwd_ksweep" if kernel_mode else "sde3_bwd_emit"): 1}
    st = rec["stats"]
    grid = tuple(x.cpu() for x in (st.step_times, st.naccept, st.nreject))
    rec_c, grads_c = step_on(torch.device("cpu"), params0, grid)
    _, grads_n = step_on(dev, {k: v * (1.0 + 1e-7) for k, v in params0.items()},
                         tuple(x.to(dev) for x in grid))
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        if not bool(grads_c[k].any()):
            assert not bool(g.any()), k
            continue
        spread = float((grads_n[k] - g).norm()) / float(g.norm())
        err = float((g - grads_c[k]).norm()) / float(grads_c[k].norm())
        assert err <= max(1e-3, 10.0 * spread), (k, err, spread)


# ---------------------------------------------------------------------------
# The dopri5 kernels (deterministic parity step)
# ---------------------------------------------------------------------------

ODE_STIMS = [[0.0, 0.0, 0.0, 15.0], [0.0, 0.0, 15.0, 15.0], [0.0, 15.0, 15.0, 15.0],
             [15.0, 15.0, 15.0, 15.0]]


@pytest.fixture
def ode(dev):
    from columnflow_torch.solvers.fused import round_max_steps

    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=(8, 4, 1), n_inputs=4, time_steps=200,
                             max_steps=1024, device=dev)
    stims = torch.tensor(ODE_STIMS, device=dev)
    model = parity.sde_model(task.params, task, stims)
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    P = task.net.num_pops
    cfg = no.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]),
                             max_steps=round_max_steps((4, 3 * P), 1024))
    return dict(task=task, stims=stims, pw=pw, sc=model.sc, kv=model.kv.contiguous(), P=P,
                cfg=cfg, w3=no._w3(pw, model.sc), y0=torch.zeros(4, 3 * P, device=dev))


def test_ode_select_kernel_equals_plain(ode):
    d = ode
    before = no.LAUNCHES["ode_select"]
    st, stats = no.ode_select(d["y0"], d["pw"], d["sc"], d["kv"], d["cfg"])
    st_p, stats_p = no._ode_select_plain(d["y0"], d["w3"], d["sc"], d["kv"], d["cfg"])
    torch.cuda.synchronize()
    assert no.LAUNCHES["ode_select"] == before + 1
    assert int(stats[2]) == 1 and stats.tolist() == stats_p.tolist()
    assert torch.equal(st, st_p)
    assert bool((st[int(stats[0]):] == d["cfg"].t_end).all())


def test_ode_select_with_a_given_first_step_and_exhaustion(ode):
    d = ode
    cfg = d["cfg"]._replace(dt0=1e-5, max_steps=38)  # a first step small enough to be accepted
    st, stats = no.ode_select(d["y0"], d["pw"], d["sc"], d["kv"], cfg)
    st_p, stats_p = no._ode_select_plain(d["y0"], d["w3"], d["sc"], d["kv"], cfg)
    torch.cuda.synchronize()
    assert stats.tolist() == stats_p.tolist() and int(stats[0]) == 38 and int(stats[2]) == 0
    assert torch.equal(st, st_p) and float(st[1]) == float(torch.tensor(1e-5))


def test_ode_replay_kernels_equal_plain(ode):
    d = ode
    st, stats = no.ode_select(d["y0"], d["pw"], d["sc"], d["kv"], d["cfg"])
    n = min(int(stats[0]), 96)
    stn = st[:n + 1].contiguous()
    ys, co = no.ode_replay_fwd(d["y0"], stn, d["pw"], d["sc"], d["kv"])
    ys_p, co_p = no._ode_replay_fwd_plain(d["y0"], stn, d["w3"], d["sc"], d["kv"])
    assert torch.isfinite(co).all() and torch.equal(ys, ys_p) and torch.equal(co, co_p)
    gen = torch.Generator(device=ys.device).manual_seed(1)
    cobar = torch.randn(co.shape, generator=gen, device=ys.device)
    got = no.ode_replay_bwd(ys, cobar, stn, d["pw"], d["sc"], d["kv"])
    want = no._ode_replay_bwd_plain(ys, cobar, stn, d["w3"], d["sc"], d["kv"])
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("ybar", "d_wT", "d_iwT")):
        assert torch.isfinite(g).all() and torch.equal(g, w), name
    # An empty grid: nothing to sweep.
    ybar, d_wT, d_iwT = no.ode_replay_bwd(ys[:0], cobar[:0], st[:1].contiguous(), d["pw"],
                                          d["sc"], d["kv"])
    assert not bool(ybar.any()) and not bool(d_wT.any()) and not bool(d_iwT.any())


def test_ode_wrappers_raise_on_a_batch_too_large_for_one_block(ode):
    """Sixteen (B, 312) states and the split weights exceed one block's
    shared memory: the sweep no longer raises but routes to the cluster team
    for the batch (its accumulators in device memory there), which equals
    the plain version bit for bit."""
    d = ode
    B = 16
    kv = d["kv"][:, :1].expand(-1, B, -1).contiguous()
    assert no.ode_block_bytes(d["P"], 4, B, True) > 232448
    assert no.ode_bwd_route(d["P"], 4, B) == "resident"
    assert not no.ode_team_plan(d["P"], 4, B, 3, no.KSWEEP).accs
    y0 = torch.zeros(B, 3 * d["P"], device=kv.device)
    st, stats = no.ode_select(y0, d["pw"], d["sc"], kv, d["cfg"])
    stn = st[:17].contiguous()
    ys, co = no.ode_replay_fwd(y0, stn, d["pw"], d["sc"], kv)
    cobar = torch.randn(co.shape, generator=torch.Generator(device=kv.device).manual_seed(3),
                        device=kv.device)
    before = no.LAUNCHES["ode_replay_bwd_ksweep"]
    got = no.ode_replay_bwd(ys, cobar, stn, d["pw"], d["sc"], kv)
    want = no._ode_replay_bwd_plain(ys, cobar, stn, d["w3"], d["sc"], kv)
    torch.cuda.synchronize()
    assert no.LAUNCHES["ode_replay_bwd_ksweep"] == before + 1
    for g, w, name in zip(got, want, ("ybar", "d_wT", "d_iwT")):
        assert torch.isfinite(g).all() and torch.equal(g, w), name


def _ode_step(dev, grid=None, params=None):
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=(8, 4, 1), n_inputs=4, time_steps=100,
                             max_steps=1024, device=dev)
    if params is not None:
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    rec = parity.make_train_step(task)(torch.tensor(ODE_STIMS, device=dev), grid=grid)
    return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}, params0, task


def test_deterministic_parity_step_on_cuda_matches_cpu(dev):
    before = dict(no.LAUNCHES)
    rec, grads, params0, task = _ode_step(dev)
    torch.cuda.synchronize()
    for k in ("ode_select", "ode_replay_fwd", "ode_replay_bwd_ksweep"):
        assert no.LAUNCHES[k] == before[k] + 1, k
    assert no.LAUNCHES["ode_replay_bwd"] == before["ode_replay_bwd"]
    st = rec["stats"]
    assert bool(st.success) and bool(torch.isfinite(rec["loss"]))
    for k, g in grads.items():
        assert bool((g[~task.grad_mask[k].bool().cpu()] == 0).all()), k
    rec_c, grads_c, _, _ = _ode_step(torch.device("cpu"),
                                     grid=(st.step_times.cpu(), int(st.naccept)),
                                     params=params0)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        assert float((g - grads_c[k]).norm()) <= 1e-3 * float(grads_c[k].norm()) + 1e-30, k


def test_ode_kernels_never_reach_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_ode_select_plain", "_ode_attempt_plain", "_ode_replay_fwd_plain",
                 "_ode_replay_bwd_plain"):
        monkeypatch.setattr(no, name, boom)
    before = dict(no.LAUNCHES)
    rec, _, _, _ = _ode_step(dev)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(rec["loss"]))
    # the selection ran as the cluster team, never as team8
    assert no.LAUNCHES["ode_select"] == before["ode_select"] + 1
    assert no.LAUNCHES["ode_select_team8"] == before["ode_select_team8"]


# ---------------------------------------------------------------------------
# The f32-exact engine past one block: B7t-team (the replay as a team per
# lane, from 24 columns), B8t-team (the kernel-mode sweep as one team for the
# batch, 18-63 columns) and B8't (the emit-mode sweep on the three-term split,
# from 64 columns, with the weight gradients outside)
# ---------------------------------------------------------------------------


def _exact(dev, cpa, T=50):
    from columnflow_torch.solvers.fused import round_max_steps

    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=cpa, n_inputs=4, time_steps=T, max_steps=1024,
                             device=dev)
    model = parity.sde_model(task.params, task, torch.tensor(ODE_STIMS, device=dev))
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    P = task.net.num_pops
    cfg = no.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]),
                             max_steps=round_max_steps((4, 3 * P), 1024))
    y0 = torch.zeros(4, 3 * P, device=dev)
    st, stats = no.ode_select(y0, pw, model.sc, model.kv.contiguous(), cfg)
    return dict(pw=pw, sc=model.sc, kv=model.kv.contiguous(), P=P, w3=no._w3(pw, model.sc),
                y0=y0, st=st, n=int(stats[0]))


def test_exact_replay_team_equals_plain(dev):
    """B7t-team at 24 columns (P = 192, where one block's 227 KB no longer
    hold the three-term weights) on the first 16 accepted steps."""
    d = _exact(dev, (16, 6, 2))
    assert no.ode_fwd_route(d["P"], 4) == "team"
    stn = d["st"][:17].contiguous()
    before = dict(no.LAUNCHES)
    ys, co = no.ode_replay_fwd(d["y0"], stn, d["pw"], d["sc"], d["kv"])
    ys_p, co_p = no._ode_replay_fwd_plain(d["y0"], stn, d["w3"], d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert {k: no.LAUNCHES[k] - before[k] for k in before if no.LAUNCHES[k] != before[k]} == {
        "ode_replay_fwd_team": 1}
    assert torch.isfinite(co).all() and torch.equal(ys, ys_p) and torch.equal(co, co_p)


@pytest.mark.parametrize("cpa", [(8, 6, 4), (16, 8, 8)])
def test_exact_sweep_team_equals_plain(dev, cpa):
    """The kernel-mode sweep past one block (B8t-team's widths, now the
    cluster team for the batch) at 18 and 32 columns on 16 steps (ybar0, d
    wT and d iwT bit for bit), and on an empty grid."""
    d = _exact(dev, cpa)
    assert no.ode_bwd_route(d["P"], 4, 4) == "resident"
    stn = d["st"][:17].contiguous()
    ys, co = no._ode_replay_fwd_plain(d["y0"], stn, d["w3"], d["sc"], d["kv"])
    cobar = torch.randn(co.shape, generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    before = no.LAUNCHES["ode_replay_bwd_ksweep"]
    got = no.ode_replay_bwd(ys.contiguous(), cobar, stn, d["pw"], d["sc"], d["kv"])
    want = no._ode_replay_bwd_plain(ys, cobar, stn, d["w3"], d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert no.LAUNCHES["ode_replay_bwd_ksweep"] == before + 1
    for g, w, name in zip(got, want, ("ybar", "d_wT", "d_iwT")):
        assert torch.isfinite(g).all() and torch.equal(g, w), name
    ybar, d_wT, d_iwT = no.ode_replay_bwd(ys[:0].contiguous(), cobar[:0], stn[:1].contiguous(),
                                          d["pw"], d["sc"], d["kv"])
    assert not bool(ybar.any()) and not bool(d_wT.any()) and not bool(d_iwT.any())


def test_exact_emit_sweep_equals_plain(dev):
    """B8't at 64 columns (P = 512) on 8 steps: ybar0 and every ybar_steps[k]
    bit for bit."""
    d = _exact(dev, (32, 24, 8))
    w3 = {k: v.contiguous() for k, v in d["w3"].items()}
    stn = d["st"][:9].contiguous()
    ys, co = no.ode_replay_fwd(d["y0"], stn, d["pw"], d["sc"], d["kv"])
    cobar = torch.randn(co.shape, generator=torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    before = no.LAUNCHES["ode_replay_bwd_emit_split3"]
    got = no.ode_replay_bwd_emit(ys, cobar, stn, w3, d["sc"], d["kv"])
    want = no._ode_replay_bwd_emit_plain(ys, cobar, stn, w3, d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert no.LAUNCHES["ode_replay_bwd_emit_split3"] == before + 1
    for g, w, name in zip(got, want, ("ybar", "ybar_steps")):
        assert torch.isfinite(g).all() and torch.equal(g, w), name


def _exact_step(dev, cpa, grid=None, params=None, T=50):
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=cpa, n_inputs=4, time_steps=T, max_steps=1024,
                             device=dev)
    if params is not None:
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    rec = parity.make_train_step(task)(torch.tensor(ODE_STIMS, device=dev), grid=grid)
    return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}, params0


@pytest.mark.parametrize("cpa,T,want", [
    ((16, 8, 8), 50, {"ode_select": 1, "ode_replay_fwd_team": 1, "ode_replay_bwd_ksweep": 1}),
    ((32, 24, 8), 25,
     {"ode_select": 1, "ode_replay_fwd_team": 1, "ode_replay_bwd_emit_split3": 1})])
def test_exact_step_past_one_block_on_cuda_matches_cpu(dev, cpa, T, want):
    """The deterministic step at 32 columns (kernel mode: B7t-team, the
    kernel-mode sweep's cluster team)
    over 50 points and 64 (outer mode: B7t-team, B8't, the outer pass) over
    25: one launch of each of its kernels and none of anything else; against
    the same step on the CPU on the card's grid, the loss within 1e-5 and
    each gradient within the larger of 1e-3 and ten times the CPU's own
    spread under a 1e-7 nudge of the weights (the sweep rounds every
    transposed product to bf16, so a last-bit change of a rate flips
    roundings), a limit that must stay at most GRAD_TOL_CAP: a larger one
    would pass a wrong gradient. (At 64 columns over 50 points the lateral
    gradient's spread is 4.4e-2 on the CPU, over 25 points 2.3e-3.)"""
    before = dict(no.LAUNCHES)
    rec, grads, params0 = _exact_step(dev, cpa, T=T)
    torch.cuda.synchronize()
    launched = {k: no.LAUNCHES[k] - before[k] for k in before if no.LAUNCHES[k] != before[k]}
    assert launched == want
    st = rec["stats"]
    assert bool(st.success) and bool(torch.isfinite(rec["loss"]))
    grid = (st.step_times.cpu(), int(st.naccept))
    rec_c, grads_c, _ = _exact_step(torch.device("cpu"), cpa, grid=grid, params=params0, T=T)
    nudged = {k: v if k == "output_weights" else v * (1.0 + 1e-7) for k, v in params0.items()}
    _, grads_n, _ = _exact_step(torch.device("cpu"), cpa, grid=grid, params=nudged, T=T)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        norm = float(grads_c[k].norm()) + 1e-30
        tol = max(1e-3, 10 * float((grads_n[k] - grads_c[k]).norm()) / norm)
        assert torch.isfinite(g).all(), k
        assert tol <= GRAD_TOL_CAP, (k, tol)
        assert float((g - grads_c[k]).norm()) / norm <= tol, (k, tol)


@pytest.mark.parametrize("columns,B", [(13, 4), (17, 4), (18, 4), (23, 4), (24, 4), (63, 4),
                                       (104, 4), (312, 4), (13, 16)])
def test_route_byte_count_is_the_librarys(dev, columns, B):
    """``ode_block_bytes``, which ``ode_fwd_route`` and ``ode_bwd_route``
    read, equals the shared memory the library's B7 and B8 ask for
    (``cf_ode_block_bytes``)."""
    import ctypes

    P, got = 8 * columns, ctypes.c_longlong()
    for sweep in (False, True):
        assert no._lib().cf_ode_block_bytes(B, P, 4, int(sweep), ctypes.byref(got)) == 0
        assert got.value == no.ode_block_bytes(P, 4, B, sweep), (columns, B, sweep)


def test_exact_team_kernels_never_reach_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_ode_select_plain", "_ode_attempt_plain", "_ode_replay_fwd_plain",
                 "_ode_replay_bwd_plain", "_ode_replay_bwd_emit_plain"):
        monkeypatch.setattr(no, name, boom)
    for cpa in ((8, 6, 4), (32, 24, 8)):
        before = dict(no.LAUNCHES)
        rec, _, _ = _exact_step(dev, cpa, T=20)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(rec["loss"])), cpa
        launched = {k: no.LAUNCHES[k] - before[k] for k in before if no.LAUNCHES[k] != before[k]}
        # B6, at 18 columns the kernel-mode sweep, and at 64 (outer mode)
        # B7t-team and B8't, as cluster teams, once each; never team8
        assert launched["ode_select"] == 1 and not any(k.endswith("team8") for k in launched)
        assert "ode_replay_bwd_team" not in launched and "ode_replay_bwd" not in launched
        if cpa == (8, 6, 4):
            assert launched["ode_replay_bwd_ksweep"] == 1
        if cpa == (32, 24, 8):
            assert launched["ode_replay_fwd_team"] == 1
            assert launched["ode_replay_bwd_emit_split3"] == 1


# ---------------------------------------------------------------------------
# The split2 tier's kernels (teams of blocks, weights from L2), at the
# reference width so that the plain versions stay quick; chip_smoke.py holds
# them at 104 columns.
# ---------------------------------------------------------------------------


def test_ode_select_takes_16_lanes(ode):
    """All 16 four-bit patterns as one batch state: the selection's team
    holds them (a selection that holds the batch in one block runs out of
    shared memory past ~6 lanes at 13 columns)."""
    d = ode
    B = 16
    kv = d["kv"][:, :1].expand(-1, B, -1).contiguous()
    y0 = torch.zeros(B, 3 * d["P"], device=kv.device)
    st, stats = no.ode_select(y0, d["pw"], d["sc"], kv, d["cfg"])
    st_p, stats_p = no._ode_select_plain(y0, d["w3"], d["sc"], kv, d["cfg"])
    torch.cuda.synchronize()
    assert int(stats[2]) == 1 and stats.tolist() == stats_p.tolist() and torch.equal(st, st_p)
    t, y = st[5].clone(), torch.rand(y0.shape, device=kv.device) * 10
    f0 = no.ode_drift(t, y, d["w3"], d["sc"], kv).contiguous()
    h = (st[6] - st[5]) * 3.0
    a = no.ode_attempt(t, y, f0, h, d["pw"], d["sc"], kv, d["cfg"])
    a_p = no._ode_attempt_plain(t, y, f0, h, d["w3"], d["sc"], kv, d["cfg"])
    for g, w in zip(a, a_p):
        assert torch.equal(g, w)


def test_ode_split2_replay_kernels_equal_plain(ode):
    d = ode
    w2 = {k: v.contiguous() for k, v in nw.prepare_premixed_split2(d["pw"], d["sc"].fc)[0].items()}
    st, stats = no.ode_select(d["y0"], d["pw"], d["sc"], d["kv"], d["cfg"])
    n = min(int(stats[0]), 64)
    stn = st[:n + 1].contiguous()
    ys, co = no.ode_replay_fwd_split2(d["y0"], stn, w2, d["sc"], d["kv"])
    ys_p, co_p = no._ode_replay_fwd_plain(d["y0"], stn, w2, d["sc"], d["kv"])
    assert torch.isfinite(co).all() and torch.equal(ys, ys_p) and torch.equal(co, co_p)
    gen = torch.Generator(device=ys.device).manual_seed(1)
    cobar = torch.randn(co.shape, generator=gen, device=ys.device)
    got = no.ode_replay_bwd_emit(ys, cobar, stn, w2, d["sc"], d["kv"])
    want = no._ode_replay_bwd_emit_plain(ys, cobar, stn, w2, d["sc"], d["kv"])
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("ybar", "ybar_steps")):
        assert torch.isfinite(g).all() and torch.equal(g, w), name


# ---------------------------------------------------------------------------
# B6, B8' and B8't as cluster teams (csrc/ode_team.cuh): the selection one
# team of 16 (or 8) blocks for the batch, the emit-mode sweep one per lane,
# each block's columns of the split in shared memory by TMA
# ---------------------------------------------------------------------------


def _team3_routes(P, NB, NT, sweep):
    """The cluster-team routes that take the shape: resident where the plan
    keeps the slice, and streamed always."""
    plan = no.ode_team_plan(P, 4, NB, NT, sweep)
    assert plan.fits
    return ["streamed"] if plan.stream else ["resident", "streamed"]


def _team3_setup(dev, columns, B, T=40):
    from columnflow_torch.data import parity_combinations

    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=TEAM_CPA[columns], n_inputs=4, time_steps=T,
                             max_steps=16384, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    stims = (torch.as_tensor(parity_combinations(4, fixed_position=False), device=dev)
             if B == 16 else make_parity_batch(gen, 4, B, device=dev))
    model = parity.sde_model(task.params, task, stims)
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    sc, kv = model.sc, model.kv.contiguous()
    w3 = {k: v.contiguous() for k, v in nw.prepare_premixed_split(pw, sc.fc)[0].items()}
    w2 = _w2(pw, sc)
    return dict(task=task, gen=gen, pw=pw, sc=sc, kv=kv, w3=w3, w2=w2, P=task.net.num_pops,
                B=B, y0=torch.zeros(B, 3 * task.net.num_pops, device=dev))


def _team3_cfg(d, t_index):
    from columnflow_torch.solvers.fused import round_max_steps

    return no.ODESelectConfig(float(d["task"].ts[0]), float(d["task"].ts[t_index]),
                              max_steps=round_max_steps((d["B"], 3 * d["P"]), 16384))


@pytest.mark.parametrize("columns,B", [(13, 4), (13, 16), (32, 4), (104, 4), (104, 16)])
def test_ode_team_selection_equals_plain(dev, columns, B):
    """B6 as one cluster team at 13, 32 and 104 columns, 4 and 16 lanes, on
    every route the shape admits: the selection over a short horizon (its
    accepted times and stats) and 16 single attempts along the replay, with
    1, 1.5 and 2.5 times the accepted step (y1, f1, ratio, h, next h), bit
    for bit against the plain versions; one launch of the team, none of
    team8."""
    d = _team3_setup(dev, columns, B)
    cfg = _team3_cfg(d, {13: 8, 32: 8, 104: 3}[columns])
    st_p, stats_p = no._ode_select_plain(d["y0"], d["w3"], d["sc"], d["kv"], cfg)
    n = int(stats_p[0])
    ys, _ = no._ode_replay_fwd_plain(d["y0"], st_p[:n + 1].contiguous(), d["w3"], d["sc"],
                                     d["kv"])
    for route in _team3_routes(d["P"], B, 3, False):
        before = dict(no.LAUNCHES)
        st, stats = no.ode_select(d["y0"], d["pw"], d["sc"], d["kv"], cfg, route=route)
        torch.cuda.synchronize()
        assert no.LAUNCHES["ode_select"] == before["ode_select"] + 1
        assert no.LAUNCHES["ode_select_team8"] == before["ode_select_team8"]
        assert int(stats[2]) == 1 and stats.tolist() == stats_p.tolist(), route
        assert torch.equal(st, st_p), route
        for r in range(16):
            k = int(r / 16 * (n - 1))
            t, y = st_p[k].clone(), ys[k].contiguous()
            h = ((st_p[k + 1] - st_p[k]) * (1.0, 1.5, 2.5)[r % 3]).clone()
            f0 = no.ode_drift(t, y, d["w3"], d["sc"], d["kv"]).contiguous()
            a = no.ode_attempt(t, y, f0, h, d["pw"], d["sc"], d["kv"], cfg, route=route)
            a_p = no._ode_attempt_plain(t, y, f0, h, d["w3"], d["sc"], d["kv"], cfg)
            for g, w in zip(a, a_p):
                assert torch.equal(g, w), (route, r)


@pytest.mark.parametrize("columns", [13, 32, 104])
@pytest.mark.parametrize("terms", [2, 3])
def test_ode_team_emit_sweep_equals_plain(dev, columns, terms):
    """B8' (two terms) and B8't (three) as a cluster team per lane at 13,
    32 and 104 columns on every route the shape admits, over 12 accepted
    steps (8 at 104): ybar0 and every ybar_steps[k] bit for bit against the
    plain version, one launch each, and team8's result equal too."""
    d = _team3_setup(dev, columns, 4)
    st, stats = no.ode_select(d["y0"], d["pw"], d["sc"], d["kv"], _team3_cfg(d, 6))
    W = 8 if columns == 104 else 12
    stn = st[:W + 1].contiguous()
    w = d["w3"] if terms == 3 else d["w2"]
    ys, co = no._ode_replay_fwd_plain(d["y0"], stn, w, d["sc"], d["kv"])
    ys = ys.contiguous()
    cobar = torch.randn(co.shape, generator=d["gen"], device=dev)
    want = no._ode_replay_bwd_emit_plain(ys, cobar, stn, w, d["sc"], d["kv"])
    name = "ode_replay_bwd_emit_split3" if terms == 3 else "ode_replay_bwd_emit"
    for route in _team3_routes(d["P"], 1, terms, True) + ["team8"]:
        key = name + ("_team8" if route == "team8" else "")
        before = no.LAUNCHES[key]
        got = no.ode_replay_bwd_emit(ys, cobar, stn, w, d["sc"], d["kv"], route=route)
        torch.cuda.synchronize()
        assert no.LAUNCHES[key] == before + 1, route
        for g, ref, what in zip(got, want, ("ybar", "ybar_steps")):
            assert torch.isfinite(g).all() and torch.equal(g, ref), (route, what)


# The kernel-mode sweep (B8 at 13-17 columns, B8t-team at 18-63) as one
# cluster team for the batch (csrc/ode_ksweep_team.cu): (columns, lanes) ->
# the accepted steps of its window
KSWEEP_CASES = {(13, 4): 64, (17, 4): 32, (18, 4): 32, (32, 4): 32, (63, 4): 12, (13, 1): 32,
                (13, 16): 16, (32, 16): 12}
KSWEEP_CPA = {13: (8, 4, 1), 17: (8, 6, 3), 18: (8, 6, 4), 32: (16, 8, 8), 63: (32, 24, 7)}


def _ksweep_window(dev, columns, B, W):
    """The engine's inputs at a width and lane count, the kernel's own
    selection over 60 grid points, the plain replay of its first W accepted
    steps from the zero state, and random cotangents of the dense rows."""
    from columnflow_torch.data import parity_combinations
    from columnflow_torch.solvers.fused import round_max_steps

    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=KSWEEP_CPA[columns], n_inputs=4, time_steps=60,
                             max_steps=16384, device=dev)
    stims = torch.as_tensor(parity_combinations(4, fixed_position=False), device=dev)
    stims = stims[torch.arange(B, device=dev) % stims.shape[0]]
    model = parity.sde_model(task.params, task, stims)
    pw = {k: v.detach().contiguous() for k, v in model.pw.items()}
    sc, kv, P = model.sc, model.kv.contiguous(), task.net.num_pops
    y0 = torch.zeros(B, 3 * P, device=dev)
    cfg = no.ODESelectConfig(float(task.ts[0]), float(task.ts[-1]),
                             max_steps=round_max_steps((B, 3 * P), 16384))
    st, stats = no.ode_select(y0, pw, sc, kv, cfg)
    W = min(W, int(stats[0]))
    stn = st[:W + 1].contiguous()
    w3 = no._w3(pw, sc)
    ys, co = no._ode_replay_fwd_plain(y0, stn, w3, sc, kv)
    gen = torch.Generator(device=dev).manual_seed(columns * 100 + B)
    cobar = torch.randn(co.shape, generator=gen, device=dev)
    return dict(pw=pw, sc=sc, kv=kv, P=P, w3=w3, ys=ys.contiguous(), cobar=cobar, stn=stn)


@pytest.mark.parametrize("columns,B", sorted(KSWEEP_CASES))
def test_ksweep_team_equals_plain_and_the_yardsticks(dev, columns, B):
    """The kernel-mode sweep's cluster team at 13, 17, 18, 32 and 63
    columns, 1, 4 and 16 lanes, on every route its plan admits (resident
    where the slice fits, streamed always): ybar0, d wT and d iwT bit for
    bit against the plain version and against the kernels it replaces on
    the shape (B8, route "block", where one block holds the batch;
    B8t-team, route "team8"); one launch of the team a sweep and none of
    the others."""
    d = _ksweep_window(dev, columns, B, KSWEEP_CASES[columns, B])
    P = d["P"]
    plan = no.ode_team_plan(P, 4, B, 3, no.KSWEEP)
    assert plan.fits and no.ode_bwd_route(P, 4, B) == ("streamed" if plan.stream else "resident")
    args = (d["ys"], d["cobar"], d["stn"], d["pw"], d["sc"], d["kv"])
    want = no._ode_replay_bwd_plain(d["ys"], d["cobar"], d["stn"], d["w3"], d["sc"], d["kv"])
    for route in [None] + ([] if plan.stream else ["resident"]) + ["streamed"]:
        before = dict(no.LAUNCHES)
        got = no.ode_replay_bwd(*args, route=route)
        torch.cuda.synchronize()
        launched = {k: no.LAUNCHES[k] - before[k] for k in before if no.LAUNCHES[k] != before[k]}
        assert launched == {"ode_replay_bwd_ksweep": 1}, (route, launched)
        for g, w, name in zip(got, want, ("ybar", "d_wT", "d_iwT")):
            assert torch.isfinite(g).all() and torch.equal(g, w), (route, name)
    yardsticks = ["team8"] + (["block"] if no.ode_block_bytes(P, 4, B, True) <= 232448 else [])
    for route in yardsticks:
        key = "ode_replay_bwd" if route == "block" else "ode_replay_bwd_team"
        before = no.LAUNCHES[key]
        old = no.ode_replay_bwd(*args, route=route)
        torch.cuda.synchronize()
        assert no.LAUNCHES[key] == before + 1, route
        for g, w, name in zip(got, old, ("ybar", "d_wT", "d_iwT")):
            assert torch.equal(g, w), (route, name)


def test_ksweep_routes_refuse_what_they_do_not_take(dev):
    """A resident team where the plan streams (63 columns at 4 lanes)
    raises before the launch; where the plan does not fit (17 columns at 16
    lanes) the route is B8t-team's; the empty grid gives zeros."""
    d = _ksweep_window(dev, 63, 4, 2)
    with pytest.raises(ValueError, match="resident"):
        no.ode_replay_bwd(d["ys"], d["cobar"], d["stn"], d["pw"], d["sc"], d["kv"],
                          route="resident")
    assert no.ode_bwd_route(8 * 17, 4, 16) == "team8"
    ybar, d_wT, d_iwT = no.ode_replay_bwd(d["ys"][:0].contiguous(), d["cobar"][:0],
                                          d["stn"][:1].contiguous(), d["pw"], d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert not bool(ybar.any()) and not bool(d_wT.any()) and not bool(d_iwT.any())


# B8s as the kernel-mode sweep's cluster team on the two-term split
# (ode_ksweep16_kernel<2, *, *>): (columns, lanes) -> the accepted steps of
# its window
KSWEEP2_CASES = {(13, 4): 48, (32, 4): 32, (63, 4): 12, (13, 1): 32, (13, 16): 16,
                 (32, 16): 12}


@pytest.mark.parametrize("columns,B", sorted(KSWEEP2_CASES))
def test_b8s_ksweep_team_equals_plain_and_team8(dev, columns, B):
    """B8s's cluster team at 13, 32 and 63 columns, 1, 4 and 16 lanes, on
    its shape's route and on "streamed": ybar0, d wT and d iwT bit for bit
    against the plain version on the two-term split and against the 8-block
    B8s (route "team8", the yardstick); one launch of the team a sweep."""
    d = _ksweep_window(dev, columns, B, KSWEEP2_CASES[columns, B])
    P = d["P"]
    w2 = _w2(d["pw"], d["sc"])
    plan = no.ode_team_plan(P, 4, B, 2, no.KSWEEP)
    assert plan.fits and no.ode_bwd_route(P, 4, B, terms=2) == (
        "streamed" if plan.stream else "resident")
    args = (d["ys"], d["cobar"], d["stn"], w2, d["sc"], d["kv"])
    want = no._ode_replay_bwd_plain(*args)
    for route in [None] + ([] if plan.stream else ["resident"]) + ["streamed"]:
        before = dict(no.LAUNCHES)
        got = no.ode_replay_bwd_split2(*args, route=route)
        torch.cuda.synchronize()
        launched = {k: no.LAUNCHES[k] - before[k] for k in before if no.LAUNCHES[k] != before[k]}
        assert launched == {"ode_replay_bwd_split2_ksweep": 1}, (route, launched)
        for g, w, name in zip(got, want, ("ybar", "d_wT", "d_iwT")):
            assert torch.isfinite(g).all() and torch.equal(g, w), (route, name)
    before = no.LAUNCHES["ode_replay_bwd_split2"]
    old = no.ode_replay_bwd_split2(*args, route="team8")
    torch.cuda.synchronize()
    assert no.LAUNCHES["ode_replay_bwd_split2"] == before + 1
    for g, w, name in zip(got, old, ("ybar", "d_wT", "d_iwT")):
        assert torch.equal(g, w), name
    assert bool(got[1].any())


SDE_KSWEEP_CPA = {13: (8, 4, 1), 17: (8, 6, 3), 19: (8, 6, 5)}


@pytest.mark.parametrize("columns,lanes,B", [(13, True, 4), (13, False, 4), (17, True, 4),
                                             (17, False, 4), (19, True, 4), (19, False, 4),
                                             (13, True, 1), (13, True, 8)])
def test_sde3_ksweep_team_equals_plain_and_the_block(dev, columns, lanes, B):
    """B4't as one cluster team for the batch at 13, 17 and 19 columns on
    per-lane and uniform grids (4 lanes; 1 and 8 at 13 columns), over 40
    steps (the last two padding, truncation every 16, chunk 10), on its
    shape's route and on "streamed": ybar, d wT and d iwT bit for bit
    against the plain version and the one-block B4't (route "block", the
    yardstick); one launch of the team a sweep."""
    d = _net_inputs(dev, cpa=SDE_KSWEEP_CPA[columns], T=1000, B=B)
    gen, P = d["gen"], d["P"]
    assert ns.sde3_bwd_route(P, 4, B) == "resident"
    params, net = nw.build_column_network(ColumnConfig.load(), gen,
                                          columns_per_area=SDE_KSWEEP_CPA[columns], n_inputs=4,
                                          device=dev)
    pw = {k: v.detach().contiguous() for k, v in nw.premix_network_weights(params, net).items()}
    n = 40
    t0s, hs, dw, i10 = _team_grid(dev, gen, B, P, n, lanes, d["ts"])
    ys = ns.replay3_fwd(_states(gen, B, P, dev), t0s, hs, dw, i10, n - 2, pw, d["sc"], d["kv"])
    ysbar = torch.randn((n, B, 3 * P), generator=gen, device=dev)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n - 2, 16, 10, pw, d["sc"], d["kv"])
    want = ns._replay3_bwd_plain(*bwd)
    for route in (None, "streamed"):
        before = dict(ns.LAUNCHES)
        got = ns.replay3_bwd(*bwd, route=route)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
        assert launched == {"sde3_bwd_ksweep": 1}, (route, launched)
        for g, w, name in zip(got, want, ("ybar", "d_wT", "d_iwT")):
            assert torch.isfinite(g).all() and torch.equal(g, w), (route, name)
    before = ns.LAUNCHES["sde3_bwd"]
    block = ns.replay3_bwd(*bwd, route="block")
    torch.cuda.synchronize()
    assert ns.LAUNCHES["sde3_bwd"] == before + 1
    for g, w, name in zip(got, block, ("ybar", "d_wT", "d_iwT")):
        assert torch.equal(g, w), name
    assert bool(got[1].any())
    with pytest.raises(ValueError, match="route"):
        ns.replay3_bwd(*bwd, route="team8")


# B4't and B4s as one cluster team for the batch (sde3_ksweep16_kernel<3 or
# 2, *, *>) at every width of kernel mode: (terms, columns, per-lane grids,
# lanes); B4s runs on per-lane grids only
SDE_KSWEEP_WIDE_CPA = {13: (8, 4, 1), 20: (10, 6, 4), 32: (16, 8, 8), 63: (32, 24, 7)}
SDE_KSWEEP_WIDE = [(3, 20, True, 4), (3, 20, False, 4), (3, 32, True, 4), (3, 32, False, 4),
                   (3, 63, True, 4), (3, 63, False, 4), (3, 32, True, 1), (3, 32, True, 8),
                   (2, 13, True, 4), (2, 20, True, 4), (2, 32, True, 4), (2, 63, True, 4),
                   (2, 13, True, 1), (2, 32, True, 8)]


@pytest.mark.parametrize("terms,columns,lanes,B", SDE_KSWEEP_WIDE)
def test_sde_ksweep_teams_equal_plain_and_team(dev, terms, columns, lanes, B):
    """The cluster team for the batch on three terms (B4't, where B4't-team
    ran before: 20-63 columns) and on two (B4s), from the zero state over 40
    steps (the last two padding, truncation every 16, chunk 10) at 13, 20,
    32 and 63 columns, 1, 4 and 8 lanes, per-lane and uniform grids: on
    the shape's route and on "streamed", ybar, d wT and d iwT bit for bit
    against the plain version and against the 8-block team it replaced
    (route "team", the yardstick); one launch of the team a sweep."""
    cpa = SDE_KSWEEP_WIDE_CPA[columns]
    d = _net_inputs(dev, cpa=cpa, T=1000, B=B)
    gen, P = d["gen"], d["P"]
    plan = no.ode_team_plan(P, 4, B, terms, no.SDE_KSWEEP)
    assert plan.fits and ns.sde3_bwd_route(P, 4, B, terms) == (
        "streamed" if plan.stream else "resident")
    n = 40
    t0s, hs, dw, i10 = _team_grid(dev, gen, B, P, n, lanes, d["ts"])
    y0 = torch.zeros(B, 3 * P, device=dev)
    if terms == 3:
        w = d["wf"]
        ys = ns.replay3_fwd(y0, t0s, hs, dw, i10, n - 2, w, d["sc"], d["kv"])
        sweep, plain, key, old = ns.replay3_bwd, ns._replay3_bwd_plain, "sde3_bwd_ksweep", \
            "sde3_bwd_team"
    else:
        w = d["w2"]
        ys = ns.replay_fwd(y0, t0s, hs, dw, i10, n - 2, w, d["sc"], d["kv"])
        sweep, plain, key, old = ns.replay2_bwd, ns._replay2_bwd_plain, "sde2_bwd_ksweep", \
            "sde2_bwd"
    ysbar = torch.randn((n, B, 3 * P), generator=gen, device=dev)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n - 2, 16, 10, w, d["sc"], d["kv"])
    want = plain(*bwd)
    for route in (None, "streamed"):
        before = dict(ns.LAUNCHES)
        got = sweep(*bwd, route=route)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
        assert launched == {key: 1}, (route, launched)
        for g, p, name in zip(got, want, ("ybar", "d_wT", "d_iwT")):
            assert torch.isfinite(g).all() and torch.equal(g, p), (route, name)
    before = ns.LAUNCHES[old]
    team = sweep(*bwd, route="team")
    torch.cuda.synchronize()
    assert ns.LAUNCHES[old] == before + 1
    for g, p, name in zip(got, team, ("ybar", "d_wT", "d_iwT")):
        assert torch.equal(g, p), name
    assert bool(got[1].any())


def test_sde_ksweep_routes_refuse_what_they_do_not_take(dev):
    """Where the plan does not fit (63 columns at 8 lanes) both splits'
    routes are the 8-block team's and a forced cluster route raises before
    the launch; a route of the other split raises too."""
    d = _net_inputs(dev, cpa=(32, 24, 7), T=1000, B=8)
    P, B, n = d["P"], 8, 4
    assert ns.sde3_bwd_route(P, 4, B) == "team" and ns.sde3_bwd_route(P, 4, B, 2) == "team"
    z = torch.zeros(n, B, 3 * P, device=dev)
    t = torch.full((n, B), 1e-3, device=dev)
    for route in ("resident", "streamed"):
        with pytest.raises(ValueError, match="team"):
            ns.replay2_bwd(z, z, t, t, t, n, 0, 1, d["w2"], d["sc"], d["kv"], route=route)
    with pytest.raises(ValueError, match="route"):
        ns.replay2_bwd(z, z, t, t, t, n, 0, 1, d["w2"], d["sc"], d["kv"], route="block")


@pytest.mark.parametrize("columns", [13, 18, 32, 63, 104, 151, 312])
def test_ode_team_plan_is_the_librarys(dev, columns):
    """``ode_team_plan``, which the wrappers, ``ode_team_route``,
    ``ode_bwd_route`` and ``sde3_bwd_route`` read, equals the plan the
    library launches with (``cf_ode_team_plan``) for the selection's 1, 4
    and 16 lanes, the emit-mode sweep's two and three terms, the kernel-mode
    sweep's 1, 4 and 16 lanes on three terms (B8, B8t-team) and on two
    (B8s), and the SDE's kernel-mode sweep's 1, 4 and 8 lanes on three terms
    (B4't) and on two (B4s)."""
    import ctypes

    P, out = 8 * columns, (ctypes.c_longlong * 23)()
    for NB, NT, use in ((1, 3, no.SELECT), (4, 3, no.SELECT), (16, 3, no.SELECT),
                        (1, 2, no.SWEEP), (1, 3, no.SWEEP), (1, 3, no.KSWEEP),
                        (4, 3, no.KSWEEP), (16, 3, no.KSWEEP), (1, 2, no.KSWEEP),
                        (4, 2, no.KSWEEP), (16, 2, no.KSWEEP), (1, 3, no.SDE_KSWEEP),
                        (4, 3, no.SDE_KSWEEP), (8, 3, no.SDE_KSWEEP), (1, 2, no.SDE_KSWEEP),
                        (4, 2, no.SDE_KSWEEP), (8, 2, no.SDE_KSWEEP)):
        for stream in (False, True):
            assert no._lib().cf_ode_team_plan(P, 4, NB, NT, use, 0, int(stream), out) == 0
            want = tuple(int(v) for v in no.ode_team_plan(P, 4, NB, NT, use, stream))
            assert tuple(out) == want, (NB, NT, use, stream)


@pytest.mark.parametrize("columns", [13, 24, 32, 63, 94, 104, 106, 151, 312])
def test_ode_replay_plan_is_the_librarys(dev, columns):
    """The replay's plan (``ode_team_plan(..., REPLAY, C=...)``, which
    ``ode_replay_route`` and the wrappers read) equals the library's
    (``cf_ode_team_plan``) on two and three terms, clusters of 8 and (where
    16 divides P) 16, resident and streamed; and the card holds at least one
    cluster of each (``cf_ode_replay_max_clusters``)."""
    import ctypes

    P, out = 8 * columns, (ctypes.c_longlong * 23)()
    for NT in (2, 3):
        for C in (8, 16):
            if P % C:
                continue
            for stream in (False, True):
                assert no._lib().cf_ode_team_plan(P, 4, 1, NT, no.REPLAY, C, int(stream),
                                                  out) == 0
                plan = no.ode_team_plan(P, 4, 1, NT, no.REPLAY, stream, C)
                assert tuple(out) == tuple(int(v) for v in plan), (NT, C, stream)
                assert no.ode_replay_max_clusters(P, 4, NT, C, plan.stream) >= 1


@pytest.mark.parametrize("columns,B", [(13, 4), (24, 4), (32, 4), (63, 4), (104, 4), (104, 16),
                                       (312, 4)])
def test_ode_team_replay_equals_plain(dev, columns, B):
    """B7t-team (three terms) and B7 split2 (two) as cluster teams per lane
    at 13-312 columns, 4 lanes and 16 at 104 (clusters of 8 there: the card
    holds 7 of 16), on every route the shape admits and on team8, over 16
    accepted steps (8 at 312 and with 16 lanes): ys and the dense rows bit
    for bit against the plain version (so every route equals the others and
    team8), one launch of the route's kernel each, none of anything else."""
    d = _team3_setup(dev, columns, B)
    st, stats = no.ode_select(d["y0"], d["pw"], d["sc"], d["kv"],
                              _team3_cfg(d, 3 if B == 16 else (4 if columns == 312 else 6)))
    W = min(8 if columns == 312 or B == 16 else 16, int(stats[0]))
    stn = st[:W + 1].contiguous()
    for NT, w, name in ((3, d["w3"], "ode_replay_fwd_team"), (2, d["w2"], "ode_replay_fwd_split2")):
        want = no._ode_replay_fwd_plain(d["y0"], stn, w, d["sc"], d["kv"])
        route, plan = no._replay_team(None, d["P"], 4, B, NT)
        assert plan.C == (16 if d["P"] % 16 == 0 and B <= 7 else 8)
        for r in list(dict.fromkeys([route, "streamed"])) + ["team8"]:
            key = name + ("_team8" if r == "team8" else "")
            before = dict(no.LAUNCHES)
            if NT == 3:
                got = no.ode_replay_fwd(d["y0"], stn, d["pw"], d["sc"], d["kv"], route=r)
            else:
                got = no.ode_replay_fwd_split2(d["y0"], stn, w, d["sc"], d["kv"], route=r)
            torch.cuda.synchronize()
            launched = {k: no.LAUNCHES[k] - before[k] for k in before
                        if no.LAUNCHES[k] != before[k]}
            assert launched == {key: 1}, (r, launched)
            for g, x, what in zip(got, want, ("ys", "coeffs")):
                assert torch.isfinite(g).all() and torch.equal(g, x), (NT, r, what)


def _split2_step(dev, monkeypatch, grid=None, params=None):
    from columnflow_torch.solvers import fused

    monkeypatch.setattr(fused, "OUTER_ARG_BYTES", 0)  # outer mode at 13 columns
    task = parity.build_task(ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
                             columns_per_area=(8, 4, 1), n_inputs=4, time_steps=100,
                             max_steps=1024, device=dev)
    if params is not None:
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    step = parity.make_train_step(task, split2=True)
    rec = step(torch.tensor(ODE_STIMS, device=dev), grid=grid)
    return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}, params0


def test_split2_parity_step_on_cuda_matches_cpu(dev, monkeypatch):
    before = dict(no.LAUNCHES)
    rec, grads, params0 = _split2_step(dev, monkeypatch)
    torch.cuda.synchronize()
    for k in ("ode_select", "ode_replay_fwd_split2", "ode_replay_bwd_emit"):
        assert no.LAUNCHES[k] == before[k] + 1, k
    st = rec["stats"]
    assert bool(st.success) and bool(torch.isfinite(rec["loss"]))
    rec_c, grads_c, _ = _split2_step(torch.device("cpu"), monkeypatch,
                                     grid=(st.step_times.cpu(), int(st.naccept)), params=params0)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        assert float((g - grads_c[k]).norm()) <= 1e-3 * float(grads_c[k].norm()) + 1e-30, k


def test_split2_kernels_never_reach_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_ode_select_plain", "_ode_attempt_plain", "_ode_replay_fwd_plain",
                 "_ode_replay_bwd_emit_plain"):
        monkeypatch.setattr(no, name, boom)
    before = dict(no.LAUNCHES)
    rec, _, _ = _split2_step(dev, monkeypatch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(rec["loss"]))
    launched = {k: no.LAUNCHES[k] - before[k] for k in before if no.LAUNCHES[k] != before[k]}
    # B6, B7 split2 and B8' as cluster teams, once each; never team8
    assert launched == {"ode_select": 1, "ode_replay_fwd_split2": 1, "ode_replay_bwd_emit": 1}


# ---------------------------------------------------------------------------
# The two-term split's kernel-mode sweeps: B8s (deterministic) and B4s
# (stochastic, per-lane grids), each one team for the batch at every width
# ---------------------------------------------------------------------------


def _w2(pw, sc):
    return {k: v.contiguous() for k, v in nw.prepare_premixed_split2(pw, sc.fc)[0].items()}


@pytest.mark.parametrize("cpa", [(8, 4, 1), (16, 8, 8), (32, 24, 7)])
def test_split2_kernel_mode_b8s_equals_plain(dev, cpa):
    """B7 split2 on the first 16 accepted steps of the selection at 13, 32
    and 63 columns, and B8s over them with random cotangents of the dense
    rows: ys, rows, ybar0, d wT and d iwT bit for bit, one launch each (B8s
    takes the kernel-mode sweep's cluster team on two terms at every one of
    these widths: 13 populations per block at 13 columns)."""
    d = _exact(dev, cpa)
    w2 = _w2(d["pw"], d["sc"])
    assert no.ode_bwd_route(d["P"], 4, 4, terms=2) == "resident"
    stn = d["st"][:17].contiguous()
    before = dict(no.LAUNCHES)
    ys, co = no.ode_replay_fwd_split2(d["y0"], stn, w2, d["sc"], d["kv"])
    ys_p, co_p = no._ode_replay_fwd_plain(d["y0"], stn, w2, d["sc"], d["kv"])
    cobar = torch.randn(co.shape, generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    got = no.ode_replay_bwd_split2(ys, cobar, stn, w2, d["sc"], d["kv"])
    want = no._ode_replay_bwd_plain(ys, cobar, stn, w2, d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert {k: no.LAUNCHES[k] - before[k] for k in before if no.LAUNCHES[k] != before[k]} == {
        "ode_replay_fwd_split2": 1, "ode_replay_bwd_split2_ksweep": 1}
    assert torch.isfinite(co).all() and torch.equal(ys, ys_p) and torch.equal(co, co_p)
    for g, w, name in zip(got, want, ("ybar", "d_wT", "d_iwT")):
        assert torch.isfinite(g).all() and torch.equal(g, w), name
    assert bool(got[1].any())


@pytest.mark.parametrize("cpa", [(8, 4, 1), (16, 8, 8), (32, 24, 7)])
def test_split2_kernel_mode_b4s_equals_plain(dev, cpa):
    """B3 and B4s at 13, 32 and 63 columns on a 12-step window of per-lane
    grids (the last two steps padding, truncation every 5 steps, chunk 4):
    ys, ybar, d wT and d iwT bit for bit against the plain versions, one
    launch each; B4s on its cluster team for the batch (the shape's route,
    "resident" at every one of these widths), and the same against the
    8-block team (route "team", the yardstick)."""
    d = _net_inputs(dev, cpa=cpa, T=1000)
    gen, B, P = d["gen"], 4, d["P"]
    assert ns.sde3_bwd_route(P, 4, B, terms=2) == "resident"
    n = 12
    t0s, hs, dw, i10 = _team_grid(dev, gen, B, P, n, True, d["ts"])
    y0 = _states(gen, B, P, dev)
    before = dict(ns.LAUNCHES)
    fwd = (t0s, hs, dw, i10, n - 2, d["w2"], d["sc"], d["kv"])
    ys = ns.replay_fwd(y0, *fwd)
    ysbar = torch.randn((n, B, 3 * P), generator=gen, device=dev)
    bwd = (ys[:-1].contiguous(), ysbar, t0s, hs, i10, n - 2, 5, 4, d["w2"], d["sc"], d["kv"])
    got = ns.replay2_bwd(*bwd)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ns.LAUNCHES.items() if v != before[k]}
    assert launched == {"sde_replay_fwd": 1, "sde2_bwd_ksweep": 1}
    assert torch.isfinite(ys).all() and torch.equal(ys, ns._replay_fwd_plain(y0, *fwd))
    assert bool(got[1].any())
    for g, w in zip(got, ns._replay2_bwd_plain(*bwd)):
        assert torch.isfinite(g).all() and torch.equal(g, w)
    before = ns.LAUNCHES["sde2_bwd"]
    team = ns.replay2_bwd(*bwd, route="team")
    torch.cuda.synchronize()
    assert ns.LAUNCHES["sde2_bwd"] == before + 1
    for g, w in zip(got, team):
        assert torch.equal(g, w)


@pytest.mark.parametrize("stochastic", [False, True])
def test_split2_kernel_mode_steps_on_cuda_match_cpu(dev, stochastic, monkeypatch):
    """``make_train_step(task, split2=True)`` (B6, B7 split2, B8s) and
    ``make_train_step(task, stochastic=True, adaptive=True, split2=True)``
    (the f32 selection on the jax.random tree, B3, B4s) at 13 columns over
    50 grid points, "auto" taking kernel mode: one launch of each kernel of
    the path and no plain version; the same step on the CPU on the card's
    grid: loss rel 1e-5, each gradient within the larger of 1e-3 and ten
    times the card's own spread under a 1e-7 nudge of the weights, a limit
    of at most GRAD_TOL_CAP."""
    flags = dict(split2=True, stochastic=stochastic, adaptive=stochastic)
    keys = torch.randint(0, 2**32, (4, 2), generator=torch.Generator().manual_seed(4),
                         dtype=torch.int64)

    def step_on(device, params=None, grid=None):
        task = parity.build_task(ColumnConfig.load(),
                                 torch.Generator(device=device).manual_seed(0),
                                 columns_per_area=(8, 4, 1), time_steps=50, max_steps=1024,
                                 device=device)
        if params is not None:
            with torch.no_grad():
                for k, p in task.params.items():
                    p.copy_(params[k])
        rec = parity.make_train_step(task, **flags)(
            torch.tensor(ODE_STIMS, device=device), keys.to(device) if stochastic else None,
            grid=grid)
        return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    params0 = {k: p.detach().cpu().clone() for k, p in parity.build_task(
        ColumnConfig.load(), torch.Generator(device=dev).manual_seed(0),
        columns_per_area=(8, 4, 1), time_steps=50, device=dev).params.items()}
    mod = ns if stochastic else no
    with monkeypatch.context() as m:
        for name in (("_select_plain", "_replay_fwd_plain", "_replay2_bwd_plain") if stochastic
                     else ("_ode_select_plain", "_ode_replay_fwd_plain", "_ode_replay_bwd_plain")):
            m.setattr(mod, name, boom)
        before = dict(mod.LAUNCHES)
        rec, grads = step_on(dev, params0)
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in mod.LAUNCHES.items() if v != before[k]}
    assert launched == ({"sde_select": 1, "sde_replay_fwd": 1, "sde2_bwd_ksweep": 1}
                        if stochastic
                        else {"ode_select": 1, "ode_replay_fwd_split2": 1,
                              "ode_replay_bwd_split2_ksweep": 1})
    st = rec["stats"]
    if stochastic:
        grid = tuple(x.cpu() for x in (st.step_times, st.naccept, st.nreject))
    else:
        grid = (st.step_times.cpu(), int(st.naccept))
    rec_c, grads_c = step_on(torch.device("cpu"), params0, grid)
    _, grads_n = step_on(dev, {k: v * (1.0 + 1e-7) for k, v in params0.items()},
                         tuple(x.to(dev) if torch.is_tensor(x) else x for x in grid))
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        if not bool(grads_c[k].any()):
            assert not bool(g.any()), k
            continue
        spread = float((grads_n[k] - g).norm()) / float(g.norm())
        err = float((g - grads_c[k]).norm()) / float(grads_c[k].norm())
        tol = max(1e-3, 10.0 * spread)
        assert err <= tol <= GRAD_TOL_CAP, (k, err, spread)


# ---------------------------------------------------------------------------
# The XOR kernels (dopri5 and the uniform-grid SDE, kernel mode)
# ---------------------------------------------------------------------------

XOR_T = 200


def _xor_task(device, params=None):
    task = xor_task.build_task(ColumnConfig.load(), torch.Generator(device=device).manual_seed(0),
                               time_steps=XOR_T, max_steps=1024, device=device)
    if params is not None:
        with torch.no_grad():
            for k, p in task.params.items():
                p.copy_(params[k])
    return task


@pytest.fixture
def xor(dev):
    from columnflow_torch.data import xor_conditions
    from columnflow_torch.models.xor import split_xor_params
    from columnflow_torch.solvers.fused import round_max_steps, uniform_step_times

    task = _xor_task(dev)
    conds = torch.as_tensor(xor_conditions(), device=dev)
    sc, kv = xor_task.drift_inputs(task, conds)
    pf = {k: v.detach().clone() for k, v in split_xor_params(task.params).items()}
    cfg = no.ODESelectConfig(0.0, float(task.ts[-1]), max_steps=round_max_steps((4, 72), 1024))
    t0s, h = uniform_step_times(task.ts, (4, 72))
    gen = torch.Generator(device=dev).manual_seed(5)
    _, i1, i10, _, _ = brownian_pack(gen, task.ts, (4,))
    return dict(task=task, conds=conds, sc=sc, kv=kv, pf=pf, cfg=cfg, t0s=t0s, h=h, gen=gen,
                i1=i1.contiguous(), i10=i10.contiguous(), y0=torch.zeros(4, 72, device=dev))


def test_xor_select_and_attempts_equal_plain(xor):
    d = xor
    before = xo.LAUNCHES["xor_select"]
    st, stats = xo.xor_select(d["y0"], d["pf"], d["sc"], d["kv"], d["cfg"])
    st_p, stats_p = xo._xor_select_plain(d["y0"], d["pf"], d["sc"], d["kv"], d["cfg"])
    torch.cuda.synchronize()
    assert xo.LAUNCHES["xor_select"] == before + 1
    assert int(stats[2]) == 1 and stats.tolist() == stats_p.tolist() and torch.equal(st, st_p)
    n = int(stats[0])
    ys, _ = xo._xor_replay_fwd_plain(d["y0"], st[:n + 1].contiguous(), d["pf"], d["sc"], d["kv"])
    for k, stretch in ((0, 1.0), (n // 3, 2.5), (n // 2, 1.5), (n - 2, 4.0)):
        t, y = st[k].clone(), ys[k].contiguous()
        h = ((st[k + 1] - st[k]) * stretch).clone()
        f0 = xo.xor_ode_drift(t, y, d["pf"], d["sc"], d["kv"]).contiguous()
        a = xo.xor_attempt(t, y, f0, h, d["pf"], d["sc"], d["kv"], d["cfg"])
        a_p = xo._xor_attempt_plain(t, y, f0, h, d["pf"], d["sc"], d["kv"], d["cfg"])
        for got, want in zip(a, a_p):
            assert torch.equal(got, want), k


def test_xor_replay_kernels_equal_plain(xor):
    d = xor
    st, stats = xo.xor_select(d["y0"], d["pf"], d["sc"], d["kv"], d["cfg"])
    stn = st[:int(stats[0]) + 1].contiguous()
    ys, co = xo.xor_replay_fwd(d["y0"], stn, d["pf"], d["sc"], d["kv"])
    ys_p, co_p = xo._xor_replay_fwd_plain(d["y0"], stn, d["pf"], d["sc"], d["kv"])
    assert torch.isfinite(co).all() and torch.equal(ys, ys_p) and torch.equal(co, co_p)
    cobar = torch.randn(co.shape, generator=d["gen"], device=co.device)
    yb, rows = xo.xor_replay_bwd(ys, cobar, stn, d["pf"], d["sc"], d["kv"])
    yb_p, rows_p = xo._xor_replay_bwd_plain(ys, cobar, stn, d["pf"], d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert torch.isfinite(yb).all() and torch.equal(yb, yb_p)
    for k in rows:
        assert torch.equal(rows[k], rows_p[k]), k


def test_xor_sde_kernels_equal_plain(xor):
    d = xor
    args = (d["t0s"], d["h"])
    ys = xs.xor_sde_fwd(d["y0"], *args, d["i1"], d["i10"], d["pf"], d["sc"], d["kv"])
    ys_p = xs._xor_sde_fwd_plain(d["y0"], *args, d["i1"], d["i10"], d["pf"], d["sc"], d["kv"])
    assert torch.isfinite(ys).all() and torch.equal(ys, ys_p)
    ysbar = torch.randn(ys.shape, generator=d["gen"], device=ys.device)
    yb, rows = xs.xor_sde_bwd(ys, ysbar, *args, d["i10"], d["pf"], d["sc"], d["kv"])
    yb_p, rows_p = xs._xor_sde_bwd_plain(ys, ysbar, *args, d["i10"], d["pf"], d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert torch.isfinite(yb).all() and torch.equal(yb, yb_p)
    for k in rows:
        assert torch.equal(rows[k], rows_p[k]), k


def _xor_step(device, stochastic, params=None, grid=None, noise=None):
    from columnflow_torch.data import xor_conditions

    task = _xor_task(device, params)
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    conds = torch.as_tensor(xor_conditions(), device=device)
    if stochastic and noise is None:
        gen = torch.Generator(device=device).manual_seed(9)
        _, i1, i10, _, _ = brownian_pack(gen, task.ts, (4, 1))
        noise = (i1, i10)
    rec = xor_task.make_train_step(task, stochastic=stochastic)(conds, noise=noise, grid=grid)
    return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}, params0, noise


@pytest.mark.parametrize("stochastic", [False, True])
def test_xor_steps_on_cuda_match_cpu(dev, stochastic):
    counters = (xo.LAUNCHES, xs.LAUNCHES, no.LAUNCHES, ns.LAUNCHES, cs.LAUNCHES)
    before = [dict(c) for c in counters]
    rec, grads, params0, noise = _xor_step(dev, stochastic)
    torch.cuda.synchronize()
    launched = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c if c[k] != b[k]}
    want = ({"xor_sde_fwd": 1, "xor_sde_bwd": 1} if stochastic else
            {"xor_select": 1, "xor_replay_fwd": 1, "xor_replay_bwd": 1})
    assert launched == want
    assert bool(torch.isfinite(rec["loss"]))
    grid = None
    if not stochastic:
        assert bool(rec["stats"].success)
        grid = (rec["stats"].step_times.cpu(), int(rec["stats"].naccept))
    rec_c, grads_c, _, _ = _xor_step(torch.device("cpu"), stochastic, params=params0, grid=grid,
                                     noise=None if noise is None else
                                     tuple(x.cpu() for x in noise))
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        assert float((g - grads_c[k]).norm()) <= 1e-3 * float(grads_c[k].norm()) + 1e-30, k


def test_xor_kernels_never_reach_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for mod, names in ((xo, ("_xor_select_plain", "_xor_attempt_plain", "_xor_replay_fwd_plain",
                             "_xor_replay_bwd_plain")),
                       (xs, ("_xor_sde_fwd_plain", "_xor_sde_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    for stochastic in (False, True):
        rec, _, _, _ = _xor_step(dev, stochastic)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(rec["loss"]))


# ---------------------------------------------------------------------------
# The XOR stochastic-adaptive kernels: the selection (B5x on the krng tree,
# the XLA selection on the jax.random tree), the lanes' replay (B3xl) and its
# kernel-mode reverse sweep (B4'xl)
# ---------------------------------------------------------------------------

XOR_ADAPTIVE_M = 2048


def _xor_lane_keys(device, seed=11):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**32, (4, 2), generator=gen, dtype=torch.int64).to(device)


def _xor_selection(d, tree):
    words = _sde_key_words(_xor_lane_keys(d["y0"].device), tree).to(d["y0"].device)
    cfg = select_config(d["task"].ts, max_steps=XOR_ADAPTIVE_M, brownian=tree, drift="f32")
    return words, cfg


@pytest.mark.parametrize("tree", ["jax", "kernel"])
def test_xor_sde_select_and_attempts_equal_plain(xor, tree):
    d = xor
    words, cfg = _xor_selection(d, tree)
    before = xs.LAUNCHES["xor_sde_select"]
    got = xs.xor_sde_select(d["y0"], words, d["pf"], d["sc"], d["kv"], cfg)
    want = xs._xor_select_plain(d["y0"], words, d["pf"], d["sc"], d["kv"], cfg)
    torch.cuda.synchronize()
    assert xs.LAUNCHES["xor_sde_select"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    st, na = got[0], got[1]
    ht, dw, i10 = _replay_grid(st, words, cfg.t_start, cfg.t_end, 20, tree)
    t0s, hs = ht[:, :-1].T.contiguous(), (ht[:, 1:] - ht[:, :-1]).T.contiguous()
    n_real = 2 * int(na.max())
    ys = xs._xor_replay_fwd_plain(d["y0"], t0s, hs, dw.T.contiguous(), i10.T.contiguous(), n_real,
                                  d["pf"], d["sc"], d["kv"])
    tree_w = ns.lane_noise(words, cfg.t_start, cfg.t_end, 20, tree)[0]
    for k, stretch in ((0, 1.0), (n_real // 5, 2.5), (n_real // 2, 1.5), (n_real - 4, 4.0)):
        t1 = t0s[k][:, None].contiguous()
        h = (hs[k][:, None] * stretch + 1e-6).contiguous()
        args = (t1, ys[k].contiguous(), h, torch.full_like(t1, 0.7),
                tree_w.evaluate(t1).contiguous(), words, d["pf"], d["sc"], d["kv"], cfg)
        a, a_p = xs.xor_sde_attempt(*args), xs._xor_attempt_plain(*args)
        for g, w in zip(a, a_p):
            assert torch.equal(g, w), k


def test_xor_sde_replay_kernels_equal_plain(xor):
    from columnflow_torch.solvers.fused import sweep_chunk

    d = xor
    words, cfg = _xor_selection(d, "jax")
    st, na, _, _ = xs.xor_sde_select(d["y0"], words, d["pf"], d["sc"], d["kv"], cfg)
    ht, dw, i10 = _replay_grid(st, words, cfg.t_start, cfg.t_end, 20, "jax")
    t0s, hs = ht[:, :-1].T.contiguous(), (ht[:, 1:] - ht[:, :-1]).T.contiguous()
    i1, i10 = dw.T.contiguous(), i10.T.contiguous()
    n, n_real = t0s.shape[0], 2 * int(na.max())
    before = dict(xs.LAUNCHES)
    ys = xs.xor_sde_replay_fwd(d["y0"], t0s, hs, i1, i10, n_real, d["pf"], d["sc"], d["kv"])
    ys_p = xs._xor_replay_fwd_plain(d["y0"], t0s, hs, i1, i10, n_real, d["pf"], d["sc"], d["kv"])
    assert torch.isfinite(ys).all() and torch.equal(ys, ys_p)
    assert torch.equal(ys[n_real + 1:], ys[n_real].expand_as(ys[n_real + 1:]))
    ysbar = torch.randn(ys.shape, generator=d["gen"], device=ys.device)
    chunk = sweep_chunk((4, 72), n)
    yb, rows = xs.xor_sde_replay_bwd(ys, ysbar, t0s, hs, i10, n_real, chunk, d["pf"], d["sc"],
                                     d["kv"])
    yb_p, rows_p = xs._xor_replay_bwd_plain(ys, ysbar, t0s, hs, i10, n_real, chunk, d["pf"],
                                            d["sc"], d["kv"])
    torch.cuda.synchronize()
    assert xs.LAUNCHES["xor_sde_replay_fwd"] == before["xor_sde_replay_fwd"] + 1
    assert xs.LAUNCHES["xor_sde_replay_bwd"] == before["xor_sde_replay_bwd"] + 1
    assert torch.isfinite(yb).all() and torch.equal(yb, yb_p)
    for k in rows:
        assert torch.equal(rows[k], rows_p[k]), k


def _xor_adaptive_step(device, fused_pass, params=None, grid=None):
    from columnflow_torch.data import xor_conditions

    task = _xor_task(device, params)
    params0 = {k: p.detach().cpu().clone() for k, p in task.params.items()}
    conds = torch.as_tensor(xor_conditions(), device=device)
    step = xor_task.make_train_step(task, stochastic=True, adaptive=True, fused_pass=fused_pass)
    rec = step(conds, grid=grid, keys=_xor_lane_keys(device))
    return rec, {k: p.grad.detach().cpu() for k, p in task.params.items()}, params0


@pytest.mark.parametrize("fused_pass", [False, True])
def test_xor_adaptive_steps_on_cuda_match_cpu(dev, fused_pass):
    counters = (xo.LAUNCHES, xs.LAUNCHES, no.LAUNCHES, ns.LAUNCHES, cs.LAUNCHES)
    before = [dict(c) for c in counters]
    rec, grads, params0 = _xor_adaptive_step(dev, fused_pass)
    torch.cuda.synchronize()
    launched = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c if c[k] != b[k]}
    assert launched == {"xor_sde_select": 1, "xor_sde_replay_fwd": 1, "xor_sde_replay_bwd": 1}
    assert bool(torch.isfinite(rec["loss"]))
    stats = rec["stats"]
    grid = tuple(x.cpu() for x in (stats.step_times, stats.naccept, stats.nreject))
    rec_c, grads_c, _ = _xor_adaptive_step(torch.device("cpu"), fused_pass, params=params0,
                                           grid=grid)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for k, g in grads.items():
        assert float((g - grads_c[k]).norm()) <= 1e-3 * float(grads_c[k].norm()) + 1e-30, k


def test_xor_adaptive_kernels_never_reach_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_xor_select_plain", "_xor_attempt_plain", "_xor_replay_fwd_plain",
                 "_xor_replay_bwd_plain"):
        monkeypatch.setattr(xs, name, boom)
    for fused_pass in (False, True):
        rec, _, _ = _xor_adaptive_step(dev, fused_pass)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(rec["loss"]))


# ---------------------------------------------------------------------------
# The Hopf kernels (dopri5 on the MLP drift, kernel mode)
# ---------------------------------------------------------------------------

HOPF_T, HOPF_SPAN = 200, 5.0


def _hopf_task(device, params=None):
    task = bifurcation.build_task(torch.Generator(device=device).manual_seed(0),
                                  time_points=HOPF_T, total_time=HOPF_SPAN, max_steps=1024,
                                  device=device)
    if params is not None:
        with torch.no_grad():
            for layer, src in zip(task.params, params):
                for k, p in layer.items():
                    p.copy_(src[k])
    return task


@pytest.fixture
def hopf(dev):
    from columnflow_torch.data import make_hopf_dataset

    task = _hopf_task(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    true_y = make_hopf_dataset(gen, 32, task.ts, device=dev)
    params = [{k: v.detach().clone() for k, v in layer.items()} for layer in task.params]
    mu = ho.MuTable(true_y[:, :, 2].contiguous(), 0.0, task.dt)
    cfg = no.ODESelectConfig(0.0, float(task.ts[-1]), max_steps=1024)
    return dict(task=task, true_y=true_y, params=params, mu=mu, cfg=cfg, gen=gen,
                y0=true_y[0, :, :2].contiguous())


def test_hopf_select_and_attempts_equal_plain(hopf):
    d = hopf
    before = ho.LAUNCHES["hopf_select"]
    st, stats = ho.hopf_select(d["y0"], d["params"], d["mu"], d["cfg"])
    st_p, stats_p = ho._hopf_select_plain(d["y0"], d["params"], d["mu"], d["cfg"])
    torch.cuda.synchronize()
    assert ho.LAUNCHES["hopf_select"] == before + 1
    assert int(stats[2]) == 1 and stats.tolist() == stats_p.tolist() and torch.equal(st, st_p)
    n = int(stats[0])
    ys, _ = ho._hopf_replay_fwd_plain(d["y0"], st[:n + 1].contiguous(), d["params"], d["mu"])
    for k, stretch in ((0, 1.0), (n // 3, 2.5), (n // 2, 1.5), (n - 2, 4.0)):
        t, y = st[k].clone(), ys[k].contiguous()
        h = ((st[k + 1] - st[k]) * stretch).clone()
        f0 = ho.hopf_ode_drift(t, y, d["params"], d["mu"]).contiguous()
        a = ho.hopf_attempt(t, y, f0, h, d["params"], d["mu"], d["cfg"])
        a_p = ho._hopf_attempt_plain(t, y, f0, h, d["params"], d["mu"], d["cfg"])
        for got, want in zip(a, a_p):
            assert torch.equal(got, want), k


def test_hopf_replay_kernels_equal_plain(hopf):
    d = hopf
    st, stats = ho.hopf_select(d["y0"], d["params"], d["mu"], d["cfg"])
    stn = st[:int(stats[0]) + 1].contiguous()
    ys, co = ho.hopf_replay_fwd(d["y0"], stn, d["params"], d["mu"])
    ys_p, co_p = ho._hopf_replay_fwd_plain(d["y0"], stn, d["params"], d["mu"])
    assert torch.isfinite(co).all() and torch.equal(ys, ys_p) and torch.equal(co, co_p)
    cobar = torch.randn(co.shape, generator=d["gen"], device=co.device)
    yb, grads = ho.hopf_replay_bwd(ys, cobar, stn, d["params"], d["mu"])
    yb_p, grads_p = ho._hopf_replay_bwd_plain(ys, cobar, stn, d["params"], d["mu"])
    torch.cuda.synchronize()
    assert torch.isfinite(yb).all() and torch.equal(yb, yb_p)
    for i, (g, g_p) in enumerate(zip(grads, grads_p)):
        for k in g:
            assert torch.equal(g[k], g_p[k]), (i, k)


def test_hopf_wrappers_refuse_other_widths_and_lanes(hopf):
    from columnflow_torch.models.hopf import build_hopf_mlp

    d = hopf
    narrow = build_hopf_mlp(torch.Generator(device=d["y0"].device).manual_seed(1),
                            sizes=(3, 16, 16, 16, 2), device=d["y0"].device)
    with pytest.raises(ValueError, match="MLP"):
        ho.hopf_select(d["y0"], narrow, d["mu"], d["cfg"])
    y0 = torch.zeros(33, 2, device=d["y0"].device)
    mu = ho.MuTable(torch.zeros(HOPF_T, 33, device=d["y0"].device), 0.0, d["mu"].dt)
    with pytest.raises(ValueError, match="lanes"):
        ho.hopf_replay_fwd(y0, torch.zeros(2, device=y0.device), d["params"], mu)


def _hopf_step(device, true_y, params=None, grid=None):
    task = _hopf_task(device, params)
    params0 = [{k: p.detach().cpu().clone() for k, p in layer.items()} for layer in task.params]
    rec = bifurcation.make_train_step(task)(true_y.to(device), grid=grid)
    grads = [{k: p.grad.detach().cpu() for k, p in layer.items()} for layer in task.params]
    return rec, grads, params0


def test_hopf_step_on_cuda_matches_cpu(hopf):
    counters = (ho.LAUNCHES, xo.LAUNCHES, xs.LAUNCHES, no.LAUNCHES, ns.LAUNCHES, cs.LAUNCHES)
    before = [dict(c) for c in counters]
    rec, grads, params0 = _hopf_step(hopf["y0"].device, hopf["true_y"])
    torch.cuda.synchronize()
    launched = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c if c[k] != b[k]}
    assert launched == {"hopf_select": 1, "hopf_replay_fwd": 1, "hopf_replay_bwd": 1}
    assert bool(torch.isfinite(rec["loss"])) and bool(rec["stats"].success)
    grid = (rec["stats"].step_times.cpu(), int(rec["stats"].naccept))
    rec_c, grads_c, _ = _hopf_step(torch.device("cpu"), hopf["true_y"].cpu(), params=params0,
                                   grid=grid)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for g, g_c in zip(grads, grads_c):
        for k in g:
            assert float((g[k] - g_c[k]).norm()) <= 1e-3 * float(g_c[k].norm()) + 1e-30, k


def test_hopf_kernels_never_reach_the_plain_versions(hopf, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_hopf_select_plain", "_hopf_attempt_plain", "_hopf_replay_fwd_plain",
                 "_hopf_replay_bwd_plain"):
        monkeypatch.setattr(ho, name, boom)
    rec, _, _ = _hopf_step(hopf["y0"].device, hopf["true_y"])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(rec["loss"]))


# ---------------------------------------------------------------------------
# The Hopf MLP in outer mode: B8ho at the reference width, and the wide MLP
# (3-512-512-512-2) through B6h-wide, B7h-wide and B8ho-wide
# ---------------------------------------------------------------------------

HOPF_WIDE = (3, 512, 512, 512, 2)
HOPF_WIDE_STD = 0.1 * (100 / 512) ** 0.5


def _hopf_wide_task(device, params=None, time_points=100, total_time=2.5):
    """A ``HopfTask`` built by hand around the wide MLP, as a user would."""
    from columnflow_torch.models.hopf import build_hopf_mlp
    from columnflow_torch.train.optim import torch_rmsprop

    if params is None:
        params = build_hopf_mlp(torch.Generator(device=device).manual_seed(0), sizes=HOPF_WIDE,
                                init_std=HOPF_WIDE_STD, device=device)
    params = [{k: v.detach().to(device).clone().requires_grad_(True) for k, v in layer.items()}
              for layer in params]
    ts = linspace(0.0, total_time, time_points, device=device)
    opt, _ = torch_rmsprop([p for layer in params for p in layer.values()], lr=1e-3, alpha=0.99)
    return bifurcation.HopfTask(params, ts, float((ts[1] - ts[0]).item()), opt, 1024)


def test_hopf_emit_sweep_equals_plain_and_kernel_mode(hopf):
    d = hopf
    st, stats = ho.hopf_select(d["y0"], d["params"], d["mu"], d["cfg"])
    stn = st[:int(stats[0]) + 1].contiguous()
    ys, co = ho.hopf_replay_fwd(d["y0"], stn, d["params"], d["mu"])
    cobar = torch.randn(co.shape, generator=d["gen"], device=co.device)
    before = ho.LAUNCHES["hopf_replay_bwd_emit"]
    yb, steps = ho.hopf_replay_bwd_emit(ys, cobar, stn, d["params"], d["mu"])
    yb_p, steps_p = ho._hopf_replay_bwd_emit_plain(ys, cobar, stn, d["params"], d["mu"])
    yb_k, _ = ho.hopf_replay_bwd(ys, cobar, stn, d["params"], d["mu"])
    torch.cuda.synchronize()
    assert ho.LAUNCHES["hopf_replay_bwd_emit"] == before + 1
    assert torch.isfinite(steps).all() and torch.equal(steps, steps_p)
    assert torch.equal(yb, yb_p) and torch.equal(yb, yb_k)


@pytest.fixture
def hopf_wide(dev):
    from columnflow_torch.data import make_hopf_dataset

    task = _hopf_wide_task(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    true_y = make_hopf_dataset(gen, 32, task.ts, device=dev)
    params = [{k: v.detach().clone() for k, v in layer.items()} for layer in task.params]
    mu = ho.MuTable(true_y[:, :, 2].contiguous(), 0.0, task.dt)
    cfg = no.ODESelectConfig(0.0, float(task.ts[-1]), max_steps=1024)
    return dict(task=task, true_y=true_y, params=params, mu=mu, cfg=cfg, gen=gen,
                y0=true_y[0, :, :2].contiguous())


def test_hopf_wide_kernels_equal_plain(hopf_wide):
    d = hopf_wide
    before = dict(ho.LAUNCHES)
    st, stats = ho.hopf_select(d["y0"], d["params"], d["mu"], d["cfg"])
    st_p, stats_p = ho._hopf_select_plain(d["y0"], d["params"], d["mu"], d["cfg"])
    assert int(stats[2]) == 1 and stats.tolist() == stats_p.tolist() and torch.equal(st, st_p)
    n = int(stats[0])
    stn = st[:n + 1].contiguous()
    ys, co = ho.hopf_replay_fwd(d["y0"], stn, d["params"], d["mu"])
    ys_p, co_p = ho._hopf_replay_fwd_plain(d["y0"], stn, d["params"], d["mu"])
    assert torch.isfinite(co).all() and torch.equal(ys, ys_p) and torch.equal(co, co_p)
    for k, stretch in ((0, 1.0), (n // 2, 2.5), (n - 2, 4.0)):
        t, y = stn[k].clone(), ys[k].contiguous()
        h = ((stn[k + 1] - stn[k]) * stretch).clone()
        f0 = ho.hopf_ode_drift(t, y, d["params"], d["mu"]).contiguous()
        a = ho.hopf_attempt(t, y, f0, h, d["params"], d["mu"], d["cfg"])
        a_p = ho._hopf_attempt_plain(t, y, f0, h, d["params"], d["mu"], d["cfg"])
        for got, want in zip(a, a_p):
            assert torch.equal(got, want), k
    cobar = torch.randn(co.shape, generator=d["gen"], device=co.device)
    yb, steps = ho.hopf_replay_bwd_emit(ys, cobar, stn, d["params"], d["mu"])
    yb_p, steps_p = ho._hopf_replay_bwd_emit_plain(ys, cobar, stn, d["params"], d["mu"])
    torch.cuda.synchronize()
    assert torch.isfinite(yb).all() and torch.equal(yb, yb_p) and torch.equal(steps, steps_p)
    launched = {k: v - before[k] for k, v in ho.LAUNCHES.items() if v != before[k]}
    assert launched == {"hopf_select_wide": 1, "hopf_replay_fwd_wide": 1, "hopf_attempt_wide": 3,
                        "hopf_replay_bwd_emit_wide": 1}
    with pytest.raises(ValueError, match="MLP"):
        ho.hopf_replay_bwd(ys, cobar, stn, d["params"], d["mu"])


def _hopf_outer_step(device, true_y, wide, params=None, grid=None):
    """One outer-mode train step: the wide task's ``make_train_step`` ("auto"
    is "outer" there), or at the reference width ``hopf_odeint_dopri5_fused``
    with ``arg_grads="outer"``, SmoothL1, backward and RMSprop."""
    from columnflow_torch.ops.losses import smooth_l1
    from columnflow_torch.solvers.fused import hopf_odeint_dopri5_fused

    true_y = true_y.to(device)
    if wide:
        task = _hopf_wide_task(device, params, time_points=10, total_time=0.25)
        rec = bifurcation.make_train_step(task)(true_y[:10], grid=grid)
    else:
        task = _hopf_task(device, params)
        task.optimizer.zero_grad(set_to_none=True)
        pred, stats = hopf_odeint_dopri5_fused(task.params, true_y[:, :, 2], task.dt,
                                               true_y[0, :, :2], task.ts,
                                               max_steps=task.max_steps, grid=grid,
                                               return_stats=True, arg_grads="outer")
        loss = smooth_l1(pred, true_y[:, :, :2])
        loss.backward()
        task.optimizer.step()
        rec = {"loss": loss.detach(), "stats": stats}
    grads = [{k: p.grad.detach().cpu() for k, p in layer.items()} for layer in task.params]
    return rec, grads


@pytest.mark.parametrize("wide", [False, True])
def test_hopf_outer_steps_on_cuda_match_cpu(dev, hopf, wide):
    from columnflow_torch.models.hopf import build_hopf_mlp

    counters = (ho.LAUNCHES, xo.LAUNCHES, xs.LAUNCHES, no.LAUNCHES, ns.LAUNCHES, cs.LAUNCHES)
    before = [dict(c) for c in counters]
    params0 = (build_hopf_mlp(torch.Generator(device=dev).manual_seed(0), sizes=HOPF_WIDE,
                              init_std=HOPF_WIDE_STD, device=dev) if wide
               else [{k: v.cpu() for k, v in layer.items()} for layer in hopf["params"]])
    rec, grads = _hopf_outer_step(dev, hopf["true_y"], wide, params0)
    torch.cuda.synchronize()
    launched = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c if c[k] != b[k]}
    sfx = "_wide" if wide else ""
    assert launched == {f"hopf_select{sfx}": 1, f"hopf_replay_fwd{sfx}": 1,
                        f"hopf_replay_bwd_emit{sfx}": 1}
    assert bool(torch.isfinite(rec["loss"])) and bool(rec["stats"].success)
    grid = (rec["stats"].step_times.cpu(), int(rec["stats"].naccept))
    rec_c, grads_c = _hopf_outer_step(torch.device("cpu"), hopf["true_y"].cpu(), wide,
                                      [{k: v.cpu() for k, v in layer.items()} for layer in params0],
                                      grid=grid)
    assert float(rec["loss"]) == pytest.approx(float(rec_c["loss"]), rel=1e-5)
    for g, g_c in zip(grads, grads_c):
        for k in g:
            assert float((g[k] - g_c[k]).norm()) <= 1e-3 * float(g_c[k].norm()) + 1e-30, k


@pytest.mark.parametrize("wide", [False, True])
def test_hopf_outer_steps_never_reach_the_plain_versions(dev, hopf, wide, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("_hopf_select_plain", "_hopf_attempt_plain", "_hopf_replay_fwd_plain",
                 "_hopf_replay_bwd_plain", "_hopf_replay_bwd_emit_plain"):
        monkeypatch.setattr(ho, name, boom)
    rec, _ = _hopf_outer_step(dev, hopf["true_y"], wide)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(rec["loss"]))
