"""The CUDA kernels of ``columnflow_torch.kernels.column_step`` and
``columnflow_torch.kernels.network_sde`` against their plain PyTorch
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
2^-8, apart).
"""

import pytest
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.data import make_parity_batch, sample_wta_mus, wta_stim_three_phases
from columnflow_torch.kernels import column_step as cs
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.models import network as nw
from columnflow_torch.models.wta import build_wta
from columnflow_torch.ops.interp import step_table_knots
from columnflow_torch.ops.losses import huber_trajectory_loss_wta
from columnflow_torch.solvers.sde import brownian_pack
from columnflow_torch.solvers.sde_adaptive import _replay_grid, _sde_key_words, select_config
from columnflow_torch.tasks import parity
from columnflow_torch.tasks.wta import DT, linspace

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
                words=_sde_key_words(keys))


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
    rec = parity.make_train_step(task, **STEP)(stims, words, grid=grid)
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
