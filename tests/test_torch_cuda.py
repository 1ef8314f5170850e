"""The CUDA kernels of ``columnflow_torch.kernels.column_step`` against their
plain PyTorch versions, on the card.

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
"""

import pytest
import torch

from columnflow_torch.config import ColumnConfig
from columnflow_torch.data import sample_wta_mus, wta_stim_three_phases
from columnflow_torch.kernels import column_step as cs
from columnflow_torch.models.wta import build_wta
from columnflow_torch.ops.losses import huber_trajectory_loss_wta
from columnflow_torch.solvers.sde import brownian_pack
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
