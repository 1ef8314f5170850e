"""Port parity: ``columnflow_torch.solvers.sde_adaptive`` and
``solvers.fused`` (the plain versions of the selection, replay and reverse
sweep kernels) against ``columnflow.solvers.sde_adaptive`` /
``columnflow.solvers.fused``, at the JAX tests' size: columns (2, 1),
2 inputs, 60 grid points, max_steps 512, batch 2, the flagship's drifts
(bf16 selection, split2 replay, gradbf16 weight gradients). JAX's Pallas
kernels run in interpret mode.

What can be held. One controller attempt from identical inputs: the same
decision, err and next h rel 1e-3 (err is the norm of a difference of two
solutions that agree to ~rtol, so float32 rounding differences of the
drifts appear in it magnified). A whole selection cannot be held pathwise
across implementations: a rate an ulp apart can round to bf16 differently,
an error estimate then differs, h differs, the interval normals' counters
differ, and from there the two runs draw different noise. It is held
statistically: both succeed, naccept and nreject within 10%. The replay, the loss and the gradients are held on JAX's frozen
grid and lane keys: states 1e-5 of each component's largest magnitude,
loss rel 1e-5, gradient rel L2 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.data import make_parity_batch as j_batch
from columnflow.models import network as jn
from columnflow.models.column import Stimulus as JStim
from columnflow.ops.interp import interp_knots as j_knots
from columnflow.ops.interp import step_table_knots as j_step_knots
from columnflow.solvers import krng as jk
from columnflow.solvers import sde_adaptive as jsa
from columnflow.tasks import parity as jpt
from columnflow_torch.convert import lane_key_words, network_from_jax
from columnflow_torch.kernels import network_sde as ns
from columnflow_torch.models import network as tn
from columnflow_torch.ops.interp import step_table_knots
from columnflow_torch.solvers import sde_adaptive as tsa
from columnflow_torch.solvers.fused import sdeint_fused, truncation_stride
from columnflow_torch.tasks import parity as tpt

T, B, M = 60, 2, 512


@pytest.fixture(scope="module")
def setup():
    task = jpt.build_task(JaxConfig.load(), jax.random.PRNGKey(0), columns_per_area=(2, 1),
                          n_inputs=2, time_steps=T, max_steps=M)
    stims = j_batch(jax.random.PRNGKey(1), 2, B)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    dt, n_in, P = task.dt, 2, task.net.num_pops
    jfc = jn.build_network_fused_consts(task.net)
    kts, _ = j_step_knots(T, dt, jnp.zeros(n_in), jnp.zeros(n_in))
    jpw = jn.premix_network_weights(task.params, task.net)
    kv_all = jax.vmap(lambda s: j_step_knots(T, dt, jnp.zeros_like(s), s)[1])(stims)

    def drift(fn):
        return lambda t, y, pw, fc, kv: fn(t, y, pw, fc, JStim(0.0, dt, kv),
                                           interp_fn=lambda t_, a, b, v: j_knots(t_, kts, v))

    a_diff = lambda t, y, pw, fc, kv: jnp.full_like(y, jn.NETWORK_NOISE_STD)  # noqa: E731
    ts = task.ts
    t0, t1 = float(ts[0]), float(ts[-1])
    h0 = float((np.asarray(ts)[-1] - np.asarray(ts)[0]) / (4.0 * T))

    def one_pass(y0_b, key_b, kv_b):
        return jsa._adaptive_pass_fused(
            drift(jn.network_drift_premixed_select16), a_diff, y0_b, key_b, t0, t1, 1e-3,
            1e-3, h0, M, 20, "pi", "sra1", (jn.premix_select16(jpw), jfc, kv_b),
            interpret=True)

    st, na, nr, ok = jax.vmap(one_pass)(jnp.zeros((B, 1, 3 * P)), keys, kv_all[:, :, None, :])
    params, net = network_from_jax({k: np.asarray(v) for k, v in task.params.items()}, task.net)
    fc = tn.build_network_fused_consts(net)
    tkts, kv = step_table_knots(T, dt, torch.zeros(B, n_in), torch.as_tensor(np.asarray(stims)))
    pw = tn.premix_network_weights(params, net)
    return dict(task=task, stims=stims, keys=keys, jfc=jfc, kts=kts, jpw=jpw, kv_all=kv_all,
                drift=drift, a_diff=a_diff, t0=t0, t1=t1, h0=h0,
                grid=(np.asarray(st), np.asarray(na), np.asarray(nr), np.asarray(ok)),
                params=params, net=net, model=tsa.PremixedNetworkSDE(pw, ns.SDEConsts(fc, tkts), kv),
                words=tsa._sde_key_words(lane_key_words(keys)),
                cfg=ns.SelectConfig(t0, t1, 1e-3, 1e-3, h0, M, 20, 0.0))


def _scaled(got, want):
    want = np.asarray(want)
    scale = np.abs(want).reshape(-1, want.shape[-1]).max(0)
    return float(np.max(np.abs(np.asarray(got) - want) / np.maximum(scale, 1e-30)))


def test_one_controller_attempt_matches_jax_body(setup):
    """States with every rate either in the linear regime (v - a > 70, where
    the rate is 48 (v - a) - 981 to the last bit) or near zero: there the
    bf16 rounding of the rates, which the selection drift applies, gives
    the same value on both sides. Elsewhere an ulp of difference between
    XLA's exp/tanh and torch's can round a rate one bf16 ulp apart, which
    moves the error estimate (a difference of two solutions) by ~1e-3.
    Err and next h agree to rel 1e-3 (measured 2.7e-4 where err lies near
    the decision, 0.3..20): err is the norm of the difference of two
    solutions that agree to ~rtol = 1e-3, so the float32 rounding of the
    drifts' large, cancelling currents (1e-7 relative) appears in it
    magnified by 1e3 and more."""
    s = setup
    P = s["net"].num_pops
    model = s["model"]
    w16 = tn.premix_select16(model.pw)
    rng = np.random.default_rng(3)
    decisions, rel = set(), [0.0]
    for b in range(B):
        key_b, kv_b = s["keys"][b], s["kv_all"][b][:, None, :]
        tree, i10_draw = jsa._noise_backend(key_b, s["t0"], s["t1"], 20, jnp.float32, "kernel")
        body = jax.jit(jsa._make_body(jsa._sra1_step, 0.5, True,
                                      s["drift"](jn.network_drift_premixed_select16),
                                      s["a_diff"], s["t1"], tree, i10_draw, 1e-3, 1e-3,
                                      jnp.float32, (jn.premix_select16(s["jpw"]), s["jfc"], kv_b),
                                      controller="pi", doubling=None))
        for t1 in (0.003, 0.031, 0.05):
            a = rng.uniform(0, 5, (1, P))
            v = a + np.where(rng.random((1, P)) < 0.5, rng.uniform(75, 150, (1, P)),
                             rng.uniform(-60, -25, (1, P)))
            y1 = np.concatenate([v, a, rng.uniform(0, 50, (1, P))], 1).astype(np.float32)
            for h in (2e-6, 5e-6, 1e-5):
                t1f, hf = np.float32(t1), np.float32(h)
                w_t1 = tree.evaluate(jnp.float32(t1f))
                c = jsa._Carry(t0=jnp.float32(t1f), y0=jnp.asarray(y1), t1=jnp.float32(t1f),
                               y1=jnp.asarray(y1), h=jnp.float32(hf), step_times=jnp.zeros(8),
                               naccept=jnp.int32(0), nreject=jnp.int32(0),
                               err_prev=jnp.float32(0.7), w_t1=w_t1)
                out = body(c)
                got = ns.select_attempt(
                    torch.tensor([[t1f]]), torch.as_tensor(y1), torch.tensor([[hf]]),
                    torch.tensor([[0.7]]), torch.tensor([[float(w_t1)]]), s["words"][b:b + 1],
                    w16, model.sc, model.kv[:, b:b + 1].contiguous(), s["cfg"])
                accept = int(out.naccept) == 1
                decisions.add(accept)
                assert bool(got.accept) == accept
                assert float(got.t_new) == float(out.t1)
                err_jax = (float(out.err_prev) if accept
                           else (0.9 * float(hf) / float(out.h)) ** 2)
                h_rel = abs(float(got.h_next) / float(out.h) - 1)
                if 0.3 <= err_jax < 20.0:  # near the decision, below the clip
                    rel += [h_rel, abs(float(got.err) / err_jax - 1)]
                else:
                    assert h_rel < 1e-3
                if accept:
                    want = np.asarray(out.y1)
                    assert np.max(np.abs(got.y_new.numpy() - want)) <= 1e-5 * np.abs(want).max()
    assert decisions == {True, False}
    assert max(rel) < 1e-3, max(rel)


def test_whole_plain_selection_matches_jax_statistically(setup):
    """Measured at this size: naccept (406, 412) against JAX's (408, 404),
    nreject (68, 68) against (66, 72). The grids themselves part at the
    first step: from y0 = 0 every rate is the same value, and its bf16
    rounding sets the first error estimate (2.57 here, 4.04 in JAX's
    kernel; JAX's own jitted and eager passes differ there too)."""
    s = setup
    st_j, na_j, nr_j, ok_j = s["grid"]
    st, na, nr, ok = ns._select_plain(torch.zeros(B, 3 * s["net"].num_pops), s["words"],
                                      tn.premix_select16(s["model"].pw), s["model"].sc,
                                      s["model"].kv, s["cfg"])
    assert ok.all() and ok_j.all()
    assert (st[torch.arange(B), na.long()] == s["t1"]).all()
    assert (torch.diff(st, dim=1) >= 0).all()
    np.testing.assert_allclose(na.numpy(), na_j, rtol=0.1)
    np.testing.assert_allclose(nr.numpy(), nr_j, rtol=0.1, atol=3)


def _split3_body(s, b):
    """JAX's controller body on lane b's krng tree with the three-term
    selection drift: ``network_drift_premixed`` on ``prepare_premixed_split``
    of the weights, the in-kernel pass's drift under ``select_prepare``."""
    key_b, kv_b = s["keys"][b], s["kv_all"][b][:, None, :]
    tree, i10_draw = jsa._noise_backend(key_b, s["t0"], s["t1"], 20, jnp.float32, "kernel")
    w3 = jn.prepare_premixed_split(s["jpw"], s["jfc"])[0]
    body = jax.jit(jsa._make_body(jsa._sra1_step, 0.5, True, s["drift"](jn.network_drift_premixed),
                                  s["a_diff"], s["t1"], tree, i10_draw, 1e-3, 1e-3, jnp.float32,
                                  (w3, s["jfc"], kv_b), controller="pi", doubling=None))
    return tree, body


def test_one_split3_attempt_matches_jax_body(setup):
    """B5t's plain version (``drift="split3"``: the three-term split of
    ``prepare_premixed_split``, the krng tree) for one controller attempt,
    against JAX's body with that drift, from random states at three times
    and three steps per lane: the same decision, err and next h rel 1e-3
    where err lies near the decision (0.3..20), the new state within 1e-5 of
    its scale."""
    s = setup
    P = s["net"].num_pops
    model = s["model"]
    w3 = ns.select_weights_split3({k: v.detach() for k, v in model.pw.items()}, model.sc)
    cfg = s["cfg"]._replace(drift="split3")
    rng = np.random.default_rng(4)
    decisions, rel = set(), [0.0]
    for b in range(B):
        tree, body = _split3_body(s, b)
        for t1 in (0.003, 0.031, 0.05):
            a = rng.uniform(0, 5, (1, P))
            v = a + rng.uniform(-60, 150, (1, P))
            y1 = np.concatenate([v, a, rng.uniform(0, 50, (1, P))], 1).astype(np.float32)
            for h in (2e-6, 5e-6, 1e-5):
                t1f, hf = np.float32(t1), np.float32(h)
                w_t1 = tree.evaluate(jnp.float32(t1f))
                c = jsa._Carry(t0=jnp.float32(t1f), y0=jnp.asarray(y1), t1=jnp.float32(t1f),
                               y1=jnp.asarray(y1), h=jnp.float32(hf), step_times=jnp.zeros(8),
                               naccept=jnp.int32(0), nreject=jnp.int32(0),
                               err_prev=jnp.float32(0.7), w_t1=w_t1)
                out = body(c)
                got = ns.select_attempt(
                    torch.tensor([[t1f]]), torch.as_tensor(y1), torch.tensor([[hf]]),
                    torch.tensor([[0.7]]), torch.tensor([[float(w_t1)]]), s["words"][b:b + 1],
                    w3, model.sc, model.kv[:, b:b + 1].contiguous(), cfg)
                accept = int(out.naccept) == 1
                decisions.add(accept)
                assert bool(got.accept) == accept
                assert float(got.t_new) == float(out.t1)
                err_jax = (float(out.err_prev) if accept
                           else (0.9 * float(hf) / float(out.h)) ** 2)
                h_rel = abs(float(got.h_next) / float(out.h) - 1)
                if 0.3 <= err_jax < 20.0:
                    rel += [h_rel, abs(float(got.err) / err_jax - 1)]
                else:
                    assert h_rel < 1e-3
                if accept:
                    want = np.asarray(out.y1)
                    assert np.max(np.abs(got.y_new.numpy() - want)) <= 1e-5 * np.abs(want).max()
    assert decisions == {True, False}
    assert max(rel) < 1e-3, max(rel)


def test_whole_split3_selection_matches_jax_in_kernel_pass_statistically(setup):
    """B5t's plain selection loop against JAX's in-kernel pass with
    ``select_prepare=prepare_premixed_split`` (interpret mode): both
    succeed, and per lane naccept and nreject lie within 10% plus 3 steps
    plus twice the port's own spread under a 1e-7 nudge of the weights.
    Measured: naccept (394, 402) against JAX's (394, 403); nreject (62, 86)
    against (65, 71), where the nudge alone moves the port's to (67, 67):
    once an error estimate an ulp apart flips a decision, the two runs draw
    other noise (ROADMAP.md section C)."""
    s = setup
    P = s["net"].num_pops
    model = s["model"]

    def one_pass(y0_b, key_b, kv_b):
        return jsa._adaptive_pass_fused(
            s["drift"](jn.network_drift_premixed), s["a_diff"], y0_b, key_b, s["t0"], s["t1"],
            1e-3, 1e-3, s["h0"], M, 20, "pi", "sra1", (s["jpw"], s["jfc"], kv_b),
            prepare=jn.prepare_premixed_split, interpret=True)

    _, na_j, nr_j, ok_j = jax.vmap(one_pass)(jnp.zeros((B, 1, 3 * P)), s["keys"],
                                             s["kv_all"][:, :, None, :])
    def port(scale):
        pw = {k: v.detach() * scale for k, v in model.pw.items()}
        return ns._select_plain(torch.zeros(B, 3 * P), s["words"],
                                ns.select_weights_split3(pw, model.sc), model.sc, model.kv,
                                s["cfg"]._replace(drift="split3"))

    st, na, nr, ok = port(1.0)
    _, na_n, nr_n, _ = port(1.0 + 1e-7)
    assert ok.all() and np.asarray(ok_j).all()
    assert (st[torch.arange(B), na.long()] == s["t1"]).all()
    for got, nudged, want in ((na, na_n, na_j), (nr, nr_n, nr_j)):
        want = np.asarray(want)
        spread = 2 * np.abs(nudged.numpy() - got.numpy())
        assert (np.abs(got.numpy() - want) <= 0.1 * want + 3 + spread).all()


def test_split3_selection_weights_are_one_block_of_the_replay_split(setup):
    """``select_weights_split3`` holds the replay's three terms as one
    contiguous (3, P, P) block (the kernel reads them through one pointer)
    with the plain drift's views into it; the three-term drift is the
    in-kernel pass's only on the krng tree."""
    s = setup
    model = s["model"]
    pw = {k: v.detach() for k, v in model.pw.items()}
    w3 = ns.select_weights_split3(pw, model.sc)
    split = tn.prepare_premixed_split(pw, model.sc.fc)[0]
    assert w3["w3"].is_contiguous() and w3["w3"].dtype == torch.bfloat16
    for i, k in enumerate(("wT_hi", "wT_mid", "wT_lo")):
        assert torch.equal(w3[k], split[k]) and w3[k].data_ptr() == w3["w3"][i].data_ptr()
    assert tsa.resolve_selection(True, None, False) == ("kernel", "split3")
    assert tsa.resolve_selection(False, None, False) == ("jax", "f32")
    y = torch.zeros(1, 3 * s["net"].num_pops)
    one = torch.zeros(1, 1)
    with pytest.raises(ValueError, match="krng"):
        ns.select_attempt(one, y, one + 1e-5, one + 1, one, s["words"][:1], w3, model.sc,
                          model.kv[:, :1].contiguous(),
                          s["cfg"]._replace(drift="split3", brownian="jax"))


def _jax_noise(s):
    """The replay grid and noise exactly as the JAX batched replay builds
    them from the frozen grid."""
    st = jnp.asarray(s["grid"][0])
    mids = st[:, :-1] + 0.5 * (st[:, 1:] - st[:, :-1])
    ht = jnp.concatenate([jnp.stack([st[:, :-1], mids], axis=2).reshape(B, -1), st[:, -1:]],
                         axis=1)

    def per_lane(key_b, ht_b):
        tree, i10_draw = jsa._noise_backend(key_b, s["t0"], s["t1"], 20, jnp.float32, "kernel")
        w = jax.vmap(tree.evaluate)(ht_b)
        dw = w[1:] - w[:-1]
        za = jax.vmap(i10_draw)(ht_b[:-1], ht_b[1:])
        hh = ht_b[1:] - ht_b[:-1]
        return dw, hh * (0.5 * dw + jnp.sqrt(hh / 12.0) * za)

    dw, i10 = jax.vmap(per_lane)(s["keys"], ht)
    return ht, dw, i10


def test_replay_noise_matches_jax(setup):
    s = setup
    ht, dw_j, i10_j = _jax_noise(s)
    tree, i10_draw = tsa._noise_backend(s["words"], s["t0"], s["t1"], 20)
    ht_t = torch.as_tensor(np.asarray(ht))
    np.testing.assert_array_equal(ht_t.numpy(), np.asarray(ht))
    w = tree.evaluate(ht_t)
    dw = w[:, 1:] - w[:, :-1]
    za = i10_draw(ht_t[:, :-1], ht_t[:, 1:])
    hh = ht_t[:, 1:] - ht_t[:, :-1]
    i10 = hh * (0.5 * dw + torch.sqrt(hh / 12.0) * za)
    scale = float(np.sqrt(s["t1"] - s["t0"]))
    assert np.max(np.abs(dw.numpy() - np.asarray(dw_j))) < 1e-5 * scale
    assert np.max(np.abs(i10.numpy() - np.asarray(i10_j))) < 1e-5 * scale * 1e-3


def test_sdeint_fused_forward_matches_jax(setup):
    from columnflow.solvers.fused import sdeint_fused as j_sdeint_fused

    s = setup
    ht, dw, i10 = _jax_noise(s)
    n_real = 2 * int(s["grid"][1].max())
    P = s["net"].num_pops
    want = j_sdeint_fused(
        s["drift"](jn.network_drift_premixed), s["a_diff"], jnp.zeros((B, 3 * P)), None, None,
        s["jpw"], s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1), method="srk",
        noise_pack=(dw.T, i10.T), ts_steps=ht, interpret=True, nondiff_args=(1, 2),
        prepare=jn.prepare_premixed_split2, n_real=n_real)
    m = s["model"]
    got = sdeint_fused(m.pw, m.sc, m.kv, torch.zeros(B, 3 * P), torch.as_tensor(np.asarray(ht)),
                       (torch.as_tensor(np.asarray(dw)).T, torch.as_tensor(np.asarray(i10)).T),
                       n_real=n_real)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _scaled(got.detach().numpy(), want) < 1e-5


def _loss_and_grad_jax(s, bptt_every):
    st, na = (jnp.asarray(x) for x in s["grid"][:2])
    P = s["net"].num_pops
    drift, a_diff = s["drift"], s["a_diff"]

    def loss(pw):
        ys = jsa._replay_pass_fused_batch(
            "sra1", True, drift(jn.network_drift_premixed), a_diff, jnp.zeros((B, 3 * P)),
            s["task"].ts, st, na, M, s["keys"], (pw, s["jfc"], jnp.moveaxis(s["kv_all"], 0, 1)),
            "kernel", 20, s["task"].ts[0], s["task"].ts[-1], interpret=True,
            nondiff_args=(1, 2), prepare=jn.prepare_premixed_split2, bptt_every=bptt_every,
            vjp_drift=drift(jn.network_drift_premixed_gradbf16), vjp_diffusion=a_diff)
        out = jpt.readout(ys, s["task"].params, s["task"].net)
        return jnp.mean(jnp.abs(out - jpt.parity_targets(s["stims"])))

    return jax.value_and_grad(loss)(s["jpw"])


@pytest.mark.parametrize("bptt_every", [32, 3])
def test_replay_loss_and_gradient_match_jax(setup, bptt_every):
    """bptt_every=32 is the flagship's window (64 half steps, one chunk of
    64 at this size); 3 gives 6 half steps, a window that leaves a
    remainder chunk of 4 of the 1024 half steps, truncated after it too."""
    s = setup
    want_loss, want_grad = _loss_and_grad_jax(s, bptt_every)
    m = s["model"]
    pw = {k: v.detach().clone().requires_grad_(True) for k, v in m.pw.items()}
    model = tsa.PremixedNetworkSDE(pw, m.sc, m.kv)
    st, na, nr = (torch.as_tensor(x) for x in s["grid"][:3])
    ys = tsa.sdeint_adaptive_batch(model, torch.zeros(B, 3 * s["net"].num_pops),
                                   torch.as_tensor(np.asarray(s["task"].ts)),
                                   lane_key_words(s["keys"]), max_steps=M,
                                   bptt_every=bptt_every, grid=(st, na, nr))
    out = tpt.readout(ys, s["params"], s["net"])
    loss = torch.mean(torch.abs(out - tpt.parity_targets(torch.as_tensor(np.asarray(s["stims"])))))
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k in ("wT", "iwT"):
        g, w = pw[k].grad.numpy(), np.asarray(want_grad[k])
        assert np.isfinite(g).all()
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-3, k


def test_truncation_stride_follows_the_jax_chunking():
    # full width (4 lanes x 2496): chunk 8, kc = round(64 / 8) = 8
    assert truncation_stride((4, 2496), 32768, 64) == 64
    assert truncation_stride((4, 2496), 32768, 20) == 16  # round(2.5) == 2
    assert truncation_stride((2, 72), 1024, 64) == 64    # chunk 64, kc 1
    assert truncation_stride((2, 72), 1024, 6) == 6
    assert truncation_stride((2, 72), 100, 256) == 300   # chunk 100, kc round(2.56)
    assert truncation_stride((2, 72), 1024, None) == 0
