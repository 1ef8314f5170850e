"""Port parity: ``columnflow_torch.models.network`` and the replay step's
hand-written VJPs against ``columnflow.models.network`` and ``jax.vjp``.

Both sides take the JAX package's parameters (``convert.network_from_jax``)
at the JAX tests' size, columns (2, 1), 2 inputs, batch 2 (the masks also
at the reference's (8, 4, 1)).

Tolerances. Masks, constants and bf16 splits: equal. Drifts: 1e-6 of each
component's sum of absolute terms (a float32 sum in another order, with
XLA's exp/tanh a few ulp off torch's), one population at the firing-rate
singularity; split2 within 2^-15 of that scale: its two-term split of the
rates keeps ~16 bits, so a rate an ulp away can round its second term one
bf16 ulp apart (measured 1.03e-5 here). The split2 step's state VJP: rel L2 1e-5 (it keeps the bf16
rounding points of ``jax.vjp``; the plain float32 product would miss by
~3e-3). The gradbf16 step's weight cotangent: rel L2 1e-3. The three-term
split's VJP (the deterministic fused step's): its rounding points against
``jax.vjp`` of ``matmul_split`` through ``split_f32`` on bf16-representable
cotangent inputs, equal; in float64 the same formulas are the plain
products (rel 1e-14). Against ``jax.vjp`` of the whole drift and of the
dopri5 step: tests/test_torch_ode_fused.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.config import ColumnConfig as JaxConfig
from columnflow.models import network as jn
from columnflow.models.column import Stimulus as JStim
from columnflow.ops.interp import interp_at as j_interp_at
from columnflow.ops.interp import interp_knots as j_knots
from columnflow.ops.interp import step_table_knots as j_step_knots
from columnflow.solvers.fused import _make_sde_step
from columnflow_torch.config import ColumnConfig
from columnflow_torch.convert import network_from_jax
from columnflow_torch.kernels.network_sde import SDEConsts, step_vjp_split2
from columnflow_torch.models import network as tn
from columnflow_torch.models.column import Stimulus
from columnflow_torch.ops.interp import interp_knots, step_table_knots
from columnflow_torch.solvers.fused import outer_arg_grads

T, B, DT = 60, 2, 0.06 / 59


@pytest.fixture(scope="module")
def nets():
    jparams, jnet = jn.build_column_network(JaxConfig.load(), jax.random.PRNGKey(0),
                                            columns_per_area=(2, 1), n_inputs=2)
    params, net = network_from_jax({k: np.asarray(v) for k, v in jparams.items()}, jnet)
    rng = np.random.default_rng(1)
    P = net.num_pops
    y = np.concatenate([rng.uniform(-5, 25, (B, P)), rng.uniform(0, 5, (B, P)),
                        rng.uniform(0, 50, (B, P))], axis=1).astype(np.float32)
    y[0, 3], y[0, P + 3] = 20.4375, 0.0  # 48 (v - a) - 981 == 0: the singularity
    stims = np.array([[0.0, 15.0], [15.0, 15.0]], np.float32)
    t = np.array([[0.02], [0.0301]], np.float32)
    return dict(jparams=jparams, jnet=jnet, params=params, net=net, y=y, stims=stims, t=t,
                rng=rng)


@pytest.mark.parametrize("cpa,n_in", [((2, 1), 2), ((8, 4, 1), 4)])
def test_masks_and_constants_equal(cpa, n_in):
    _, jnet = jn.build_column_network(JaxConfig.load(), jax.random.PRNGKey(3),
                                      columns_per_area=cpa, n_inputs=n_in)
    _, net = tn.build_column_network(ColumnConfig.load(), torch.Generator().manual_seed(3),
                                     columns_per_area=cpa, n_inputs=n_in)
    for f in ("inner_weights", "background_current", "adaptation_strength", "input_mask",
              "feedforward_mask", "lateral_mask", "output_mask"):
        np.testing.assert_array_equal(getattr(net, f), np.asarray(getattr(jnet, f)), err_msg=f)
    assert net.num_pops == jnet.num_pops and net.columns_per_area == tuple(cpa)
    jfc, fc = jn.build_network_fused_consts(jnet), tn.build_network_fused_consts(net)
    for k in jfc:
        np.testing.assert_array_equal(np.asarray(fc[k]), np.asarray(jfc[k], np.float32), err_msg=k)


def test_splits_bit_equal():
    w = np.random.default_rng(2).normal(size=(24, 24)).astype(np.float32) * 3
    for got, want in zip(tn.split_f32(torch.as_tensor(w)), jn.split_f32(jnp.asarray(w))):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    pw_j = {"wT": jnp.asarray(w), "iwT": jnp.ones((2, 24))}
    pw_t = {"wT": torch.as_tensor(w), "iwT": torch.ones(2, 24)}
    got, want = tn.prepare_premixed_split2(pw_t, {})[0], jn.prepare_premixed_split2(pw_j, {})[0]
    for k in ("wT_hi", "wT_mid"):
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


def _abs_terms(y, fr, wT, ext, iwT, fc):
    """Per component, the sum of the absolute terms of the drift (float64)."""
    P = fc["bg"].shape[0]
    fr, wT, iwT = (np.abs(np.asarray(a, np.float64)) for a in (fr, wT, iwT))
    R, ts, tm, ta = fc["resistance"], fc["tau_syn"], fc["tau_mem"], fc["tau_adapt"]
    sv = (np.abs(y[..., :P]) / tm + R * ts / tm
          * (fr @ wT + np.abs(np.asarray(ext, np.float64)) @ iwT + np.abs(np.asarray(fc["bg"]))))
    sa = (np.abs(y[..., P:2 * P]) + np.abs(np.asarray(fc["adapt"])) * fr) / ta
    sr = (np.abs(y[..., 2 * P:]) + fr) / ts
    return np.concatenate([sv, sa, sr], axis=-1)


def _scaled(got, want, scale):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)) / np.maximum(scale, 1e-30)))


@pytest.mark.parametrize("variant", ["plain", "split", "split2", "select16", "gradbf16"])
def test_premixed_drifts_match_jax(nets, variant):
    jnet, net, y, t = nets["jnet"], nets["net"], nets["y"], nets["t"]
    jfc, fc = jn.build_network_fused_consts(jnet), tn.build_network_fused_consts(net)
    stims = nets["stims"]
    jkts, jkv = j_step_knots(T, DT, jnp.zeros_like(stims), jnp.asarray(stims))
    kts, kv = step_table_knots(T, DT, torch.zeros(B, 2), torch.as_tensor(stims))
    jpw = jn.premix_network_weights(nets["jparams"], jnet)
    pw = tn.premix_network_weights(nets["params"], net)
    jprep = {"plain": lambda p: p, "split": lambda p: jn.prepare_premixed_split(p, jfc)[0],
             "split2": lambda p: jn.prepare_premixed_split2(p, jfc)[0],
             "select16": jn.premix_select16, "gradbf16": lambda p: p}[variant]
    tprep = {"plain": lambda p: p, "split": lambda p: tn.prepare_premixed_split(p, fc)[0],
             "split2": lambda p: tn.prepare_premixed_split2(p, fc)[0],
             "select16": tn.premix_select16, "gradbf16": lambda p: p}[variant]
    jfn = {"select16": jn.network_drift_premixed_select16,
           "gradbf16": jn.network_drift_premixed_gradbf16}.get(variant, jn.network_drift_premixed)
    tfn = {"select16": tn.network_drift_premixed_select16,
           "gradbf16": tn.network_drift_premixed_gradbf16}.get(variant, tn.network_drift_premixed)
    want = jfn(jnp.asarray(t), jnp.asarray(y), jprep(jpw), jfc, JStim(0.0, DT, jkv),
               interp_fn=lambda t_, a, b, v: j_knots(t_, jkts, v))
    got = tfn(torch.as_tensor(t), torch.as_tensor(y), tprep(pw), fc, Stimulus(0.0, DT, kv),
              interp_fn=lambda t_, a, b, v: interp_knots(t_, kts, v))
    P = net.num_pops
    fr = tn.compute_firing_rate(torch.as_tensor(y[:, :P] - y[:, P:2 * P])).numpy()
    ext = interp_knots(torch.as_tensor(t), kts, kv).numpy()
    scale = _abs_terms(y, fr, pw["wT"].numpy(), ext, pw["iwT"].numpy(), fc)
    assert np.isfinite(got.numpy()).all()
    assert _scaled(got.numpy(), want, scale) < (2.0**-15 if variant == "split2" else 1e-6)


def test_network_drift_matches_jax(nets):
    jnet, net, y = nets["jnet"], nets["net"], nets["y"]
    table = np.zeros((T, 2), np.float32)
    table[T // 2:] = nets["stims"][1]
    want = jn.network_drift(0.0301, jnp.asarray(y[0]), nets["jparams"], jnet,
                            JStim(0.0, DT, jnp.asarray(table)), interp_fn=j_interp_at)
    got = tn.network_drift(0.0301, torch.as_tensor(y[0]), nets["params"], net,
                           Stimulus(0.0, DT, torch.as_tensor(table)))
    fc = tn.build_network_fused_consts(net)
    pw = tn.premix_network_weights(nets["params"], net)
    P = net.num_pops
    fr = tn.compute_firing_rate(torch.as_tensor(y[0, :P] - y[0, P:2 * P])).numpy()
    scale = _abs_terms(y[0], fr, pw["wT"].numpy(), table[-1], pw["iwT"].numpy(), fc)
    assert _scaled(got.numpy(), want, scale) < 1e-6
    assert torch.equal(tn.network_diffusion(0.0, torch.as_tensor(y), None, net, None),
                       torch.full((B, 3 * P), 10.0))


def _step_inputs(nets):
    rng = nets["rng"]
    t0 = np.array([[0.0291], [0.0305]], np.float32)
    h = np.array([[3e-4], [0.0]], np.float32)  # lane 1: an h == 0 padding step
    i1 = (rng.normal(size=(B, 1)) * np.sqrt(h)).astype(np.float32)
    i10 = (h * (0.5 * i1 + np.sqrt(h / 12) * rng.normal(size=(B, 1)))).astype(np.float32)
    c = rng.normal(size=nets["y"].shape).astype(np.float32)
    return t0, h, i1, i10, c


def _jax_drifts(nets):
    jkts, jkv = j_step_knots(T, DT, jnp.zeros((B, 2)), jnp.asarray(nets["stims"]))

    def drift(fn):
        return lambda t, y, pw, fc, kv: fn(t, y, pw, fc, JStim(0.0, DT, kv),
                                           interp_fn=lambda t_, a, b, v: j_knots(t_, jkts, v))

    diff = lambda t, y, pw, fc, kv: jnp.full_like(y, jn.NETWORK_NOISE_STD)  # noqa: E731
    return drift, diff, jkv


def test_split2_step_state_vjp_matches_jax_vjp(nets):
    jnet, net, y = nets["jnet"], nets["net"], nets["y"]
    t0, h, i1, i10, c = _step_inputs(nets)
    drift, diff, jkv = _jax_drifts(nets)
    jfc = jn.build_network_fused_consts(jnet)
    args = jn.prepare_premixed_split2(jn.premix_network_weights(nets["jparams"], jnet), jfc,
                                      jkv)
    step = _make_sde_step(drift(jn.network_drift_premixed), diff, "srk", safe_h=True)
    _, vjp = jax.vjp(lambda yy: step(jnp.asarray(t0), jnp.asarray(h), yy, jnp.asarray(i1),
                                     jnp.asarray(i10), args), jnp.asarray(y))
    want = np.asarray(vjp(jnp.asarray(c))[0])

    fc = tn.build_network_fused_consts(net)
    kts, kv = step_table_knots(T, DT, torch.zeros(B, 2), torch.as_tensor(nets["stims"]))
    w2 = tn.prepare_premixed_split2(tn.premix_network_weights(nets["params"], net), fc)[0]
    got = step_vjp_split2(torch.as_tensor(t0), torch.as_tensor(h), torch.as_tensor(y),
                          torch.as_tensor(i10), torch.as_tensor(c), w2, SDEConsts(fc, kts),
                          kv).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], c[1])  # h == 0: the identity
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_gradbf16_step_weight_cotangent_matches_jax(nets):
    jnet, net, y = nets["jnet"], nets["net"], nets["y"]
    t0, h, i1, i10, c = _step_inputs(nets)
    h[1] = 2e-4
    drift, diff, jkv = _jax_drifts(nets)
    jfc = jn.build_network_fused_consts(jnet)
    step = _make_sde_step(drift(jn.network_drift_premixed_gradbf16), diff, "srk", safe_h=True)
    jpw = jn.premix_network_weights(nets["jparams"], jnet)
    _, vjp = jax.vjp(lambda pw: step(jnp.asarray(t0), jnp.asarray(h), jnp.asarray(y),
                                     jnp.asarray(i1), jnp.asarray(i10), (pw, jfc, jkv)), jpw)
    want = vjp(jnp.asarray(c))[0]

    fc = tn.build_network_fused_consts(net)
    kts, kv = step_table_knots(T, DT, torch.zeros(B, 2), torch.as_tensor(nets["stims"]))
    pw = tn.premix_network_weights(nets["params"], net)
    d_wT, d_iwT = outer_arg_grads(torch.as_tensor(y)[None], torch.as_tensor(c)[None],
                                  torch.as_tensor(t0).T, torch.as_tensor(h).T,
                                  torch.as_tensor(i10).T, pw, SDEConsts(fc, kts), kv)
    for got, k in ((d_wT, "wT"), (d_iwT, "iwT")):
        w = np.asarray(want[k])
        assert np.linalg.norm(got.numpy() - w) / np.linalg.norm(w) < 1e-3, k


def test_split3_vjp_rounding_points_equal_jax():
    """``matmul_split`` through ``split_f32`` has no transcendental: with the
    same float32 inputs both sides round every cotangent alike, so the
    port's three-term VJP equals ``jax.vjp`` bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 60, (4, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 24)) * 3).astype(np.float32)
    c = rng.normal(size=(4, 24)).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_: jn.matmul_split(x_, *jn.split_f32(w_)), jnp.asarray(x),
                     jnp.asarray(w))
    want_x, want_w = vjp(jnp.asarray(c))
    hi, mid, lo = tn.split_f32(torch.as_tensor(w))
    got_x = tn.split3_cotangent(torch.as_tensor(c), hi, mid, lo)
    got_w = tn.split3_fold(tn.split3_accumulate(None, torch.as_tensor(x), torch.as_tensor(c)))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    # Two products sharing one split: the cotangents add in bf16 before the fold.
    _, vjp2 = jax.vjp(lambda w_: (lambda s: jn.matmul_split(jnp.asarray(x), *s)
                                  + jn.matmul_split(jnp.asarray(x[::-1]), *s))(jn.split_f32(w_)),
                      jnp.asarray(w))
    acc = tn.split3_accumulate(None, torch.as_tensor(x[::-1].copy()), torch.as_tensor(c))
    acc = tn.split3_accumulate(acc, torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_array_equal(tn.split3_fold(acc).numpy(), np.asarray(vjp2(jnp.asarray(c))[0]))


def test_split3_in_float64_is_the_plain_product():
    rng = np.random.default_rng(8)
    x, w, c = (torch.as_tensor(rng.normal(size=s)) for s in ((4, 24), (24, 24), (4, 24)))
    hi, mid, lo = tn.split_f32(w)
    assert hi is w and not bool(mid.any()) and not bool(lo.any())
    torch.testing.assert_close(tn.matmul_split(x, hi, mid, lo), x @ w, rtol=1e-14, atol=0)
    torch.testing.assert_close(tn.split3_cotangent(c, hi, mid, lo), c @ w.T, rtol=1e-14, atol=0)
    torch.testing.assert_close(tn.split3_fold(tn.split3_accumulate(None, x, c)), x.T @ c,
                               rtol=1e-14, atol=0)
