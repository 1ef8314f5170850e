"""Port parity: ``columnflow_torch.solvers.krng`` against
``columnflow.solvers.krng``.

Threefry, the key fold and the uniform draw are integer and exact float
arithmetic: bit for bit. ``ndtri`` uses log and sqrt, whose float32 results
may differ from XLA's by an ulp: within 4 ulp. Interval normals and tree
values: rel 1e-6. Tree values sum 21 such normals: within 1e-5 of the
path's scale sqrt(t1 - t0) (measured 3.4e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columnflow.solvers import krng as jk
from columnflow.solvers.sde_adaptive import _sde_key_words as jax_key_words
from columnflow_torch.convert import lane_key_words
from columnflow_torch.solvers import krng as tk
from columnflow_torch.solvers.sde_adaptive import _sde_key_words

RNG = np.random.default_rng(0)
N = 10_000


def _words(n):
    return RNG.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("fn", ["threefry2x32", "fold2"])
def test_threefry_and_fold_bit_equal(fn):
    k0, k1, x0, x1 = _words(N)
    want = getattr(jk, fn)(*(jnp.asarray(a) for a in (k0, k1, x0, x1)))
    got = getattr(tk, fn)(*(torch.as_tensor(a.astype(np.int64)) for a in (k0, k1, x0, x1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_uniform_from_bits_bit_equal():
    bits = _words(N)[0]
    bits[:3] = [0, 2**32 - 1, 511]
    want = np.asarray(jk.uniform_from_bits(jnp.asarray(bits)))
    got = tk.uniform_from_bits(torch.as_tensor(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_ndtri_within_4_ulp():
    bits = _words(N)[0]
    p = tk.uniform_from_bits(torch.as_tensor(bits.astype(np.int64)))
    p = torch.cat([p, torch.tensor([2.0**-24, 1 - 2.0**-24, 0.02425, 0.5, 0.97575])])
    got = tk.ndtri(p).numpy()
    want = np.asarray(jk.ndtri(jnp.asarray(p.numpy())))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.max(np.abs(got - want) / ulp) <= 4.0


def test_interval_normal_and_tree_at_random_times():
    t0, t1 = 0.0, float(np.float32(0.06))
    ta = np.sort(RNG.uniform(t0, t1, (2, 1000)).astype(np.float32), axis=0)
    k0, k1 = 12345, 67890
    want = np.asarray(jk.interval_normal(jnp.uint32(k0), jnp.uint32(k1),
                                         jnp.asarray(ta[0]), jnp.asarray(ta[1]), t0, t1))
    got = tk.interval_normal(k0, k1, torch.as_tensor(ta[0]), torch.as_tensor(ta[1]),
                             t0, t1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

    times = np.concatenate([ta[0], [t0, t1, t1 * 0.5]]).astype(np.float32)
    jtree = jk.KernelBrownianTree(t0=t0, t1=t1, k0=jnp.uint32(k0), k1=jnp.uint32(k1))
    want = np.asarray(jax.vmap(jtree.evaluate)(jnp.asarray(times)))
    got = tk.KernelBrownianTree(t0, t1, k0, k1).evaluate(torch.as_tensor(times)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.sqrt(t1 - t0)
    assert got[-2] == pytest.approx(want[-2], rel=1e-6)  # the padding time t_end


def test_sde_key_words_bit_equal():
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    want = np.stack([np.asarray(w) for w in jax.vmap(jax_key_words)(keys)], axis=1)
    got = _sde_key_words(lane_key_words(keys)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
