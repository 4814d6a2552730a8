"""The port's sorted search (``engine/search.py``) against the JAX package's
``lower_bound`` on the same numpy-seeded keys and queries, exactly: the
searchsorted form over order-preserving int64 keys, and the loop twin.

The JAX loop returns n + 1 where every key is below the query and its
halving reaches lo = hi = n before its last round; the searchsorted form
returns n there (every caller clamps to a row count <= n), and the loop
twin returns what JAX returns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vargeno_tpu.engine import search as j_search
from vargeno_tpu_torch.engine import search

M32 = 0xFFFFFFFF


def _keys(n, rng, dup: bool, pads: int):
    """n sorted (hi, lo) uint32 pairs (hi drawn from few values when
    ``dup``, so blocks repeat), then ``pads`` sentinel rows."""
    hi = rng.integers(0, 6 if dup else 2**32, n, dtype=np.uint64)
    lo = rng.integers(0, 4 if dup else 2**32, n, dtype=np.uint64)
    hi, lo = hi.astype(np.uint32), lo.astype(np.uint32)
    hi[rng.random(n) < 0.1] = M32   # keys in the top block too
    o = np.lexsort((lo, hi))
    pad = np.full(pads, M32, np.uint32)
    return np.concatenate([hi[o], pad]), np.concatenate([lo[o], pad])


def _queries(hi, lo, rng, m=400):
    """Queries on, between and beyond the keys, and at the word limits."""
    qh = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    ql = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    if hi.size:
        pick = rng.integers(0, hi.size, m // 2)
        qh[:m // 2], ql[:m // 2] = hi[pick], lo[pick]
        ql[m // 4:m // 2] += 1
    qh[-6:] = [0, 0, M32, M32, 0xFFFFFF00, 0xFFFFFFFF]
    ql[-6:] = [0, M32, 0, M32, 0, 7]
    return qh, ql


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("n,dup,pads", [
    (0, False, 0), (1, False, 0), (2, False, 0), (2, True, 1), (3, True, 2),
    (17, True, 0), (1000, True, 5), (1000, False, 0), (4096, False, 32)])
def test_lower_bound_matches_jax(n, dup, pads):
    rng = np.random.default_rng(n * 7 + pads)
    hi, lo = _keys(n, rng, dup, pads)
    qh, ql = _queries(hi, lo, rng)
    want = np.asarray(j_search.lower_bound(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qh), jnp.asarray(ql)))
    N = hi.size
    keys = torch.from_numpy(search.np_okey(hi, lo))
    got = search.lower_bound(keys, _t(qh), _t(ql)).numpy()
    np.testing.assert_array_equal(got, np.minimum(want, N))
    loop = search.lower_bound_loop(_t(hi), _t(lo), _t(qh), _t(ql)).numpy()
    np.testing.assert_array_equal(loop, want)
    # the key is order-preserving and gives back its words
    k = keys.numpy()
    assert np.all(k[1:] >= k[:-1])
    np.testing.assert_array_equal(search.key_hi(keys).numpy(), hi)
    np.testing.assert_array_equal(search.key_lo(keys).numpy(), lo)


@pytest.mark.parametrize("n", [1, 50, 3000])
def test_block_bounds_match_jax(n):
    """block_end and the hi24 form against the JAX block bounds, whose
    ``q + 1`` wraps in uint32 at hi = 0xFFFFFFFF and hi24 = 0xFFFFFF; there
    both use n, as the sharded callers do."""
    rng = np.random.default_rng(n)
    hi, lo = _keys(n, rng, True, 3)
    qh, _ = _queries(hi, lo, rng)
    N = hi.size
    keys = torch.from_numpy(search.np_okey(hi, lo))
    j_s, j_e = (np.asarray(a) for a in j_search.block_bounds_hi32(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(qh)))
    q = _t(qh)
    start = search.lower_bound(keys, q, torch.zeros_like(q))
    end = torch.where(q == M32, N, search.block_end(keys, q))
    np.testing.assert_array_equal(start.numpy(), np.minimum(j_s, N))
    np.testing.assert_array_equal(end.numpy(), np.minimum(j_e, N))
    q24 = qh >> np.uint32(8)
    j_s, j_e = (np.asarray(a) for a in j_search.block_bounds_hi24(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(q24)))
    t24 = _t(q24)
    start = search.lower_bound(keys, t24 << 8, torch.zeros_like(t24))
    end = torch.where(t24 == 0xFFFFFF, N,
                      search.block_end(keys, (t24 << 8) | 0xFF))
    np.testing.assert_array_equal(start.numpy(), np.minimum(j_s, N))
    np.testing.assert_array_equal(end.numpy(), np.minimum(j_e, N))
