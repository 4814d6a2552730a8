"""Combined ref+snp bucket-table lookup: the port against the JAX function,
on the mini index's combined table (the port's small-Bloom index, built by
``torch_index_share.small_index``, through ``jax_view``). Exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_index_share import jax_view, small_index

from vargeno_tpu.engine.device_index import build_device_index
from vargeno_tpu.engine.hashtable import ht_lookup_both as j_lookup
from vargeno_tpu_torch.engine.hashtable import (build_hash_table,
                                                ht_lookup_both)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mini():
    return small_index()


@pytest.fixture(scope="module")
def combined(mini):
    d = build_device_index(jax_view(mini), host_only=True,
                           ht_target_load=0.5)
    return d, mini


def _queries(index, rng, n_each=3000):
    """Ref keys, snp keys (ambiguous rows included), random misses and
    single-base neighbors of ref keys (mostly misses)."""
    ref = index.ref.kmers[rng.integers(0, index.ref.kmers.size, n_each)]
    snp = index.snp.kmers[rng.integers(0, index.snp.kmers.size, n_each)]
    miss = rng.integers(0, 2**63, n_each, dtype=np.uint64) * np.uint64(2)
    nb = ref ^ (np.uint64(1) << (np.uint64(2) * rng.integers(
        0, 32, n_each).astype(np.uint64)))
    keys = np.concatenate([ref, snp, miss, nb])
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _compare(table, nb, chain, hi, lo, valid):
    t = torch.from_numpy(np.ascontiguousarray(table).view(np.int32))
    got = ht_lookup_both(t, nb, chain,
                         torch.from_numpy(hi.astype(np.int64)),
                         torch.from_numpy(lo.astype(np.int64)),
                         None if valid is None else torch.from_numpy(valid))
    want = j_lookup(jnp.asarray(table), nb, chain, jnp.asarray(hi),
                    jnp.asarray(lo),
                    None if valid is None else jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype))
    return got


@pytest.mark.parametrize("masked", [False, True])
def test_lookup_both_matches_jax(combined, masked):
    d, index = combined
    rng = np.random.default_rng(11)
    hi, lo = _queries(index, rng)
    valid = rng.random(hi.shape[0]) < 0.8 if masked else None
    got = _compare(d.both_ht, d.both_ht_nb, d.both_ht_chain, hi, lo, valid)
    n = 3000
    r_hit, s_hit = got[0].numpy(), got[3].numpy()
    live = np.ones(hi.shape[0], bool) if valid is None else valid
    assert r_hit[:n][live[:n]].all()          # every ref key found
    assert s_hit[n:2 * n][live[n:2 * n]].all()  # every snp key found
    assert not (r_hit | s_hit)[~live].any()    # masked lanes miss


def test_numpy_build_lookups_match_jax(mini):
    """The port's numpy table build (rounds placement) answers like the JAX
    lookup over the same table, with a chain > 1 from a 0.9 bucket load."""
    rng = np.random.default_rng(12)
    keys = mini.ref.kmers[:29491]   # 1024 buckets x 32 slots x 0.9
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pos = rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(
        np.uint32)
    flag = (rng.integers(0, 2, keys.size) | (rng.random(keys.size) < 0.5)
            * 0x80).astype(np.uint8)
    info = rng.integers(0, 256, keys.size).astype(np.uint8)
    tab = build_hash_table(hi, lo, pos, flag, info, target_load=1.0,
                           use_native=False)
    assert tab.nb == 1024 and tab.chain > 1
    qh, ql = _queries(mini, rng, 2000)
    _compare(tab.table, tab.nb, tab.chain, np.concatenate([hi, qh]),
             np.concatenate([lo, ql]), None)
