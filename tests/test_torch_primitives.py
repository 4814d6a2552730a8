"""Port primitives against the JAX package and numpy, on the same numpy
inputs. Every output is an integer, so agreement is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vargeno_tpu.core import hashes as jhashes
from vargeno_tpu.engine import backend as jbackend
from vargeno_tpu.engine import batch as jbatch
from vargeno_tpu.engine.scan_ops import compact_src as j_compact_src
from vargeno_tpu_torch.core import hashes as thashes
from vargeno_tpu_torch.core import kmer as tkmer
from vargeno_tpu_torch.engine.scan_ops import compact_src

torch.set_num_threads(2)


def _words(rng, n):
    """u32 words covering the edges, >= 2**31 and random values."""
    edge = np.array([0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0x80000001,
                     0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    return np.concatenate([edge, rng.integers(0, 1 << 32, n,
                                              dtype=np.uint64)
                           .astype(np.uint32)])


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_hash32_vs_numpy_and_jax():
    x = _words(np.random.default_rng(1), 4000)
    got = thashes.hash32(_t(x)).numpy()
    np.testing.assert_array_equal(got, thashes.np_hash32(x))
    np.testing.assert_array_equal(got, np.asarray(jhashes.hash32(x)))


def test_hash40_and_snp_bf_bit():
    rng = np.random.default_rng(2)
    lo = _words(rng, 4000)
    hi8 = rng.integers(0, 256, lo.shape[0]).astype(np.uint32)
    hi8[:9] = 0xFF
    x40 = (hi8.astype(np.uint64) << np.uint64(32)) | lo
    h = thashes.hash40(_t(x40.astype(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(h, thashes.np_hash40(x40))
    for bits in (1_120_000_000, 1 << 18, 999_983):
        got = thashes.snp_bf_bit(_t(hi8), _t(lo), bits).numpy()
        np.testing.assert_array_equal(
            got, (thashes.np_hash40(x40) % np.uint64(bits)).astype(np.int64))
        ref = np.asarray(jhashes.snp_bf_bit(hi8, lo, bits))
        np.testing.assert_array_equal(got, ref)


def test_popcount_ctz_bitrev():
    rng = np.random.default_rng(3)
    x = _words(rng, 4000)
    np.testing.assert_array_equal(
        thashes.popcount(_t(x)).numpy(),
        np.asarray(jax.lax.population_count(jnp.asarray(x))))
    np.testing.assert_array_equal(
        thashes.ctz32(_t(x)).numpy(), np.asarray(jbackend._ctz32(x)))
    np.testing.assert_array_equal(
        tkmer.bitrev2_u32(_t(x)).numpy(),
        np.asarray(jbatch._bitrev2_u32(jnp.asarray(x))))


def test_encode_and_rc_enc_vs_jax():
    rng = np.random.default_rng(4)
    B, L, K = 97, 128, 4
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.01] = 4
    nk = rng.integers(0, K + 1, B).astype(np.int32)
    t_enc = tkmer.encode_batch(torch.from_numpy(codes),
                               torch.from_numpy(nk), K)
    j_enc = jbatch.encode_batch(jnp.asarray(codes), jnp.asarray(nk), K)
    for a, b in zip(t_enc, j_enc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t_rc = tkmer.rc_enc(*t_enc, torch.from_numpy(nk), K)
    j_rc = jbatch.rc_enc(*j_enc, jnp.asarray(nk), K)
    for a, b in zip(t_rc, j_rc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("m,n_out,density", [
    (1000, 64, 0.02), (1000, 64, 0.3), (5000, 700, 0.1), (300, 400, 0.9),
    (1, 64, 1.0), (4096, 64, 0.0)])
def test_compact_src_vs_jax(m, n_out, density):
    rng = np.random.default_rng(m + n_out)
    mask = rng.random(m) < density
    src, ovf = compact_src(torch.from_numpy(mask), n_out)
    jsrc, jovf = j_compact_src(jnp.asarray(mask), n_out, method="scan")
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    assert int(ovf) == int(jovf) == max(int(mask.sum()) - n_out, 0)
