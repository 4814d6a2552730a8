"""The vote scan: the port's plain versions, in the JAX layout and on the
step's packed event records, against the JAX Pallas kernel in interpret
mode (as tests/test_misc.py runs it). Outputs are integers: exact equality.
The CUDA kernel is held against the plain versions in
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vargeno_tpu.engine.pallas_vote import vote_scan_pallas
from vargeno_tpu_torch.kernels.vote import (vote_scan, vote_scan_records,
                                            vote_scan_records_plain)

torch.set_num_threads(2)


def _events(E, B, seed, n_idx=20, p_valid=0.5, p_nb=0.3):
    """Event streams with repeating idx values and ragged per-read counts;
    events at e >= ev_n[b] are invalid, as the engine writes them."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_idx, (E, B)).astype(np.uint32)
    idx[rng.random((E, B)) < 0.05] |= np.uint32(0x80000000)  # >= 2**31
    k = rng.integers(0, 4, (E, B)).astype(np.int32)
    isnb = rng.random((E, B)) < p_nb
    ev_n = rng.integers(0, E + 1, B).astype(np.int32)
    valid = (rng.random((E, B)) < p_valid) & (np.arange(E)[:, None]
                                              < ev_n[None, :])
    return idx, k, isnb, valid, ev_n


def _plain(idx, k, isnb, valid, C, ev_n):
    return vote_scan(torch.from_numpy(idx.astype(np.int64)),
                     torch.from_numpy(k), torch.from_numpy(isnb),
                     torch.from_numpy(valid), C, torch.from_numpy(ev_n))


@pytest.mark.parametrize("E,B,C,n_idx", [
    (32, 256, 16, 20), (96, 512, 32, 40), (8, 64, 64, 12),
    (32, 512, 4, 64)])
def test_plain_vote_matches_pallas_interpret(E, B, C, n_idx):
    idx, k, isnb, valid, ev_n = _events(E, B, seed=E * B + C, n_idx=n_idx)
    process, target, ovf = _plain(idx, k, isnb, valid, C, ev_n)
    jp, jt, jo = vote_scan_pallas(
        jnp.asarray(idx), jnp.asarray(k), jnp.asarray(isnb),
        jnp.asarray(valid), C, ev_n=jnp.asarray(ev_n), tile=min(B, 512),
        interpret=True)
    np.testing.assert_array_equal(process.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(target.numpy(),
                                  np.asarray(jt).astype(np.int64))
    assert int(ovf) == int(jo)
    if C == 4:   # 64 distinct values into 4 slots: the table overflows
        assert int(ovf) > 0
    assert process.numpy().any()


def _records(idx, k, isnb, valid, ev_n, E_pad, seed, over=0):
    """Pack (E, B) events into the step's records: (B, E) views of
    (B, E + E_pad)-strided int64 word buffers, meta = k | isnb << 5 |
    valid << 6 with random ``src`` bits from bit 7 up; the padding words
    hold junk the vote must not read. ``over`` is added to the counts of
    reads that are full (an unclamped count past E)."""
    rng = np.random.default_rng(seed)
    E, B = idx.shape
    rec_idx = rng.integers(0, 2**32, (B, E + E_pad)).astype(np.int64)
    rec_meta = rng.integers(0, 2**32, (B, E + E_pad)).astype(np.int64)
    rec_idx[:, :E] = idx.T.astype(np.int64)
    src = rng.integers(0, 2**25, (B, E)).astype(np.int64)
    rec_meta[:, :E] = (k.T.astype(np.int64) | (isnb.T.astype(np.int64) << 5)
                       | (valid.T.astype(np.int64) << 6) | (src << 7))
    total = ev_n.astype(np.int64)
    total[total == E] += over
    return (torch.from_numpy(rec_idx)[:, :E],
            torch.from_numpy(rec_meta)[:, :E], torch.from_numpy(total))


@pytest.mark.parametrize("E,B,C,n_idx", [
    (32, 256, 16, 20),      # records, src bits, idx words >= 2**31
    (8, 64, 64, 12),        # C > E
    (32, 512, 4, 64),       # C < E: the table overflows
    (16, 128, 8, 10),       # every full read's count runs past E
])
def test_records_vote_matches_unpacked_and_pallas(E, B, C, n_idx):
    idx, k, isnb, valid, ev_n = _events(E, B, seed=7 * E + B + C, n_idx=n_idx)
    ev_n[0] = 0                  # a read with no events
    ev_n[1] = E                  # a full read
    valid[:, 0] = False
    over = 5 if E == 16 else 0
    rec_idx, rec_meta, total = _records(idx, k, isnb, valid, ev_n, E_pad=3,
                                        seed=C, over=over)
    assert rec_idx.stride() == (E + 3, 1) and int(total.max()) == E + over
    assert int((rec_meta >> 7).max()) > 0 and int(rec_idx.max()) >= 2**31
    rp, rt, ro = vote_scan_records(rec_idx, rec_meta, total, C)
    pp, pt, po = vote_scan_records_plain(rec_idx, rec_meta, total, C)
    up, ut, uo = _plain(idx, k, isnb, valid, C, ev_n)
    jp, jt, jo = vote_scan_pallas(
        jnp.asarray(idx), jnp.asarray(k), jnp.asarray(isnb),
        jnp.asarray(valid), C, ev_n=jnp.asarray(ev_n), tile=min(B, 512),
        interpret=True)
    for got_p, got_t, got_o in ((rp, rt, ro), (pp, pt, po), (up, ut, uo)):
        assert got_p.dtype == torch.bool and got_t.dtype == torch.int64
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(got_t.numpy(),
                                      np.asarray(jt).astype(np.int64))
        assert int(got_o) == int(jo)
    assert not bool(rp[0]) and int(rt[0]) == 0
    assert (int(ro) > 0) == (C == 4)
    assert rp.numpy().any()


def test_both_vote_entries_take_no_reads():
    """B = 0: empty outputs and a zero counter from either entry."""
    z = torch.zeros((0, 9), dtype=torch.int64)
    for out in (vote_scan_records(z[:, :8], z[:, :8], z[:, 0], 4),
                vote_scan(z.t(), z.t().int(), z.t().bool(), z.t().bool(), 4,
                          z[:, 0].int())):
        process, target, ovf = out
        assert process.shape == (0,) and process.dtype == torch.bool
        assert target.shape == (0,) and target.dtype == torch.int64
        assert ovf.shape == () and int(ovf) == 0


def test_both_vote_entries_check_the_same_things_on_the_cpu():
    """What the card's path refuses, the CPU path refuses too."""
    E, B = 4, 3
    i64 = torch.zeros((B, E), dtype=torch.int64)
    n = torch.zeros(B, dtype=torch.int64)
    flag = torch.zeros((E, B), dtype=torch.bool)
    for C in (0, -1):
        with pytest.raises(ValueError):
            vote_scan_records(i64, i64, n, C)
        with pytest.raises(ValueError):
            vote_scan(i64.t(), i64.t(), flag, flag, C, n)
    with pytest.raises(TypeError):
        vote_scan_records(i64.int(), i64, n, 4)
    with pytest.raises(TypeError):
        vote_scan_records(i64, i64, n.int(), 4)
    with pytest.raises(ValueError):
        vote_scan_records(i64, i64[:, :3], n, 4)
    with pytest.raises(ValueError):
        vote_scan_records(i64, i64, n[:2], 4)
    with pytest.raises(TypeError):
        vote_scan(i64.t(), i64.t(), flag.long(), flag, 4, n)
    with pytest.raises(ValueError):
        vote_scan(i64.t(), i64.t(), flag, flag[:, :2], 4, n)
