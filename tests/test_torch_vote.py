"""The vote scan: the port's plain version against the JAX Pallas kernel in
interpret mode (as tests/test_misc.py runs it). Outputs are integers: exact
equality. The CUDA kernel is held against the plain version in
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vargeno_tpu.engine.pallas_vote import vote_scan_pallas
from vargeno_tpu_torch.kernels.vote import vote_scan

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
