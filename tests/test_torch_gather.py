"""The row-gather sum: the port's plain version (what ``gather_rows_sum``
runs for a CPU tensor) against the Pallas kernel it replaces -- the ``kern``
of ``tools/bench_gather.py:245-286``, rebuilt here from that body at a small
size and run in interpret mode -- and against a numpy sum. Outputs are
integers modulo 2**32: exact equality, tolerance 0. The gather bench is run
once at a tiny size for its control flow and its keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vargeno_tpu_torch.kernels.gather import (gather_rows_sum,
                                              gather_rows_sum_plain)
from vargeno_tpu_torch.tools import bench_gather
from vargeno_tpu_torch.tools.bench_gather import bench

torch.set_num_threads(2)

NBUF = 8


def _pallas_gather(idx, table):
    """tools/bench_gather.py's Pallas row gather (scalar-prefetched indices,
    128 B row DMAs, NBUF in flight), interpreted on the CPU."""
    N = idx.shape[0]

    def kern(idx_ref, tab_ref, out_ref):
        def body(scratch, sem):
            def get(slot, i):
                return pltpu.make_async_copy(
                    tab_ref.at[idx_ref[i]], scratch.at[slot], sem.at[slot])

            for s in range(NBUF):
                get(s, s).start()

            def loop(i, acc):
                slot = jax.lax.rem(i, NBUF)
                get(slot, i).wait()
                acc = acc + jnp.sum(scratch[slot].astype(jnp.int32))

                @pl.when(i + NBUF < N)
                def _():
                    get(slot, i + NBUF).start()

                return acc

            out_ref[0, 0] = jax.lax.fori_loop(0, N, loop, jnp.int32(0))

        pl.run_scoped(body, scratch=pltpu.VMEM((NBUF, 32), jnp.uint32),
                      sem=pltpu.SemaphoreType.DMA((NBUF,)))

    r = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.int32),
        interpret=True)(jnp.asarray(idx), jnp.asarray(table))
    return int(r[0, 0])


def _as_i32(total: int) -> int:
    total &= 0xFFFFFFFF
    return total - (1 << 32) if total >= 1 << 31 else total


def _tensor(table):
    return torch.from_numpy(table.view(np.int32))


@pytest.mark.parametrize("seed", [7, 8])
def test_plain_matches_pallas_interpret(seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, (4096, 32), dtype=np.uint32)
    idx = rng.integers(0, 4096, 256, dtype=np.int32)
    want = _pallas_gather(idx, table)
    got = gather_rows_sum(_tensor(table), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == want
    # the XLA gather of the same rows agrees too
    assert want == int(jnp.take(jnp.asarray(table), jnp.asarray(idx),
                                axis=0).astype(jnp.int32).sum())


@pytest.mark.parametrize("N,R,W,case", [
    (256, 4096, 32, "random"), (300, 1024, 128, "random"),
    (1000, 64, 96, "random"), (500, 4096, 32, "one_row"),
    (1, 4096, 32, "random"), (0, 16, 32, "random"),
    (4099, 8, 32, "all_ones")])
def test_plain_matches_numpy(N, R, W, case):
    rng = np.random.default_rng(N + W)
    table = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    if case == "all_ones":   # every word 0xFFFFFFFF: the sum wraps often
        table[:] = 0xFFFFFFFF
    idx = rng.integers(0, R, N, dtype=np.int64)
    if case == "one_row":
        idx[:] = idx[0]
    want = _as_i32(int(table[idx].astype(np.uint64).sum()))
    before = gather_rows_sum.launches
    for dtype in (torch.int32, torch.int64):
        for fn in (gather_rows_sum, gather_rows_sum_plain):
            got = fn(_tensor(table), torch.from_numpy(idx).to(dtype))
            assert got.dtype == torch.int32 and got.shape == ()
            assert int(got) == want
    # a CPU tensor goes to the plain version: no kernel launch is counted
    assert gather_rows_sum.launches == before


def test_bench_runs_small_on_cpu():
    out = bench("cpu", table_mb=1, shrink=256, reps=1, verbose=False)
    assert out["device"] == "cpu"
    n1, n2 = (1 << 20) // 256, (1 << 21) // 256
    for key in (f"word_gather_{n1}", f"row_gather_{n1}",
                f"word_gather_sorted_{n2}", f"row_gather_sorted_{n2}",
                f"row_gather_shaped_{n1}", "row_gather_512B",
                "kernel_row_gather", f"kernel_row_gather_{(1 << 22) // 256}",
                "kernel_row_gather_512B", "device_sort_u32", "scatter_rows",
                "scatter_scalar"):
        assert out[key] > 0, key
    assert "pallas_row_gather" not in out


def test_bench_cli_refuses_missing_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_gather.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench("cuda")
