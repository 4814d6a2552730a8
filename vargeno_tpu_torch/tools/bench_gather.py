"""Microbenchmark: random-access primitive rates on the current device
(port of ``tools/bench_gather.py``).

    python -m vargeno_tpu_torch.tools.bench_gather [--device cuda|cpu]

The geno inner loop is gather-dominated (hash-bucket rows, scan windows,
event scatters). This tool measures, on 256 MiB tables:

  - gather of 4 B words and of 128 B rows (``index_select``) at N = 2**20
    and 2**21, random and sorted indices
  - gather of 512 B rows (the combined hash table's bucket row) at N = 2**19
  - the same 128 B row gather made with (B, 4)-shaped indices
  - sort of 2**21 32-bit keys (``torch.sort``)
  - scatter of 20 B rows and of scalar words (``index_put_``) into an
    event-buffer-shaped tensor
  - the hand-written row-gather kernel (``kernels.gather.gather_rows_sum``)
    at (N, W) = (65536, 32), (2**22, 32) and (2**19, 128)

Each PyTorch op is timed alone with its output materialised, as the engine
runs it: the median of CUDA-event timings after a warm-up. Rates
(lanes/s) feed the lane bound of ``utils/roofline.py`` and say what a
bucket-probe kernel could gain over the library gather. The last line of
the output is one JSON object.

A rate whose implied sector traffic (max(row bytes, 32 B) per lane) exceeds
the card's peak memory rate by more than 5 % is reported as null: the
tables are five times the L2 cache, so such a rate means the measurement
was wrong, not that the card was fast.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..kernels.gather import gather_rows_sum, gather_rows_sum_plain
from ..utils.profiling import device_ms
from ..utils.roofline import device_hbm_gbps

SECTOR_BYTES = 32
CEILING_SLACK = 1.05


def bench(device: torch.device | str, table_mb: int = 256, shrink: int = 1,
          reps: int = 10, verbose: bool = True) -> dict:
    """Run every measurement on ``device``. ``shrink`` divides every lane
    count (with a small ``table_mb``, for a quick run of the control flow;
    a measurement uses the defaults)."""
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu "
                           "to run on the host)")
    kind = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    peak = device_hbm_gbps(kind) * 1e9
    rng = np.random.default_rng(7)
    out: dict = {"device": kind, "table_mb": table_mb}

    def say(msg):
        if verbose:
            print(msg, file=sys.stderr, flush=True)

    def words(shape):
        """Random uint32 words as an int32 tensor on the device."""
        a = rng.integers(0, 2**32, shape, dtype=np.uint32)
        return torch.from_numpy(a.view(np.int32)).to(device)

    def index(high, shape):
        a = rng.integers(0, high, shape, dtype=np.int32)
        return torch.from_numpy(a).to(device)

    def rate(n, row_bytes, fn):
        """Lanes per second of ``fn``, or None above the sector-traffic
        ceiling (checked on the card only: a host cache has no such bound)."""
        r = n / (device_ms(fn, device, reps) * 1e-3)
        if on_cuda and r * max(row_bytes, SECTOR_BYTES) > peak * CEILING_SLACK:
            return None
        return r

    def show(r):
        return "implausible" if r is None else f"{r / 1e6:10.1f} M/s"

    table_w = words(table_mb * 2**20 // 4)
    n_rows = table_mb * 2**20 // 128
    table_r = words((n_rows, 32))

    for N in ((1 << 20) // shrink, (1 << 21) // shrink):
        idx_w = index(table_w.shape[0], N)
        idx_r = index(n_rows, N)
        idx_ws, idx_rs = torch.sort(idx_w)[0], torch.sort(idx_r)[0]
        out[f"word_gather_{N}"] = rate(
            N, 4, lambda: table_w.index_select(0, idx_w))
        out[f"row_gather_{N}"] = rate(
            N, 128, lambda: table_r.index_select(0, idx_r))
        # sorted indices: if these run much faster, probes should be sorted
        # first (a sort-merge join would beat point lookups)
        out[f"word_gather_sorted_{N}"] = rate(
            N, 4, lambda: table_w.index_select(0, idx_ws))
        out[f"row_gather_sorted_{N}"] = rate(
            N, 128, lambda: table_r.index_select(0, idx_rs))
        say(f"N={N:8d}  word-gather {show(out[f'word_gather_{N}'])} "
            f"sorted {show(out[f'word_gather_sorted_{N}'])}   row-gather "
            f"128B {show(out[f'row_gather_{N}'])} sorted "
            f"{show(out[f'row_gather_sorted_{N}'])}")
    del table_w

    # the same row gather made with (B, 4)-shaped indices
    N = (1 << 20) // shrink
    idx2d = index(n_rows, (N // 4, 4))
    out[f"row_gather_shaped_{N}"] = rate(N, 128, lambda: table_r[idx2d])
    say(f"row-gather shaped (B,4) {show(out[f'row_gather_shaped_{N}'])}")

    # 512 B rows: the combined hash table's bucket row
    n_rows5 = table_mb * 2**20 // 512
    table_r5 = words((n_rows5, 128))
    N5 = (1 << 19) // shrink
    idx_r5 = index(n_rows5, N5)
    out["row_gather_512B"] = rate(
        N5, 512, lambda: table_r5.index_select(0, idx_r5))
    say(f"row-gather 512B {show(out['row_gather_512B'])}")

    # the hand-written kernel, at the shape of the kernel it replaces and at
    # sizes large enough to outlast a launch; each checked against the plain
    # version first (a rate of a wrong sum is worth nothing)
    for key, table, n_tab, N, W in (
            ("kernel_row_gather", table_r, n_rows, (1 << 16) // shrink, 32),
            (f"kernel_row_gather_{(1 << 22) // shrink}", table_r, n_rows,
             (1 << 22) // shrink, 32),
            ("kernel_row_gather_512B", table_r5, n_rows5, N5, 128)):
        idx = index(n_tab, N)
        got = int(gather_rows_sum(table, idx))
        want = int(gather_rows_sum_plain(table, idx))
        if got != want:
            raise AssertionError(f"{key}: kernel sum {got} != plain {want}")
        out[key] = rate(N, W * 4, lambda: gather_rows_sum(table, idx))
        say(f"{key} (N={N}, {W * 4} B rows) {show(out[key])}")
    del table_r, table_r5

    # sort rate (the enabler for sort-merge designs); int32 keys: torch
    # sorts no uint32, and the key width is what the radix passes cost
    N = (1 << 21) // shrink
    keys = words(N)
    out["device_sort_u32"] = N / (device_ms(lambda: torch.sort(keys),
                                            device, reps) * 1e-3)
    say(f"sort 32-bit keys {show(out['device_sort_u32'])}")

    # scatter of 20 B rows into a (B, E + 1, 5) buffer (event-shaped), and
    # of scalar words into the flat buffer (the engine's event writes)
    B, E = 32768 // shrink, 16
    N = B * 4
    rows_b, rows_e = index(B, N).long(), index(E, N).long()
    vals = words((N, 5))
    buf = torch.zeros((B, E + 1, 5), dtype=torch.int32, device=device)
    out["scatter_rows"] = rate(
        N, 20, lambda: buf.index_put_((rows_b, rows_e), vals))
    flat_t = index(B * (E + 1), N).long()
    vals1 = vals[:, 0].contiguous()
    flat = torch.zeros(B * (E + 1), dtype=torch.int32, device=device)
    out["scatter_scalar"] = rate(
        N, 4, lambda: flat.index_put_((flat_t,), vals1))
    say(f"scatter-20B {show(out['scatter_rows'])}   scatter-scalar "
        f"{show(out['scatter_scalar'])}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.bench_gather",
        description="random-access primitive rates on the current device")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu must be asked for)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("error: no CUDA device is available (pass --device cpu to "
              "run on the host)", file=sys.stderr)
        return 1
    print(json.dumps(bench(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
