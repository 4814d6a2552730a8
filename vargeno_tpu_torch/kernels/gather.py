"""Row-gather sum: the wrapping 32-bit sum of every word of
``table[idx[i]]`` over all i, as a hand-written CUDA kernel for Hopper
(``csrc/gather.cu``) with its plain PyTorch twin.

Replaces the Pallas kernel ``kern`` of ``pallas_gather``
(``tools/bench_gather.py:245-286``): the random-row gather-rate probe whose
rate says what a bucket-row lookup can cost on the device. The TPU kernel
gathers 128 B rows (W = 32 words); the port's bucket rows are 512 B
(W = 128), so any W that is a multiple of 32 is taken.

``table`` holds uint32 words as int32 bit patterns (torch has no uint32
arithmetic). Addition modulo 2**32 is associative and commutative, so the
kernel's sum equals the plain version's exactly, whatever the order.

``gather_rows_sum`` runs the plain version for a tensor on the CPU, and
launches the kernel for a CUDA tensor (or raises) -- there is no fallback
between the two. The source holds two kernels behind one entry, a ring of
bulk asynchronous copies for many 128 B rows and direct loads for the rest;
the library picks by the shape. It is compiled with nvcc for sm_90a at
first use (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def _bind(lib) -> None:
    fn = lib.vgt_gather_rows_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn = lib.vgt_gather_uses_ring
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int]


def load_library():
    """Build (once per source version) and load the kernel library."""
    return _build.load_library("gather", _bind)


def gather_rows_sum_plain(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one ``index_select``, the rows summed in
    int64 (|N * W * 2**31| stays far below 2**63; the signed words' sum is
    congruent to the unsigned words' sum modulo 2**32), then cut to 32 bits
    and read as int32."""
    total = table.index_select(0, idx).sum(dtype=torch.int64) & 0xFFFFFFFF
    return (total - ((total >> 31) << 32)).to(torch.int32)


KERNELS = {"chosen": 0, "ring": 1, "direct": 2}


def launch(table, idx, out, kernel: str = "chosen") -> None:
    """The bare kernel launch on the current stream, nothing checked:
    adds the sum into ``out`` (0-d int32, zeroed by the caller). The library
    picks the ring kernel for many 128 B rows and the direct-load kernel
    for the rest, which is what ``gather_rows_sum`` launches; ``kernel`` =
    "ring" (W = 32, 64 or 128) or "direct" names one whatever the shape, so
    that the choice can be measured from both sides."""
    dev = table.device
    with torch.cuda.device(dev):
        rc = load_library().vgt_gather_rows_sum(
            table.data_ptr(), idx.data_ptr(), idx.shape[0], table.shape[1],
            int(idx.dtype == torch.int64), out.data_ptr(), KERNELS[kernel],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: CUDA error {rc}")


def gather_rows_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (R, W) int32 bit patterns of uint32 words, W a multiple of 32,
    16 B aligned; idx (N,) int32 or int64 with 0 <= idx < R (not checked on
    the device). Returns the 0-d int32 sum over i, w of table[idx[i], w]
    modulo 2**32."""
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_sum_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows_sum: unsupported device {dev}")
    if table.dtype != torch.int32 or table.dim() != 2:
        raise TypeError(f"gather_rows_sum: table must be (R, W) int32, got "
                        f"{tuple(table.shape)} {table.dtype}")
    if table.shape[1] == 0 or table.shape[1] % 32:
        raise ValueError(f"gather_rows_sum: row width {table.shape[1]} is "
                         f"not a multiple of 32 words")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise TypeError(f"gather_rows_sum: idx must be (N,) int32 or int64, "
                        f"got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != dev:
        raise ValueError(f"gather_rows_sum: idx on {idx.device}, table on "
                         f"{dev}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows_sum: table and idx must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("gather_rows_sum: table is not 16-byte aligned (the "
                         "ring kernel copies rows in bulk)")
    with torch.cuda.device(dev):
        out = torch.zeros((), dtype=torch.int32, device=dev)
    if idx.shape[0] == 0:
        return out
    launch(table, idx, out)
    gather_rows_sum.launches += 1
    return out


gather_rows_sum.launches = 0   # kernel launches since the last reset
