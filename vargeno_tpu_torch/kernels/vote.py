"""The vote scan: the reference's improved_index_table_add (qv.cc:132-178)
over each read's ordered events, as a hand-written CUDA kernel for Hopper
(``csrc/vote.cu``) with its plain PyTorch twin.

Replaces ``vargeno_tpu/engine/pallas_vote.py`` ``_vote_kernel`` (reached
through ``vote_scan_pallas``). For each read it keeps a C-slot candidate
table (idx, freq, kmask) plus the live best state, and walks the read's
events in order:

- match = a used slot holds the event's idx; accept = valid and (match or
  not a neighbor event); a non-matching accepted event inserts at slot
  ncand, or counts one cand_overflow when the table is full;
- the touched slot gets freq += 1 and kmask |= 1 << k; when at least two
  k-mer slots support it, it competes for best (strictly higher frequency
  takes over, a tie sets ambiguous, growth of the best itself clears it).

process = has_best and best_freq > 1 and not ambiguous; target = best idx.

Public layout is the JAX one, events-major (E, B). ``vote_scan`` runs the
plain version for a tensor on the CPU, and launches the kernel for a
CUDA tensor (or raises) -- there is no fallback between the two.

A read inserts at most one candidate per event, so a table of min(C, E)
slots gives the same result as one of C; the wrapper launches with that
width. Up to 512 slots the table sits in registers; a wider one (overflow
escalation doubles C without a bound) in a global workspace.

The kernel is compiled with nvcc for sm_90a at first use, into
``vargeno_tpu_torch/_build/`` under a name keyed by the source hash, and
loaded with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.hashes import M32, as_i32, popcount
from . import _build


def _bind(lib) -> None:
    fn = lib.vgt_vote_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5)
    lib.vgt_vote_reg_max_c.restype = ctypes.c_int
    lib.vgt_vote_reg_max_c.argtypes = []


def load_library():
    """Build (once per source version) and load the kernel library."""
    return _build.load_library("vote", _bind)


def vote_scan_plain(ev_idx, ev_k, ev_isnb, ev_valid, C: int, ev_n=None):
    """Plain PyTorch vote: a loop over the E events with the reads
    vectorized (a twin of the JAX lax.scan vote_step, batch.py:708-757).
    Events at e >= ev_n[b] are skipped, as the kernel skips them."""
    E, B = ev_idx.shape
    dev = ev_idx.device
    idx = ev_idx.long() & M32
    kk = ev_k.long()
    isnb = ev_isnb.bool()
    valid = ev_valid.bool()
    if ev_n is not None:
        valid = valid & (torch.arange(E, device=dev)[:, None]
                         < ev_n.long()[None, :])
    c_iota = torch.arange(C, device=dev)[None, :]
    cidx = torch.zeros(B, C, dtype=torch.int64, device=dev)
    cfreq = torch.zeros_like(cidx)
    ckm = torch.zeros_like(cidx)
    ncand = torch.zeros(B, dtype=torch.int64, device=dev)
    best = torch.full_like(ncand, -1)
    bfreq = torch.zeros_like(ncand)
    bidx = torch.zeros_like(ncand)
    amb = torch.zeros(B, dtype=torch.bool, device=dev)
    covf = torch.zeros((), dtype=torch.int64, device=dev)
    for e in range(E):
        e_idx, e_k, e_isnb, e_val = idx[e], kk[e], isnb[e], valid[e]
        used = c_iota < ncand[:, None]
        match = used & (cidx == e_idx[:, None])
        found = match.any(1)
        accept = e_val & (found | ~e_isnb)
        can_ins = ncand < C
        insert = accept & ~found
        eff = accept & (found | can_ins)
        ins_hot = (c_iota == ncand[:, None]) & (insert & can_ins)[:, None]
        onehot = (match & accept[:, None]) | ins_hot
        cidx = torch.where(onehot, e_idx[:, None], cidx)
        cfreq = cfreq + onehot
        ckm = ckm | torch.where(onehot, 1 << e_k[:, None], 0)
        ncand = ncand + (insert & can_ins)
        covf = covf + (insert & ~can_ins).sum()

        f = torch.where(onehot, cfreq, 0).sum(1)
        elig = popcount(torch.where(onehot, ckm, 0).sum(1)) >= 2
        upd = eff & elig
        has_best = best >= 0
        is_best = eff & (e_idx == bidx) & has_best
        bfreq = bfreq + is_best          # keep the best's freq live
        slot = torch.where(onehot, c_iota, 0).sum(1)
        take_new = upd & (~has_best | (~is_best & (f > bfreq)))
        set_amb = upd & has_best & ~is_best & (f == bfreq)
        clr_amb = upd & (is_best | ~has_best | (f > bfreq))
        best = torch.where(take_new, slot, best)
        bidx = torch.where(take_new, e_idx, bidx)
        bfreq = torch.where(take_new, f, bfreq)
        amb = torch.where(set_amb, True, torch.where(clr_amb, False, amb))
    has_best = best >= 0
    target = torch.where(has_best, bidx, 0)
    process = has_best & (bfreq > 1) & ~amb
    return process, target, covf


def _check(t, name, shape, dtypes, dev):
    if t.device != dev:
        raise ValueError(f"vote_scan: {name} on {t.device}, expected {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"vote_scan: {name} shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"vote_scan: {name} dtype {t.dtype}")


def vote_scan(ev_idx, ev_k, ev_isnb, ev_valid, C: int, ev_n=None):
    """ev_* are (E, B): idx int32/int64 (32-bit words), k int32/int64 in
    [0, 32), isnb/valid bool; ev_n (B,) is each read's event count.
    Returns (process (B,) bool, target (B,) int64 words, cand_overflow 0-d
    int64)."""
    dev = ev_idx.device
    if dev.type == "cpu":
        return vote_scan_plain(ev_idx, ev_k, ev_isnb, ev_valid, C, ev_n)
    if dev.type != "cuda":
        raise ValueError(f"vote_scan: unsupported device {dev}")
    if C < 1:
        raise ValueError(f"vote_scan: C={C} must be at least 1")
    E, B = ev_idx.shape
    ints = (torch.int32, torch.int64)
    _check(ev_idx, "ev_idx", (E, B), ints, dev)
    _check(ev_k, "ev_k", (E, B), ints, dev)
    _check(ev_isnb, "ev_isnb", (E, B), (torch.bool,), dev)
    _check(ev_valid, "ev_valid", (E, B), (torch.bool,), dev)
    if ev_n is None:
        ev_n = torch.full((B,), E, dtype=torch.int32, device=dev)
    _check(ev_n, "ev_n", (B,), ints, dev)
    if ev_idx.dtype == torch.int64:
        ev_idx = as_i32(ev_idx)
    ev_idx = ev_idx.contiguous()
    ev_k = ev_k.to(torch.int32).contiguous()
    ev_isnb = ev_isnb.contiguous()
    ev_valid = ev_valid.contiguous()
    ev_n = ev_n.to(torch.int32).contiguous()
    process = torch.empty(B, dtype=torch.bool, device=dev)
    target = torch.empty(B, dtype=torch.int32, device=dev)
    ovf = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return process, target.long(), ovf.sum(dtype=torch.int64)
    lib = load_library()
    width = max(1, min(C, E))   # at most E inserts: same result as C slots
    ws = None
    if width > lib.vgt_vote_reg_max_c():
        ws = torch.empty((3, B, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.vgt_vote_scan(
            ev_idx.data_ptr(), ev_k.data_ptr(), ev_isnb.data_ptr(),
            ev_valid.data_ptr(), ev_n.data_ptr(), E, B, width,
            None if ws is None else ws.data_ptr(),
            process.data_ptr(), target.data_ptr(), ovf.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vote kernel launch failed: CUDA error {rc}")
    vote_scan.launches += 1
    return process, target.long() & M32, ovf.sum(dtype=torch.int64)


vote_scan.launches = 0   # kernel launches since the last reset
