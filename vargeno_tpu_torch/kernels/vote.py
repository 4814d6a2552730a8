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

Two entries, one kernel:

- ``vote_scan_records`` takes the step's event records as the step builds
  them: read-major (B, E) views of int64 words with any row stride, idx in
  one and ``meta = k | isnb << 5 | valid << 6 | src << 7`` in the other,
  and the unclamped per-read count. The kernel decodes them itself, so a
  call is the launch plus the zeroing of one counter word.
- ``vote_scan`` keeps the JAX layout, events-major (E, B) with k / isnb /
  valid apart; on the card it packs its arguments into records first.

Each runs its plain version for a tensor on the CPU, and launches the
kernel for a CUDA tensor (or raises) -- there is no fallback between the
two.

A read inserts at most one candidate per event, so a table of min(C, E)
slots gives the same result as one of C; the wrappers launch with that
width. Up to 512 slots the table sits in registers; a wider one (overflow
escalation doubles C without a bound) in a global workspace.

The kernel is compiled with nvcc for sm_90a at first use, into
``vargeno_tpu_torch/_build/`` under a name keyed by the source hash, and
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core.hashes import M32, popcount
from . import _build

_INTS = (torch.int32, torch.int64)
NB_FLAG, VALID_FLAG = 1 << 5, 1 << 6   # meta = k | isnb<<5 | valid<<6 | ...
_count_lock = threading.Lock()   # the sharded runner's shards launch from
                                 # threads of their own


def _bind(lib) -> None:
    fn = lib.vgt_vote_records
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)
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


def vote_scan_records_plain(ev_idx, ev_meta, ev_total, C: int):
    """Plain PyTorch version of ``vote_scan_records``: unpack the records,
    then ``vote_scan_plain``."""
    E = ev_idx.shape[1]
    return vote_scan_plain(
        ev_idx.t(), (ev_meta & 0x1F).t(), ((ev_meta & NB_FLAG) != 0).t(),
        ((ev_meta & VALID_FLAG) != 0).t(), C, ev_total.clamp(0, E))


def _check(fn, t, name, shape, dtypes, dev):
    if t.device != dev:
        raise ValueError(f"{fn}: {name} on {t.device}, expected {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} dtype {t.dtype}")


def _check_common(fn, dev, C):
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    if C < 1:
        raise ValueError(f"{fn}: C={C} must be at least 1")


def _empty_result(dev):
    return (torch.zeros(0, dtype=torch.bool, device=dev),
            torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def launch_records(ev_idx, ev_meta, ev_total, width: int, process, target,
                   ovf, ws=None):
    """The bare kernel launch on the current stream, nothing checked and
    nothing allocated: (B, E) int64 record views of one row stride, (B,)
    int64 counts, a table of ``width`` slots (``ws``: (3, B, width) int32
    when width > 512), outputs process (B,) bool, target (B,) int64 and
    ``ovf`` 0-d int64 that the caller has zeroed. Timing this is timing
    the kernel apart from its wrapper."""
    B, E = ev_idx.shape
    dev = ev_idx.device
    with torch.cuda.device(dev):
        rc = load_library().vgt_vote_records(
            ev_idx.data_ptr(), ev_meta.data_ptr(), ev_total.data_ptr(),
            ev_idx.stride(0), E, B, width,
            None if ws is None else ws.data_ptr(), process.data_ptr(),
            target.data_ptr(), ovf.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"vote kernel launch failed: CUDA error {rc}")


def _launch(ev_idx, ev_meta, ev_total, C):
    """Allocate the outputs (and the workspace of a wide table), zero the
    counter and launch: two device operations."""
    B, E = ev_idx.shape
    dev = ev_idx.device
    width = max(1, min(C, E))   # at most E inserts: same result as C slots
    process = torch.empty(B, dtype=torch.bool, device=dev)
    target = torch.empty(B, dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    ws = None
    if width > load_library().vgt_vote_reg_max_c():
        ws = torch.empty((3, B, width), dtype=torch.int32, device=dev)
    launch_records(ev_idx, ev_meta, ev_total, width, process, target, ovf, ws)
    return process, target, ovf


def vote_scan_records(ev_idx, ev_meta, ev_total, C: int):
    """The vote over event records. ev_idx, ev_meta: (B, E) int64 words,
    unit stride along E and one row stride >= E (the step hands views of its
    (B, E + 1) buffers, uncopied); idx is the low 32 bits of its word, meta
    is k | isnb << 5 | valid << 6 and any bits from bit 7 up, which are
    ignored. ev_total (B,) int64: each read's event count, clamped to
    [0, E] here; records at e >= ev_total[b] are skipped.
    Returns (process (B,) bool, target (B,) int64 words, cand_overflow 0-d
    int64)."""
    fn = "vote_scan_records"
    dev = ev_idx.device
    _check_common(fn, dev, C)
    if ev_idx.dim() != 2:
        raise ValueError(f"{fn}: ev_idx must be (B, E), got "
                         f"{tuple(ev_idx.shape)}")
    B, E = ev_idx.shape
    _check(fn, ev_idx, "ev_idx", (B, E), (torch.int64,), dev)
    _check(fn, ev_meta, "ev_meta", (B, E), (torch.int64,), dev)
    _check(fn, ev_total, "ev_total", (B,), (torch.int64,), dev)
    if B == 0:
        return _empty_result(dev)
    if dev.type == "cpu":
        return vote_scan_records_plain(ev_idx, ev_meta, ev_total, C)
    for t, name in ((ev_idx, "ev_idx"), (ev_meta, "ev_meta")):
        if E > 1 and t.stride(1) != 1:
            raise ValueError(f"{fn}: {name} is not unit-stride along E")
        if B > 1 and (t.stride(0) < E or t.stride(0) != ev_idx.stride(0)):
            raise ValueError(f"{fn}: {name} row stride {t.stride(0)}")
    if not ev_total.is_contiguous():
        raise ValueError(f"{fn}: ev_total must be contiguous")
    if B == 1 or E <= 1:   # strides torch leaves free: make them plain
        ev_idx, ev_meta = ev_idx.contiguous(), ev_meta.contiguous()
    out = _launch(ev_idx, ev_meta, ev_total, C)
    with _count_lock:
        vote_scan_records.launches += 1
    return out


vote_scan_records.launches = 0   # kernel launches since the last reset


def vote_scan(ev_idx, ev_k, ev_isnb, ev_valid, C: int, ev_n=None):
    """The vote in the JAX layout. ev_* are (E, B): idx int32/int64 (32-bit
    words), k int32/int64 in [0, 32), isnb/valid bool; ev_n (B,) is each
    read's event count (E when None). On the card the arguments are packed
    into records and go through the kernel of ``vote_scan_records``.
    Returns (process (B,) bool, target (B,) int64 words, cand_overflow 0-d
    int64)."""
    fn = "vote_scan"
    dev = ev_idx.device
    _check_common(fn, dev, C)
    if ev_idx.dim() != 2:
        raise ValueError(f"{fn}: ev_idx must be (E, B), got "
                         f"{tuple(ev_idx.shape)}")
    E, B = ev_idx.shape
    _check(fn, ev_idx, "ev_idx", (E, B), _INTS, dev)
    _check(fn, ev_k, "ev_k", (E, B), _INTS, dev)
    _check(fn, ev_isnb, "ev_isnb", (E, B), (torch.bool,), dev)
    _check(fn, ev_valid, "ev_valid", (E, B), (torch.bool,), dev)
    if ev_n is not None:
        _check(fn, ev_n, "ev_n", (B,), _INTS, dev)
    if B == 0:
        return _empty_result(dev)
    if dev.type == "cpu":
        return vote_scan_plain(ev_idx, ev_k, ev_isnb, ev_valid, C, ev_n)
    # records: the kernel reads each word's low 32 bits, so idx is widened
    # as it is; meta is put together in k's type, then transposed and
    # widened in one copy
    rec_idx = torch.empty((B, E), dtype=torch.int64, device=dev)
    rec_idx.copy_(ev_idx.t())
    meta = torch.add(ev_k & 0x1F, ev_isnb, alpha=NB_FLAG)
    meta.add_(ev_valid, alpha=VALID_FLAG)
    rec_meta = torch.empty((B, E), dtype=torch.int64, device=dev)
    rec_meta.copy_(meta.t())
    total = (torch.full((B,), E, dtype=torch.int64, device=dev)
             if ev_n is None else ev_n.long().contiguous())
    out = _launch(rec_idx, rec_meta, total, C)
    vote_scan.launches += 1
    return out


vote_scan.launches = 0   # kernel launches since the last reset
