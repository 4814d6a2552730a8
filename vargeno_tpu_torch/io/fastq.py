"""Jax-free copy of ``vargeno_tpu/io/fastq.py``.

FASTQ streaming into fixed-shape padded batches (host side).

Replaces the reference's one-read-at-a-time fgets loop (src/qv.cc:760-763)
with a chunked reader that yields numpy arrays ready for device transfer:
base codes (B, L) uint8 (N=4, pad=4), per-read true k-mer counts, and the
per-kmer-index quality characters the neighbor search is gated on
(src/qv.cc:836: the reference indexes the quality string by *k-mer index*).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..core.kmer import np_codes_from_bytes


# The reference reads each FASTQ line into a 1023-char fgets buffer
# (src/qv.cc:700), so its sequence envelope is 1022 bases = 31 k-mers;
# reads are floored to 32-base multiples anyway (src/qv.cc:778-779), so
# 992 padded bases reproduce its behavior for ANY input it can handle.
REF_MAX_READ_LEN = 992


def peek_max_read_len(path: str, n_reads: int = 8192) -> int:
    """Maximum sequence length among the first ``n_reads`` records (fast
    header-free scan; used by the CLI to auto-size max_read_len so >128 bp
    FASTQs are not silently truncated at default flags)."""
    mx = 0
    with open(path, "rb") as f:
        for i in range(n_reads):
            if not f.readline():
                break
            seq = f.readline()
            if not seq:
                break
            mx = max(mx, len(seq.rstrip(b"\n")))
            f.readline()
            f.readline()
    return mx


def autosize_read_len(path: str, n_reads: int = 8192) -> int:
    """max_read_len for a FASTQ: the 32-multiple covering the longest of
    the first n_reads reads, in [128, REF_MAX_READ_LEN]. (The streaming
    reader still warns if a longer read appears later in the file.)"""
    mx = peek_max_read_len(path, n_reads)
    return max(128, min((mx // 32) * 32, REF_MAX_READ_LEN))


def autosize_shapes(path: str, n_reads: int = 8192):
    """(max_read_len, max_kmers) for a FASTQ. The kmer-slot count follows
    the OBSERVED longest read, not the padded length: 101 bp reads use
    floor(101/32)=3 slots (the reference ignores the sub-32 tail,
    src/qv.cc:779), and a 4th slot would inflate every B*K-proportional
    gather grid by a third for nothing."""
    mx = peek_max_read_len(path, n_reads)
    L = max(128, min((mx // 32) * 32, REF_MAX_READ_LEN))
    K = max(1, min(L // 32, mx // 32))
    return L, K


@dataclasses.dataclass
class ReadBatch:
    codes: np.ndarray      # (B, L) uint8 base codes; pad/N = 4, invalid = 7
    n_kmers: np.ndarray    # (B,) int32 floor(read_len/32), capped at K slots
    qual: np.ndarray       # (B, Kmax) uint8 quality char at kmer index
    n_valid: int           # number of real (non-pad) reads in this batch
    global_n_valid: int = -1  # striped readers: total reads in the GLOBAL
                              # batch this stripe belongs to (-1 = n_valid)


def iter_read_batches(path: str, batch_reads: int, max_read_len: int,
                      max_kmers: int, skip_reads: int = 0,
                      use_native: bool = True) -> Iterator[ReadBatch]:
    B, L, Km = batch_reads, max_read_len, max_kmers
    if use_native:
        from .. import native

        if native.available():
            for codes, n_kmers, qual, got in native.fastq_batches(
                    path, B, L, Km, skip_reads=skip_reads):
                yield ReadBatch(codes, n_kmers, qual, got)
            return
    codes = np.full((B, L), 4, np.uint8)
    n_kmers = np.zeros(B, np.int32)
    qual = np.zeros((B, Km), np.uint8)
    fill = 0
    max_slen = 0
    with open(path, "rb") as f:
        for _ in range(skip_reads * 4):
            f.readline()
        n_qmm = 0
        while True:
            rid = f.readline()
            if not rid or not rid.strip():
                break
            seq = f.readline().rstrip(b"\r\n")
            _sep = f.readline()
            q = f.readline().rstrip(b"\r\n")
            if not _sep:
                from ..errors import FastqError

                raise FastqError(
                    f"{path}: file ends mid-record (header {rid[:50]!r} "
                    f"has no '+'/quality lines) -- truncated download or "
                    f"concatenation?")
            if len(q) != len(seq):
                n_qmm += 1
            max_slen = max(max_slen, len(seq))
            ln = min(len(seq), L)
            k = min(ln // 32, Km)
            c = np_codes_from_bytes(seq[:ln])
            codes[fill, :ln] = c
            codes[fill, ln:] = 4
            n_kmers[fill] = k
            nq = min(len(q), Km)
            qrow = np.zeros(Km, np.uint8)
            qrow[:nq] = np.frombuffer(q[:nq], np.uint8)
            qual[fill] = qrow
            fill += 1
            if fill == B:
                yield ReadBatch(codes.copy(), n_kmers.copy(), qual.copy(), B)
                codes[:] = 4
                n_kmers[:] = 0
                qual[:] = 0
                fill = 0
    if fill:
        yield ReadBatch(codes.copy(), n_kmers.copy(), qual.copy(), fill)
    _warn_truncation(max_slen, L, Km)
    _warn_qual_mismatch(n_qmm, path)


def _warn_truncation(max_slen: int, L: int, Km: int) -> None:
    """Warn whenever a read LOST K-MERS to the configured shapes: either
    its bases exceed the padded length L, or its floor(len/32) k-mers
    exceed the slot cap Km (Km may be < L//32 when auto-sized from a
    peek of the file's head, io.fastq.autosize_shapes)."""
    if max_slen // 32 > min(L // 32, Km):
        import warnings

        warnings.warn(
            f"FASTQ contains reads up to {max_slen} bases but the engine "
            f"shapes cover only {min(L // 32, Km)} k-mers/read "
            f"(max_read_len={L}, kmer slots={Km}): long reads were "
            f"TRUNCATED and results may diverge from the reference. "
            f"Re-run with --max-read-len "
            f"{min((max_slen // 32) * 32, REF_MAX_READ_LEN)}.")


def _warn_qual_mismatch(n: int, path: str) -> None:
    """Quality lines shorter/longer than their sequence violate the FASTQ
    spec; quality is indexed by K-MER slot (src/qv.cc:836), so a short
    line silently mis-gates the neighbor search for that read."""
    if n:
        import warnings

        warnings.warn(
            f"{path}: {n} record(s) have a quality line whose length "
            f"differs from the sequence length; missing positions read as "
            f"quality 0 (always below the neighbor-search threshold).")


class _FastqStream:
    """Buffered FASTQ record stream with two primitives: ``skip(n)``
    (drop n records at newline-count speed -- other processes' stripes)
    and ``parse(n)`` (materialize n records as padded code/qual arrays).
    The building block for striped multi-process readers; parsing uses
    the native window parser when available."""

    def __init__(self, path: str, max_read_len: int, max_kmers: int,
                 chunk: int = 1 << 23):
        self.f = open(path, "rb")
        self.L, self.Km = max_read_len, max_kmers
        self.chunk = chunk
        self.buf = b""
        self.eof = False
        self.max_slen = 0
        from .. import native

        self._native = native if native.available() else None

    def close(self):
        self.f.close()
        _warn_truncation(self.max_slen, self.L, self.Km)

    def _fill(self) -> bool:
        if self.eof:
            return False
        data = self.f.read(self.chunk)
        if len(data) < self.chunk:
            self.eof = True
        if data:
            self.buf += data
        if self.eof and self.buf and not self.buf.endswith(b"\n"):
            self.buf += b"\n"   # unterminated final record
        return bool(data)

    def skip(self, n: int) -> int:
        """Skip up to n records; returns how many were actually skipped
        (< n only at EOF)."""
        if n <= 0:
            return 0
        remaining = 4 * n
        while remaining > 0:
            cnt = self.buf.count(b"\n")
            if cnt == 0:
                if not self._fill() and self.eof:
                    break
                continue
            if cnt <= remaining:
                off = self.buf.rfind(b"\n")
                self.buf = self.buf[off + 1:]
                remaining -= cnt
                if remaining > 0 and self.eof and not self.buf:
                    break
            else:
                nl = np.flatnonzero(
                    np.frombuffer(self.buf, np.uint8) == 10)
                off = int(nl[remaining - 1])
                self.buf = self.buf[off + 1:]
                remaining = 0
        return (4 * n - remaining) // 4

    def _parse_native(self, n: int):
        import ctypes

        lib = self._native._load()
        L, Km = self.L, self.Km
        codes = np.empty((n, L), np.uint8)
        nk = np.empty(n, np.int32)
        qual = np.empty((n, Km), np.uint8)
        data = self.buf
        cursor = ctypes.c_int64(0)
        mx = ctypes.c_int64(0)
        qmm = ctypes.c_int64(0)
        got = lib.vgt_fastq_batch(
            ctypes.c_char_p(data), len(data), ctypes.byref(cursor), n, L,
            Km, codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            qual.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(mx), ctypes.byref(qmm))
        self.buf = data[cursor.value:]
        self.max_slen = max(self.max_slen, int(mx.value))
        return codes, nk, qual, int(got)

    def _parse_py(self, n: int):
        L, Km = self.L, self.Km
        nl = np.flatnonzero(np.frombuffer(self.buf, np.uint8) == 10)
        nrec = min(n, nl.shape[0] // 4)
        codes = np.full((n, L), 4, np.uint8)
        nk = np.zeros(n, np.int32)
        qual = np.zeros((n, Km), np.uint8)
        mv = self.buf
        for r in range(nrec):
            # record r spans lines 4r..4r+3: header, seq, sep, qual
            seq = mv[int(nl[4 * r]) + 1: int(nl[4 * r + 1])]
            q = mv[nl[4 * r + 2] + 1: nl[4 * r + 3]]
            self.max_slen = max(self.max_slen, len(seq))
            ln = min(len(seq), L)
            codes[r, :ln] = np_codes_from_bytes(seq[:ln])
            nk[r] = min(ln // 32, Km)
            nq = min(len(q), Km)
            qual[r, :nq] = np.frombuffer(q[:nq], np.uint8)
        if nrec:
            self.buf = self.buf[int(nl[4 * nrec - 1]) + 1:]
        return codes, nk, qual, nrec

    def parse(self, n: int):
        """Parse up to n records into (codes(n,L), n_kmers(n,), qual(n,Km),
        got) -- rows beyond ``got`` are pads."""
        L, Km = self.L, self.Km
        codes = np.full((n, L), 4, np.uint8)
        nk = np.zeros(n, np.int32)
        qual = np.zeros((n, Km), np.uint8)
        got = 0
        while got < n:
            if self.buf.count(b"\n") < 4:
                if not self._fill() and self.eof:
                    break
                continue
            if self._native is not None:
                c, k, q, g = self._parse_native(n - got)
            else:
                c, k, q, g = self._parse_py(n - got)
            if g == 0:
                if not self._fill() and self.eof:
                    break
                continue
            codes[got:got + g] = c[:g]
            nk[got:got + g] = k[:g]
            qual[got:got + g] = q[:g]
            got += g
        return codes, nk, qual, got


def iter_read_batches_strided(path: str, local_batch: int, n_stripes: int,
                              stripe: int, max_read_len: int,
                              max_kmers: int,
                              skip_reads: int = 0) -> Iterator[ReadBatch]:
    """Stripe-partitioned batches for multi-process (multi-host) readers.

    Global batch g holds file reads [g*GB, (g+1)*GB) where GB =
    local_batch * n_stripes; this process PARSES only its stripe's rows
    [stripe*LB, (stripe+1)*LB) of each global batch and skips everyone
    else's at newline-count speed. Every stripe yields the SAME number of
    batches (tail batches pad with invalid reads), and each batch carries
    ``global_n_valid`` = total real reads in its global batch -- so N
    per-process host loops stay collectively aligned with zero
    communication. ``skip_reads`` skips whole GLOBAL reads first
    (checkpoint resume)."""
    LB = local_batch
    st = _FastqStream(path, max_read_len, max_kmers)
    try:
        if skip_reads:
            st.skip(skip_reads)
        while True:
            pre = st.skip(stripe * LB)
            codes, nk, qual, got = st.parse(LB)
            post = st.skip((n_stripes - 1 - stripe) * LB)
            gval = pre + got + post
            if gval == 0:
                break
            yield ReadBatch(codes, nk, qual, got, global_n_valid=gval)
    finally:
        st.close()


def prefetch(it, depth: int = 2):
    """Run an iterator on a background thread with a bounded queue, so
    batch parsing/encoding overlaps device compute instead of serializing
    into the dispatch loop. Exceptions propagate to the consumer.

    Closing the consumer generator early (or abandoning it) signals the
    worker to stop, so no thread is left blocked on a full queue at
    interpreter shutdown."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    _ERR = object()   # sentinel wrapper: items that ARE exceptions still yield
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put((None, item)):
                    return
            _put((_END, None))
        except BaseException as e:  # noqa: BLE001 - repropagated below
            _put((_ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            tag, item = q.get()
            if tag is _END:
                return
            if tag is _ERR:
                raise item
            yield item
    finally:
        stop.set()
        while True:  # unblock a worker waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
        if t.is_alive():
            # the wrapped iterator is blocked inside next() and cannot see
            # the stop flag; surface it instead of silently leaking the
            # daemon thread (it dies with the process either way)
            import warnings
            warnings.warn("prefetch worker did not stop within 5s "
                          "(producer blocked in next()); daemon thread "
                          "left running")
