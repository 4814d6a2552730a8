"""End-to-end ``geno`` runner (port of ``vargeno_tpu/engine/geno.py``
GenoRunner): FASTQ stream -> batched step on one device -> per-site pileup
counts -> float64 host calling -> output VCF.

In queued-orientation mode (the default) each read runs forward once; only
the reads that fail are queued, reverse-complemented, into later batches
(the reference's retry-on-failure, qv.cc:1504-1510). Otherwise every batch
runs both orientations inline in one dual step. Counts are
order-independent, so the two give the same result.

The host loop is in order: encode a batch (native packing, in a producer
thread), dispatch its step, sync ONE packed vector [stats | process bits |
read_ok bits] with a pinned non-blocking device-to-host copy, and then
either accept the batch's counts or -- when a capacity counter overflowed
-- double the tripped capacities and redo the batch from the totals it
started with. With ``auto_tune`` the runner shrinks the lane capacities to
the maxima it measured over the first ``tune_batches`` batches; a
checkpoint (pileup counts + read offset) is written only at a batch
boundary with the retry queue drained, so a resumed run reproduces an
uninterrupted one exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, GenoConfig
from ..core.hashes import M32
from ..core.kmer import np_encode_batch
from ..finalize import finalize_calls
from ..index import store
from ..io.fastq import iter_read_batches, prefetch
from ..io.vcf_writer import write_calls_vcf
from ..kernels.vote import vote_scan_records
from ..utils.profiling import Meter
from . import checkpoint as ckpt
from .autotune import TUNE_KEYS, tuned_config
from .batch import make_batch_processor
from .device_index import TorchDeviceIndex, build_device_index


def _strip_orientation(key: str) -> str:
    """A dual step's per-pass stat key without its fwd_ / rev_ prefix."""
    return key.split("_", 1)[1] if key.startswith(("fwd_", "rev_")) else key


def _escalate_config(cfg: GenoConfig, tripped) -> GenoConfig:
    """Double every capacity whose overflow counter fired (the reference's
    buffers are unbounded, so any overflow means potential divergence;
    escalation restores exactness)."""
    upd: dict = {}

    def bump(field, cap=None):
        cur = upd.get(field, getattr(cfg, field))
        new = cur * 2
        if isinstance(cur, int):
            new = int(new)
        if cap is not None:
            new = min(new, cap)
        if new != cur:
            upd[field] = new

    for key in tripped:
        base = _strip_orientation(key)
        if base == "ni_overflow":
            bump("neighbor_item_frac", 1.0)
        elif base == "probe_overflow":
            bump("probe_hit_cap")
        elif base == "event_overflow":
            bump("events_per_read")
        elif base == "cand_overflow":
            bump("candidates_per_read")
        elif base == "snp_scan_overflow":
            bump("scan_slot_cap", cfg.block_size_threshold)
            bump("scan_active_frac", 1.0)
            # the routed backend folds its scan-route truncation into the
            # same key: bump its caps too (inert on a local backend)
            bump("route_scan_slots", cfg.block_size_threshold)
            bump("route_factor", 64.0)
        elif base == "agree_overflow":
            bump("agree_cap")
        elif base == "act_overflow":
            bump("probe_active_frac", 1.0)
        elif base == "sev_overflow":
            bump("sparse_events_frac", 1.0)
        elif base == "amb_overflow":
            # capped where every exact lookup (ref and SNP, each k-mer
            # slot) of every read has a slot
            bump("amb_hits_per_read", 2 * cfg.max_kmers_per_read)
        elif base == "site_slot_overflow":
            bump("sites_per_context", 32)
        elif base == "route_overflow":
            # sharded dictionary: the per-(src, dst) routing lane cap
            bump("route_factor", 64.0)
    if not upd:
        return cfg
    return dataclasses.replace(cfg, **upd)


def revcomp_select_host(codes, nk, qual, sel):
    """Gather rows ``sel`` and reverse-complement them (qv.cc:787-806),
    native C when available else numpy; quality is NOT reversed."""
    from .. import native

    if native.available():
        return native.revcomp_select(codes, nk, qual, sel)
    c = codes[sel]
    k = nk[sel]
    length = k * 32
    L = c.shape[1]
    idx = length[:, None] - 1 - np.arange(L)[None, :]
    valid = idx >= 0
    g = np.take_along_axis(c, np.clip(idx, 0, L - 1), axis=1)
    rc = np.where(g < 4, 3 - g, g)
    rc = np.where(valid, rc, 4).astype(np.uint8)
    return rc, k, qual[sel]


def _bits(mask: torch.Tensor) -> torch.Tensor:
    """(B,) bool -> (ceil(B/32),) int64 words, bit j of word w = lane
    32w + j."""
    pad = (-mask.shape[0]) % 32
    m = torch.nn.functional.pad(mask.long(), (0, pad)).reshape(-1, 32)
    return (m << torch.arange(32, device=mask.device)).sum(1)


def _unbits(words: np.ndarray, n: int) -> np.ndarray:
    full = (words[:, None] >> np.arange(32)) & 1
    return full.reshape(-1)[:n].astype(bool)


def upload(dev, enc, qual, n_kmers=None) -> list:
    """A pre-encoded host batch as the step's arguments on ``dev``: (hi,
    lo) as int64 words, the masks, [n_kmers,] qual."""
    hi, lo, kv, rok = enc

    def words(a):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        return t.to(dev).long() & M32

    args = [words(hi), words(lo), torch.from_numpy(kv).to(dev),
            torch.from_numpy(rok).to(dev)]
    if n_kmers is not None:   # the dual step derives the reverse pass
        args.append(torch.from_numpy(np.ascontiguousarray(n_kmers)).to(dev))
    args.append(torch.from_numpy(np.ascontiguousarray(qual)).to(dev))
    return args


def step_vec(proc, args, dual: bool, ref_cnt, alt_cnt):
    """Dispatch one step; returns (ref_cnt, alt_cnt, stat keys, vec) with
    the stats and -- single orientation -- the (process, read_ok) bit words
    packed into ONE device vector, so a batch syncs the host once."""
    if dual:
        rc, ac, stats = proc.dual_enc(*args, ref_cnt, alt_cnt)
        masks = []
    else:
        rc, ac, process, read_ok, stats = proc.single_enc(*args, ref_cnt,
                                                          alt_cnt)
        masks = [_bits(process), _bits(read_ok)]
    keys = sorted(stats)
    return rc, ac, keys, torch.cat([torch.stack([stats[k] for k in keys])]
                                   + masks)


def fetch(vecs) -> list:
    """Device vectors -> numpy, with one pinned non-blocking copy each and
    one wait per device."""
    hosts, done = [], {}
    for v in vecs:
        if v.device.type != "cuda":
            hosts.append(v)
            continue
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        hosts.append(h)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(v.device))
        done[v.device] = ev
    for ev in done.values():
        ev.synchronize()
    return [h.numpy() for h in hosts]


def unpack_vec(vals: np.ndarray, keys, B: Optional[int]):
    """(stats row, masks) of a fetched step vector; masks = the (process,
    read_ok) bool arrays of a single-orientation step of B reads, else
    None."""
    srow = dict(zip(keys, vals[:len(keys)].tolist()))
    if B is None:
        return srow, None
    nw = (B + 31) // 32
    bits = vals[len(keys):]
    return srow, (_unbits(bits[:nw], B), _unbits(bits[nw:], B))


def reads_of(batch) -> int:
    """The reads a host-loop batch accounts for: its own, or for a stripe
    of a global batch (``iter_read_batches_strided``), the global batch's."""
    return batch.n_valid if batch.global_n_valid < 0 else \
        batch.global_n_valid


def _encoder(K: int):
    from .. import native

    if native.available():
        return lambda c, k: native.encode_batch(c, k, K)
    return lambda c, k: np_encode_batch(c, k, K)


class GenoRunner:
    """Single-device geno on a torch device (``cuda`` by default; ``cpu``
    only when asked for).

    ``queued_orientation=True`` (default) runs each read forward once and
    queues only failed reads' reverse complements into later batches;
    ``False`` runs both orientations of every batch inline (twice the
    device work a batch, the same counts). ``vote`` replaces the vote
    implementation (the kernel wrapper by default); ``metrics_path`` is
    where ``meter.emit()`` appends its jsonl throughput line."""

    def __init__(self, index: store.VarGenoIndex,
                 config: GenoConfig = DEFAULT_CONFIG,
                 device: str | torch.device = "cuda",
                 dix: Optional[TorchDeviceIndex] = None,
                 vote=vote_scan_records, queued_orientation: bool = True,
                 metrics_path: Optional[str] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (pass "
                               "--device cpu to run on the host)")
        self.index = index
        self.config = config
        self.dix = (build_device_index(index, self.device,
                                       config.ht_target_load)
                    if dix is None else dix)
        self.vote = vote
        self.queued = queued_orientation
        self._procs: dict = {}
        self._cfg_run = config   # escalated / tuned as the run goes
        self.ref_cnt, self.alt_cnt = self._fresh_counts()
        self.stats_totals: dict = {}
        self.n_reads = 0
        self.n_retry_reads = 0   # reads re-run reverse-complemented
        self.n_escalations = 0   # batch redos after an overflow
        self._tune_max: dict = {}   # per-batch telemetry maxima
        self._tune_seen = 0
        self._tuned = not config.auto_tune
        self.meter = Meter(metrics_path)

    def _proc(self, cfg: GenoConfig):
        proc = self._procs.get(cfg)
        if proc is None:
            proc = self._procs[cfg] = make_batch_processor(self.dix, cfg,
                                                           self.vote)
        return proc

    # --- hooks a mesh runner overrides (dist.sharding): the reads of one
    # host-loop batch, the count layout, and how one attempt of a batch is
    # dispatched and synced ---

    def _loop_batch(self) -> int:
        """Reads per host-loop batch (a mesh runner's is D x batch)."""
        return self.config.batch_reads

    def _fresh_counts(self):
        """Zeroed pileup accumulators on this runner's device."""
        z = torch.zeros(self.dix.n_sites + 1, dtype=torch.int32,
                        device=self.device)
        return z, torch.zeros_like(z)

    def _restore_ckpt(self, rc, ac) -> None:
        self.ref_cnt = torch.from_numpy(
            np.ascontiguousarray(rc, np.int32)).to(self.device)
        self.alt_cnt = torch.from_numpy(
            np.ascontiguousarray(ac, np.int32)).to(self.device)

    def _upload(self, enc, qual, n_kmers=None):
        return upload(self.device, enc, qual, n_kmers)

    def _attempt(self, proc, args, dual: bool):
        """Dispatch one attempt of a batch and sync its one packed vector.
        Returns (ref_cnt, alt_cnt, stats, tune_stats, masks): the new
        totals, the stats row, the values auto-tune reads, and the host
        (process, read_ok) masks (None for the dual step)."""
        rc, ac, keys, vec = step_vec(proc, args, dual, self.ref_cnt,
                                     self.alt_cnt)
        srow, masks = unpack_vec(fetch([vec])[0], keys,
                                 None if dual else args[0].shape[0])
        return rc, ac, srow, srow, masks

    def run_batch(self, enc, qual, n_kmers=None):
        """Run one pre-encoded batch to an overflow-free (or retry-capped)
        attempt, then commit its counts. Without ``n_kmers`` it is one
        orientation, and the host (process, read_ok) masks come back for
        the retry queue; with ``n_kmers`` (each read's k-mer count) it is
        the dual step, which returns None."""
        dual = n_kmers is not None
        args = self._upload(enc, qual, n_kmers)
        rounds = 0
        while True:
            rc, ac, srow, tune, masks = self._attempt(
                self._proc(self._cfg_run), args, dual)
            tripped = [k for k, v in srow.items() if "overflow" in k and v]
            if not tripped or rounds >= self.config.auto_retry_max:
                break
            new_cfg = _escalate_config(self._cfg_run, tripped)
            if new_cfg == self._cfg_run:
                break   # caps already at their limits
            self._cfg_run = new_cfg
            rounds += 1
            self.n_escalations += 1
        self.ref_cnt, self.alt_cnt = rc, ac
        self._bump(srow)
        if not self._tuned:
            self._maybe_tune(tune)
        return masks

    def _bump(self, stats):
        for k, v in stats.items():
            if k.endswith("_max"):  # telemetry maxima, not counters
                self.stats_totals[k] = max(self.stats_totals.get(k, 0),
                                           int(v))
            else:
                self.stats_totals[k] = self.stats_totals.get(k, 0) + int(v)

    def _maybe_tune(self, stats: dict) -> None:
        """Accumulate per-batch telemetry maxima; once ``tune_batches``
        batches are seen, shrink lane capacities to measured maxima x
        headroom (engine.autotune). Overflow escalation keeps results
        exact if a tuned cap later trips."""
        for k, v in stats.items():
            base = _strip_orientation(k)
            if base in TUNE_KEYS:
                self._tune_max[base] = max(self._tune_max.get(base, 0),
                                           int(v))
        self._tune_seen += 1
        if self._tune_seen < self.config.tune_batches:
            return
        self._tuned = True
        self._cfg_run = tuned_config(self._cfg_run, self.dix,
                                     self._tune_max,
                                     self.config.tune_headroom)

    def consume_fastq(self, fastq_path: str,
                      limit_batches: Optional[int] = None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 64) -> None:
        """Genotype a FASTQ stream into the running counts. With
        ``checkpoint_path`` the run resumes from the checkpoint there (when
        one exists) and saves one every ``checkpoint_every`` batches and at
        the end; ``limit_batches`` stops the run after that many batches
        (retry batches included)."""
        skip = 0
        if checkpoint_path:
            state = ckpt.load(checkpoint_path)
            if state is not None:
                rc, ac, meta = state
                self._restore_ckpt(rc, ac)
                skip = meta["n_reads"]
                self.n_reads = skip
        consume = self._consume_queued if self.queued else self._consume_dual
        consume(fastq_path, skip, limit_batches, checkpoint_path,
                checkpoint_every)
        if checkpoint_path:
            self._ckpt_save(checkpoint_path)
        overflow = {k: v for k, v in self.stats_totals.items()
                    if "overflow" in k and v}
        if overflow:
            warnings.warn(f"engine capacity overflows (results may diverge "
                          f"from reference): {overflow}")

    def _ckpt_save(self, path: str) -> None:
        ckpt.save(path, *self.host_counts(), self.n_reads)

    def _read_batches(self, fastq_path, skip):
        """The host loop's read batches (a multi-process runner reads its
        stripe of each global batch)."""
        cfg = self.config
        return iter_read_batches(fastq_path, self._loop_batch(),
                                 cfg.max_read_len, cfg.max_kmers_per_read,
                                 skip_reads=skip)

    def _batches(self, fastq_path, skip):
        """Encoded batches from a producer thread: (batch, enc) pairs in a
        generator that stops its thread when closed."""
        encode = _encoder(self.config.max_kmers_per_read)

        def produce():
            for b in self._read_batches(fastq_path, skip):
                yield b, encode(b.codes, b.n_kmers)

        return contextlib.closing(prefetch(produce(), depth=3)), encode

    def _consume_dual(self, fastq_path, skip, limit_batches,
                      checkpoint_path, checkpoint_every):
        batches, _ = self._batches(fastq_path, skip)
        nb = 0
        with batches as it:
            for batch, enc in it:
                self.n_reads += reads_of(batch)
                self.run_batch(enc, batch.qual, n_kmers=batch.n_kmers)
                self.meter.bump(reads_of(batch))
                nb += 1
                if checkpoint_path and nb % checkpoint_every == 0:
                    self._ckpt_save(checkpoint_path)
                if limit_batches and nb >= limit_batches:
                    break

    def _consume_queued(self, fastq_path, skip, limit_batches,
                        checkpoint_path, checkpoint_every):
        B = self._loop_batch()
        batches, encode = self._batches(fastq_path, skip)
        pend: list = []     # queued (codes, nk, qual) reverse complements
        pend_n = 0
        nb = 0

        def enqueue_failures(codes, nk, qual, n_valid, process, read_ok):
            nonlocal pend_n
            retry = (~process) & read_ok & (nk > 0)
            retry[n_valid:] = False
            if not retry.any():
                return
            sel = np.flatnonzero(retry)
            self.n_retry_reads += sel.size
            pend.append(revcomp_select_host(codes, nk, qual, sel))
            pend_n += sel.size

        def flush_pending(force=False):
            nonlocal pend_n, nb
            while pend_n >= B or (force and pend_n > 0):
                codes, nk, qual, got = self._take_queued(pend, B)
                pend_n -= got
                self.run_batch(encode(codes, nk), qual)
                self.meter.bump(0)
                nb += 1

        with batches as it:
            for batch, enc in it:
                self.n_reads += batch.n_valid
                process, read_ok = self.run_batch(enc, batch.qual)
                self.meter.bump(batch.n_valid)
                nb += 1
                enqueue_failures(batch.codes, batch.n_kmers, batch.qual,
                                 batch.n_valid, process, read_ok)
                flush_pending()
                if checkpoint_path and nb % checkpoint_every == 0:
                    # drain first: a checkpoint holds no queued reads
                    flush_pending(force=True)
                    self._ckpt_save(checkpoint_path)
                if limit_batches and nb >= limit_batches:
                    break
        flush_pending(force=True)

    def _take_queued(self, queue: list, B: int):
        """Up to B queued reads off the front of ``queue`` (a list of
        (codes, n_kmers, qual) segments, consumed in place), padded with
        empty reads to B rows: (codes, n_kmers, qual, reads taken)."""
        cfg = self.config
        tc, tk, tq = [], [], []
        got = 0
        while queue and got < B:
            c0, k0, q0 = queue[0]
            need = B - got
            if c0.shape[0] <= need:
                queue.pop(0)
            else:
                queue[0] = (c0[need:], k0[need:], q0[need:])
                c0, k0, q0 = c0[:need], k0[:need], q0[:need]
            tc.append(c0)
            tk.append(k0)
            tq.append(q0)
            got += c0.shape[0]
        if got < B:
            pad = B - got
            tc.append(np.full((pad, cfg.max_read_len), 4, np.uint8))
            tk.append(np.zeros(pad, np.int32))
            tq.append(np.zeros((pad, cfg.max_kmers_per_read), np.uint8))
        return (np.concatenate(tc), np.concatenate(tk), np.concatenate(tq),
                got)

    def host_counts(self):
        return self.ref_cnt.cpu().numpy(), self.alt_cnt.cpu().numpy()

    def calls(self):
        s = self.index.sites
        n = s.pos.shape[0]
        rc, ac = self.host_counts()
        ref = np.minimum(rc[:n], self.config.max_cov)
        alt = np.minimum(ac[:n], self.config.max_cov)
        return finalize_calls(self.index.chrlens, s.pos, s.ref, s.alt,
                              s.rf, s.af, ref, alt, self.config)

    def write_vcf(self, vcf_in: str, vcf_out: str) -> None:
        write_calls_vcf(vcf_in, vcf_out, self.calls())

