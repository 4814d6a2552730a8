"""End-to-end ``geno`` runner (port of ``vargeno_tpu/engine/geno.py``
GenoRunner on the queued-orientation path): FASTQ stream -> batched step on
one device -> per-site pileup counts -> float64 host calling -> output VCF.

Each read runs forward once; only the reads that fail are queued,
reverse-complemented, into later batches (the reference's
retry-on-failure, qv.cc:1504-1510). Counts are order-independent, so the
result equals running both orientations inline.

The host loop is in order: encode a batch (native packing, in a producer
thread), dispatch its step, sync ONE packed vector [stats | process bits |
read_ok bits] with a pinned non-blocking device-to-host copy, and then
either accept the batch's counts or -- when a capacity counter overflowed
-- double the tripped capacities and redo the batch from the totals it
started with.
"""

from __future__ import annotations

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
from ..kernels.vote import vote_scan
from .batch import make_batch_processor
from .device_index import TorchDeviceIndex, build_device_index


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
        if key == "ni_overflow":
            bump("neighbor_item_frac", 1.0)
        elif key == "probe_overflow":
            bump("probe_hit_cap")
        elif key == "event_overflow":
            bump("events_per_read")
        elif key == "cand_overflow":
            bump("candidates_per_read")
        elif key == "snp_scan_overflow":
            bump("scan_slot_cap", cfg.block_size_threshold)
            bump("scan_active_frac", 1.0)
        elif key == "agree_overflow":
            bump("agree_cap")
        elif key == "act_overflow":
            bump("probe_active_frac", 1.0)
        elif key == "sev_overflow":
            bump("sparse_events_frac", 1.0)
        elif key == "site_slot_overflow":
            bump("sites_per_context", 32)
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


def _encoder(K: int):
    from .. import native

    if native.available():
        return lambda c, k: native.encode_batch(c, k, K)
    return lambda c, k: np_encode_batch(c, k, K)


class GenoRunner:
    """Single-device geno on a torch device (``cuda`` by default; ``cpu``
    only when asked for). ``vote`` replaces the vote implementation (the
    kernel wrapper by default)."""

    def __init__(self, index: store.VarGenoIndex,
                 config: GenoConfig = DEFAULT_CONFIG,
                 device: str | torch.device = "cuda",
                 dix: Optional[TorchDeviceIndex] = None, vote=vote_scan):
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
        self._procs: dict = {}
        self._cfg_run = config   # escalated when capacities trip
        n = self.dix.n_sites
        self.ref_cnt = torch.zeros(n + 1, dtype=torch.int32,
                                   device=self.device)
        self.alt_cnt = torch.zeros_like(self.ref_cnt)
        self.stats_totals: dict = {}
        self.n_reads = 0
        self.n_retry_reads = 0   # reads re-run reverse-complemented
        self.n_escalations = 0   # batch redos after an overflow

    def _proc(self, cfg: GenoConfig):
        proc = self._procs.get(cfg)
        if proc is None:
            proc = self._procs[cfg] = make_batch_processor(self.dix, cfg,
                                                           self.vote)
        return proc

    def _fetch(self, vec: torch.Tensor) -> np.ndarray:
        """The batch's one device-to-host sync."""
        if vec.device.type != "cuda":
            return vec.numpy()
        host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
        host.copy_(vec, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host.numpy()

    def _upload(self, enc, qual):
        hi, lo, kv, rok = enc
        dev = self.device

        def words(a):
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            return t.to(dev).long() & M32

        return (words(hi), words(lo), torch.from_numpy(kv).to(dev),
                torch.from_numpy(rok).to(dev),
                torch.from_numpy(np.ascontiguousarray(qual)).to(dev))

    def run_batch(self, enc, qual):
        """Run one pre-encoded batch to an overflow-free (or retry-capped)
        attempt, then commit its counts. Returns host (process, read_ok)."""
        args = self._upload(enc, qual)
        B = args[0].shape[0]
        rounds = 0
        while True:
            proc = self._proc(self._cfg_run)
            rc, ac, process, read_ok, stats = proc.single_enc(
                *args, self.ref_cnt, self.alt_cnt)
            keys = sorted(stats)
            vec = torch.cat([torch.stack([stats[k] for k in keys]),
                             _bits(process), _bits(read_ok)])
            vals = self._fetch(vec)
            srow = dict(zip(keys, vals[:len(keys)].tolist()))
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
        nw = (B + 31) // 32
        bits = vals[len(keys):]
        return _unbits(bits[:nw], B), _unbits(bits[nw:], B)

    def _bump(self, stats):
        for k, v in stats.items():
            if k.endswith("_max"):  # telemetry maxima, not counters
                self.stats_totals[k] = max(self.stats_totals.get(k, 0),
                                           int(v))
            else:
                self.stats_totals[k] = self.stats_totals.get(k, 0) + int(v)

    def consume_fastq(self, fastq_path: str) -> None:
        cfg = self.config
        B = cfg.batch_reads
        encode = _encoder(cfg.max_kmers_per_read)
        pend: list = []     # queued (codes, nk, qual) reverse complements
        pend_n = 0

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
            nonlocal pend_n
            while pend_n >= B or (force and pend_n > 0):
                tc, tk, tq = [], [], []
                got = 0
                while pend and got < B:
                    c0, k0, q0 = pend[0]
                    need = B - got
                    if c0.shape[0] <= need:
                        pend.pop(0)
                    else:
                        pend[0] = (c0[need:], k0[need:], q0[need:])
                        c0, k0, q0 = c0[:need], k0[:need], q0[:need]
                    tc.append(c0)
                    tk.append(k0)
                    tq.append(q0)
                    got += c0.shape[0]
                if got < B:
                    pad = B - got
                    tc.append(np.full((pad, tc[0].shape[1]), 4, np.uint8))
                    tk.append(np.zeros(pad, np.int32))
                    tq.append(np.zeros((pad, tq[0].shape[1]), np.uint8))
                pend_n -= got
                codes, nk = np.concatenate(tc), np.concatenate(tk)
                self.run_batch(encode(codes, nk), np.concatenate(tq))

        def produce():
            for b in iter_read_batches(fastq_path, B, cfg.max_read_len,
                                       cfg.max_kmers_per_read):
                yield b, encode(b.codes, b.n_kmers)

        for batch, enc in prefetch(produce(), depth=3):
            self.n_reads += batch.n_valid
            process, read_ok = self.run_batch(enc, batch.qual)
            enqueue_failures(batch.codes, batch.n_kmers, batch.qual,
                             batch.n_valid, process, read_ok)
            flush_pending()
        flush_pending(force=True)
        overflow = {k: v for k, v in self.stats_totals.items()
                    if "overflow" in k and v}
        if overflow:
            warnings.warn(f"engine capacity overflows (results may diverge "
                          f"from reference): {overflow}")

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

