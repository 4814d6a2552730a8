"""End-to-end ``geno`` runner (port of ``vargeno_tpu/engine/geno.py``
GenoRunner): FASTQ stream -> batched step on one device -> per-site pileup
counts -> float64 host calling -> output VCF.

In queued-orientation mode (the default) each read runs forward once; only
the reads that fail are queued, reverse-complemented, into later batches
(the reference's retry-on-failure, qv.cc:1504-1510). Otherwise every batch
runs both orientations inline in one dual step. Counts are
order-independent, so the two give the same result.

The host loop (JAX ``_consume_queued``) keeps ``pipeline_depth`` batches
in flight. A producer thread parses and encodes each batch (and, at
group size 1 on one device, uploads it over a side stream); the main
thread dispatches its step on the running totals and gets back a handle:
the totals it started from, and ONE packed vector [stats | process bits |
read_ok bits] on its way to a pinned host buffer of its own (``Fetch``),
which a fetch worker thread waits for. A batch is finalized once more
than ``pipeline_depth`` are in flight and its vector has landed: its
overflow counters are read, and when a capacity overflowed the tripped
capacities are doubled and the batch and every later in-flight batch are
redone from the totals it started at (``_chain_rewind``); then its failed
reads are queued. With ``group_size`` G > 1, G pre-encoded sub-batches go
as one grouped dispatch (``BatchProcessor.multi_enc``); with
``pre_encode`` off the base codes go and the step encodes them. With
``auto_tune`` the runner shrinks the lane capacities to the maxima it
measured over the first ``tune_batches`` batches. A checkpoint (pileup
counts + read offset) is written only with nothing staged, in flight or
queued, so a resumed run reproduces an uninterrupted one exactly, and
every knob gives the same counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import warnings
from collections import deque
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
from ..utils.profiling import Meter, StageTimer, span
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
    """(..., B) bool -> the (..., ceil(B/32)) int64 words flattened, bit j
    of word w of a row = lane 32w + j."""
    pad = (-mask.shape[-1]) % 32
    m = torch.nn.functional.pad(mask.long(), (0, pad))
    m = m.reshape(*mask.shape[:-1], -1, 32)
    return (m << torch.arange(32, device=mask.device)).sum(-1).reshape(-1)


def _unbits(words: np.ndarray, shape) -> np.ndarray:
    """Inverse of ``_bits``: a bool array of ``shape`` (an int is (n,))."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    full = ((words[:, None] >> np.arange(32)) & 1).astype(bool)
    return full.reshape(*shape[:-1], -1)[..., :shape[-1]]


def _words(dev, a) -> torch.Tensor:
    """Host uint32 words as int64 on ``dev``."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return t.to(dev).long() & M32


def upload(dev, enc, qual, n_kmers=None) -> list:
    """A pre-encoded host batch -- or a (G, B, ...) stack of them -- as the
    step's arguments on ``dev``: (hi, lo) as int64 words, the masks,
    [n_kmers,] qual."""
    hi, lo, kv, rok = enc
    args = [_words(dev, hi), _words(dev, lo), torch.from_numpy(kv).to(dev),
            torch.from_numpy(rok).to(dev)]
    if n_kmers is not None:   # the dual step derives the reverse pass
        args.append(torch.from_numpy(np.ascontiguousarray(n_kmers)).to(dev))
    args.append(torch.from_numpy(np.ascontiguousarray(qual)).to(dev))
    return args


# the processor method each kind of dispatch runs
STEPS = dict(dual="dual_enc", enc="single_enc", codes="single",
             group="multi_enc")


def step_vec(proc, args, kind: str, ref_cnt, alt_cnt):
    """Dispatch one step of ``kind`` (a key of STEPS); returns (ref_cnt,
    alt_cnt, stat keys, vec) with the stats and -- every kind but the dual
    step -- the (process, read_ok) bit words packed into ONE device
    vector, so a batch syncs the host once."""
    out = getattr(proc, STEPS[kind])(*args, ref_cnt, alt_cnt)
    with span("step.pack"):
        if kind == "dual":
            rc, ac, stats = out
            masks = []
        else:
            rc, ac, process, read_ok, stats = out
            masks = [_bits(process), _bits(read_ok)]
        keys = sorted(stats)
        return rc, ac, keys, torch.cat(
            [torch.stack([stats[k] for k in keys])] + masks)


class Fetch:
    """The host copy of one dispatch's packed vectors: a pinned buffer of
    its own and a CUDA event for each, the non-blocking copy started when
    the step is issued. ``wait`` blocks until the copies have landed (the
    fetch worker calls it off the dispatch thread); ``result`` returns
    the numpy vectors, or raises what the wait raised. Host tensors are
    taken as they are."""

    def __init__(self, vecs):
        self.hosts, self.events = [], []
        for v in vecs:
            ev = None
            if v.device.type == "cuda":
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(v.device))
                v = h
            self.hosts.append(v)
            self.events.append(ev)
        self.done = threading.Event()
        self._lock = threading.Lock()
        self._vals = self._err = None

    @property
    def landed(self) -> bool:
        return self.done.is_set()

    def wait(self) -> None:
        with self._lock:
            if self.done.is_set():
                return
            try:
                for ev in self.events:
                    if ev is not None:
                        ev.synchronize()
                self._vals = [h.numpy() for h in self.hosts]
            except Exception as e:  # noqa: BLE001 - raised by result()
                self._err = e
            self.done.set()

    def result(self) -> list:
        self.wait()
        if self._err is not None:
            raise self._err
        return self._vals


class FetchWorker:
    """A thread that waits for submitted fetches in FIFO order -- the
    pipeline's finalize order -- so the dispatch thread never blocks on a
    batch that has not landed (JAX ``_start_fetch_worker``)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="vgt-fetch")
        self._t.start()

    def _run(self) -> None:
        while True:
            f = self._q.get()
            if f is None:
                return
            f.wait()

    def submit(self, f: Fetch) -> None:
        self._q.put(f)

    def stop(self) -> None:
        self._q.put(None)
        self._t.join(timeout=5)


def unpack_vec(vals: np.ndarray, keys, shape):
    """(stats row, masks) of a fetched step vector; masks = the (process,
    read_ok) bool arrays of ``shape`` ((B,), or (G, B) for a group), None
    for the dual step (``shape`` None)."""
    srow = dict(zip(keys, vals[:len(keys)].tolist()))
    if shape is None:
        return srow, None
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    nw = int(np.prod(shape[:-1], dtype=np.int64)) * ((shape[-1] + 31) // 32)
    bits = vals[len(keys):]
    return srow, (_unbits(bits[:nw], shape), _unbits(bits[nw:], shape))


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


def _index_of(handles: list, p: dict) -> int:
    """Position of ``p`` in ``handles`` by identity (handles hold tensors,
    which ``==`` cannot compare)."""
    return next(i for i, q in enumerate(handles) if q is p)


class GenoRunner:
    """Single-device geno on a torch device (``cuda`` by default; ``cpu``
    only when asked for).

    ``queued_orientation=True`` (default) runs each read forward once and
    queues only failed reads' reverse complements into later batches;
    ``False`` runs both orientations of every batch inline (twice the
    device work a batch, the same counts). ``vote`` replaces the vote
    implementation (the kernel wrapper by default); ``metrics_path`` is
    where ``meter.emit()`` appends its jsonl throughput line.

    Chained accumulation: the running totals go straight through each step
    as its accumulator inputs, and its outputs become the new totals, so a
    batch dispatched behind an unchecked one builds on that one's counts.
    An overflow REWINDS to the tripping batch's input totals and
    re-dispatches it and every later in-flight batch in order
    (``_chain_rewind``), so the rebuilt chain holds every batch once. No
    step writes its accumulators in place (``pileup_accumulate``)."""

    _producer_upload = True   # G = 1 queued batches upload off-thread

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
        self.n_retry_batches = 0   # batches of them dispatched
        self.n_escalations = 0   # batch redos after an overflow
        self.n_rewinds = 0       # later in-flight batches an escalation
                                 # re-dispatched
        self.n_vcf_native = 0    # VCF rewrites by the native pass
        self.n_vcf_fallback = 0  # and by the Python loop
        self._inflight: list = []   # dispatched handles, dispatch order
        self._worker: Optional[FetchWorker] = None   # while a loop runs
        self._up_stream = None   # the producer thread's upload stream
        self._tune_max: dict = {}   # per-batch telemetry maxima
        self._tune_seen = 0
        self._tuned = not config.auto_tune
        self.meter = Meter(metrics_path)
        # the host loop's seconds by stage: the main thread's read_batch,
        # dispatch, retry_dispatch, finalize_wait and enqueue_retry, the
        # producer thread's producer.parse, producer.encode and
        # producer.upload, and write_vcf's vcf_calls and vcf_write
        self.timer = StageTimer(sync=False)

    def _proc(self, cfg: GenoConfig):
        proc = self._procs.get(cfg)
        if proc is None:
            proc = self._procs[cfg] = make_batch_processor(self.dix, cfg,
                                                           self.vote)
        return proc

    # --- hooks a mesh runner overrides (dist.sharding): the reads of one
    # host-loop batch, the count layout, the uploads, and how one attempt
    # of a batch is issued and settled ---

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

    def _upload_group(self, encs, quals):
        """G pre-encoded sub-batches as one (G, B, ...) stack."""
        return upload(self.device,
                      tuple(np.stack(a) for a in zip(*encs)),
                      np.stack(quals))

    def _upload_codes(self, codes, n_kmers, qual):
        """A host batch of (B, L) base codes as the codes step's
        arguments."""
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (codes, n_kmers, qual)]

    def _upload_async(self, enc, qual):
        """(args, event): a batch uploaded from the producer thread. On a
        card the copies run on a side stream, and ``_adopt`` makes the
        compute stream wait for them."""
        if self.device.type != "cuda":
            return self._upload(enc, qual), None
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._up_stream):
            args = self._upload(enc, qual)
            ev = torch.cuda.Event()
            ev.record(self._up_stream)
        return args, ev

    def _adopt(self, args, ev):
        """A producer-thread upload handed to the compute stream: it waits
        for the copies, and the allocator keeps each tensor until the
        compute stream is done with it."""
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in args:
                t.record_stream(cur)
        return args

    def _mask_shape(self, kind: str, args):
        """The (process, read_ok) mask shape of one device's vector."""
        if kind == "dual":
            return None
        return tuple(args[0].shape[:2 if kind == "group" else 1])

    def _issue(self, procs, args, kind: str, totals):
        """Issue one attempt from the totals ``totals``; nothing is synced.
        Returns (ref_cnt, alt_cnt, stat keys, packed vectors)."""
        rc, ac, keys, vec = step_vec(procs, args, kind, *totals)
        return rc, ac, keys, [vec]

    def _settle(self, keys, vals, shape):
        """(stats, tune, masks) of an attempt from its fetched vectors:
        the stats row that escalation reads, the values auto-tune reads,
        and the host (process, read_ok) masks (None for the dual step)."""
        srow, masks = unpack_vec(vals[0], keys, shape)
        return srow, srow, masks

    # --- the dispatch pipeline (JAX ``_dispatch_batch`` /
    # ``_finalize_batch`` / ``_chain_rewind``) ---

    def _dispatch(self, kind: str, args) -> dict:
        """Issue a batch (or a group) on the running totals at the current
        config and return its in-flight handle: the totals it started from
        (the rewind point), its stat keys and mask shape, and its
        ``Fetch``, handed to the fetch worker when one runs. The totals
        move on to its outputs at once."""
        cfg = self._cfg_run
        totals = (self.ref_cnt, self.alt_cnt)
        rc, ac, keys, vecs = self._issue(self._proc(cfg), args, kind,
                                         totals)
        p = dict(kind=kind, args=args, cfg=cfg, keys=keys,
                 shape=self._mask_shape(kind, args), fetch=Fetch(vecs),
                 totals_in=totals, rounds=0)
        self.ref_cnt, self.alt_cnt = rc, ac
        self._inflight.append(p)
        if self._worker is not None:
            self._worker.submit(p["fetch"])
        return p

    def _finalize(self, p: dict):
        """Settle handle ``p``; while a capacity tripped, escalate and redo
        it (with every later in-flight batch) from the totals it started
        at; then commit its stats. Returns its masks."""
        while True:
            stats, tune, masks = self._settle(p["keys"], p["fetch"].result(),
                                              p["shape"])
            tripped = [k for k, v in stats.items() if "overflow" in k and v]
            if not tripped or p["rounds"] >= self.config.auto_retry_max:
                break
            new_cfg = _escalate_config(self._cfg_run, tripped)
            if new_cfg == self._cfg_run and p["cfg"] == self._cfg_run:
                break   # caps already at their limits for this attempt
            # a sibling in flight may have escalated _cfg_run past the
            # config this attempt ran at: then redo at the current one
            self._cfg_run = new_cfg
            rounds = p["rounds"] + 1
            self.n_escalations += 1
            self._chain_rewind(p)
            p["rounds"] = rounds
        del self._inflight[_index_of(self._inflight, p)]
        self._bump(stats)
        if not self._tuned:
            self._maybe_tune(tune)
        return masks

    def _chain_rewind(self, p: dict) -> None:
        """Restore the totals to before ``p``'s (truncated) contribution,
        then re-dispatch ``p`` and every LATER in-flight handle in
        dispatch order, each updated IN PLACE so the loop's deque sees the
        redone dispatches."""
        i = _index_of(self._inflight, p)
        redo = self._inflight[i:]
        del self._inflight[i:]
        self.ref_cnt, self.alt_cnt = p["totals_in"]
        for q in redo:
            rounds = q["rounds"]
            q.update(self._dispatch(q["kind"], q["args"]))
            q["rounds"] = rounds
            self._inflight[-1] = q
        self.n_rewinds += len(redo) - 1

    @contextlib.contextmanager
    def _fetching(self):
        """A host loop's fetch worker; the in-flight list is empty after
        it (a loop that raised leaves no handle behind)."""
        self._worker = FetchWorker()
        try:
            yield
        finally:
            self._worker.stop()
            self._worker = None
            self._inflight.clear()

    def run_batch(self, enc, qual, n_kmers=None):
        """Run one pre-encoded batch to an overflow-free (or retry-capped)
        attempt, then commit its counts (dispatch + finalize, nothing else
        in flight). Without ``n_kmers`` it is one orientation, and the host
        (process, read_ok) masks come back for the retry queue; with
        ``n_kmers`` (each read's k-mer count) it is the dual step, which
        returns None."""
        dual = n_kmers is not None
        p = self._dispatch("dual" if dual else "enc",
                           self._upload(enc, qual, n_kmers))
        return self._finalize(p)

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
        with self._fetching():
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

    def _parsed(self, fastq_path, skip):
        """The host loop's read batches, each parse timed as the stage
        ``producer.parse`` (the last one finds the end of the stream)."""
        st = self.timer
        it = iter(self._read_batches(fastq_path, skip))
        while True:
            with st.stage("producer.parse"):
                b = next(it, None)
            if b is None:
                return
            yield b

    def _batches(self, fastq_path, skip):
        """Encoded batches from a producer thread: (batch, enc) pairs in a
        generator that stops its thread when closed."""
        encode = _encoder(self.config.max_kmers_per_read)
        st = self.timer

        def produce():
            for b in self._parsed(fastq_path, skip):
                with st.stage("producer.encode"):
                    e = encode(b.codes, b.n_kmers)
                yield b, e

        return contextlib.closing(prefetch(produce(), depth=3)), encode

    def _dual_depth(self) -> int:
        """Dual batches kept in flight: one pending behind the newest (JAX
        GenoRunner's non-queued loop); a multi-process runner keeps
        ``pipeline_depth``."""
        return 1

    def _consume_dual(self, fastq_path, skip, limit_batches,
                      checkpoint_path, checkpoint_every):
        batches, _ = self._batches(fastq_path, skip)
        depth = self._dual_depth()
        st = self.timer
        inflight: deque = deque()
        nb = 0

        def finalize_one():
            p = inflight.popleft()
            with st.stage("finalize_wait"):
                self._finalize(p)
            self.meter.bump(p["count"])

        with batches as it:
            while True:
                with st.stage("read_batch"):
                    item = next(it, None)
                if item is None:
                    break
                batch, enc = item
                self.n_reads += reads_of(batch)
                with st.stage("dispatch"):
                    p = self._dispatch("dual", self._upload(
                        enc, batch.qual, batch.n_kmers))
                p["count"] = reads_of(batch)
                inflight.append(p)
                nb += 1
                while len(inflight) > depth:
                    finalize_one()
                if checkpoint_path and nb % checkpoint_every == 0:
                    while inflight:
                        finalize_one()
                    self._ckpt_save(checkpoint_path)
                if limit_batches and nb >= limit_batches:
                    break
        while inflight:
            finalize_one()

    def _consume_queued(self, fastq_path, skip, limit_batches,
                        checkpoint_path, checkpoint_every):
        """The queued host loop (JAX ``_consume_queued``): up to
        ``pipeline_depth`` batches in flight (more, up to depth + 6, while
        the head has not landed), each synced by the fetch worker; failed
        reads queued from the finalized masks; with ``pre_encode`` groups
        of ``group_size`` sub-batches a dispatch, else the codes step.
        Everything staged or in flight is finalized and the retry queue run
        dry before a checkpoint and at the end."""
        cfg = self.config
        B = self._loop_batch()
        depth = max(1, cfg.pipeline_depth)
        hard = depth + 6   # bounds device memory and a rewind's cost
        encode = _encoder(cfg.max_kmers_per_read) if cfg.pre_encode else None
        G = max(1, cfg.group_size) if encode is not None else 1
        st = self.timer
        pend: list = []     # queued (codes, nk, qual) reverse complements
        pend_n = 0
        nb = 0
        inflight: deque = deque()
        stage_buf: list = []   # staged (enc, qual, count, host) sub-batches

        def launch(kind, args, count, hosts):
            p = self._dispatch(kind, args)
            p["count"] = count
            p["hosts"] = hosts
            inflight.append(p)

        def dispatch(codes, nk, qual, count, host, enc=None, args=None):
            """host = (codes, nk, qual, n_valid) for a forward batch whose
            failures are re-queued reverse-complemented, None for a retry
            batch (the reference tries two orientations, qv.cc:1504-1510);
            ``enc`` / ``args``: the producer thread's encoding / upload."""
            nonlocal nb
            self.n_reads += count
            if host is None:
                self.n_retry_batches += 1
            nb += 1
            if encode is None:
                launch("codes", self._upload_codes(codes, nk, qual), count,
                       [host])
            elif args is not None:
                launch("enc", args, count, [host])
            else:
                stage_buf.append((encode(codes, nk) if enc is None else enc,
                                  qual, count, host))
                flush_stage()

        def flush_stage(force=False):
            """Full groups go as one grouped dispatch; on force, the
            leftovers go one by one."""
            while G > 1 and len(stage_buf) >= G:
                grp = stage_buf[:G]
                del stage_buf[:G]
                launch("group", self._upload_group([g[0] for g in grp],
                                                   [g[1] for g in grp]),
                       sum(g[2] for g in grp), [g[3] for g in grp])
            while stage_buf and (force or G == 1):
                enc, qual, count, host = stage_buf.pop(0)
                launch("enc", self._upload(enc, qual), count, [host])

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

        def pump(force=False):
            while inflight and (force or len(inflight) > depth):
                if (not force and len(inflight) <= hard
                        and not inflight[0]["fetch"].landed):
                    break   # keep dispatching; the worker flags it landed
                p = inflight.popleft()
                with st.stage("finalize_wait"):
                    process, read_ok = self._finalize(p)
                self.meter.bump(p["count"])
                hosts = p["hosts"]
                if all(h is None for h in hosts):
                    continue
                with st.stage("enqueue_retry"):
                    if p["kind"] != "group":
                        enqueue_failures(*hosts[0], process, read_ok)
                        continue
                    for g, h in enumerate(hosts):   # a group's rows
                        if h is not None:
                            enqueue_failures(*h, process[g], read_ok[g])

        def flush_pending(force=False):
            nonlocal pend_n
            while pend_n >= B or (force and pend_n > 0):
                with st.stage("retry_dispatch"):
                    codes, nk, qual, got = self._take_queued(pend, B)
                    # the queue moves BEFORE pump(): finalizing a forward
                    # batch there may append retries
                    pend_n -= got
                    dispatch(codes, nk, qual, 0, None)
                pump()

        def drain():
            # finalize everything staged and in flight, then run the retry
            # queue dry (finalizing a retry batch never enqueues more)
            flush_stage(force=True)
            pump(force=True)
            flush_pending(force=True)
            flush_stage(force=True)
            pump(force=True)

        # G = 1: the producer thread also uploads (JAX ``pre_up``); grouped
        # staging stacks on the host, and a mesh splits rows per shard
        pre_up = encode is not None and G == 1 and self._producer_upload
        if pre_up and self.device.type == "cuda" and self._up_stream is None:
            self._up_stream = torch.cuda.Stream(self.device)

        def produce():
            for b in self._parsed(fastq_path, skip):
                if encode is None:
                    yield b, None, None
                    continue
                with st.stage("producer.encode"):
                    e = encode(b.codes, b.n_kmers)
                up = None
                if pre_up:
                    with st.stage("producer.upload"):
                        up = self._upload_async(e, b.qual)
                yield b, e, up

        with contextlib.closing(prefetch(produce(), depth=3)) as it:
            while True:
                with st.stage("read_batch"):
                    item = next(it, None)
                if item is None:
                    break
                batch, enc, up = item
                with st.stage("dispatch"):
                    dispatch(batch.codes, batch.n_kmers, batch.qual,
                             batch.n_valid,
                             (batch.codes, batch.n_kmers, batch.qual,
                              batch.n_valid), enc=enc,
                             args=None if up is None else self._adopt(*up))
                pump()
                flush_pending()
                if checkpoint_path and nb % checkpoint_every == 0:
                    drain()   # a checkpoint holds no queued or in-flight read
                    self._ckpt_save(checkpoint_path)
                if limit_batches and nb >= limit_batches:
                    break
        drain()

    def _take_queued(self, segs: list, B: int):
        """Up to B queued reads off the front of ``segs`` (a list of
        (codes, n_kmers, qual) segments, consumed in place), padded with
        empty reads to B rows: (codes, n_kmers, qual, reads taken)."""
        cfg = self.config
        tc, tk, tq = [], [], []
        got = 0
        while segs and got < B:
            c0, k0, q0 = segs[0]
            need = B - got
            if c0.shape[0] <= need:
                segs.pop(0)
            else:
                segs[0] = (c0[need:], k0[need:], q0[need:])
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
        """The calls (the count fetch and ``finalize_calls``, stage
        ``vcf_calls``), then the VCF rewrite (stage ``vcf_write``)."""
        with self.timer.stage("vcf_calls"):
            table = self.calls()
        self._rewrite(vcf_in, vcf_out, table)

    def _rewrite(self, vcf_in: str, vcf_out: str, table) -> None:
        """The VCF rewrite (stage ``vcf_write``), counted by the path that
        ran in ``n_vcf_native`` / ``n_vcf_fallback``."""
        with self.timer.stage("vcf_write"):
            path = write_calls_vcf(vcf_in, vcf_out, table)
        if path == "native":
            self.n_vcf_native += 1
        else:
            self.n_vcf_fallback += 1

