"""Multi-device execution: data-parallel read streaming over a mesh of torch
devices (port of ``vargeno_tpu/dist/sharding.py``).

- Reads are the data axis: each of the D shards runs ``batch_reads`` reads
  a step (global batch = D x batch_reads) against a replicated index, one
  copy of it on each distinct device.
- The JAX runner is one ``shard_map`` program; here the host thread
  dispatches the D shard steps in turn. Launches are asynchronous, so one
  GPU runs while the next is fed, and the batch syncs the host once per
  device.
- Pileup counts stay per shard and are merged at ``host_counts`` (and so at
  checkpoint time). Per-SNP counts are order-independent sums, so the late
  merge is exact, and a checkpoint holds the merged (n + 1,) layout: a
  single-device checkpoint resumes on a mesh and the other way round.
- The shards' totals CHAIN through the steps as the single-device
  runner's do (a list of D tensors each), so batches stay in flight behind
  unchecked ones and an escalation rewinds every shard to the tripping
  batch's input totals (``GenoRunner._chain_rewind``). The JAX mesh uses
  fresh per-batch buffers and a late merge instead; the counts are the
  same sums either way.

``ShardedGenoRunner`` subclasses the single-device ``GenoRunner`` and keeps
its whole host loop (producer-thread encode, the dispatch pipeline --
``pipeline_depth`` batches in flight, grouped dispatch -- queued
reverse-complement retries or the inline dual step, overflow escalation
and rewind, auto-tune, checkpoints); it overrides the batch size, the
count layout, the uploads and how one attempt of a batch is issued and
settled. A mesh always ships pre-encoded words (``pre_encode`` is forced
on, as in JAX). The sharded-dictionary runner
(``dist.sharded_dict``) subclasses it and runs its shards in lockstep
through ``Mesh.run_lockstep``.

A mesh names its devices. ``make_mesh(n)`` takes ``cuda:0 .. n-1`` and
refuses more shards than visible GPUs; a device may repeat only where the
caller names the devices itself (on the host every device is ``cpu``; on a
one-GPU machine ``["cuda:0", "cuda:0"]`` exercises real D = 2 routing as a
check, not a deployment).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, GenoConfig
from ..engine.batch import make_batch_processor
from ..engine.device_index import from_numpy, host_fields
from ..engine.geno import GenoRunner, step_vec, unpack_vec, upload
from ..index import store
from ..kernels.vote import vote_scan_records

DEFAULT_TIMEOUT = 300.0   # seconds a shard may wait at a collective


class MeshAborted(RuntimeError):
    """A collective was abandoned: another shard failed or a wait timed
    out."""


class Mesh:
    """D shards, each on a torch device, and the one collective that the
    routed backend needs (``all_to_all``). ``run_lockstep`` runs one
    callable a shard, each on its own thread, so every shard's step can
    meet at each collective; ``timeout`` bounds every wait there and the
    whole lockstep call.

    ``size`` is the global shard count D and ``all_to_all`` takes a global
    shard rank; ``devices`` are this process's shards, global ranks
    ``offset .. offset + len(devices) - 1``. One process holds every
    shard here (offset 0); ``dist.multihost.ProcessMesh`` spans
    processes."""

    def __init__(self, devices: Sequence, timeout: float = DEFAULT_TIMEOUT):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.offset = 0
        self.timeout = timeout
        self._barrier = threading.Barrier(len(self.devices), timeout=timeout)
        self._slots: list = [None] * len(self.devices)

    def device_ctx(self, i: int):
        """The CUDA device guard of local shard ``i`` (nothing on the
        host)."""
        dev = self.devices[i]
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _wait(self) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise MeshAborted("a mesh collective was abandoned (another "
                              "shard failed, or a wait passed "
                              f"{self.timeout} s)") from None

    def all_to_all(self, rank: int, buf: torch.Tensor) -> torch.Tensor:
        """Shard ``rank`` sends ``buf[d]`` to shard d; returns (D, ...) on
        its own device with row s = what shard s sent it. Every shard must
        call it, in the same order: the first barrier waits until all have
        posted, the second until all have read before a buffer is
        dropped."""
        if self.size == 1:
            return buf
        self._slots[rank] = buf
        self._wait()
        dev = self.devices[rank]
        out = torch.stack([self._slots[s][rank].to(dev)
                           for s in range(self.size)])
        self._wait()
        return out

    def run_lockstep(self, fns: Sequence) -> list:
        """Run ``fns[r]()`` for every shard r on its own thread (under its
        device guard) and return the results in shard order. If a shard
        raises, the collectives abort and the first exception that is not
        the abort itself is raised here; if the call outlasts the timeout,
        TimeoutError. Never a silent partial result."""
        n = len(self.devices)
        if len(fns) != n:
            raise ValueError(f"{len(fns)} callables for {n} shards")
        results: list = [None] * n
        errors: list = [None] * n

        def work(r):
            try:
                with self.device_ctx(r):
                    results[r] = fns[r]()
            except BaseException as e:   # re-raised in the calling thread
                errors[r] = e
                self._barrier.abort()

        threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                    name=f"mesh-shard-{r}")
                   for r in range(n)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, t in enumerate(threads) if t.is_alive()]
        if hung:
            self._barrier.abort()   # frees any shard parked at a collective
            raise TimeoutError(f"mesh shards {hung} did not finish within "
                               f"{self.timeout} s")
        self._barrier.reset()
        self._slots = [None] * n
        first = [e for e in errors if e is not None
                 and not isinstance(e, MeshAborted)]
        if first:
            raise first[0]
        aborted = [e for e in errors if e is not None]
        if aborted:
            raise aborted[0]
        return results


def make_mesh(n_devices: Optional[int] = None, devices=None,
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """A mesh over ``devices`` as named, or by default over ``cuda:0 ..
    n-1``: more shards than visible GPUs is an error, never a quiet run on
    the host or on a repeated card."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"{n_devices} shards asked for but "
                             f"{len(devices)} devices named")
        return Mesh(devices, timeout)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (name the devices, "
                           "e.g. ['cpu'] * n, to run a mesh on the host)")
    avail = torch.cuda.device_count()
    n = avail if n_devices is None else n_devices
    if not 1 <= n <= avail:
        raise ValueError(f"requested a {n}-device mesh but {avail} CUDA "
                         f"device(s) are visible (a device repeats only "
                         f"when the caller names the devices)")
    return Mesh([f"cuda:{i}" for i in range(n)], timeout)


def device_bytes(tensors) -> int:
    """Bytes of the distinct tensor storages among ``tensors``."""
    seen = {}
    for t in tensors:
        if t.numel():
            seen[(t.device, t.untyped_storage().data_ptr())] = \
                t.untyped_storage().nbytes()
    return sum(seen.values())


class ShardedGenoRunner(GenoRunner):
    """Data-parallel geno over a mesh. The host feeds batches of
    local_D x batch_reads reads (local_D = the mesh's devices in this
    process, D of them in one process); local shard i runs reads
    [i*B, (i+1)*B) on ``mesh.devices[i]``. Inherits GenoRunner's host
    loop."""

    _producer_upload = False   # rows are split per shard from host arrays

    def __init__(self, index: store.VarGenoIndex, mesh: Mesh,
                 config: GenoConfig = DEFAULT_CONFIG,
                 vote=vote_scan_records, queued_orientation: bool = True,
                 metrics_path: Optional[str] = None):
        if not config.pre_encode:
            # the mesh dispatch path ships packed kmer words
            config = dataclasses.replace(config, pre_encode=True)
        self.mesh = mesh
        self.D = mesh.size   # global shard count
        self.local_D = len(mesh.devices)
        self.shards = self._prepare_shards(index, config)
        super().__init__(index, config, device=mesh.devices[0],
                         dix=self._dix_of(self.shards[0]), vote=vote,
                         queued_orientation=queued_orientation,
                         metrics_path=metrics_path)

    # --- the index (the sharded-dictionary runner overrides these) ---

    def _prepare_shards(self, index, config) -> list:
        """One replicated device index per distinct device, shared by the
        shards on it."""
        fields, statics = host_fields(index, config.ht_target_load)
        per_dev: dict = {}
        for dev in self.mesh.devices:
            if dev not in per_dev:
                per_dev[dev] = from_numpy(fields, statics, dev)
        return [per_dev[dev] for dev in self.mesh.devices]

    @staticmethod
    def _dix_of(shard):
        return shard

    def _processor(self, cfg: GenoConfig, rank: int):
        return make_batch_processor(self.shards[rank], cfg, self.vote)

    def _run_shards(self, fns) -> list:
        """The replicated index needs no collective: dispatch the shard
        steps in turn from this thread."""
        out = []
        for r, fn in enumerate(fns):
            with self.mesh.device_ctx(r):
                out.append(fn())
        return out

    def device_bytes(self) -> int:
        """Device bytes of the index tables, each distinct copy once."""
        return device_bytes(t for s in self.shards
                            for t in vars(self._dix_of(s)).values()
                            if isinstance(t, torch.Tensor))

    # --- GenoRunner hooks ---

    def _loop_batch(self) -> int:
        return self.local_D * self.config.batch_reads

    def _proc(self, cfg: GenoConfig):
        procs = self._procs.get(cfg)
        if procs is None:
            procs = self._procs[cfg] = [self._processor(cfg, r)
                                        for r in range(self.local_D)]
        return procs

    def _fresh_counts(self):
        n = self.dix.n_sites + 1
        rc = [torch.zeros(n, dtype=torch.int32, device=dev)
              for dev in self.mesh.devices]
        return rc, [torch.zeros_like(z) for z in rc]

    def _restore_ckpt(self, rc, ac) -> None:
        """Checkpoints hold merged counts; restoring the total into shard 0
        (the rest zero) is exact, since counts are sums."""
        self.ref_cnt, self.alt_cnt = self._fresh_counts()
        self.ref_cnt[0] = torch.from_numpy(
            np.ascontiguousarray(rc, np.int32)).to(self.mesh.devices[0])
        self.alt_cnt[0] = torch.from_numpy(
            np.ascontiguousarray(ac, np.int32)).to(self.mesh.devices[0])

    def host_counts(self):
        rc = np.sum([t.cpu().numpy() for t in self.ref_cnt], axis=0,
                    dtype=np.int32)
        ac = np.sum([t.cpu().numpy() for t in self.alt_cnt], axis=0,
                    dtype=np.int32)
        return rc, ac

    def _shard_rows(self, a, r, axis=0):
        """Shard ``r``'s rows of a host array (None stays None)."""
        if a is None:
            return None
        B = self.config.batch_reads
        return a[(slice(None),) * axis + (slice(r * B, (r + 1) * B),)]

    def _upload(self, enc, qual, n_kmers=None):
        return [upload(dev, tuple(self._shard_rows(a, r) for a in enc),
                       self._shard_rows(qual, r),
                       self._shard_rows(n_kmers, r))
                for r, dev in enumerate(self.mesh.devices)]

    def _upload_group(self, encs, quals):
        enc = tuple(np.stack(a) for a in zip(*encs))
        qual = np.stack(quals)
        return [upload(dev, tuple(self._shard_rows(a, r, 1) for a in enc),
                       self._shard_rows(qual, r, 1))
                for r, dev in enumerate(self.mesh.devices)]

    def _mask_shape(self, kind: str, args):
        return super()._mask_shape(kind, args[0])

    def _merge_rows(self, keys, rows) -> list:
        """The stats rows that the batch's decisions read: here this
        process's shards, which are all of them. A multi-process runner
        gathers every process's rows (``dist.multihost``)."""
        return rows

    def _issue(self, procs, args, kind: str, totals):
        """Every local shard's step from its own totals, one packed vector
        each."""
        outs = self._run_shards([
            functools.partial(step_vec, procs[r], args[r], kind,
                              totals[0][r], totals[1][r])
            for r in range(self.local_D)])
        return ([o[0] for o in outs], [o[1] for o in outs], outs[0][2],
                [o[3] for o in outs])

    def _settle(self, keys, vals, shape):
        """Stats over every shard's row (``_merge_rows``): ``*_max`` keys
        take the max over shards, the rest the sum; auto-tune reads each
        key's largest single-shard value (capacities are per-shard
        shapes); the masks are the shards' rows side by side."""
        rows, masks = zip(*(unpack_vec(v, keys, shape) for v in vals))
        rows = self._merge_rows(keys, list(rows))
        stats = {k: (max(r[k] for r in rows) if k.endswith("_max")
                     else sum(r[k] for r in rows)) for k in keys}
        tune = {k: max(r[k] for r in rows) for k in keys}
        if shape is not None:
            masks = tuple(np.concatenate([m[i] for m in masks], axis=-1)
                          for i in range(2))
        else:
            masks = None
        return stats, tune, masks
