"""Multi-process geno on ``torch.distributed`` (port of
``vargeno_tpu/dist/multihost.py``).

P processes, each driving local_D shards of one mesh of D = P x local_D
shards: process p holds global shard ranks p*local_D .. (p+1)*local_D - 1.

- ``initialize`` joins the process group at an address given outright
  (``tcp://HOST:PORT``), with the world size and this process's rank. The
  data group (the routed step's all-to-alls) uses the backend the caller
  names: ``nccl`` on the cards, ``gloo`` on the host. A ``gloo`` control
  group carries the host-side traffic: the stats rows, the count merge
  and the barriers. Nothing swaps one backend for another: if NCCL fails,
  the run fails. ``timeout`` bounds every collective, so a dead or stalled
  peer ends the run in an error instead of parking the others.
- Each process reads only its stripe of the FASTQ
  (``io.fastq.iter_read_batches_strided``): global batch g is the file's
  reads [g*GB, (g+1)*GB); process p parses rows [p*LB, (p+1)*LB) of it and
  skips the rest. Every stripe yields the same number of batches with the
  same ``global_n_valid``, so the host loops stay aligned.
- Stats are replicated: every attempt of a batch all-gathers each shard's
  stats row over the control group, so every process sees every shard's
  row and takes the same escalation and auto-tune decisions, and so makes
  the same collectives in the same order.
- Queued orientation (the default) is LOCKSTEP QUEUED RETRY, with
  ``pipeline_depth`` batches in flight: forward batches run one
  orientation; retry batches are scheduled from a
  per-process pending vector derived from the replicated per-shard
  ``retry_n`` stat alone, so every process fires them at the same loop
  points. A process fills its rows of a retry batch from its own queue
  (a retry stays on the process that parsed the read; counts are
  order-independent sums) and pads the rest; a local queue that disagrees
  with the replicated count is a desync error. With
  ``queued_orientation=False`` every batch runs both orientations in one
  step (GenoRunner's dual loop over the stripes, ``pipeline_depth`` of
  them in flight). A batch is finalized when more than ``pipeline_depth``
  are in flight, a decision on counts alone: the per-attempt stats
  all-gather and the routed step's exchange then meet in the same order
  in every process.
- Per-site counts stay per shard and are summed over the control group in
  ``host_counts``. Checkpoints hold the merged counts and the global read
  count, in the single-process file format: process 0 writes them and a
  barrier follows, and a run may resume on another process count, on one
  process, or in the JAX package. Only process 0 writes the VCF.
"""

from __future__ import annotations

import dataclasses
import datetime
import zlib
from collections import deque
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG, GenoConfig
from ..engine import checkpoint as ckpt
from ..engine.geno import revcomp_select_host
from ..index import store
from ..io.fastq import iter_read_batches_strided
from .sharded_dict import ShardedDictGenoRunner
from .sharding import DEFAULT_TIMEOUT, Mesh, ShardedGenoRunner

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Cluster:
    """This process's place in the process group (``initialize``)."""

    rank: int
    size: int
    backend: str      # the data group's (the default group)
    timeout: float    # seconds, every collective and mesh wait
    ctrl: object      # the gloo control group


def initialize(init_method: str, world_size: int, rank: int, backend: str,
               timeout: float = DEFAULT_TIMEOUT) -> Cluster:
    """Join the process group at ``init_method`` (``tcp://HOST:PORT``) as
    ``rank`` of ``world_size``: the data group over ``backend``, and a gloo
    control group. Every process of the group calls it with the same
    address, size, backend and timeout."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    td = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=td)
    ctrl = dist.new_group(backend="gloo", timeout=td)
    return Cluster(rank, world_size, backend, timeout, ctrl)


def barrier(cluster: Cluster) -> None:
    dist.barrier(group=cluster.ctrl)


def shutdown(cluster: Cluster) -> None:
    """Wait for every process, then leave the process group."""
    barrier(cluster)
    dist.destroy_process_group()


class ProcessMesh(Mesh):
    """A mesh over every process of ``cluster``: this process's shards are
    ``devices``, global ranks ``cluster.rank * len(devices) + i``; D =
    cluster.size x len(devices).

    ``all_to_all`` keeps the single-process contract. The local shards'
    threads post their (D, ...) buffers; local shard 0's thread then
    issues one ``dist.all_to_all_single`` between the processes, and each
    thread takes its (D, ...) receive slice. One local shard needs no
    thread. Over gloo, which moves host memory, the exchange copies the
    buffers to the host and the answers back to each shard's device
    itself: that is gloo's transport, not a fallback. Over nccl it runs on
    ``devices[0]``."""

    def __init__(self, cluster: Cluster, devices: Sequence):
        super().__init__(devices, cluster.timeout)
        self.cluster = cluster
        self.size = cluster.size * len(self.devices)
        self.offset = cluster.rank * len(self.devices)
        self._recv: list = []
        if self.devices[0].type == "cuda":
            # this process's card is its current device: NCCL's, and where
            # pinned host buffers and events take their context
            torch.cuda.set_device(self.devices[0])

    def all_to_all(self, rank: int, buf: torch.Tensor) -> torch.Tensor:
        i = rank - self.offset
        if len(self.devices) == 1:
            return self._exchange([buf])[0]
        self._slots[i] = buf
        self._wait()
        if i == 0:
            self._recv = self._exchange(self._slots)
        self._wait()
        return self._recv[i]

    def _exchange(self, bufs) -> list:
        L, P = len(self.devices), self.cluster.size
        home = (self.devices[0] if self.cluster.backend == "nccl"
                else torch.device("cpu"))
        rest = bufs[0].shape[1:]
        # (L src, P, L dst, ...) -> (P, L src, L dst, ...): row p goes to
        # process p
        send = torch.stack([b.to(home) for b in bufs])
        send = send.reshape(L, P, L, *rest).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        # recv[p, i, j]: what global shard p*L + i sent to local shard j
        return [recv[:, :, j].reshape(self.size, *rest).to(dev)
                for j, dev in enumerate(self.devices)]


class _MultiHostMixin:
    """Overrides that turn a single-process mesh runner into one process
    of a multi-process run. Mix in FRONT of ShardedGenoRunner /
    ShardedDictGenoRunner; the mesh must be a ``ProcessMesh``."""

    def __init__(self, index: store.VarGenoIndex, mesh: ProcessMesh,
                 config: GenoConfig = DEFAULT_CONFIG, **kw):
        if not isinstance(mesh, ProcessMesh):
            raise TypeError("a multi-process runner needs a ProcessMesh")
        self.cluster = mesh.cluster
        self._rows: list = []      # every shard's stats row, last attempt
        super().__init__(index, mesh, config, **kw)

    # --- replicated stats, merged counts, checkpoints, the VCF ---

    def _merge_rows(self, keys, rows) -> list:
        """Every process's shard rows, in global shard order, on every
        process (one all_gather over the control group). Each row carries
        a checksum of the stat keys, so processes that run different
        steps fail here instead of deciding on misread rows."""
        sig = zlib.crc32(",".join(keys).encode())
        local = torch.tensor([[r[k] for k in keys] + [sig] for r in rows],
                             dtype=torch.int64)
        parts = [torch.empty_like(local) for _ in range(self.cluster.size)]
        with self.timer.stage("stats_gather"):
            dist.all_gather(parts, local, group=self.cluster.ctrl)
        table = torch.cat(parts)
        if bool((table[:, -1] != sig).any()):
            raise RuntimeError("multihost stats desync: the processes' "
                               "steps report different stat keys")
        self._rows = [dict(zip(keys, r[:-1])) for r in table.tolist()]
        return self._rows

    def host_counts(self):
        """The counts summed over every shard of every process (a
        collective: every process calls it)."""
        rc, ac = super().host_counts()
        both = torch.from_numpy(np.stack([rc, ac]).astype(np.int64))
        dist.all_reduce(both, group=self.cluster.ctrl)
        both = both.numpy().astype(np.int32)
        return both[0], both[1]

    def _restore_ckpt(self, rc, ac) -> None:
        """The merged totals go to process 0's first shard, zeros
        elsewhere: exact, since counts are sums."""
        if self.cluster.rank == 0:
            super()._restore_ckpt(rc, ac)
        else:
            self.ref_cnt, self.alt_cnt = self._fresh_counts()

    def _ckpt_save(self, path: str) -> None:
        counts = self.host_counts()   # collective: every process runs it
        if self.cluster.rank == 0:
            ckpt.save(path, *counts, self.n_reads)
        barrier(self.cluster)

    def write_vcf(self, vcf_in: str, vcf_out: str) -> None:
        with self.timer.stage("vcf_calls"):
            table = self.calls()   # collective (host_counts)
        if self.cluster.rank == 0:
            self._rewrite(vcf_in, vcf_out, table)
        barrier(self.cluster)

    # --- the host loops ---

    def _read_batches(self, fastq_path, skip):
        cfg = self.config
        return iter_read_batches_strided(
            fastq_path, self._loop_batch(), self.cluster.size,
            self.cluster.rank, cfg.max_read_len, cfg.max_kmers_per_read,
            skip_reads=skip)

    def _dual_depth(self) -> int:
        return max(1, self.config.pipeline_depth)

    def _consume_queued(self, fastq_path, skip, limit_batches,
                        checkpoint_path, checkpoint_every):
        """Lockstep queued retry with ``pipeline_depth`` batches in flight
        (JAX ``_consume_queued_mh``). ``pend[p]`` is process p's count of
        queued reverse complements, identical on every process because it
        is summed from the replicated ``retry_n`` rows of finalized
        forward batches only; a retry batch fires wherever some process
        has a whole batch of them (and at a checkpoint and the end, until
        all are done). Every finalize decision depends on counts alone
        (``len(inflight) > depth``), never on whether a batch has landed
        here, so every process makes the same collectives in the same
        order. Groups are not formed (as in JAX). ``limit_batches`` counts
        forward batches. The stages are GenoRunner's (``read_batch``,
        ``dispatch``, ``retry_dispatch``, ``finalize_wait``), with
        ``stats_gather`` inside ``finalize_wait``."""
        P, me, L = self.cluster.size, self.cluster.rank, self.local_D
        LB = self._loop_batch()
        depth = max(1, self.config.pipeline_depth)
        st = self.timer
        batches, encode = self._batches(fastq_path, skip)
        pend = np.zeros(P, np.int64)
        queue: list = []   # this process's (codes, n_kmers, qual) segments
        inflight: deque = deque()
        nb = 0

        def launch(enc, qual, count, host):
            p = self._dispatch("enc", self._upload(enc, qual))
            p["count"] = count
            p["host"] = host
            inflight.append(p)

        def dispatch_retry():
            with st.stage("retry_dispatch"):
                take = np.minimum(pend, LB)
                codes, nk, qual, got = self._take_queued(queue, LB)
                if got != int(take[me]):
                    raise RuntimeError(
                        f"multihost retry desync: the replicated stats say "
                        f"{int(take[me])} reads are pending here, the local "
                        f"queue held {got}")
                pend[:] -= take
                self.n_retry_reads += int(take.sum())
                self.n_retry_batches += 1
                launch(encode(codes, nk), qual, 0, None)

        def finalize_one():
            p = inflight.popleft()
            with st.stage("finalize_wait"):
                process, read_ok = self._finalize(p)
            self.meter.bump(p["count"])
            if p["host"] is None:
                return
            rn = np.asarray([r["retry_n"] for r in self._rows], np.int64)
            pend[:] += rn.reshape(P, L).sum(axis=1)
            codes, nk, qual = p["host"]
            sel = np.flatnonzero((~process) & read_ok & (nk > 0))
            if sel.size:
                queue.append(revcomp_select_host(codes, nk, qual, sel))
            while pend.max() >= LB:
                dispatch_retry()

        def drain():
            while inflight:
                finalize_one()
            while pend.max() > 0:
                dispatch_retry()
                while inflight:
                    finalize_one()

        with batches as it:
            while True:
                with st.stage("read_batch"):
                    item = next(it, None)
                if item is None:
                    break
                batch, enc = item
                self.n_reads += batch.global_n_valid
                with st.stage("dispatch"):
                    launch(enc, batch.qual, batch.global_n_valid,
                           (batch.codes, batch.n_kmers, batch.qual))
                nb += 1
                while len(inflight) > depth:
                    finalize_one()
                if checkpoint_path and nb % checkpoint_every == 0:
                    drain()   # a checkpoint holds no queued reads
                    self._ckpt_save(checkpoint_path)
                if limit_batches and nb >= limit_batches:
                    break
        drain()


class MultiHostGenoRunner(_MultiHostMixin, ShardedGenoRunner):
    """Data-parallel geno across processes: every process holds the
    replicated index, once per distinct local device."""


class MultiHostDictGenoRunner(_MultiHostMixin, ShardedDictGenoRunner):
    """Sharded-dictionary geno across processes: the dictionaries are
    partitioned over the global D shards and each process places only its
    own shards, so P processes hold an index P times larger than one
    process's devices; probes route through ``ProcessMesh.all_to_all``."""
