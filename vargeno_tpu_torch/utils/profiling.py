"""Tracing / profiling / metrics (port of ``vargeno_tpu/utils/profiling.py``).

- ``span(name)``: a named range on the profiler's timeline
  (``torch.profiler.record_function``) while a profiler runs; otherwise a
  shared null context, after one flag check. Spans keep no clock of their
  own: in a trace they stand on the profiler's clock beside the kernels,
  copies and sets they launched.
- ``trace(dir)``: context manager around ``torch.profiler`` that writes a
  Chrome trace (``<dir>/trace.json``, viewable in Perfetto) of every
  thread's spans and host operations and, when there is a card, of the
  device.
- ``StageTimer``: wall time per named stage, recorded from any thread, with
  a device sync at the end of a stage where one is asked for; each stage
  is also a span ``stage.<name>``.
- ``Meter``: throughput counter (reads/s, batches/s) with jsonl export.
- ``device_ms``: median time of a function on a device, from CUDA events on
  the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import threading
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler runs, else a shared null
    context: a ``record_function`` entered with no profiler still costs
    microseconds, the flag check a fraction of one."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _all_threads():
    """A profiler config that records every thread (the producer's
    stages), where this torch offers one; else None, the default."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, experimental_config=_all_threads()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name))


class StageTimer:
    """Seconds and calls by stage name; stages may be recorded from several
    threads at once. Durations only: the timeline is the profiler's, where
    each stage is the span ``stage.<name>``."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Optional[torch.device] = None):
        """``block_on``: the CUDA device whose queued work belongs to the
        stage; it is synchronized before the clock is read."""
        with span("stage." + name):
            t0 = time.perf_counter()
            yield
            if self.sync and block_on is not None \
                    and torch.device(block_on).type == "cuda":
                torch.cuda.synchronize(block_on)
            dt = time.perf_counter() - t0
        with self._lock:
            if name in self.totals:
                self.totals[name] += dt
                self.counts[name] += 1
            else:   # a new key: a reader copying the dicts never sees
                    # them grow under it
                self.totals = {**self.totals, name: dt}
                self.counts = {**self.counts, name: 1}

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:9.3f}s  x{n:<6d} "
                         f"{1e3*total/max(n,1):8.2f} ms/call")
        return "\n".join(lines)


class Meter:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.t0 = time.time()
        self.reads = 0
        self.batches = 0
        self.extra: Dict[str, int] = {}

    def bump(self, reads: int, **counters) -> None:
        self.reads += reads
        self.batches += 1
        for k, v in counters.items():
            self.extra[k] = self.extra.get(k, 0) + int(v)

    def snapshot(self) -> dict:
        dt = max(time.time() - self.t0, 1e-9)
        d = dict(reads=self.reads, batches=self.batches,
                 elapsed_s=round(dt, 3),
                 reads_per_sec=round(self.reads / dt, 1))
        d.update(self.extra)
        return d

    def emit(self, stages: Optional[Dict[str, float]] = None,
             **counters) -> dict:
        """Append the snapshot and ``counters`` as one json line;
        ``stages``: seconds by stage (a ``StageTimer``'s totals), kept
        under ``stages``."""
        snap = self.snapshot()
        snap.update(counters)
        if stages is not None:
            snap["stages"] = dict(stages)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        return snap


def device_ms(fn, device: torch.device | str, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` timed runs after one
    warm-up run. On a CUDA device each run is bracketed by CUDA events on
    the current stream; on the CPU by the host clock."""
    device = torch.device(device)
    fn()
    times = []
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
