"""Tracing / profiling / metrics (port of ``vargeno_tpu/utils/profiling.py``).

- ``trace(dir)``: context manager around ``torch.profiler`` that writes a
  Chrome trace (``<dir>/trace.json``, viewable in Perfetto) of the host and,
  when there is a card, of the device.
- ``StageTimer``: wall time per named stage, with a device sync at the end
  of a stage where one is asked for.
- ``Meter``: throughput counter (reads/s, batches/s) with jsonl export.
- ``device_ms``: median time of a function on a device, from CUDA events on
  the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Optional[torch.device] = None):
        """``block_on``: the CUDA device whose queued work belongs to the
        stage; it is synchronized before the clock is read."""
        t0 = time.perf_counter()
        yield
        if self.sync and block_on is not None \
                and torch.device(block_on).type == "cuda":
            torch.cuda.synchronize(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

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

    def emit(self) -> dict:
        snap = self.snapshot()
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
