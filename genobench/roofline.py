"""Peaks of the card and the operations and bytes a kernel needs, from
which a kernel's share of its roofline is worked out.

A kernel's bound on one launch is the larger of bytes / peak bandwidth and
operations / peak rate; its roofline share is the sum of the bounds of
the launches over the sum of their traced times. Bytes count each input
the launch needs read once and each output written once, as these
inputs need them (a read's records past its event count are never read).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bytes_per_s=3.35e12, int_ops_per_s=67e12),
}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def vote_bytes(B: int, events: int) -> int:
    """Bytes of one vote launch over B reads holding ``events`` records in
    all (each read's count clamped to the record width): per read its
    int64 event count read, its process byte and int64 target written;
    per record its int64 idx and meta words read; one int64 overflow
    counter written."""
    return B * (8 + 1 + 8) + events * 16 + 8


def vote_ops(events: int) -> int:
    """Integer operations of one vote launch: at least one comparison of
    each record against its read's candidate table."""
    return events


def bound_s(nbytes: int, ops: int, peak: dict = DEFAULT_PEAK) -> float:
    return max(nbytes / peak["bytes_per_s"], ops / peak["int_ops_per_s"])


def vote_bound_s(launches, peak: dict = DEFAULT_PEAK) -> float:
    """Summed bound of vote launches given as (reads, events)."""
    return sum(bound_s(vote_bytes(B, n), vote_ops(n), peak)
               for B, n in launches)
