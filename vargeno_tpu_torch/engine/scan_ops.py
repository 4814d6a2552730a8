"""Stream compaction for the engine (port of ``vargeno_tpu/engine/scan_ops.py``
compact_src / cumsum_mask).

Every compaction in the batch step (low-quality k-mer items, probe hits,
ambiguous exact hits, sparse events, agreeing contexts, site hits, active
probe lanes) maps a 0/1 lane mask to a fixed-length list of set-lane ids.
One torch path serves all of them: an inclusive cumsum gives each set lane
its output slot, and one scatter of the lane ids writes the slots, with
every lane that does not fit routed to a sink slot past the end. Nothing
syncs the host (no ``torch.nonzero``), so shapes stay fixed per batch.
"""

from __future__ import annotations

import torch


def cumsum_mask(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 prefix sum of a flat bool / small-int tensor."""
    return torch.cumsum(x, 0, dtype=torch.int64)


def compact_src(mask: torch.Tensor, n_out: int):
    """``mask`` (M,) bool -> ``src`` (n_out,) int64 where src[j] is the index
    of the j-th set lane (ascending lane order) and -1 marks an empty slot;
    plus ``overflow``, the count of set lanes that did not fit (a 0-d int64
    tensor)."""
    (m,) = mask.shape
    tgt = cumsum_mask(mask) - 1
    keep = mask & (tgt < n_out)
    out = torch.full((n_out + 1,), -1, dtype=torch.int64, device=mask.device)
    out.index_put_((torch.where(keep, tgt, n_out),),
                   torch.arange(m, device=mask.device))
    total = mask.sum(dtype=torch.int64)
    return out[:n_out], total - keep.sum(dtype=torch.int64)
