"""Multi-sample cohort genotyping: N donors against one device-resident
index (port of ``vargeno_tpu/engine/cohort.py``).

No reference equivalent (the reference genotypes one FASTQ per run): the
index, its device tables and the runner's tuned / escalated step are built
once, each sample streams through the same GenoRunner (or, with ``mesh``,
the data-parallel ShardedGenoRunner) with its own pileup accumulators, and
per-sample VCFs are written at the end. Per-sample outputs are
byte-identical to N single runs because per-SNP counts are
order-independent saturating sums.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, GenoConfig
from ..finalize import finalize_calls
from ..index import store
from .geno import GenoRunner


class CohortRunner:
    def __init__(self, index: store.VarGenoIndex,
                 sample_names: Sequence[str],
                 config: GenoConfig = DEFAULT_CONFIG,
                 device: str | torch.device = "cuda", mesh=None):
        """``mesh`` (a ``dist.sharding.Mesh``): stream every sample
        data-parallel over its devices; ``device`` is then unused."""
        self.index = index
        self.config = config
        if mesh is not None:
            from ..dist.sharding import ShardedGenoRunner

            self._runner = ShardedGenoRunner(index, mesh, config)
        else:
            self._runner = GenoRunner(index, config, device=device)
        # None until consumed
        self.counts: Dict[str, Optional[tuple]] = {
            name: None for name in sample_names}
        self.stats: Dict[str, dict] = {name: {} for name in sample_names}

    def consume_sample(self, name: str, fastq_path: str,
                       limit_batches: Optional[int] = None) -> None:
        r = self._runner
        if self.counts[name] is None:
            r.ref_cnt, r.alt_cnt = r._fresh_counts()
        else:
            r.ref_cnt, r.alt_cnt = self.counts[name]
        r.stats_totals = {}
        r.consume_fastq(fastq_path, limit_batches=limit_batches)
        self.counts[name] = (r.ref_cnt, r.alt_cnt)
        st = self.stats[name]
        for k, v in r.stats_totals.items():
            st[k] = st.get(k, 0) + int(v)

    def sample_calls(self, name: str):
        s = self.index.sites
        n = s.pos.shape[0]
        if self.counts[name] is None:
            z = np.zeros(n, np.int32)
            rc_h, ac_h = z, z
        else:
            r = self._runner
            r.ref_cnt, r.alt_cnt = self.counts[name]
            rc_h, ac_h = r.host_counts()
        ref = np.minimum(rc_h[:n], self.config.max_cov)
        alt = np.minimum(ac_h[:n], self.config.max_cov)
        return finalize_calls(self.index.chrlens, s.pos, s.ref, s.alt,
                              s.rf, s.af, ref, alt, self.config)

    def write_vcfs(self, vcf_in: str, out_pattern: str) -> List[str]:
        """out_pattern must contain '{sample}'. Each sample's calls and
        rewrite are the runner's stages ``vcf_calls`` and ``vcf_write``, and
        its rewrite counts in the runner's ``n_vcf_native`` /
        ``n_vcf_fallback``."""
        r = self._runner
        outs = []
        for name in self.counts:
            out = out_pattern.format(sample=name)
            with r.timer.stage("vcf_calls"):
                table = self.sample_calls(name)
            r._rewrite(vcf_in, out, table)
            outs.append(out)
        return outs
