"""A cell of BENCHMARK.json shrunk to a size the CPU tests can run: the
same configuration and mix files with the genome, SNPs, reads, batch and
Bloom filters cut down. ``SITES`` is the reference's site count in the
tests' runs."""

from __future__ import annotations

import dataclasses

import torch

from genobench import spec

MB = 200_000
SNPS = 2_000
READS = 4_096
BATCH = 512
SITES = 400


def tiny_cell(name: str) -> spec.Cell:
    torch.set_num_threads(2)
    c = spec.cell(name)
    cfg = dict(c.config, genome_bases=MB, snps=SNPS)
    if cfg.get("families"):
        cfg["families"] = dict(cfg["families"], seg_len=[100, 300],
                               high_copy=[16, 60])
    cfg["geno"] = dict(cfg["geno"], ref_bf_bytes=1 << 17,
                       snp_bf_bytes=1 << 14, ref_lite_bf_bytes=8)
    mix = dict(c.mix, coverage=READS * c.mix["read_len"] / MB,
               batch_reads=BATCH)
    return dataclasses.replace(c, config=cfg, mix=mix)


CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
