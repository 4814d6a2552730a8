"""Long reads on the port, at the CLI's auto-sized shapes.

The reference handles reads up to its 1023-char fgets buffer
(src/qv.cc:700), flooring each to a 32-base multiple (qv.cc:778-779).
``reads_long.fq`` mixes 101/300/320/640/992-base reads over the mini
genome; ``golden_long_output.vcf`` is the compiled reference binary's
output. The port's runner at the shapes the CLI picks from a FASTQ peek
must reproduce it; a config too small for the file must warn."""

import os

import pytest
import torch
from torch_index_share import FIX, small_index

from vargeno_tpu.io.fastq import autosize_read_len as j_autosize
from vargeno_tpu_torch.config import GenoConfig
from vargeno_tpu_torch.engine.geno import GenoRunner
from vargeno_tpu_torch.io.fastq import (autosize_read_len, autosize_shapes,
                                        iter_read_batches,
                                        peek_max_read_len)

torch.set_num_threads(2)

LONG_FQ = os.path.join(FIX, "reads_long.fq")
SHORT_FQ = os.path.join(FIX, "reads.fq")


def test_autosize_read_len():
    assert peek_max_read_len(LONG_FQ) == 992
    assert autosize_read_len(LONG_FQ) == 992 == j_autosize(LONG_FQ)
    assert autosize_shapes(LONG_FQ) == (992, 31)
    # the short-read file keeps the standard 128 envelope
    assert autosize_read_len(SHORT_FQ) == 128 == j_autosize(SHORT_FQ)


def test_long_reads_match_reference(tmp_path):
    """GenoRunner on the CPU at the CLI's auto-sized config (no length
    flags) byte-matches the reference binary's output."""
    L, K = autosize_shapes(LONG_FQ)   # what the CLI picks
    runner = GenoRunner(small_index(), GenoConfig(
        batch_reads=512, max_read_len=L, max_kmers_per_read=K), device="cpu")
    runner.consume_fastq(LONG_FQ)
    assert not any(v for k, v in runner.stats_totals.items()
                   if "overflow" in k)
    out = str(tmp_path / "long_output.vcf")
    runner.write_vcf(os.path.join(FIX, "snps.vcf"), out)
    with open(out) as f, open(os.path.join(FIX,
                                           "golden_long_output.vcf")) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_truncation_warns(use_native):
    """A config too small for the file's reads warns, never silently."""
    n = 0
    with pytest.warns(UserWarning, match="TRUNCATED"):
        for b in iter_read_batches(LONG_FQ, 512, 128, 4,
                                   use_native=use_native):
            n += b.n_valid
    assert n > 0
