"""vargeno_tpu_torch: the PyTorch + CUDA port of vargeno_tpu.

`index` builds 32-mer reference/SNP dictionaries and Bloom filters from
FASTA+VCF on the host; `geno` streams FASTQ reads in fixed-shape batches
through a batched lookup/vote/pileup step on one GPU (the vote is a
hand-written CUDA kernel) and writes GT/GQ calls into the input VCF.

The package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"
