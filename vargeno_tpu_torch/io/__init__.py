"""FASTA / FASTQ / VCF input and VCF output."""
