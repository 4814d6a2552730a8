"""Genotype-likelihood model."""
