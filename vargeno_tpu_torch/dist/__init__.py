"""Multi-device geno: the data-parallel mesh runner and the sharded-dictionary
runner."""
