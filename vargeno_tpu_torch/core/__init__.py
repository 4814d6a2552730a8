"""k-mer codec and hash functions (numpy host forms, torch device forms)."""
