"""Index build: dictionaries, Bloom filters, persistence."""
