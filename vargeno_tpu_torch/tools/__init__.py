"""Command-line measurement tools of the port (run with ``python -m``)."""
