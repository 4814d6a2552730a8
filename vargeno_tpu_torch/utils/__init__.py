"""Measurement helpers: roofline accounting, timers, traces."""
