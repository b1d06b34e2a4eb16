"""Frozen operation and byte counts: one module per configuration
(`<config>.py`, found by the configuration's name), the kernels' bounds
(`kernels.py`) and the card's published peaks (`peaks.py`)."""
