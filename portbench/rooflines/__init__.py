"""Frozen per-launch bounds of the port's kernels (``kernels.py``)."""
