"""Segment-aware flash-attention forward: plain version and CUDA kernel."""
