"""Fused LayerNorm-Modulate (AdaLN) forward: plain version and CUDA kernel."""
