"""Joint q/k RMSNorm forward (QK-norm): plain version and CUDA kernel."""
