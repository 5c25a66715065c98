"""Share of their bound that the fused AdaLN (K1-K3) and q/k RMSNorm
(K4-K6) launches of the traced steps reached: the frozen bounds of
``portbench.rooflines`` (bytes read and written once over 3.35 TB/s) over
their device time in the trace."""

from portbench.rooflines.kernels import NORMS, norm_bounds, roofline_pct

UNIT = "%"
LAYER = "kernels: fused_adaln, fused_rmsnorm"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return roofline_pct(run, NORMS, norm_bounds)
