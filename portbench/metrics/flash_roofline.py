"""Share of the attention layer's bound that the flash attention launches
K7, K8 and K9 of the traced steps reached: the frozen bound of
``portbench.rooflines`` (the products each attention call needs, forward
two and backward five, from the shapes over 989 TFLOP/s, every tile live)
over the device time of every K7, K8 and K9 launch in the trace, the
recompute's too."""

from portbench.rooflines.kernels import FLASH, flash_bound, roofline_pct

UNIT = "%"
LAYER = "kernels: flash_attention"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return roofline_pct(run, FLASH, flash_bound)
