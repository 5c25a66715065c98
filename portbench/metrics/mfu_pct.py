"""The whole step's share of the H100's bf16 peak: the frozen model FLOPs
(``portbench.flops``: forward and backward, no recompute) of the steps in
the traced run's unprofiled window over its wall seconds times 989 TFLOP/s."""

from portbench.flops import PEAK_BF16, step_flops

UNIT = "%"
LAYER = "model step"
SOURCE = "host_clock"
MOVES = "tokens_per_s"


def read(run):
    if not run.step_microbatches:
        return None
    flops = sum(step_flops(run.cfg, mbs) for mbs in run.step_microbatches)
    return 100.0 * flops / (run.window_s * PEAK_BF16)
