"""The device's idle share of the traced sub-window of whole steps: 1 -
the union of the device kernels' intervals over the window's wall span,
from ``torch.profiler``."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    if run.trace is None or not run.trace.kernels or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
