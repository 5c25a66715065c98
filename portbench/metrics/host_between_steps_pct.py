"""Share of the window's wall time outside the trainer's steps: the host
fetching the next item, reading back the loss, and Python between steps.
(window wall - the sum of ``Trainer``'s step times, CUDA events around each
step's execution) / window wall, over the traced run's unprofiled window."""

UNIT = "%"
LAYER = "trainer and loader"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    if not run.step_times:
        return None
    return 100.0 * (run.window_s - sum(run.step_times)) / run.window_s
