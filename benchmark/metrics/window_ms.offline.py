"""One EMAGE full window, ms: the median device time of the ``emage.window`` spans whose
window-step graph was replayed (29 a call of 128 x 60 s), in the profiled stretch."""
from harness import spans


def read(ctx):
    return spans.median_ms(spans.recorded(), "emage.window", graph="replayed")
