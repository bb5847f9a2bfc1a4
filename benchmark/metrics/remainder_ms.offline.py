"""EMAGE's eager remainder window (60 frames of a 60 s take), ms: the device time of the
``emage.remainder`` span, the median over the profiled stretch's calls."""
from harness import spans


def read(ctx):
    return spans.median_ms(spans.recorded(), "emage.remainder")
