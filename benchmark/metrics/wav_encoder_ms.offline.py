"""CaMN's WavEncoder, ms: the device time of the ``camn.audio_encoder`` span, the median
over the profiled stretch's calls."""
from harness import spans


def read(ctx):
    return spans.median_ms(spans.recorded(), "camn.audio_encoder")
