"""EMAGE's four part decoders in the final decode, ms: the summed device time of the
``vq.part`` spans under ``emage.decode`` (face with K1, upper, hands, lower; the global
VAE and the rotations left out), the median over the profiled stretch's calls."""
from harness import spans


def read(ctx):
    return spans.median_sum_ms(spans.recorded(), "emage.decode", "vq.part", direct=True)
