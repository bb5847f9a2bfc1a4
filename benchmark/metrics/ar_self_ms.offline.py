"""EMAGE's AR loop outside its windows, ms: the device time of ``emage.inference`` less
that of its ``emage.window`` and ``emage.remainder`` spans (the input preparation, the
casts, the copies of each window's kept frames, and the gaps between them), the median
over the profiled stretch's calls."""
import statistics

from harness import spans


def read(ctx):
    recorded = spans.recorded()
    selves = []
    for root in spans.named(recorded, "emage.inference"):
        inner = [s for s in recorded if s["parent"] == root["id"]
                 and s["name"] in ("emage.window", "emage.remainder")]
        times = spans.device_ms([root] + inner)
        if times is None or not inner:
            return None
        selves.append(times[0] - sum(times[1:]))
    return statistics.median(selves) if selves else None
