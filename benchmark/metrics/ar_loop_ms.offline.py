"""EMAGE's autoregressive loop (``EmageAudioModel.inference``: every window's step and
its seed decode), ms a call: the median of the spans stretch's synchronised host-clock
spans around the call's inference."""
import statistics


def read(ctx):
    spans = ctx["result"]["spans"].get("inference")
    return 1e3 * statistics.median(spans) if spans else None
