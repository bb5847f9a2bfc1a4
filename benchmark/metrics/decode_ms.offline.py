"""EMAGE's final decode (``EmageVQModel.decode(get_global_motion=True)``), ms a call:
the median of the spans stretch's synchronised host-clock spans around it."""
import statistics


def read(ctx):
    spans = ctx["result"]["spans"].get("decode")
    return 1e3 * statistics.median(spans) if spans else None
