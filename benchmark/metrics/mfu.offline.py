"""Whole-call model FLOP utilisation, %: the FLOPs of one call counted over the frozen
reference at the cell's shapes (``FlopCounterMode``), times the calls of the spans
stretch, over that stretch's seconds, over the peak of the cell's precision."""


def read(ctx):
    res = ctx["result"]
    flops = res.get("flops_per_call")
    if not flops or not res["window_s"]:
        return None
    rate = flops * res["calls"] / res["window_s"]
    return 100.0 * rate / ctx["peaks"].peak_flops(ctx["precision"])
