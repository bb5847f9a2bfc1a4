"""Whole-step model FLOP utilisation, %: the FLOPs of one training step's forward and
backward, counted over the plain reference at the cell's shapes (``FlopCounterMode``;
the program's recomputation in its LSTM backward is not counted), times the steps of the
spans stretch, over that stretch's seconds, over the peak of the cell's precision. None
where the profiled steps ran no kernel on a card."""


def read(ctx):
    res = ctx["result"]
    flops = res.get("flops_per_call")
    if not flops or not res["window_s"] or not ctx["summary"]["kernel_count"]:
        return None
    rate = flops * res["calls"] / res["window_s"]
    return 100.0 * rate / ctx["peaks"].peak_flops(ctx["precision"])
