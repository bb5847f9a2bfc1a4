"""Kernel K2 (``lstm_layer_kernel``, one launch a bidirectional LSTM layer), % of its
roofline: the least time one layer's recurrence could take on the card, the larger of
its FLOPs (2 T B 4H H, both directions) over the peak of the cell's precision and its
bytes (the input projections, the recurrent weights and the states out, at the cell's
element size) over HBM bandwidth, over K2's mean profiled device time a launch."""
import statistics

KERNEL = "lstm_layer_kernel"


def read(ctx):
    shape = getattr(ctx["adapter"], "k2_shape", None)
    times = [(e - s) / 1e6 for n, s, e in ctx["result"]["profile"]["kernels"] if KERNEL in n]
    if shape is None or not times:
        return None
    k2, peaks, prec = shape(), ctx["peaks"], ctx["precision"]
    flops = peaks.lstm_layer_flops(k2["t"], k2["b"], k2["h"])
    nbytes = peaks.lstm_layer_bytes(k2["t"], k2["b"], k2["h"], peaks.ELEMENT_BYTES[prec])
    return 100.0 * peaks.roofline_seconds(flops, nbytes, prec) / statistics.mean(times)
