"""CaMN's LSTM layers, ms a call: the summed device time of the call's ``lstm.layer``
spans (8: each layer's projection GEMM, the float32 upcasts, K2 and the cast back), the
median over the profiled stretch's calls."""
from harness import spans


def read(ctx):
    return spans.median_sum_ms(spans.recorded(), "camn.forward", "lstm.layer")
