"""Kernels a training step: the profiled steps' kernels (memory copies and sets left out)
over the number of steps profiled. What a CUDA graph of the step or a backward kernel of
the LSTM would cut."""

COPIES = ("Memcpy", "Memset")


def read(ctx):
    res = ctx["result"]
    kernels = sum(not name.startswith(COPIES) for name, _, _ in res["profile"]["kernels"])
    steps = res.get("profile_calls")
    return kernels / steps if kernels and steps else None
