"""Share of the profiled stretch, %, in which no kernel ran on the card (one minus the
union of kernel intervals over the stretch's host wall time)."""


def read(ctx):
    s = ctx["summary"]
    if not s["kernel_count"] or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
