"""Share of a training step, %, in which no kernel ran on the card: one minus the busy
time of the profiled steps (the union of their kernel intervals, over the number of steps
profiled) over the median host time of a step in the traced run's synchronised stretch,
which no profiler records. The profiled steps themselves take longer: recording each
launch costs the profiler some microseconds, on the order of the step's idle share."""


def read(ctx):
    res, s = ctx["result"], ctx["summary"]
    steps, step_s = res.get("profile_calls"), res.get("step_s_median")
    if not s["kernel_count"] or not steps or not step_s:
        return None
    return 100.0 * (1.0 - s["busy_s"] / steps / step_s)
