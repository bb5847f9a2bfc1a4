"""The LSTM layers' backward, ms a training step: for each ``LstmLayerFunction`` backward
node that autograd ran (8 a CaMN step: the recompute of the layer through the plain
recurrence and its vector-Jacobian product), the time between a pair of CUDA events put
on the node's stream as it starts and as it ends (the adapter's ``timing``), summed over
the step's nodes; the median over the steps of the traced run's synchronised stretch,
which no profiler records. The first event runs when the node starts if the device is
idle, or when the work before it ends; the second once the last kernel the node launched
has ended. So a backward bound by the host and one bound by the card count alike."""
import statistics


def read(ctx):
    steps = (ctx["result"].get("node_ms") or {}).get("lstm_backward") or []
    totals = [sum(step) for step in steps if step]
    return statistics.median(totals) if totals else None
