"""Faults planted under the training cell's step, one for each way a step can be broken:
its state handed back unchanged, half of the batch left out of the loss, one LSTM layer's
recurrent-weight gradient dropped in the recompute backward, the loss altered where it is
produced, the BatchNorm statistics frozen. The correctness check has to fail each
(``tests/test_bench_train.py`` on the CPU; ``tools/readings_train.py --fault`` reads one
on the card at the cell's own size).

Each fault takes ``patch(owner, name, value)``, as ``tools/faults.py``'s do.
"""
import torch


def _state_unchanged(patch):
    """The optimizer never updates: the parameters and Adam's state stay as they were."""
    from pantomatrix_tpu_torch.train.optim import TrainOptimizer

    patch(TrainOptimizer, "step", lambda self: None)


def _half_batch(patch):
    """The loss is the mean over the first half of the rows alone."""
    from pantomatrix_tpu_torch.train import steps

    geodesic = steps._geodesic

    def half(pred6d, gt6d):
        h = gt6d.shape[0] // 2
        return geodesic(pred6d[:h], gt6d[:h])

    patch(steps, "_geodesic", half)


def _w_hh_grad_dropped(patch):
    """The body decoder's first LSTM layer loses its W_hh gradient in
    ``LstmLayerFunction``'s backward (on CPU tensors, where ``nn/lstm.py`` would run the
    plain recurrence under autograd, that layer goes through the function too)."""
    from pantomatrix_tpu_torch.models import camn
    from pantomatrix_tpu_torch.nn import lstm
    from pantomatrix_tpu_torch.ops import lstm_cuda

    class Dropped(lstm_cuda.LstmLayerFunction):
        @staticmethod
        def backward(ctx, grad_out):
            grad_x, _, _ = lstm_cuda.LstmLayerFunction.backward(ctx, grad_out)
            return grad_x, None, None

    apply, layer, bidirectional = camn.camn_apply, [0], lstm.lstm_bidirectional

    def counted(*args, **kwargs):
        layer[0] = 0
        return apply(*args, **kwargs)

    def routed(x_proj, w_hh, hidden):
        layer[0] += 1
        if layer[0] == 1 and torch.is_grad_enabled():
            return Dropped.apply(x_proj, w_hh, hidden)
        return bidirectional(x_proj, w_hh, hidden)

    patch(camn, "camn_apply", counted)
    patch(lstm, "lstm_bidirectional", routed)


def _loss_scaled(patch):
    """The loss (and so its gradient) 1.1 times what it is."""
    from pantomatrix_tpu_torch.train import steps

    geodesic = steps._geodesic
    patch(steps, "_geodesic", lambda pred6d, gt6d: 1.1 * geodesic(pred6d, gt6d))


def _bn_frozen(patch):
    """Train-mode BatchNorm normalises with the batch's statistics but never moves its
    running ones."""
    from pantomatrix_tpu_torch.nn import layers

    forward = layers.BatchNorm1d.forward

    def frozen(self, x):
        with layers.frozen_running_stats():
            return forward(self, x)

    patch(layers.BatchNorm1d, "forward", frozen)


FAULTS = {
    "camn-train-bf16": {"state_unchanged": _state_unchanged,
                        "half_batch": _half_batch,
                        "w_hh_grad_dropped": _w_hh_grad_dropped,
                        "loss_scaled": _loss_scaled,
                        "bn_frozen": _bn_frozen},
}
