"""The policy's FLOPs of the window's training calls as performed, over the
window's time, as a share of the card's float32 peak: every Linear's
forward on every collected row (and the bootstrap row of each lane); on
every row of every epoch's minibatches the forward, the weight gradients
and the input gradients of every layer but the first. The observation
needs no gradient, so autograd never computes the first layer's:
`mfu.train`'s three forwards an update row count it too."""

from portbench.metrics import costs


def read(run):
    first = getattr(run, "first_layer_flops", None)
    if not run.calls or first is None:
        return None
    update = 3 * run.row_flops - first
    flops = run.calls * (run.collect_rows * run.row_flops
                         + run.update_rows * update)
    return costs.mfu(flops, run.window_s)
