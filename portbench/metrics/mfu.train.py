"""The policy's FLOPs of the window's training calls over the window's
time, as a share of the card's float32 peak: the collection's forward on
every row (and the bootstrap row of each lane), and three forwards' worth
(forward and backward) on every row of every epoch's minibatches."""

from portbench.metrics import costs


def read(run):
    if not run.calls:
        return None
    flops = run.calls * run.row_flops * (run.collect_rows
                                         + 3 * run.update_rows)
    return costs.mfu(flops, run.window_s)
