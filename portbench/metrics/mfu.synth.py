"""The policy's forward FLOPs of the window's synth calls (every lane,
every step, times its symmetry copies) over the window's time, as a share
of the card's float32 peak."""

from portbench.metrics import costs


def read(run):
    if not run.calls:
        return None
    flops = run.calls * run.lanes * run.steps_per_call * run.row_flops
    return costs.mfu(flops, run.window_s)
