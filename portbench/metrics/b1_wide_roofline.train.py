"""Kernel B1's wide step (`fused_step_wide_kernel`, W >= 3 words a column):
the bytes of its launches in the trace (`costs.b1_bytes` at the cell's
lanes and widths each) over their device time, as a share of the HBM
roofline."""

from portbench.metrics import costs

KERNEL = "fused_step_wide_kernel"


def read(run):
    n = run.trace.count(KERNEL)
    if not n or getattr(run, "b1_wide_bytes", None) is None:
        return None
    return costs.roofline_share(n * run.b1_wide_bytes,
                                run.trace.seconds(KERNEL))
