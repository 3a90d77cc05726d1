"""Kernel B2 (`metrics_kernel`): the metrics update's bytes over its
device time in the trace, as a share of the HBM roofline."""

from portbench.metrics import costs


def read(run):
    n = run.trace.count("metrics_kernel")
    if not n:
        return None
    return costs.roofline_share(n * run.b2_bytes,
                                run.trace.seconds("metrics_kernel"))
