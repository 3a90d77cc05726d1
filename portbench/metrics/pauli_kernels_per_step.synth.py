"""Device kernels a Pauli env step: every kernel of the traced calls over
the env steps they took (a count)."""


def read(run):
    steps = run.trace_calls * run.steps_per_call
    if not steps:
        return None
    return run.trace.kernels() / steps
