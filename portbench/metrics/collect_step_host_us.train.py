"""The host time of one step of the training call's packed collector, µs:
the mean length of the program's `rollout.step` spans inside its
`collect_packed` span, over the traced calls."""

from portbench.metrics import program_spans


def read(run):
    calls = program_spans.train_calls(run)
    if calls is None:
        return None
    return program_spans.mean_us([s for _, _, found in calls for s in found])
