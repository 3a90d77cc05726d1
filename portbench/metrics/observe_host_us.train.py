"""The host time of the observe of one step of the training call's packed
collector (`core.dense`: the bitpacked state to the policy's uint8 bits),
µs: the mean length of the program's `observe` spans inside its
`rollout.step` spans in `collect_packed`, over the traced calls. A program
without the span reads nothing."""

from portbench.metrics import program_spans


def read(run):
    calls = program_spans.train_calls(run)
    if calls is None:
        return None
    observed = []
    for _, members, found in calls:
        steps = {s.id for s in found}
        observed += [s for s in members
                     if s.name == "observe" and s.parent in steps]
    return program_spans.mean_us(observed)
