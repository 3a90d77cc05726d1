"""The host time of one Adam step of the training call, µs: the mean
length of the program's `update` spans (forward, backward and the
optimizer's step of one minibatch), over the traced calls."""

from portbench.metrics import program_spans


def read(run):
    calls = program_spans.train_calls(run)
    if calls is None:
        return None
    return program_spans.mean_us([s for _, members, _ in calls
                                  for s in members if s.name == "update"])
