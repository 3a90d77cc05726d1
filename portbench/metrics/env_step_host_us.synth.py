"""The host time of one Pauli env step, µs: the mean length of the
program's `env.step` spans (the action's translation and the env step's
launches) in the traced synth calls."""

from portbench.metrics import program_spans


def read(run):
    calls = program_spans.synth_calls(run)
    if calls is None:
        return None
    return program_spans.mean_us([s for _, members in calls for s in members
                                  if s.name == "env.step"])
