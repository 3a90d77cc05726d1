"""The card's idle time in the front end of a synth call, ms: the time in
which the host is inside the program's `synth` span but outside its
`collect` span and nothing runs on the card (from the traced window's busy
intervals), averaged over the traced calls."""

from portbench.metrics import program_spans


def read(run):
    calls = program_spans.synth_calls(run)
    if calls is None:
        return None
    idle = sum(program_spans.idle_ns(a, b, run.trace.busy)
               for root, members in calls
               for a, b in program_spans.outside(
                   root, [s for s in members if s.name == "collect"]))
    return idle / len(calls) / 1e6
