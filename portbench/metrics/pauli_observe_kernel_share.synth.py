"""The share of the observations of the traced synth calls that went
through the observation kernel (`csrc/pauli_observe.cu`), %: the change of
the program's `pauli_observe.launches` counter over the calls, over their
`observe` spans. A program without that counter reads nothing."""

from portbench.metrics import program_spans

COUNTER = "pauli_observe.launches"


def read(run):
    calls = program_spans.synth_calls(run)
    if calls is None or any(COUNTER not in (root.counters or {})
                            for root, _ in calls):
        return None
    observed = sum(s.name == "observe" for _, members in calls
                   for s in members)
    if not observed:
        return None
    return 100.0 * sum(root.counters[COUNTER] for root, _ in calls) / observed
