"""The share of the Pauli env steps of the traced synth calls that went
through the transition kernel (`csrc/pauli_step.cu`), %: the change of the
program's `pauli_step.launches` counter over the calls, over their
`env.step` spans. A program without that counter reads nothing."""

from portbench.metrics import program_spans

COUNTER = "pauli_step.launches"


def read(run):
    calls = program_spans.synth_calls(run)
    if calls is None or any(COUNTER not in (root.counters or {})
                            for root, _ in calls):
        return None
    steps = sum(s.name == "env.step" for _, members in calls for s in members)
    if not steps:
        return None
    return 100.0 * sum(root.counters[COUNTER] for root, _ in calls) / steps
