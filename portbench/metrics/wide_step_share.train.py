"""The share of the packed collector's steps of the traced training calls
that went through B1's wide kernel, %: the change of the program's
`fused_step.wide_launches` counter over the calls, over their
`rollout.step` spans inside `collect_packed`. A program without that
counter reads nothing."""

from portbench.metrics import program_spans

COUNTER = "fused_step.wide_launches"


def read(run):
    calls = program_spans.train_calls(run)
    if calls is None or any(COUNTER not in (root.counters or {})
                            for root, _, _ in calls):
        return None
    steps = sum(len(found) for _, _, found in calls)
    if not steps:
        return None
    return 100.0 * sum(root.counters[COUNTER] for root, _, _ in calls) / steps
