"""The solve's rollout, ms a step: the collect span, which ends in a
synchronize, over its steps, averaged over the window's calls."""


def read(run):
    collect = run.spans.get("collect")
    if not collect:
        return None
    return 1e3 * sum(collect) / len(collect) / run.steps_per_call
