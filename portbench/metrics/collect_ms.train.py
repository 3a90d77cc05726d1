"""The collection of a training call, ms: the span of its packed collector
(which ends in a synchronize), averaged over the window's calls."""


def read(run):
    spans = run.spans.get("collect")
    return 1e3 * sum(spans) / len(spans) if spans else None
