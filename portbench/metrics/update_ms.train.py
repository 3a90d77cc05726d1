"""The update of a training call, ms: the span of its epochs of minibatch
Adam steps (`_fit`), averaged over the window's calls."""


def read(run):
    spans = run.spans.get("update")
    return 1e3 * sum(spans) / len(spans) if spans else None
