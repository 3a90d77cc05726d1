"""What the readers of the program's own spans share
(`qiskit_gym_torch.utils.profiling.spans()`, recorded while the traced
stretch runs under the profiler): the spans of each traced call, found by
its root span inside the traced window, checked against the program's
step counter, and the card's idle time inside an interval.

A program without spans (an older checkout) gives no calls, and its
readers return None."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

LANE_STEPS = "env_step.lane_steps"


def traced_calls(run, root: str) -> Optional[List[Tuple[object, list]]]:
    """[(root span, every span of its call)] of each call whose root span
    is named `root`, keeping only the spans inside [run.trace.t0,
    run.trace.t1]; None where there is none."""
    from qiskit_gym_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    inside = [s for s in read()
              if s.end is not None and t0 <= s.start and s.end <= t1]
    members = {}
    for s in inside:
        members.setdefault(s.call, []).append(s)
    calls = [(s, members[s.id]) for s in inside
             if s.parent is None and s.name == root]
    return calls or None


def steps(root, members: list, collector: str, lanes: float) -> list:
    """The call's `rollout.step` spans under its `collector` span. Raises
    where their count times `lanes` differs from the lane steps that the
    program counted over the call."""
    ids = {s.id for s in members if s.name == collector}
    found = [s for s in members
             if s.name == "rollout.step" and s.parent in ids]
    counted = root.counters[LANE_STEPS]
    if len(found) * lanes != counted:
        raise RuntimeError(
            f"a traced {root.name} call holds {len(found)} rollout.step "
            f"spans of {lanes} lanes, where the program counted {counted} "
            "lane steps: no span metric is read from it")
    return found


def check_updates(root, members: list) -> None:
    """A training call's Adam steps against its epochs x minibatches, which
    the program notes on the call's `fit` span (`updates`). Raises where
    the call's `update` spans inside its `fit` number otherwise."""
    fits = [s for s in members if s.name == "fit"]
    planned = [(s.notes or {}).get("updates") for s in fits]
    ids = {s.id for s in fits}
    updates = sum(s.name == "update" and s.parent in ids for s in members)
    if len(fits) != 1 or planned[0] != updates:
        raise RuntimeError(
            f"a traced {root.name} call holds {updates} update spans in "
            f"{len(fits)} fit spans that plan {planned} epochs x "
            "minibatches: no span metric is read from it")


def synth_calls(run):
    """The traced `synth` calls, each checked: one `rollout.step` of
    `run.lanes` lanes a collector step."""
    calls = traced_calls(run, "synth")
    for root, members in calls or ():
        steps(root, members, "collect", run.lanes)
    return calls


def train_calls(run):
    """The traced `train_step` calls with their packed collector's steps,
    each checked: `run.collect_rows` is T x B + B for T steps of B lanes,
    and the `update` spans number the epochs x minibatches of its `fit`."""
    calls = traced_calls(run, "train_step")
    out = []
    for root, members in calls or ():
        n = sum(s.name == "rollout.step" for s in members)
        found = steps(root, members, "collect_packed",
                      run.collect_rows / (n + 1))
        check_updates(root, members)
        out.append((root, members, found))
    return out or None


def mean_us(spans: Sequence) -> Optional[float]:
    """The mean length of `spans`, µs."""
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / len(spans) / 1e3


def idle_ns(a: int, b: int, busy: Sequence) -> int:
    """The ns of [a, b] in which the card ran nothing: its length less its
    overlap with the merged, sorted `busy` intervals."""
    covered = sum(max(0, min(b, e) - max(a, s)) for s, e in busy
                  if e > a and s < b)
    return (b - a) - covered


def outside(span, inner: Sequence) -> List[Tuple[int, int]]:
    """The intervals of `span` that no span of `inner` covers."""
    out, at = [], span.start
    for s in sorted(inner, key=lambda x: x.start):
        if s.start > at:
            out.append((at, s.start))
        at = max(at, s.end)
    if span.end > at:
        out.append((at, span.end))
    return out
