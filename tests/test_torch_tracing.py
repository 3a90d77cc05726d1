"""The port's own spans (`utils/profiling.py` `span`, `recording`, `spans`)
on the CPU: off by default, the span tree of a synth call and of a PPO
`train_step`, the step counter beside them, and the clock they share with
`torch.profiler`'s trace."""

import gc
import os
import statistics

import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from qiskit_gym_torch.envs import LinearFunctionGym
from qiskit_gym_torch.models import make_policy
from qiskit_gym_torch.ops.lanes import env_step
from qiskit_gym_torch.quantum import Circuit
from qiskit_gym_torch.rl import PPO, PPOConfig, RLSynthesis
from qiskit_gym_torch.utils import profiling

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
LANES = 8
T, B, EPOCHS, MINIBATCHES = 6, 16, 2, 3
SPANS = 10   # of each name, in the clock test
# the children every span of a call may have, by name
SYNTH_TREE = {"synth": ["synth.encode", "solve", "synth.circuit"],
              "solve": ["solve.state", "collect", "solve.rank"],
              "collect": ["rollout.step"],
              "rollout.step": ["policy", "env.step"]}
TRAIN_TREE = {"train_step": ["collect_packed", "gae", "fit"],
              "collect_packed": ["rollout.step"],
              "rollout.step": ["policy", "env.step"],
              "fit": ["update"]}


@pytest.fixture(scope="module")
def rls():
    return RLSynthesis.from_config_json(
        os.path.join(MODELS, "clifford_3q_line.json"),
        os.path.join(MODELS, "clifford_3q_line.pt"), device="cpu")


@pytest.fixture(scope="module")
def ppo():
    env = LinearFunctionGym.from_coupling_map([(0, 1), (1, 2), (2, 3)],
                                              max_depth=16, device="cpu")
    policy = make_policy("BasicPolicy", tuple(env.obs_shape()),
                         env.num_actions(),
                         dict(embedding_size=32, common_layers=[16],
                              policy_layers=[], value_layers=[]))
    cfg = PPOConfig(num_episodes=B, num_epochs=EPOCHS,
                    num_minibatches=MINIBATCHES, episode_packing=True)
    return PPO(env, policy, cfg)


def _target():
    qc = Circuit(3)
    qc.append("h", (0,))
    qc.append("cx", (0, 1))
    qc.append("s", (2,))
    return qc


def _recorded(fn):
    """The spans that `fn()` records under `recording()`, and the lane
    steps that the step counter counted meanwhile."""
    profiling.clear_spans()
    before = env_step.lane_steps
    with profiling.recording():
        fn()
    return profiling.spans(), env_step.lane_steps - before


def _check_tree(spans, tree):
    """One root; each span's parent may hold it, each child lies inside
    its parent's interval, and every span carries its root's call id."""
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 1
    root = roots[0]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.call == root.id
        assert s.start <= s.end
        if s is root:
            continue
        parent = by_id[s.parent]
        assert s.name in tree[parent.name]
        assert parent.start <= s.start and s.end <= parent.end
    return root


def _count(spans, name, parent=None):
    names = {s.id: s.name for s in spans}
    return sum(s.name == name and (parent is None
                                   or names[s.parent] == parent)
               for s in spans)


def test_off_records_nothing(rls, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span built a record_function")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    profiling.clear_spans()
    assert profiling.span("synth") is profiling.span("solve")
    assert rls.synth(_target(), num_searches=LANES) is not None
    assert profiling.spans() == []


def test_synth_span_tree(rls):
    spans, lane_steps = _recorded(
        lambda: rls.synth(_target(), num_searches=LANES))
    root = _check_tree(spans, SYNTH_TREE)
    assert root.name == "synth"
    steps = rls.env.core.max_depth
    assert {n: _count(spans, n) for n in
            ("synth.encode", "solve", "solve.state", "collect", "solve.rank",
             "synth.circuit")} == dict.fromkeys(
        ("synth.encode", "solve", "solve.state", "collect", "solve.rank",
         "synth.circuit"), 1)
    assert _count(spans, "rollout.step", "collect") == steps
    assert _count(spans, "policy", "rollout.step") == steps
    assert _count(spans, "env.step", "rollout.step") == steps
    assert len(spans) == 7 + 3 * steps
    assert lane_steps == steps * LANES
    assert root.counters["env_step.lane_steps"] == lane_steps
    assert set(root.counters) == {"env_step.lane_steps"}


def test_train_step_span_tree(ppo):
    spans, lane_steps = _recorded(lambda: ppo.train_step(T, B, 2))
    root = _check_tree(spans, TRAIN_TREE)
    assert root.name == "train_step"
    assert [_count(spans, n) for n in ("collect_packed", "gae", "fit")] == [
        1, 1, 1]
    assert _count(spans, "rollout.step", "collect_packed") == T
    assert _count(spans, "policy", "rollout.step") == T
    assert _count(spans, "env.step", "rollout.step") == T
    assert _count(spans, "update", "fit") == EPOCHS * MINIBATCHES
    fit, = (s for s in spans if s.name == "fit")
    assert fit.notes == {"updates": EPOCHS * MINIBATCHES}
    assert len(spans) == 4 + 3 * T + EPOCHS * MINIBATCHES
    assert lane_steps == T * B == root.counters["env_step.lane_steps"]


def test_spanned_opens_a_span_per_call():
    @profiling.spanned("outer")
    def outer(x):
        with profiling.span("inner"):
            profiling.note(x=x)
        return x + 1

    profiling.clear_spans()
    assert outer(1) == 2
    assert profiling.spans() == []
    with profiling.recording():
        assert [outer(2), outer(3)] == [3, 4]
    got = [(s.name, s.parent is None, s.notes) for s in profiling.spans()]
    assert got == [("outer", True, None), ("inner", False, {"x": 2}),
                   ("outer", True, None), ("inner", False, {"x": 3})]
    assert outer.__name__ == "outer"


def test_recording_nests_and_leaves_off():
    profiling.clear_spans()
    with profiling.recording():
        with profiling.recording():
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass
        with profiling.span("after"):
            pass
    with profiling.span("off"):
        pass
    got = [(s.name, s.parent is None) for s in profiling.spans()]
    assert got == [("outer", True), ("inner", False), ("after", True)]


def test_spans_share_the_profilers_clock():
    """Each span's `qgt.<name>` event starts and ends with its record. The
    collector stays off while they are recorded: a pause of the process
    between the profiler's stamp and the span's is no clock's gap."""
    from torch.profiler import ProfilerActivity, profile

    profiling.clear_spans()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("warm"):
                pass
            for _ in range(SPANS):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        torch.ones(64).sum()
    finally:
        gc.enable()
    kept = [s for s in profiling.spans() if s.name != "warm"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("qgt."):
            events.setdefault(e.name()[4:], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    ends = []
    for name in ("outer", "inner"):
        mine = sorted((s.start, s.end) for s in kept if s.name == name)
        theirs = sorted(events[name])[-len(mine):]
        assert len(mine) == SPANS and len(theirs) == SPANS
        for (a, b), (c, d) in zip(mine, theirs):
            ends += [abs(a - c), abs(b - d)]
    assert statistics.median(ends) < 0.2e6
    assert max(ends) < 2e6
