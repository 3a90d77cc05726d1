"""The readers of the program's own spans on hand-built spans and busy
intervals: the card's idle time in the synth front end, the mean host time
of a step and of an Adam step, the traced window's filter, and the raise
where a call's span count disagrees with the program's step counter."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness
from qiskit_gym_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
LANES = 4


def reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics"
                               / f"{name}.py").read


class Tree:
    """Spans of one or more calls, built by hand, with ids in order."""

    def __init__(self):
        self.spans = []

    def add(self, name, start, end, parent=None, counters=None, notes=None):
        sid = len(self.spans) + 1
        call = sid if parent is None else parent.call
        s = profiling.Span(name, sid, None if parent is None else parent.id,
                           call, start, end, counters, notes)
        self.spans.append(s)
        return s

    def synth(self, at, steps=3, lanes=LANES, step_ns=10, collect_at=20,
              counted=None):
        """A synth call at `at`: 20 ns before its collect, `steps` steps of
        `step_ns`, each holding an env.step of half its length, 30 ns
        after."""
        end = at + collect_at + steps * step_ns + 30
        root = self.add("synth", at, end, counters={
            "env_step.lane_steps": (steps * lanes if counted is None
                                    else counted)})
        self.add("synth.encode", at, at + 5, root)
        solve = self.add("solve", at + 5, end - 10, root)
        c0 = at + collect_at
        collect = self.add("collect", c0, c0 + steps * step_ns, solve)
        for t in range(steps):
            s = self.add("rollout.step", c0 + t * step_ns,
                         c0 + (t + 1) * step_ns, collect)
            self.add("env.step", s.start, s.start + step_ns // 2, s)
        self.add("synth.circuit", end - 10, end, root)
        return root

    def train(self, at, steps=2, lanes=LANES, updates=4, update_ns=100,
              counted=None, notes=None):
        """A train_step at `at`: `steps` collector steps of 10 ns, then
        `updates` Adam steps of `update_ns`, in a `fit` whose `notes` plan
        `updates` of them where None."""
        end = at + steps * 10 + updates * update_ns + 10
        root = self.add("train_step", at, end, counters={
            "env_step.lane_steps": (steps * lanes if counted is None
                                    else counted)})
        coll = self.add("collect_packed", at, at + steps * 10, root)
        for t in range(steps):
            self.add("rollout.step", at + 10 * t, at + 10 * (t + 1), coll)
        fit = self.add("fit", at + steps * 10, end - 10, root,
                       notes={"updates": updates} if notes is None else notes)
        for u in range(updates):
            a = fit.start + u * update_ns
            self.add("update", a, a + update_ns, fit)
        return root


def synth_run(t0, t1, busy=()):
    return SimpleNamespace(lanes=LANES, trace=SimpleNamespace(
        t0=t0, t1=t1, busy=[list(b) for b in busy]))


def train_run(t0, t1, steps=2, lanes=LANES):
    return SimpleNamespace(collect_rows=steps * lanes + lanes,
                           trace=SimpleNamespace(t0=t0, t1=t1, busy=[]))


@pytest.fixture
def given(monkeypatch):
    tree = Tree()
    monkeypatch.setattr(profiling, "spans", lambda: list(tree.spans))
    return tree


def test_frontend_idle_reads_the_busy_intervals(given):
    given.synth(1000)          # synth 1000-1080, collect 1020-1050
    read = reader("frontend_idle_ms.synth")
    assert read(synth_run(0, 2000)) == pytest.approx(50 / 1e6)
    # busy 1010-1030 covers 10 ns of the front end before the collect and
    # 10 inside it; 1060-1100 covers 20 ns after it
    busy = [(1010, 1030), (1060, 1100)]
    assert read(synth_run(0, 2000, busy)) == pytest.approx(20 / 1e6)


def test_frontend_idle_averages_the_calls(given):
    given.synth(1000)
    given.synth(3000, collect_at=60)    # a front end of 90 ns
    read = reader("frontend_idle_ms.synth")
    assert read(synth_run(0, 5000)) == pytest.approx((50 + 90) / 2 / 1e6)


def test_env_step_host_time(given):
    given.synth(1000, step_ns=4000)
    given.synth(20000, step_ns=8000)
    read = reader("env_step_host_us.synth")
    assert read(synth_run(0, 60000)) == pytest.approx((2 + 4) / 2)


def test_window_keeps_only_the_traced_calls(given):
    given.synth(1000, step_ns=2000)
    given.synth(20000, step_ns=6000)
    given.train(1000)
    read = reader("env_step_host_us.synth")
    assert read(synth_run(15000, 60000)) == pytest.approx(3)
    # a call that starts before the window or ends after it is left out
    assert read(synth_run(1001, 60000)) == pytest.approx(3)
    assert read(synth_run(0, 19000)) == pytest.approx(1)
    assert read(synth_run(40000, 60000)) is None
    assert reader("update_step_host_us.train")(
        train_run(15000, 60000)) is None


@pytest.mark.parametrize("name", ["collect_step_host_us.train",
                                  "update_step_host_us.train"])
def test_training_host_times(given, name):
    given.train(1000, update_ns=200)
    given.train(5000, update_ns=400)
    got = reader(name)(train_run(0, 10000))
    assert got == pytest.approx(0.01 if name.startswith("collect")
                                else 0.3)


@pytest.mark.parametrize("name", ["frontend_idle_ms.synth",
                                  "env_step_host_us.synth"])
def test_synth_step_count_mismatch_raises(given, name):
    given.synth(1000, counted=3 * LANES + 1)
    with pytest.raises(RuntimeError, match="lane steps"):
        reader(name)(synth_run(0, 2000))


@pytest.mark.parametrize("name", ["collect_step_host_us.train",
                                  "update_step_host_us.train"])
@pytest.mark.parametrize("fault", ["lane_steps", "half_the_epochs",
                                   "unplanned"])
def test_training_count_mismatch_raises(given, name, fault):
    if fault == "lane_steps":
        given.train(1000, counted=2 * LANES - 1)
    elif fault == "half_the_epochs":
        # 2 epochs x 2 minibatches planned, one epoch run
        given.train(1000, updates=2, notes={"updates": 4})
    else:
        given.train(1000, notes={})
    with pytest.raises(RuntimeError, match="lane steps|update spans"):
        reader(name)(train_run(0, 10000))


@pytest.mark.parametrize("name", ["frontend_idle_ms.synth",
                                  "env_step_host_us.synth",
                                  "collect_step_host_us.train",
                                  "update_step_host_us.train"])
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    run = train_run(0, 10) if name.endswith("train") else synth_run(0, 10)
    assert reader(name)(run) is None
