"""The reader of the share of observations that went through the
observation kernel, on hand-built spans: 100 where every `observe` span
launched it, a partial share where fewer did, nothing for a program without
the counter, without spans or without `observe` spans, and the raise where
a call's span count disagrees with the program's step counter."""

import pytest

from qiskit_gym_torch.utils import profiling
from test_portbench_program_spans import LANES, Tree, reader, synth_run

NAME = "pauli_observe_kernel_share.synth"


@pytest.fixture
def given(monkeypatch):
    tree = Tree()
    monkeypatch.setattr(profiling, "spans", lambda: list(tree.spans))
    return tree


def synth(tree, at, launched=None, observed=True, **kw):
    """A synth call of `Tree.synth` with an `observe` span opening each of
    its steps where `observed`, whose root also keeps `launched`, the change
    of the kernel's launch counter, where given."""
    root = tree.synth(at, **kw)
    if observed:
        for s in [s for s in tree.spans
                  if s.call == root.id and s.name == "rollout.step"]:
            tree.add("observe", s.start, s.start + 1, s)
    if launched is not None:
        root.counters["pauli_observe.launches"] = launched
    return root


def test_every_observation_through_the_kernel(given):
    synth(given, 1000, steps=3, launched=3)
    synth(given, 2000, steps=5, launched=5)
    assert reader(NAME)(synth_run(0, 5000)) == pytest.approx(100)


def test_fewer_launches_than_observations(given):
    synth(given, 1000, steps=4, launched=1)
    synth(given, 2000, steps=4, launched=2)
    assert reader(NAME)(synth_run(0, 5000)) == pytest.approx(100 * 3 / 8)


def test_a_program_without_the_counter(given):
    synth(given, 1000)
    synth(given, 2000, launched=3)
    assert reader(NAME)(synth_run(0, 5000)) is None
    # the window keeps only the call that has it
    assert reader(NAME)(synth_run(1500, 5000)) == pytest.approx(100)


def test_a_program_without_observe_spans(given):
    synth(given, 1000, launched=3, observed=False)
    assert reader(NAME)(synth_run(0, 5000)) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert reader(NAME)(synth_run(0, 10)) is None


def test_step_count_mismatch_raises(given):
    synth(given, 1000, counted=3 * LANES + 1, launched=3)
    with pytest.raises(RuntimeError, match="lane steps"):
        reader(NAME)(synth_run(0, 2000))
