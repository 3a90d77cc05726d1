"""Whole runs of each cell on the CPU at a small size, the harness's look
for a card skipped: sound, then with the timed path broken underneath, and
the control (the reference in bfloat16 in the program's place). `correct`
must hold for the sound runs and fall for every fault the cell can have;
the control must fail one of the cell's numbers."""

import json
from pathlib import Path

import pytest
import torch

from portbench.control import readings
from portbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 3_000_000_019
# The synth driver on the matrix env: a Clifford synth cell, added to a copy
# of the benchmark as a configuration, a traffic mix and an entry.
CLIFFORD_SYNTH = {"name": "clifford27.synth", "config": "clifford27_synth",
                  "traffic": "synth_d8_test", "chips": 1,
                  "why": "the synth driver on the matrix env"}
TRAFFIC = {"driver": "synth", "depth": 8, "rotations": 0, "pool": 2,
           "pool_seed": 8000016, "num_searches": 16, "quality_calls": 2,
           "check_calls": 2, "check_window": 2, "check_lanes": 3,
           "trace_calls": 1}
SMALL = {
    "clifford27.synth": {},
    "pauli27.synth_wide": {"num_searches": 32, "pool": 2, "quality_calls": 2,
                           "check_window": 2, "check_calls": 1,
                           "check_lanes": 3, "trace_calls": 1},
    "clifford27.train": {"horizon": 8, "lanes": 16, "difficulty": 4,
                         "check_lanes": 4, "trace_calls": 1},
}


def _linked(src: Path, dst: Path) -> None:
    dst.mkdir()
    for p in src.iterdir():
        if p.name != "__pycache__":
            (dst / p.name).symlink_to(p)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout whose BENCHMARK.json also holds the Clifford synth cell,
    with its configuration and traffic as new files."""
    path = tmp_path_factory.mktemp("checkout")
    (path / "examples").symlink_to(ROOT / "examples")
    _linked(ROOT / "portbench", path / "portbench")
    for d in ("configs", "traffic"):
        (path / "portbench" / d).unlink()
        _linked(ROOT / "portbench" / d, path / "portbench" / d)
    cfg = json.loads((ROOT / "portbench/configs/clifford27.json").read_text())
    cfg["name"] = "clifford27_synth"
    cfg["limits"] = {"synth": {"logp_gap": 5e-4}}
    (path / "portbench/configs/clifford27_synth.json").write_text(
        json.dumps(cfg))
    (path / "portbench/traffic/synth_d8_test.json").write_text(
        json.dumps(TRAFFIC))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0],
                                 name="clifford27_synth",
                                 file="portbench/configs/"
                                      "clifford27_synth.json"))
    bench["workloads"].append(CLIFFORD_SYNTH)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pauli27.synth_wide" in m.get("workloads", []):
            m["workloads"].append(CLIFFORD_SYNTH["name"])
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


def run(root, workload, plant=None, trace=False):
    return run_cell(root, workload, SEED, 0.5, trace, device="cpu",
                    overrides=SMALL[workload], plant=plant)


def stale_step(r):
    """The env step returns its state unchanged."""
    r.rls.env.core.step = lambda state, *a, **k: state


def altered_answer(r):
    """One gate added to every circuit where it is produced."""
    build = r.rls.env.build_circuit_from_solution

    def altered(*args, **kwargs):
        out = build(*args, **kwargs)
        out.append("x", (0,))
        return out

    r.rls.env.build_circuit_from_solution = altered


def miscounted(r):
    """The step adds one 2q gate too many to its counter."""
    step = r.rls.env.core.step

    def off(*args, **kwargs):
        out = step(*args, **kwargs)
        return out._replace(n_cnots=out.n_cnots + 1)

    r.rls.env.core.step = off


def misrewarded(r):
    """The step's reward is one gate's weight short."""
    core = r.rls.env.core if hasattr(r, "rls") else r.algo.core
    step = core.step

    def off(*args, **kwargs):
        out = step(*args, **kwargs)
        return out._replace(reward=out.reward - 1e-4)

    core.step = off


def longest_lane(r):
    """The solve returns the successful lane with the most 2q gates."""
    from qiskit_gym_torch.rl import solve

    pick = solve.best_lane

    def worst(final_state, traj):
        best = pick(final_state, traj)
        if best is None:
            return None
        n = final_state.n_cnots.cpu().numpy()
        ok = final_state.success.cpu().numpy()
        return int(max(range(len(n)), key=lambda s: (ok[s], n[s])))

    solve.best_lane = worst
    r.undo_plant = lambda: setattr(solve, "best_lane", pick)


def lost_capture(r):
    """A call that the reference should read is made past the benchmark's
    hook (as a renamed collector would be)."""
    from qiskit_gym_torch.rl import ppo, solve

    if hasattr(r, "rls"):
        solve.collect = r._undo[1]
    else:
        ppo.collect_packed = r._undo[0][2]


def frozen_weights(r):
    """The optimizer's step leaves the weights unchanged."""
    r.algo.optimizer.step = lambda *a, **k: None


def half_batch(r):
    """Every minibatch's loss is the mean over its first half."""
    loss = r.algo._loss_flat
    r.algo._loss_flat = lambda batch: loss(
        {k: v[: v.shape[0] // 2] for k, v in batch.items()})


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(root, workload, trace):
    out = run(root, workload, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert list(out)[-1] == "checks"


FAULTS = {
    "clifford27.synth": [stale_step, altered_answer, miscounted, misrewarded,
                         longest_lane, lost_capture],
    "pauli27.synth_wide": [stale_step, altered_answer, miscounted,
                           misrewarded, longest_lane, lost_capture],
    "clifford27.train": [frozen_weights, half_batch, misrewarded,
                         lost_capture],
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, faults in FAULTS.items() for f in faults],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(root, workload, fault):
    planted = []

    def plant(r):
        fault(r)
        planted.append(r)

    try:
        out = run(root, workload, plant=plant)
    finally:
        for r in planted:
            getattr(r, "undo_plant", lambda: None)()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails(root, workload):
    from portbench import harness

    cell = harness.Cell(root, workload)
    limits = cell.config["limits"][cell.traffic["driver"]]
    got = readings(root, workload, SEED, "cpu", SMALL[workload], seconds=0.5)
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items())
    assert torch.get_default_dtype() == torch.float32
