"""The 127-qubit Eagle training cell's own pieces on the CPU: the driver's
kernel names by width, the exact FLOP count of `mfu_exact.train` against a
hand count, the readers of the wide step's share and the observe's host
time on hand-built spans, and whole runs of a small copy of the cell (the
Eagle map's qubits 0-36, W = 3 words a column, a 32/[16] policy), sound
and with a fault planted underneath the benchmark's hooks."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.run import run_cell
from qiskit_gym_torch.utils import profiling
from test_portbench_program_spans import LANES, Tree, reader

ROOT = Path(__file__).resolve().parents[2]
CELL = "clifford127.train"
SMALL_CELL = "clifford37.train"
SUB_QUBITS = 37
SMALL_TRAFFIC = {"horizon": 8, "lanes": 64, "difficulty": 4,
                 "check_lanes": 4, "trace_calls": 1}
SEED = 2_900_000_127


def driver():
    return harness.load_module(ROOT / "portbench" / "drivers"
                               / "ppo_train_init.py")


def small_copy(path: Path, qubits: int = SUB_QUBITS,
               embedding: int = 32, common=(16,)) -> Path:
    """A checkout at `path` whose BENCHMARK.json also holds `SMALL_CELL`:
    the cell's configuration on the Eagle map's sub-map of qubits
    0..qubits-1 with a small policy, its artifact generated as the
    cell's own is, and the cell's traffic and driver."""
    from qiskit_gym_torch.envs.coupling_maps import eagle_127q
    from qiskit_gym_torch.envs.synthesis import CliffordGym

    (path / "portbench").mkdir(parents=True)
    for p in (ROOT / "portbench").iterdir():
        if p.name not in ("configs", "__pycache__"):
            (path / "portbench" / p.name).symlink_to(p)
    configs = path / "portbench" / "configs"
    configs.mkdir()
    for p in (ROOT / "portbench" / "configs").iterdir():
        (configs / p.name).symlink_to(p)
    art = json.loads((configs / "clifford127.artifact.json").read_text())
    edges = [e for e in eagle_127q() if max(e) < qubits]
    env = CliffordGym.from_coupling_map(
        edges, basis_gates=("H", "S", "Sdg", "SX", "SXdg", "CX", "CZ",
                            "SWAP"), device="cpu").to_json()
    art["env"] = {k: env[k] for k in art["env"]}
    art["policy"] = dict(art["policy"], embedding_size=embedding,
                         common_layers=list(common))
    (configs / "clifford37.artifact.json").write_text(json.dumps(art))
    cfg = json.loads((configs / "clifford127.json").read_text())
    cfg.update(name="clifford37", num_qubits=qubits,
               obs_shape=[2 * qubits] * 2,
               num_actions=len(env["gateset"]),
               words=-(-2 * qubits // 32), embedding_size=embedding,
               common_layers=list(common),
               artifact={"json": "portbench/configs/clifford37.artifact.json"})
    (configs / "clifford37.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "clifford37", "source": "test",
                             "file": "portbench/configs/clifford37.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": SMALL_CELL, "config": "clifford37",
                               "traffic": "ppo_init_t128_b2048",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(SMALL_CELL)
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_copy(tmp_path_factory.mktemp("checkout"))


def run(root, plant=None, trace=False):
    return run_cell(root, SMALL_CELL, SEED, 0.5, trace, device="cpu",
                    overrides=SMALL_TRAFFIC, plant=plant)


# ------------------------------------------------------------ the driver
@pytest.mark.parametrize("W", [2, 3, 8])
def test_launch_names_by_width(W):
    """Launches come back under the names of the kernels that ran them:
    the wide kernels count every launch at W >= 3 and none below."""
    steps, applies = 128, 9
    wide = W >= 3
    got = driver().launch_names((steps, steps if wide else 0),
                                (applies, applies if wide else 0), 0)
    assert got == {"fused_step_kernel": 0 if wide else steps,
                   "fused_step_wide_kernel": steps if wide else 0,
                   "apply_kernel": 0 if wide else applies,
                   "apply_wide_kernel": applies if wide else 0,
                   "metrics_kernel": 0}


def test_policy_layers_of_the_cell():
    cfg = json.loads((ROOT / "portbench/configs/clifford127.json")
                     .read_text())
    assert driver().policy_layers(cfg) == [
        ("embeddings", 254 * 254, 512), ("common.0", 512, 256),
        ("action.0", 256, 1067), ("value.0", 256, 1)]
    assert driver().first_layer_flops(cfg) == 2 * 254 * 254 * 512


# ------------------------------------------------------------- mfu_exact
def test_mfu_exact_against_a_hand_count():
    """Linears 16->8->4 with heads 4->5 and 4->1, two symmetry copies: a
    forward is 2 * (128 + 32 + 20 + 4) = 368 FLOPs a row and copy; an
    update row 3 * 368 less the first layer's input gradient, 2 * 128:
    848."""
    from portbench.metrics import costs

    row = costs.policy_flops(16, 8, [4], 5, copies=2)
    assert row == 2 * 368
    rec = SimpleNamespace(calls=3, window_s=2.0, row_flops=row,
                          first_layer_flops=2 * 2 * 128, collect_rows=10,
                          update_rows=20)
    want = 100 * 3 * 2 * (10 * 368 + 20 * 848) / 67e12 / 2.0
    assert reader("mfu_exact.train")(rec) == pytest.approx(want)
    del rec.first_layer_flops   # another driver's record
    assert reader("mfu_exact.train")(rec) is None


# ------------------------------------------------- spans and the counter
@pytest.fixture
def given(monkeypatch):
    tree = Tree()
    monkeypatch.setattr(profiling, "spans", lambda: list(tree.spans))
    return tree


def train_run(t0, t1, steps=2):
    return SimpleNamespace(collect_rows=steps * LANES + LANES,
                           trace=SimpleNamespace(t0=t0, t1=t1, busy=[]))


def train(tree, at, launched=None, observe_ns=None, steps=2):
    """A call of `Tree.train` whose root keeps `launched`, the change of
    the wide step counter, and whose steps each hold an `observe` span of
    `observe_ns`, where given."""
    root = tree.train(at, steps=steps)
    if launched is not None:
        root.counters["fused_step.wide_launches"] = launched
    if observe_ns is not None:
        for s in [s for s in tree.spans if s.name == "rollout.step"
                  and s.call == root.id]:
            tree.add("observe", s.start, s.start + observe_ns, s)
    return root


def test_every_step_through_the_wide_kernel(given):
    train(given, 1000, launched=2)
    train(given, 3000, launched=2)
    assert reader("wide_step_share.train")(train_run(0, 5000)) == \
        pytest.approx(100)


def test_no_step_through_the_wide_kernel(given):
    train(given, 1000, launched=0)
    assert reader("wide_step_share.train")(train_run(0, 5000)) == 0


def test_a_program_without_the_wide_counter(given):
    train(given, 1000)
    assert reader("wide_step_share.train")(train_run(0, 5000)) is None


def test_observe_host_time(given):
    train(given, 1000, observe_ns=6)
    train(given, 3000, observe_ns=2)
    assert reader("observe_host_us.train")(train_run(0, 5000)) == \
        pytest.approx(0.004)


def test_a_program_without_the_observe_span(given):
    train(given, 1000)
    assert reader("observe_host_us.train")(train_run(0, 5000)) is None


def test_step_count_mismatch_raises(given):
    root = train(given, 1000, launched=2)
    root.counters["env_step.lane_steps"] += 1
    for name in ("wide_step_share.train", "observe_host_us.train"):
        with pytest.raises(RuntimeError, match="lane steps"):
            reader(name)(train_run(0, 5000))


# --------------------------------------------------- the small copy, whole
def stale_step(r):
    """The env step returns its state unchanged."""
    r.algo.core.step = lambda state, *a, **k: state


def longest_lane(r):
    """The collector writes every lane's observations from the lane whose
    episodes ran longest (the fewest ended in the call): a lane index gone
    wrong underneath the benchmark's hook."""
    from qiskit_gym_torch.rl import rollout

    make = rollout._Rows.trajectory

    def wrong(rows, success):
        traj = make(rows, success)
        lane = int(torch.argmin(traj.done.sum(0)))
        obs = traj.obs[:, lane:lane + 1].expand_as(traj.obs).contiguous()
        return traj._replace(obs=obs)

    rollout._Rows.trajectory = wrong
    r.undo_plant = lambda: setattr(rollout._Rows, "trajectory", make)


def frozen_weights(r):
    """The optimizer's step leaves the weights unchanged."""
    r.algo.optimizer.step = lambda *a, **k: None


@pytest.mark.parametrize("trace", [False, True])
def test_sound_small_run_is_correct(root, trace):
    out = run(root, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    if trace:
        assert {"mfu_exact.train", "observe_host_us.train",
                "wide_step_share.train"} <= set(out["metrics"])


@pytest.mark.parametrize("fault", [stale_step, longest_lane, frozen_weights],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, fault):
    planted = []

    def plant(r):
        fault(r)
        planted.append(r)

    try:
        out = run(root, plant=plant)
    finally:
        for r in planted:
            getattr(r, "undo_plant", lambda: None)()
    assert not out["correct"], out["checks"]


def test_the_weights_follow_the_seed(root, tmp_path):
    """One seed draws the same net twice, two seeds two nets; the net has
    the program's leaves and shapes, each uniform within +-1/sqrt(inputs)."""
    from qiskit_gym_torch.models import make_policy

    cfg = harness.Cell(root, SMALL_CELL).config
    drawn = []
    for seed in (SEED, SEED, SEED + 1):
        path = tmp_path / f"{len(drawn)}.pt"
        driver().write_initial_weights(cfg, seed, str(path))
        drawn.append(torch.load(path, weights_only=True))
    w = "embeddings.weight"
    assert torch.equal(drawn[0][w], drawn[1][w])
    assert not torch.equal(drawn[0][w], drawn[2][w])
    art = json.loads((root / cfg["artifact"]["json"]).read_text())
    program = make_policy(art["policy_cls"], cfg["obs_shape"],
                          cfg["num_actions"], art["policy"]).module
    want = {k: v.shape for k, v in program.state_dict().items()}
    assert {k: v.shape for k, v in drawn[0].items()} == want
    for k, v in drawn[0].items():
        bound = want[k.replace(".bias", ".weight")][1] ** -0.5
        assert v.dtype == torch.float32
        assert float(v.abs().max()) <= bound, k
    bound = want[w][1] ** -0.5          # 32 x 5476 draws reach the bound
    assert float(drawn[0][w].abs().max()) > 0.999 * bound
