"""The port's user programs (`qiskit_gym_torch/examples/`) against the JAX
package's `examples/`, on the CPU.

- Config parity: the `env`, `policy` and `algorithm` sections (class paths
  mapped to their last segment; `difficulty` and `trained_with` left out)
  that each ported recipe's `build(device="cpu")` would save equal those of
  the shipped `examples/models/<stem>.json` the JAX recipe wrote. Where a
  later program re-saved the shipped JSON, the case names the sections
  that differ and why.
- Tour parity: the tour's seeded sections print what the JAX tour prints.
- Resume: a JAX `train_state.msgpack` and a port `train_state.pt` resume
  into the same params, iteration and difficulty.
- Walk logic: one burst of `walk_pauli_az.run`, shrunk after `build()`.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import qiskit_gym_tpu.rl.checkpoint as jax_ckpt
from qiskit_gym_tpu.rl import RLSynthesis as JaxRLSynthesis
from qiskit_gym_torch.examples import (
    finetune_clifford_27q_demos,
    intro,
    resume_training,
    train_clifford_3q_custom,
    train_pauli_12q,
    train_pauli_18q_az,
    train_pauli_27q,
    train_pauli_27q_az,
    train_pauli_27q_az_dense,
    train_pauli_27q_dense,
    train_pauli_27q_full_az,
    train_pauli_27q_full_bc,
    train_pauli_5line,
    train_pauli_bc,
    train_pauli_line,
    walk_pauli_az,
)
from qiskit_gym_torch.examples._common import MODELS, Evidence, read_config
from qiskit_gym_torch.models import params_from_jax
from qiskit_gym_torch.rl import EvalConfig

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SECTIONS = ("env", "policy_cls", "policy", "algorithm_cls", "algorithm")
RESAVED_BY_BC = ("train_pauli_bc re-saved the artifact with its own AZ "
                 "config (temperature_drop 12, episode packing over 4 pool "
                 "slots, diff_replay 4); its own case below matches")

# (recipe case, build, shipped stem, {section: why it differs})
RECIPES = [
    ("train_clifford_3q_custom", lambda: train_clifford_3q_custom.build(
        device="cpu"), "clifford_3q_custom", {}),
    ("train_pauli_5line", lambda: train_pauli_5line.build(device="cpu"),
     "pauli_5_line",
     {"env": "the shipped JSON predates the gym's explicit pauli_diff_scale "
             "default of 16, which both packages' to_json now write; "
             "loading the shipped JSON gives 16 too"}),
    ("train_pauli_line_18", lambda: train_pauli_line.build(18, device="cpu"),
     "pauli_18_line", {}),
    ("train_pauli_12q", lambda: train_pauli_12q.build(device="cpu"),
     "pauli_12_line", {}),
    ("train_pauli_27q", lambda: train_pauli_27q.build(device="cpu"),
     "pauli_heavy_hex_27q", {}),
    ("train_pauli_27q_dense", lambda: train_pauli_27q_dense.build(
        device="cpu"), "pauli_heavy_hex_27q_dense", {}),
    ("train_pauli_18q_az", lambda: train_pauli_18q_az.build(device="cpu"),
     "az_pauli_18_line", {"algorithm": RESAVED_BY_BC}),
    ("train_pauli_27q_az", lambda: train_pauli_27q_az.build(device="cpu"),
     "az_pauli_heavy_hex_27q",
     {"algorithm": "train_pauli_bc and then walk_pauli_az re-saved the "
                   "artifact with their config (512 lanes, 96 simulations, "
                   "4 epochs, lr 3e-4, packing, diff_replay 4); the walk's "
                   "case below matches"}),
    ("train_pauli_27q_az_dense", lambda: train_pauli_27q_az_dense.build(
        device="cpu"), "az_pauli_heavy_hex_27q_dense",
     {"algorithm": RESAVED_BY_BC}),
    ("train_pauli_bc_18_line", lambda: train_pauli_bc.build(
        "az_pauli_18_line", device="cpu"), "az_pauli_18_line", {}),
    ("train_pauli_bc_27q_dense", lambda: train_pauli_bc.build(
        "az_pauli_heavy_hex_27q_dense", device="cpu"),
     "az_pauli_heavy_hex_27q_dense", {}),
    ("train_pauli_27q_full_bc", lambda: train_pauli_27q_full_bc.build(
        device="cpu"), "az_pauli_heavy_hex_27q_full", {}),
    ("train_pauli_27q_full_az", lambda: train_pauli_27q_full_az.build(
        device="cpu"), "az_pauli_heavy_hex_27q_full", {}),
    ("finetune_clifford_27q_demos", lambda: finetune_clifford_27q_demos.build(
        device="cpu"), "clifford_heavy_hex_27q",
     {"algorithm_cls": "the recipe writes weights only; the shipped JSON "
                       "is the PPO artifact's, its BC stack is AlphaZero",
      "algorithm": "the recipe's AZ config (8 lanes, 4 simulations, the "
                   "two policy evals) is never saved"}),
    ("walk_pauli_az", lambda: walk_pauli_az.build(
        "az_pauli_heavy_hex_27q", device="cpu"), "az_pauli_heavy_hex_27q",
     {}),
]


def _sections(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["env"].pop("difficulty", None)
    for k in ("policy_cls", "algorithm_cls"):
        cfg[k] = cfg[k].split(".")[-1]
    return {k: cfg[k] for k in SECTIONS}


@pytest.mark.parametrize("case,build,stem,differs", RECIPES,
                         ids=[r[0] for r in RECIPES])
def test_recipe_config_matches_the_shipped_json(case, build, stem, differs):
    got, want = _sections(build().to_json()), _sections(read_config(stem))
    for k in SECTIONS:
        if k in differs:
            assert got[k] != want[k], (
                f"{case}: {k} now equals the shipped one; drop the note "
                f"({differs[k]})")
        else:
            assert got[k] == want[k], f"{case}: {k}"


# ------------------------------------------------------------------ tour
def _jax_intro():
    spec = importlib.util.spec_from_file_location(
        "jax_examples_intro", os.path.join(ROOT, "examples", "intro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded_adapter(adapter):
    """The module's gym_adapter with the action space's sampling seeded,
    so the tour's random actions are the same in both packages."""
    def make(env):
        genv = adapter(env)
        genv.action_space.seed(11)
        return genv
    return make


def test_tour_seeded_sections_print_what_the_jax_tour_prints(monkeypatch,
                                                            capsys):
    jintro = _jax_intro()
    for mod in (jintro, intro):
        monkeypatch.setattr(mod, "gym_adapter",
                            _seeded_adapter(mod.gym_adapter))

    def printed(fn, *args) -> str:
        capsys.readouterr()
        fn(*args)
        return capsys.readouterr().out

    want = printed(jintro.manual_stepping)
    got = printed(intro.manual_stepping, "cpu")
    assert "episode return:" in want and got == want
    want = printed(jintro.pauli_network_synthesis)
    got = printed(intro.pauli_network_synthesis, "cpu")
    assert "unitary-exact (up to global phase): True" in want
    assert got == want


# ---------------------------------------------------------------- resume
def test_resume_restores_jax_and_port_snapshots_alike(tmp_path):
    cfg = os.path.join(MODELS, "perm_grid_3x3.json")
    jrls = JaxRLSynthesis.from_config_json(cfg)
    jalgo = jrls.algorithm
    jalgo.params = jax.tree.map(lambda x: x + 0.5, jalgo.params)
    jalgo.iteration, jalgo.env.difficulty = 20, 5
    jax_run = tmp_path / "jax_run"
    jax_run.mkdir()
    jax_ckpt.save_training_state(jalgo, str(jax_run / "train_state.msgpack"))

    from_jax = resume_training.build(cfg, str(jax_run), device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, jalgo.params))
    assert (from_jax.algorithm.iteration, from_jax.env.difficulty) == (20, 5)
    for k, v in from_jax.params.items():
        assert torch.equal(v, want[k]), k

    port_run = tmp_path / "port_run"
    port_run.mkdir()
    from_jax.algorithm.save_training_state(str(port_run / "train_state.pt"))
    from_port = resume_training.build(cfg, str(port_run), fixed_horizon=True,
                                      device="cpu")
    assert (from_port.algorithm.iteration, from_port.env.difficulty) == (
        20, 5)
    assert from_port.algorithm.fixed_horizon
    for k, v in from_port.params.items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(FileNotFoundError):
        resume_training.build(cfg, str(tmp_path), device="cpu")


# ------------------------------------------------------------------ walk
def _tree_state(*dirs):
    out = {}
    for d in dirs:
        for dirpath, _, names in os.walk(os.path.join(ROOT, d)):
            for n in names:
                st = os.stat(os.path.join(dirpath, n))
                out[os.path.join(dirpath, n)] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.mark.parametrize("threshold", [0.0, 1.01],
                         ids=["every_gate_passes", "no_gate_passes"])
def test_walk_burst_promotes_only_on_the_gate(tmp_path, monkeypatch,
                                              threshold):
    monkeypatch.chdir(tmp_path)          # a default run path would land here
    before = _tree_state("examples", "runs-evidence")
    stem = "az_pauli_18_line"
    rls = walk_pauli_az.build(stem, device="cpu")
    rls.rl_config = rls.rl_config.with_updates(
        num_episodes=4, num_mcts_searches=2, num_epochs=1,
        diff_threshold=threshold,
        evals={"mcts_100": EvalConfig(num_episodes=2, num_mcts_searches=2)})
    rls.algorithm.config = rls.rl_config
    out = tmp_path / "out"
    log = Evidence(str(tmp_path), "corpus.jsonl")
    demos = walk_pauli_az.corpus(rls, log, per_diff=1)
    # a budget so short that exactly one burst (2 iterations) runs
    walk_pauli_az.run(rls, stem, minutes=1e-3, start=5, out=str(out),
                      demos=demos)

    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert len(rows) == 2
    passed = [r["difficulty"] for r in rows if r["eval/mcts_100"] >= threshold]
    assert rls.algorithm.best_difficulty == max(passed, default=0)
    assert rls.env.difficulty == 5 + len(passed)
    evidence = [json.loads(line) for line in open(out / "evidence.jsonl")]
    assert [r["phase"] for r in evidence] == ["walk", "walk", "final"]
    assert evidence[1]["best_difficulty"] == rls.algorithm.best_difficulty
    saved = (out / f"{stem}.json").exists()
    assert saved == bool(passed) == (out / f"{stem}.pt").exists()
    if saved:
        note = json.load(open(out / f"{stem}.json"))["trained_with"]
        assert "gate-proven" in note and "Prior provenance" in note
    assert sorted(os.listdir(tmp_path)) == ["corpus.jsonl", "out"]
    assert _tree_state("examples", "runs-evidence") == before


# ------------------------------------------------------------ entry points
MAINS = [
    ("intro", []),
    ("resume_training", [os.path.join(MODELS, "perm_grid_3x3.json"), "."]),
    ("train_clifford_3q_custom", ["1"]),
    ("train_pauli_5line", ["1"]),
    ("train_pauli_line", ["5", "1"]),
    ("train_pauli_12q", ["1"]),
    ("train_pauli_27q", ["1"]),
    ("train_pauli_27q_dense", ["1"]),
    ("train_pauli_18q_az", ["1"]),
    ("train_pauli_27q_az", ["1"]),
    ("train_pauli_27q_az_dense", ["1"]),
    ("train_pauli_bc", ["az_pauli_18_line", "1", "1"]),
    ("train_pauli_27q_full_bc", ["1", "1"]),
    ("finetune_clifford_27q_demos", ["1"]),
    ("train_pauli_27q_full_az", ["1", "8"]),
    ("walk_pauli_az", ["az_pauli_heavy_hex_27q", "5", "25"]),
]


@pytest.mark.parametrize("name,args", MAINS, ids=[m[0] for m in MAINS])
def test_entry_point_runs_on_the_card_by_default(name, args, tmp_path,
                                                  monkeypatch):
    """`python -m qiskit_gym_torch.examples.<name> <args> --out DIR` parses
    the JAX script's positional arguments and then asks for the card,
    which this machine lacks: it raises before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the CPU-only refusal is moot")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"qiskit_gym_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args + ["--out", str(tmp_path / "out")])
    assert os.listdir(tmp_path) == []
