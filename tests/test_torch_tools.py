"""The port's quality and artifact tools (`qiskit_gym_torch.tools`) against
the JAX package's (`bench_quality.py`, `bench_vs_reference.py`,
`bench_baseline5.py` and `scripts/`), on the CPU.

- eval lanes: `bench_quality.eval_lanes` on `perm_grid_3x3` (policy,
  sampled best-of-N) and `az_perm_grid_3x3` (MCTS, argmax), with injected
  scrambles and the JAX collectors' own noise, give the same `success` and
  `n_cnots` on every lane as JAX `collect` / `collect_mcts`;
  `rows_from_lanes` equals the JAX `eval_artifact`'s arithmetic;
- synth targets are the same circuits as the JAX tool's, and the five
  checkers agree with the JAX tool's on solved and corrupted circuits;
- the table and section writers mirror `tests/test_bench_tools.py`;
- one tiny burst of each artifact tool runs into `tmp_path` and leaves
  `examples/models` unchanged, and `run_pair` with one artifact on both
  sides gives equal rows.
"""

import ast
import hashlib
import importlib
import json
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qiskit_gym_tpu.quantum as jax_quantum
import qiskit_gym_tpu.rl.az as jax_az
import qiskit_gym_tpu.rl.rollout as jax_rollout
from qiskit_gym_tpu.rl.synthesis import RLSynthesis as JaxRLSynthesis
from qiskit_gym_torch.quantum import Circuit
from qiskit_gym_torch.rl import EvalConfig, RLSynthesis
from qiskit_gym_torch.tools import (bench_baseline5, bench_quality,
                                    finetune_brevity, finetune_pauli_ppo,
                                    graft_pauli_ppo, optimal_bc,
                                    vs_reference)

from test_torch_az import jax_move_draws

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MODELS = os.path.join(ROOT, "examples", "models")
sys.path.insert(0, ROOT)
jax_bq = importlib.import_module("bench_quality")
jax_bvr = importlib.import_module("bench_vs_reference")


def _paths(name):
    return (os.path.join(MODELS, name + ".json"),
            os.path.join(MODELS, name + ".pt"))


def _pair(name):
    return (JaxRLSynthesis.from_config_json(*_paths(name)),
            RLSynthesis.from_config_json(*_paths(name), device="cpu"))


def _models_digest():
    h = {}
    for n in sorted(os.listdir(MODELS)):
        with open(os.path.join(MODELS, n), "rb") as f:
            h[n] = hashlib.sha256(f.read()).hexdigest()
    return h


# ------------------------------------------------------------- eval lanes
def _jax_reset(jcore, scramble, E, S, difficulty):
    state = jcore.reset(jax.random.key(0), E, difficulty,
                        scramble_override=jnp.asarray(scramble, jnp.int32))
    return jax.tree.map(lambda x: jnp.repeat(x, S, axis=0), state)


def test_policy_eval_lanes_equal_jax_collect():
    """perm_grid_3x3 sampled best-of-4 at difficulty 4: the JAX eval's
    collect (its key's Gumbel noise and flips handed to the port)."""
    jrls, trls = _pair("perm_grid_3x3")
    jcore = jrls.algorithm.core
    E, S, diff = 12, 4, 4
    T = min(jcore.depth_slope * diff, jcore.max_depth)
    scramble = np.random.default_rng(2).integers(0, jcore.num_actions,
                                                 (E, diff))
    key = jax.random.key(7)
    jfinal, _ = jax_rollout.collect(
        jcore, jrls.algorithm.policy.apply, jrls.algorithm.params,
        _jax_reset(jcore, scramble, E, S, diff), key, T)
    gumbel, flips, _ = jax_rollout._pregen_randomness(jcore, key, T, E * S,
                                                      False)
    success, cnots = bench_quality.eval_lanes(
        trls.algorithm, diff, E, S, scramble_override=torch.as_tensor(
            scramble), gumbel=torch.as_tensor(np.asarray(gumbel)),
        flips=torch.as_tensor(np.asarray(flips)))
    np.testing.assert_array_equal(success, np.asarray(jfinal.success))
    np.testing.assert_array_equal(cnots, np.asarray(jfinal.n_cnots))
    assert success.any()


def test_mcts_argmax_eval_lanes_equal_jax_collect_mcts():
    """az_perm_grid_3x3 with an argmax MCTS a move at difficulty 4 (the
    table's first row, at 8 simulations on the CPU)."""
    jrls, trls = _pair("az_perm_grid_3x3")
    jcore = jrls.algorithm.core
    E, diff, sims = 6, 4, 8
    T = min(jcore.depth_slope * diff, jcore.max_depth)
    scramble = np.random.default_rng(3).integers(0, jcore.num_actions,
                                                 (E, diff))
    key = jax.random.key(8)
    jfinal, _ = jax.jit(lambda s, k: jax_az.collect_mcts(
        jcore, jrls.algorithm.policy.apply, jrls.algorithm.params, s, k, T,
        num_sims=sims, c_puct=1.41, deterministic=True))(
            _jax_reset(jcore, scramble, E, 1, diff), key)
    success, cnots = bench_quality.eval_lanes(
        trls.algorithm, diff, E, 1, mcts=sims, deterministic=True,
        scramble_override=torch.as_tensor(scramble),
        **jax_move_draws(jcore, key, T, sims, 1, E))
    np.testing.assert_array_equal(success, np.asarray(jfinal.success))
    np.testing.assert_array_equal(cnots, np.asarray(jfinal.n_cnots))
    assert success.any()


@pytest.mark.parametrize("E,S,p", [(16, 10, 0.3), (8, 1, 0.6), (4, 3, 0.0)])
def test_rows_from_lanes_equal_the_jax_eval_arithmetic(E, S, p, monkeypatch):
    """The JAX `eval_artifact` run with its collector replaced by the same
    random lanes: solve rate, best-of-S 2q mean (nan when nothing solved)
    and mode string equal."""
    rng = np.random.default_rng(E * S)
    success = rng.random(E * S) < p
    cnots = rng.integers(0, 40, E * S).astype(np.int32)

    class Final:  # the two fields the JAX eval reads
        def __init__(self):
            self.success, self.n_cnots = jnp.asarray(success), \
                jnp.asarray(cnots)

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(jax_bq, "collect", lambda *a, **k: (Final(), None))
    monkeypatch.setattr(jax, "jit", lambda f: f)
    want = jax_bq.eval_artifact("perm_grid_3x3", [4], num_episodes=E,
                                num_searches=S)[0]
    got = bench_quality.rows_from_lanes(success, cnots, E, S,
                                        bench_quality.eval_mode(S, 0, False))
    assert got["mode"] == want["mode"]
    assert got["solve_rate"] == want["solve_rate"]
    np.testing.assert_equal(got["mean_2q"], want["mean_2q"])


# ------------------------------------------------- synth targets, checkers
def _jax_checkers():
    """The five checkers the JAX `bench_quality.main` defines inside it,
    compiled from its source with the JAX package's quantum layer."""
    src = open(os.path.join(ROOT, "bench_quality.py")).read()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    ns = {"np": np, **{k: getattr(jax_quantum, k) for k in dir(jax_quantum)
                       if not k.startswith("_")}}
    for node in main.body:
        if isinstance(node, ast.FunctionDef) and node.name.endswith("_ck"):
            exec(textwrap.dedent(ast.get_source_segment(src, node)), ns)
    return {k: ns[k] for k in ("perm_ck", "lf_ck", "cliff_ck", "unitary_ck",
                               "sv_ck")}


def _as_jax(circ):
    out = jax_quantum.Circuit(circ.num_qubits)
    for name, qs, params in circ.data:
        out.append(name, qs, params)
    return out


@pytest.mark.parametrize("name,depth,rotations", [
    ("perm_grid_3x3", 8, 0), ("pauli_5_line", 3, 2),
    ("az_pauli_18_line", 3, 2)])
def test_synth_targets_are_the_jax_tools(name, depth, rotations):
    jrls, trls = _pair(name)
    for seed in (99 + depth, 5):
        want = jax_bq._random_target(jrls, depth, np.random.default_rng(seed),
                                     rotations)
        got = bench_quality._random_target(trls, depth,
                                           np.random.default_rng(seed),
                                           rotations)
        assert got.num_qubits == want.num_qubits
        assert got.data == want.data


@pytest.mark.parametrize("check,name,depth,rotations", [
    ("perm_ck", "perm_grid_3x3", 6, 0), ("lf_ck", "lf_5_line", 6, 0),
    ("cliff_ck", "clifford_3q_custom", 6, 0),
    ("unitary_ck", "pauli_5_line", 4, 2),
    ("sv_ck", "pauli_5_line", 4, 2)])
def test_checkers_agree_with_the_jax_tools(check, name, depth, rotations):
    """On the target itself, on a copy with a gate cancelled by its
    inverse appended (solved), and with one extra 2q gate (corrupted: a
    SWAP for the permutation checker, which refuses other matrices)."""
    jck, tck = _jax_checkers()[check], getattr(bench_quality, check)
    trls = RLSynthesis.from_config_json(*_paths(name), device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(3):
        target = bench_quality._random_target(trls, depth, rng, rotations)
        same = Circuit(target.num_qubits)
        for g in target.data:
            same.append(*g)
        same.append("swap", (0, 1))
        same.append("swap", (0, 1))
        bad = Circuit(target.num_qubits)
        for g in target.data:
            bad.append(*g)
        bad.append("swap" if check == "perm_ck" else "cx", (0, 1))
        for out, solved in ((target, True), (same, True), (bad, False)):
            assert tck(out, target) == solved
            assert jck(_as_jax(out), _as_jax(target)) == solved


# ------------------------------------------------- table and section files
DOC = """# Solve quality

| artifact | difficulty | solve rate | mean 2q gates | provenance |
|---|---|---|---|---|
| alpha (PPO) | 4 | 1.00 | 3.0 | sampled · CPU · r3 |
| alpha (PPO) | 8 | 0.90 | 5.0 | sampled · CPU · r3 |
| beta (MCTS) | 4 | 0.80 | 4.0 | argmax · CPU · r3 |

## synth() round-trips

| artifact | target depth | verified solve rate | mean 2q gates | provenance |
|---|---|---|---|---|
| alpha | 4 | 1.00 | 2.0 | synth · CPU · r3 |

## BASELINE config #5

| difficulty | verified solve rate | mean SWAPs | mean 2q | seconds/target |
|---|---|---|---|---|
| 8 | 1.00 | 6.8 | 20.2 | 156.5 |
"""


@pytest.mark.parametrize("module", ["port", "jax"])
def test_patch_rows_replaces_in_place(tmp_path, module):
    bq = bench_quality if module == "port" else jax_bq
    path = tmp_path / "QUALITY.md"
    path.write_text(DOC)
    bq._patch_rows(str(path), {
        "beta (MCTS)": ["| beta (MCTS) | 4 | 0.95 | 3.5 | argmax · TPU · r4 |",
                        "| beta (MCTS) | 12 | 0.88 | 9.0 | argmax · TPU · r4 |"],
    })
    out = path.read_text()
    assert "| beta (MCTS) | 4 | 0.80" not in out
    assert out.index("| beta (MCTS) | 4 | 0.95") < out.index("## synth()")
    assert out.index("| beta (MCTS) | 12 | 0.88") < out.index("## synth()")
    assert "| alpha (PPO) | 8 | 0.90 | 5.0 | sampled · CPU · r3 |" in out
    assert "| alpha | 4 | 1.00 | 2.0 | synth · CPU · r3 |" in out
    assert "| 8 | 1.00 | 6.8 | 20.2 | 156.5 |" in out
    if module == "port":
        mirror = tmp_path / "JAX.md"
        mirror.write_text(DOC)
        jax_bq._patch_rows(str(mirror), {
            "beta (MCTS)": ["| beta (MCTS) | 4 | 0.95 | 3.5 | argmax · TPU "
                            "· r4 |", "| beta (MCTS) | 12 | 0.88 | 9.0 | "
                            "argmax · TPU · r4 |"]})
        assert mirror.read_text() == out


def test_patch_rows_appends_an_unknown_label_as_the_jax_tool(tmp_path):
    rows = {"gamma (new)": ["| gamma (new) | 4 | 0.50 | 7.0 | argmax · x |"]}
    for bq, name in ((bench_quality, "port.md"), (jax_bq, "jax.md")):
        (tmp_path / name).write_text(DOC)
        bq._patch_rows(str(tmp_path / name), rows)
    out = (tmp_path / "port.md").read_text()
    assert out == (tmp_path / "jax.md").read_text()
    assert "| gamma (new) | 4 | 0.50" in out and "| beta (MCTS) | 4 | 0.80" \
        in out


def test_only_filter_exact_and_substring():
    stems = ["az_pauli_heavy_hex_27q", "az_pauli_heavy_hex_27q_dense",
             "az_pauli_heavy_hex_27q_full", "lf_5_line"]
    for only in ("az_pauli_heavy_hex_27q", "=az_pauli_heavy_hex_27q", None,
                 "=lf_5_line", "line"):
        got = [s for s in stems if bench_quality._only_matches(only, s)]
        want = [s for s in stems if jax_bq._only_matches(only, s)]
        assert got == want
    assert [s for s in stems if bench_quality._only_matches(
        "=az_pauli_heavy_hex_27q", s)] == ["az_pauli_heavy_hex_27q"]


def _literal(node):
    """A spec table's value: literals, tuples, dict(...) calls, and the
    checkers by name."""
    if isinstance(node, ast.Call):
        return {kw.arg: _literal(kw.value) for kw in node.keywords}
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Tuple):
        return tuple(_literal(e) for e in node.elts)
    if isinstance(node, ast.Dict):
        return {_literal(k): _literal(v)
                for k, v in zip(node.keys, node.values)}
    return ast.literal_eval(node)


def test_spec_tables_are_the_jax_tools():
    """The eval and synth spec tables of the JAX `main`, read from its
    source, are copied unchanged (the checkers compared by name)."""
    src = open(os.path.join(ROOT, "bench_quality.py")).read()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    specs = {node.targets[0].id: _literal(node.value) for node in main.body
             if isinstance(node, ast.Assign)
             and isinstance(node.targets[0], ast.Name)
             and node.targets[0].id in ("eval_specs", "synth_specs")}
    assert specs["eval_specs"] == bench_quality.EVAL_SPECS
    names = {bench_quality.perm_ck: "perm_ck", bench_quality.lf_ck: "lf_ck",
             bench_quality.cliff_ck: "cliff_ck",
             bench_quality.unitary_ck: "unitary_ck",
             bench_quality.sv_ck: "sv_ck"}
    ours = {label: (name, {k: names.get(v, v) if callable(v) else v
                           for k, v in kw.items()})
            for label, (name, kw) in bench_quality.SYNTH_SPECS.items()}
    assert ours == specs["synth_specs"]


def test_vs_reference_section_write_and_replace(tmp_path):
    path = tmp_path / "QUALITY.md"
    path.write_text(DOC)
    rows = [{"config": "lf_5_line", "depth": 8, "opt_2q": 4.8,
             "ref_solve": 1.0, "ref_2q": 5.0, "ours_solve": 1.0,
             "ours_2q": 4.9}]
    sec = vs_reference.format_section(rows, "r5", "CPU", 24, 100)
    vs_reference.write_section(str(path), sec)
    out = path.read_text()
    assert vs_reference.SECTION_MARKER == jax_bvr.SECTION_MARKER
    assert out.count(vs_reference.SECTION_MARKER) == 1
    assert "| lf_5_line | 8 | 4.8 | 1.00 | 5.0 | 1.00 | 4.9 |" in out
    assert "## BASELINE config #5" in out
    rows[0]["ours_2q"] = 4.5
    vs_reference.write_section(str(path), vs_reference.format_section(
        rows, "r5", "CPU", 24, 100))
    out2 = path.read_text()
    assert out2.count(vs_reference.SECTION_MARKER) == 1
    assert "| lf_5_line | 8 | 4.8 | 1.00 | 5.0 | 1.00 | 4.5 |" in out2
    assert "| 1.00 | 4.9 |" not in out2
    # the table lines are the JAX tool's

    def table(text):
        return [ln for ln in text.splitlines() if ln.startswith("|")]

    assert table(vs_reference.format_section(rows, "r5", "CPU", 24, 100)) \
        == table(jax_bvr.format_section(rows, "r5", "CPU", 24, 100))
    fresh = tmp_path / "new.md"
    vs_reference.write_section(str(fresh), sec)
    assert fresh.read_text() == sec


def test_baseline5_targets_and_section(tmp_path):
    """The JAX script's targets (its loop, seeds 1234 + difficulty) and a
    section that replaces its earlier copy."""
    trls = RLSynthesis.from_config_json(*_paths("az_perm_heavy_hex_27q"),
                                        device="cpu")
    env = trls.env
    n = env.config["num_qubits"]
    for difficulty in (4, 16):
        rng = np.random.default_rng(1234 + difficulty)
        want = []
        for _ in range(3):
            perm = np.arange(n)
            for _ in range(difficulty):
                _, (a, b) = env.gateset[rng.integers(len(env.gateset))]
                perm[[a, b]] = perm[[b, a]]
            want.append(perm.tolist())
        assert bench_baseline5.targets(env, difficulty, 3) == want
    path = tmp_path / "q.md"
    path.write_text(DOC.split("\n## BASELINE")[0])
    row = {"difficulty": 4, "solve_rate": 1.0, "mean_swaps": 3.0,
           "mean_2q": 9.0, "mean_seconds": 12.5}
    for secs in (12.5, 7.25):
        bench_baseline5.write_section(str(path), bench_baseline5.
                                      format_section([dict(row, mean_seconds=
                                                           secs)], "note"))
    out = path.read_text()
    assert out.count("## BASELINE config #5") == 1
    assert "| 4 | 1.00 | 3.0 | 9.0 | 7.2 |" in out and "## synth()" in out


# ------------------------------------------------------ the artifact tools
def _shrink_ppo(rls):
    rls.rl_config = rls.rl_config.with_updates(
        num_episodes=16, num_epochs=1,
        evals={"ppo_deterministic": EvalConfig(num_episodes=4)})
    rls.algorithm.config = rls.rl_config


def test_finetune_brevity_one_burst(tmp_path):
    before = _models_digest()
    rls = RLSynthesis.from_config_json(*_paths("lf_5_line"), device="cpu")
    _shrink_ppo(rls)
    final = finetune_brevity.run(rls, "lf_5_line", minutes=1e-3,
                                 out=str(tmp_path), iterations=1,
                                 num_targets=2, difficulties=(4,))
    rows = [json.loads(ln) for ln in open(tmp_path / "evidence.jsonl")]
    assert [r["phase"] for r in rows] == ["baseline", "burst", "final"]
    assert rows[1]["difficulty"] == 4 and final["phase"] == "final"
    assert (tmp_path / "learn" / "metrics.jsonl").exists()
    assert (tmp_path / "lf_5_line.json").exists() == final["shipped"]
    assert _models_digest() == before


def test_optimal_bc_one_burst(tmp_path):
    before = _models_digest()
    final = optimal_bc.run("perm_grid_3x3", minutes=1e-3, out=str(tmp_path),
                           num_targets=2, device="cpu", per_shell=8,
                           num_minibatches=4)
    rows = [json.loads(ln) for ln in open(tmp_path / "evidence.jsonl")]
    assert [r["phase"] for r in rows] == ["bfs", "corpus", "baseline",
                                          "burst", "final"]
    assert (rows[0]["states"], rows[0]["diameter"]) == (362880, 16)
    assert np.isfinite(rows[3]["bc_loss"])
    assert (tmp_path / "perm_grid_3x3.pt").exists() == final["shipped"]
    assert _models_digest() == before


def test_finetune_pauli_ppo_one_burst(tmp_path):
    before = _models_digest()
    rls = RLSynthesis.from_config_json(*_paths("pauli_heavy_hex_27q"),
                                       device="cpu")
    demos = finetune_pauli_ppo.corpus(rls, per_diff=1, log=lambda r: None)
    assert demos["episodes"] > 0
    final = finetune_pauli_ppo.run(rls, minutes=1e-3, out=str(tmp_path),
                                   demos=demos, num_targets=1,
                                   num_episodes=2, num_minibatches=2)
    rows = [json.loads(ln) for ln in open(tmp_path / "evidence.jsonl")]
    assert [r["phase"] for r in rows] == ["baseline", "burst", "final"]
    assert [r["difficulty"] for r in rows[0]["evals"]] == [4, 8, 14]
    assert final["shipped"] == (tmp_path / "pauli_heavy_hex_27q.pt").exists()
    assert _models_digest() == before


def test_graft_measures_both_weights_in_memory(tmp_path):
    before = _models_digest()
    rls = RLSynthesis.from_config_json(*_paths("pauli_heavy_hex_27q"),
                                       device="cpu")
    own = rls.algorithm.params
    final = graft_pauli_ppo.run(rls, out=str(tmp_path), ship=True,
                                num_episodes=2, num_targets=1)
    rows = [json.loads(ln) for ln in open(tmp_path / "evidence.jsonl")]
    assert [r["tag"] for r in rows[:2]] == ["ppo_shipped", "az_grafted"]
    assert final["tag"] in ("shipped", "not_shipped")
    assert (tmp_path / "pauli_heavy_hex_27q.pt").exists() == \
        (final["tag"] == "shipped")
    for k, v in rls.algorithm.params.items():    # its own weights are back
        assert torch.equal(v, own[k])
    assert _models_digest() == before


def test_run_pair_with_one_artifact_on_both_sides():
    rows = vs_reference.run_pair("perm_grid_3x3", "perm_grid_3x3",
                                 vs_reference._perm_ck, [4], MODELS, MODELS,
                                 num_targets=3, num_searches=8,
                                 device="cpu")
    (row,) = rows
    assert row["ref_solve"] == row["ours_solve"] == 1.0
    assert row["ref_2q"] == row["ours_2q"]
    assert row["opt_2q"] <= row["ours_2q"]


@pytest.mark.parametrize("module,argv", [
    (bench_baseline5, ["--targets", "1"]),
    (bench_quality, ["--only", "=lf_5_line"]),
    (finetune_brevity, ["lf_5_line", "0"]),
])
def test_entry_points_default_to_the_card(module, argv, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv + ["--out", str(tmp_path / "x")])
