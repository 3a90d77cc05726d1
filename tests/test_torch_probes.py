"""The port's MCTS evidence probes (`tools/probe_depth_cap.py`,
`tools/probe_sims_vs_priors.py`) against the JAX package's scripts, on the
CPU at E = 2 episodes, 4 simulations and one difficulty.

The rows carry the JAX probes' fields (read from their sources) and the
JAX depth-cap probe's arithmetic (its `solve_rate` and `mean_2q`
expressions, compiled out of its source, on the same lanes), and nothing
is written outside `--out`: not the working directory, not
`runs-evidence/`, not `examples/models/`."""

import ast
import hashlib
import json
import os

import numpy as np
import pytest

from qiskit_gym_torch.examples._common import REPO
from qiskit_gym_torch.tools import probe_depth_cap, probe_sims_vs_priors


def script(name: str) -> ast.Module:
    with open(os.path.join(REPO, "scripts", name)) as f:
        return ast.parse(f.read())


def dict_passed_to(tree, func: str) -> ast.Dict:
    return next(node.args[0] for node in ast.walk(tree)
                if isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == func)


def tree_digest(*dirs) -> dict:
    out = {}
    for d in dirs:
        for root, _, files in os.walk(d):
            for f in files:
                p = os.path.join(root, f)
                with open(p, "rb") as fh:
                    out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture
def guarded(tmp_path, monkeypatch):
    """A scratch working directory; fails if the probe wrote anywhere but
    the paths it was given or changed the shipped trees."""
    shipped = [os.path.join(REPO, "runs-evidence"),
               os.path.join(REPO, "examples", "models")]
    before = tree_digest(*shipped)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    yield tmp_path
    assert list(cwd.iterdir()) == []
    assert tree_digest(*shipped) == before


def test_depth_cap_rows_and_arithmetic(guarded):
    out = guarded / "depth_cap.jsonl"
    rows = probe_depth_cap.run(
        cases=(("az_perm_heavy_hex_27q", (32,), 4),), episodes=2,
        out=str(out), device="cpu")
    assert [json.loads(x) for x in out.read_text().splitlines()] == rows
    assert sorted(os.listdir(guarded)) == ["cwd", "depth_cap.jsonl"]
    tree = script("probe_depth_cap.py")
    fields = dict_passed_to(tree, "log_row")
    keys = {k.value for k in fields.keys}
    assert [r["cap"] for r in rows] == list(probe_depth_cap.CAPS)
    for r in rows:
        assert set(r) == keys | {"t"}   # log_row adds the time
        assert (r["artifact"], r["difficulty"], r["horizon"], r["sims"],
                r["episodes"]) == ("az_perm_heavy_hex_27q", 32, 64, 4, 2)
        assert 0.0 <= r["solve_rate"] <= 1.0
    # the JAX probe's own expressions for the two scores, on the same lanes
    exprs = {k.value: ast.unparse(v)
             for k, v in zip(fields.keys, fields.values)
             if k.value in ("solve_rate", "mean_2q")}
    rng = np.random.default_rng(0)
    for success in (rng.random(16) < 0.5, np.zeros(16, bool)):
        cnots = rng.integers(0, 40, 16).astype(np.int32)
        want = {k: eval(e, {"np": np}, {"success": success, "cnots": cnots})
                for k, e in exprs.items()}
        assert probe_depth_cap.score(success, cnots) == want


def test_sims_vs_priors_document(guarded):
    out = guarded / "sims.json"
    doc = probe_sims_vs_priors.run("t", 2, str(out), "cpu",
                                   difficulties=(8,), sims=(4,))
    assert json.loads(out.read_text()) == doc
    assert sorted(os.listdir(guarded)) == ["cwd", "sims.json"]
    tree = script("probe_sims_vs_priors.py")
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    docs = [n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
            and getattr(n.targets[0], "id", None) == "out"]
    assert set(doc) == {k.value for k in docs[0].keys}
    rows_dict = next(node.args[0] for node in ast.walk(main)
                     if isinstance(node, ast.Call)
                     and getattr(node.func, "attr", None) == "append")
    row_keys = {k.value for k in rows_dict.keys}
    assert doc["artifact"] == "az_pauli_heavy_hex_27q_full"
    assert doc["hardware"] == "CPU"
    assert [(r["difficulty"], r["sims"]) for r in doc["rows"]] == [(8, 4)]
    for r in doc["rows"]:
        assert set(r) == row_keys
        assert 0.0 <= r["argmax_solve_rate"] <= 1.0
