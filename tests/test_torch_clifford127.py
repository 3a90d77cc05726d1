"""IBM's 127-qubit Eagle heavy-hex map in the port: the layout against a
hand-written edge list, the benchmark's committed artifact against the one
the layout generates, the map's automorphisms, and one PPO iteration of
the port against the plain reference (`portbench/reference`) on seeded
fresh weights at the Eagle sub-map of qubits 0-36, which takes the
multi-word path (2n = 74 rows, W = 3 words a column)."""

import json
import os
import sys
from collections import deque

import pytest

from qiskit_gym_torch.envs.coupling_maps import eagle_127q
from qiskit_gym_torch.envs.synthesis import CliffordGym
from qiskit_gym_torch.spec.symmetry import coupling_automorphisms

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "portbench", "tests"))
from test_portbench_clifford127 import (SEED, SMALL_CELL,  # noqa: E402
                                        SMALL_TRAFFIC, small_copy)

BASIS = ("H", "S", "Sdg", "SX", "SXdg", "CX", "CZ", "SWAP")
ROWS = [range(0, 14), range(18, 33), range(37, 52), range(56, 71),
        range(75, 90), range(94, 109), range(113, 127)]
# (bridge qubit, the qubit it joins above, the qubit it joins below), as
# on ibm_washington
BRIDGES = [
    (14, 0, 18), (15, 4, 22), (16, 8, 26), (17, 12, 30),
    (33, 20, 39), (34, 24, 43), (35, 28, 47), (36, 32, 51),
    (52, 37, 56), (53, 41, 60), (54, 45, 64), (55, 49, 68),
    (71, 58, 77), (72, 62, 81), (73, 66, 85), (74, 70, 89),
    (90, 75, 94), (91, 79, 98), (92, 83, 102), (93, 87, 106),
    (109, 96, 114), (110, 100, 118), (111, 104, 122), (112, 108, 126)]


def _adjacency(edges, n=127):
    adj = [set() for _ in range(n)]
    for a, b in edges:
        adj[a].add(b)
        adj[b].add(a)
    return adj


def test_eagle_layout():
    edges = eagle_127q()
    want = sorted([(q, q + 1) for row in ROWS for q in row[:-1]]
                  + [(min(b, q), max(b, q)) for b, up, down in BRIDGES
                     for q in (up, down)])
    assert edges == want
    assert len(edges) == 144 == len(set(edges))
    assert all(a < b for a, b in edges)
    assert {q for e in edges for q in e} == set(range(127))
    adj = _adjacency(edges)
    assert max(len(a) for a in adj) == 3
    # connected and bipartite: a breadth-first 2-colouring from qubit 0
    # reaches every qubit and no edge joins two of one colour
    colour = {0: 0}
    todo = deque([0])
    while todo:
        u = todo.popleft()
        for v in adj[u]:
            if v not in colour:
                colour[v] = 1 - colour[u]
                todo.append(v)
    assert len(colour) == 127
    assert all(colour[a] != colour[b] for a, b in edges)


def _env():
    return CliffordGym.from_coupling_map(eagle_127q(), basis_gates=BASIS,
                                         device="cpu")


def test_committed_artifact_is_generated():
    """The benchmark's 127q artifact: the env the layout generates, with
    the policy, algorithm and class names of the shipped 27q heavy-hex
    Clifford artifact."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "clifford127.artifact.json")) as f:
        got = json.load(f)
    with open(os.path.join(ROOT, "examples", "models",
                           "clifford_heavy_hex_27q.json")) as f:
        shipped = json.load(f)
    env = _env().to_json()
    want = {k: shipped[k] for k in ("env_cls", "policy_cls", "policy",
                                    "algorithm_cls", "algorithm")}
    want["env"] = {k: env[k] for k in shipped["env"]}
    assert got == json.loads(json.dumps(want))
    assert len(got["env"]["gateset"]) == 5 * 127 + 3 * 144 == 1067


def test_eagle_automorphisms():
    """The undirected map has two: the identity and q -> 126 - q. The
    one-way CX and CZ of the gateset leave the policy one symmetry copy."""
    env = _env()
    assert coupling_automorphisms(127, env.spec.gateset) == [
        list(range(127)), list(range(126, -1, -1))]
    obs_perms, act_perms = env.twists()
    assert len(obs_perms) == len(act_perms) == 1
    assert list(env.obs_shape()) == [254, 254]
    assert env.num_actions() == 1067
    assert env.core.W == 8


@pytest.fixture(scope="module")
def iteration(tmp_path_factory):
    """The readings of one small run of the training cell on the Eagle
    sub-map: the program's, and the reference's own in bfloat16 (the
    control)."""
    from portbench import harness
    from portbench.control import readings

    root = small_copy(tmp_path_factory.mktemp("checkout"))
    limits = harness.Cell(root, SMALL_CELL).config["limits"]["ppo_train"]
    return readings(root, SMALL_CELL, SEED, "cpu", SMALL_TRAFFIC,
                    seconds=0.0), limits


def test_ppo_iteration_against_the_reference(iteration):
    got, limits = iteration
    program = got["program"]
    for exact in ("missing_captures", "transition_errors", "reward_errors"):
        assert program[exact] == 0, exact
    for name, limit in limits.items():
        assert 0 <= program[name] <= limit, name
    assert all(v <= lim for v, lim in
               ((got["checks"][k], limits.get(k, 0)) for k in got["checks"]))


def test_a_bfloat16_policy_fails_the_limits(iteration):
    got, limits = iteration
    control = got["control"]
    assert control["transition_errors"] == control["reward_errors"] == 0
    assert any(control[name] > limit for name, limit in limits.items())
