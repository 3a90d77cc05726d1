"""The frozen reference against a statevector, and against the program's
own plain CPU paths at small sizes."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import targets
from portbench.reference import ppo as ref_ppo
from portbench.reference import tableau
from portbench.reference.policy import MatrixTransition, Policy

ROOT = Path(__file__).resolve().parents[2]
MODELS = ROOT / "examples" / "models"

# ------------------------------------------------------------ statevector
_S2 = 2 ** -0.5
ONE_Q = {
    "h": np.array([[1, 1], [1, -1]]) * _S2,
    "s": np.diag([1, 1j]), "sdg": np.diag([1, -1j]),
    "sx": np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]]) / 2,
    "sxdg": np.array([[1 - 1j, 1 + 1j], [1 + 1j, 1 - 1j]]) / 2,
    "x": np.array([[0, 1], [1, 0]]), "y": np.array([[0, -1j], [1j, 0]]),
    "z": np.diag([1, -1]), "id": np.eye(2),
}


def _rot(name, t):
    c, s = np.cos(t / 2), np.sin(t / 2)
    return {"rx": np.array([[c, -1j * s], [-1j * s, c]]),
            "ry": np.array([[c, -s], [s, c]]),
            "rz": np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])}[name]


def unitary(n, circuit):
    """The circuit's matrix; qubit 0 is the least significant bit."""
    u = np.eye(2 ** n, dtype=complex)
    for name, qs, params in circuit:
        psi = u.reshape([2] * n + [2 ** n])
        if name in ONE_Q or name in ("rx", "ry", "rz"):
            g = ONE_Q[name] if name in ONE_Q else _rot(name, params[0])
            ax = n - 1 - qs[0]
            psi = np.moveaxis(np.tensordot(g, psi, axes=([1], [ax])), 0, ax)
        else:
            a, b = (n - 1 - q for q in qs)
            psi = np.moveaxis(psi, (a, b), (0, 1)).copy()
            if name == "cx":
                psi[1] = psi[1][::-1].copy()
            elif name == "cz":
                psi[1, 1] *= -1
            else:  # swap
                psi = psi.swapaxes(0, 1)
            psi = np.moveaxis(psi, (0, 1), (a, b))
        u = psi.reshape(2 ** n, 2 ** n)
    return u


def same_up_to_phase(u, v):
    return abs(abs(np.trace(u.conj().T @ v)) / u.shape[0] - 1) < 1e-9


GATES = [(g, (q,)) for g in ("h", "s", "sdg", "sx", "sxdg", "x", "y", "z")
         for q in range(3)] + [(g, p) for g in ("cx", "cz", "swap")
                               for p in ((0, 1), (1, 0), (1, 2), (2, 0))]


def random_circuit(rng, length, rotations=0):
    out = []
    for _ in range(length):
        name, qs = GATES[rng.integers(len(GATES))]
        out.append((name, qs, ()))
    for _ in range(rotations):
        pos = int(rng.integers(len(out) + 1))
        out.insert(pos, (("rx", "ry", "rz")[rng.integers(3)],
                         (int(rng.integers(3)),),
                         (float(rng.uniform(0.1, 3.0)),)))
    return out


@pytest.mark.parametrize("seed", range(40))
def test_verifiers_agree_with_the_statevector(seed):
    """Random pairs, half of them equivalent by construction (a circuit and
    the same circuit with an identity inserted, or a Pauli appended that
    changes a sign), each judged by the tableau and by the unitary."""
    rng = np.random.default_rng(seed)
    rot = seed % 3
    a = random_circuit(rng, 6, rot)
    b = list(a)
    k = int(rng.integers(len(b) + 1))
    kind = seed % 4
    if kind == 0:      # identity inserted: equivalent
        b[k:k] = [("h", (1,), ()), ("h", (1,), ())]
    elif kind == 1:    # a sign flipped
        b.append(("x", (int(rng.integers(3)),), ()))
    elif kind == 2:    # another circuit
        b = random_circuit(rng, 6, rot)
    else:              # S S = Z: equivalent through a different path
        b[k:k] = [("s", (0,), ()), ("s", (0,), ()), ("z", (0,), ())]
    want = same_up_to_phase(unitary(3, a), unitary(3, b))
    verify = tableau.verify_pauli if rot else tableau.verify_clifford
    assert verify(3, b, a) == want


def test_rotation_commutes_through_clifford():
    target = [("h", (0,), ()), ("rz", (0,), (0.7,))]
    out = [("rx", (0,), (0.7,)), ("h", (0,), ())]
    assert tableau.verify_pauli(1, out, target)
    assert not tableau.verify_pauli(1, [("rx", (0,), (-0.7,)),
                                        ("h", (0,), ())], target)
    assert not tableau.verify_pauli(1, [("rz", (0,), (0.7,)),
                                        ("h", (0,), ())], target)


def test_corrupted_answers_fail():
    rng = np.random.default_rng(3)
    a = random_circuit(rng, 10)
    assert tableau.verify_clifford(3, list(a), a)
    assert not tableau.verify_clifford(3, a + [("cx", (0, 1), ())], a)
    assert not tableau.verify_clifford(3, a[:-1], a) or a[-1][0] == "id"


# ----------------------------------------------- against the program (CPU)
def _env(stem):
    from qiskit_gym_torch.envs.synthesis import SYNTH_ENVS

    full = json.loads((MODELS / f"{stem}.json").read_text())
    env = SYNTH_ENVS[full["env_cls"].split(".")[-1]].from_json(
        full["env"], device="cpu")
    gs = [(g[0], tuple(g[1])) for g in full["env"]["gateset"]]
    return env, gs


@pytest.mark.parametrize("stem,family,rot", [
    ("clifford_heavy_hex_27q", "clifford", 0),
    ("pauli_heavy_hex_27q", "pauli", 1)])
def test_transition_and_start_follow_the_program(stem, family, rot):
    """The plain step explains every step of the program's env, and not
    an env that returns its state unchanged."""
    from qiskit_gym_torch.ops.lanes import env_step
    from qiskit_gym_torch.quantum import Circuit

    env, gs = _env(stem)
    core = env.core
    ref = MatrixTransition(27, gs, family)
    rng = np.random.default_rng(4)
    tgt = targets.random_target(rng, gs, 27, 8, rot)
    qc = Circuit(27)
    for g in tgt:
        qc.append(*g)
    state = env.make_solve_state(env.get_state(qc), 4)
    dim = 54
    obs0 = core.dense(state)[0].numpy()[:, :dim]
    assert ref.start_ok(obs0, tableau.encoded_state(27, tgt))
    g = torch.Generator().manual_seed(5)
    obs, acts, inv = [core.dense(state).numpy()[..., :dim]], [], []
    inv.append(getattr(state, "inverted", torch.zeros(4, dtype=bool)).numpy())
    for _ in range(12):
        a = torch.randint(0, len(gs), (4,), generator=g)
        flip = torch.rand(4, generator=g) < 0.5
        perm = (torch.randint(0, core.num_perms, (4,), generator=g,
                              dtype=torch.int32)
                if hasattr(core, "translate_action") else None)
        actual = core.translate_action(state, a) if perm is not None else a
        state = env_step(core, state, a, flip, perm, actual)
        acts.append(a.numpy())
        obs.append(core.dense(state).numpy()[..., :dim])
        inv.append(getattr(state, "inverted",
                           torch.zeros(4, dtype=bool)).numpy())
    obs, acts, inv = np.stack(obs), np.stack(acts), np.stack(inv)
    T = acts.shape[0]
    ok = np.ones(T, bool)
    for j in range(4):
        assert ref.errors(obs[:, j], acts[:, j], ok, ~ok, inv[:, j]) == 0
        stale = np.repeat(obs[:1, j], T + 1, axis=0)
        assert ref.errors(stale, acts[:, j], ok, ~ok,
                          np.zeros(T + 1, bool)) > 0


@pytest.mark.parametrize("stem", ["clifford_heavy_hex_27q",
                                  "pauli_heavy_hex_27q", "perm_grid_3x3"])
def test_policy_matches_the_program(stem):
    from qiskit_gym_torch.rl.synthesis import RLSynthesis

    rls = RLSynthesis.from_config_json(str(MODELS / f"{stem}.json"),
                                       str(MODELS / f"{stem}.pt"),
                                       device="cpu")
    shape = rls.env.obs_shape()
    obs = torch.randint(0, 2, (16, *shape), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want_l, want_v = rls.algorithm.policy(obs)
        got_l, got_v = Policy(str(MODELS / f"{stem}.json"),
                              str(MODELS / f"{stem}.pt"), "cpu")(obs)
    assert torch.allclose(got_l, want_l, atol=1e-4)
    assert torch.allclose(got_v, want_v, atol=1e-4)


def test_ppo_pieces_match_the_program():
    from qiskit_gym_torch.rl.rollout import Trajectory, gae

    g = torch.Generator().manual_seed(2)
    T, L = 9, 5
    reward = torch.randn(T, L, generator=g)
    value = torch.randn(T, L, generator=g)
    valid = torch.rand(T, L, generator=g) < 0.8
    done = torch.rand(T, L, generator=g) < 0.2
    last = torch.randn(L, generator=g)
    z = torch.zeros(T, L)
    traj = Trajectory(obs=z, action=z.long(), actual=z.long(), logp=z,
                      value=value, reward=reward, valid=valid, done=done,
                      inverted=valid, success=valid[0])
    want = gae(traj, 0.99, 0.95, last_value=last)
    got = ref_ppo.gae(reward, value, valid, done, last, 0.99, 0.95)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-6)


def test_reference_imports_no_program_and_no_jax():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in ("numpy", "torch", "json",
                                              "typing", "__future__"), (
                    path.name, name)


def test_metrics_costs_and_rewards():
    from portbench.reference import metrics as m

    gateset = [("CX", (0, 1)), ("CZ", (1, 2)), ("SWAP", (0, 2)), ("H", (0,))]
    cnots, gates = m.action_costs(gateset)
    assert cnots.tolist() == [1, 1, 3, 0] and gates.tolist() == [1, 3, 3, 1]
    circuit = [("cx", (0, 1), ()), ("h", (1,), ()), ("cx", (1, 0), ()),
               ("h", (1,), ()), ("swap", (0, 1), ()), ("rz", (0,), (0.3,))]
    assert m.circuit_cnots(circuit) == 5
    actions = np.array([[0, 2], [3, 1], [1, 0]])
    valid = np.array([[True, True], [True, True], [False, True]])
    assert [c.tolist() for c in m.lane_counts(actions, valid,
                                              (cnots, gates))] == [
        [1, 5], [2, 7]]
    w = m.weights({})
    assert w == (np.float32(0.01), np.float32(1e-4), np.float32(0.01))
    got = m.step_rewards(np.array([False, True]), np.array([1, 0]),
                         np.array([3, 1]), np.array([0, 2]), w)
    assert got.dtype == np.float32
    assert got == pytest.approx([-0.0103, 1 - 1e-4 + 0.02], abs=1e-7)
    with pytest.raises(NotImplementedError):
        m.weights({"metrics_weights": {"n_layers": 0.1}})
    obs = np.zeros((2, 4, 6), np.uint8)
    obs[:, :, :4] = np.eye(4, dtype=np.uint8)
    obs[1, 2, 5] = 1
    assert m.solved(obs).tolist() == [True, False]
    assert m.rotations_left(obs).tolist() == [0, 1]
    assert m.solved(np.eye(4, dtype=np.uint8)[None]).tolist() == [True]
