"""The env's circuit metrics and the reward of a step, as the artifacts'
config schema defines them, worked out from actions and observations alone.

A gate costs (2q count, gate count): a one-qubit gate (0, 1), a CX (1, 1),
a CZ (1, 3) and a SWAP (3, 3), since a CZ is H CX H and a SWAP three CXs.
A step's reward is 1 where it solves the target, less the `n_cnots` weight
times its 2q count and the `n_gates` weight times its gate count (untracked
weights, by default 0.01 and 0.0001), in float32; the Pauli-network env adds
`pauli_layer_reward` (0.01) for each rotation that the step retires. An
observation is solved where its tableau block is the identity and no
rotation column is left. Imports numpy only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

COST = {"cx": (1, 1), "cz": (1, 3), "swap": (3, 3)}
WEIGHTS = {"n_cnots": 0.01, "n_layers_cnots": 0.0, "n_layers": 0.0,
           "n_gates": 0.0001}
LAYER_REWARD = 0.01
# A reward is judged equal within this: float32 rounds a reward in [-2, 1]
# by under 2.4e-7, and the smallest weight, one gate's, is 100 times it.
REWARD_ROUNDING = 1e-6


def gate_cost(name: str) -> Tuple[int, int]:
    return COST.get(name.lower(), (0, 1))


def action_costs(gateset) -> Tuple[np.ndarray, np.ndarray]:
    """(2q count [A], gate count [A]) of each action of the gateset."""
    costs = np.array([gate_cost(name) for name, _ in gateset], np.int64)
    return costs[:, 0], costs[:, 1]


def circuit_cnots(circuit) -> int:
    """The 2q count of a returned circuit by the same costs; rotations and
    other one-qubit gates count 0."""
    return sum(COST.get(g[0].lower(), (0, 0))[0] for g in circuit)


def weights(env: dict) -> Tuple[np.float32, np.float32, np.float32]:
    """(2q weight, gate weight, rotation reward) of an artifact's env
    config, in float32. Layer weights (which need layer tracking) are not
    modelled."""
    w = dict(WEIGHTS, **(env.get("metrics_weights") or {}))
    if w["n_layers"] or w["n_layers_cnots"]:
        raise NotImplementedError("layer-weighted rewards")
    return (np.float32(w["n_cnots"]), np.float32(w["n_gates"]),
            np.float32(env.get("pauli_layer_reward", LAYER_REWARD)))


def step_rewards(solved: np.ndarray, cnots: np.ndarray, gates: np.ndarray,
                 retired: np.ndarray, w) -> np.ndarray:
    """float32 rewards of steps from their flags and counts."""
    f = np.float32
    penalty = w[0] * cnots.astype(f) + w[1] * gates.astype(f)
    return solved.astype(f) - penalty + w[2] * retired.astype(f)


def solved(obs: np.ndarray) -> np.ndarray:
    """[..., 2n, 2n + R] observations -> bool [...]: the identity tableau
    and no rotation left."""
    dim = obs.shape[-2]
    eye = np.eye(dim, dtype=obs.dtype)
    return ((obs[..., :dim] == eye).all(axis=(-2, -1))
            & ~obs[..., dim:].any(axis=(-2, -1)))


def rotations_left(obs: np.ndarray) -> np.ndarray:
    """[..., 2n, 2n + R] -> int [...]: the rotation columns in use (an
    active rotation is never the identity, so its column is never 0)."""
    dim = obs.shape[-2]
    return obs[..., dim:].any(axis=-2).sum(axis=-1)


def lane_counts(actions: np.ndarray, valid: np.ndarray,
                costs: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """[T, L] actions and valid flags -> (2q count [L], gate count [L]) of
    each lane's valid steps."""
    return tuple((c[actions] * valid).sum(axis=0) for c in costs)
