"""Shared single-env machinery for the numpy spec envs.

The Env surface matches the reference contract (reference
rust/src/envs/permutation.rs:148-257 et al.): num_actions, obs_shape,
observe (sparse 1-bit indices), reward, is_final, success, masks, reset,
step, set_state, difficulty, twists, track_solution, solution.

Randomness: every env method that draws randomness accepts optional injected
decisions so traces are reproducible and comparable with the JAX kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .gates import Gate, parse_gateset
from .metrics import MetricsTracker, MetricsWeights


class BaseSpecEnv:
    def __init__(
        self,
        num_qubits: int,
        difficulty: int,
        gateset: Sequence,
        depth_slope: int,
        max_depth: int,
        metrics_weights: Optional[dict] = None,
        add_inverts: bool = True,
        add_perms: bool = True,
        track_solution: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        self.num_qubits = int(num_qubits)
        self.difficulty = int(difficulty)
        self.gateset: List[Gate] = parse_gateset(gateset)
        self.depth_slope = int(depth_slope)
        self.max_depth = int(max_depth)
        self.metrics_weights = MetricsWeights.from_dict(metrics_weights)
        self.add_inverts = bool(add_inverts)
        self.add_perms = bool(add_perms)
        self._track_solution = bool(track_solution)
        self.rng = rng if rng is not None else np.random.default_rng()

        self.metrics = MetricsTracker(self.num_qubits)
        self._metrics_prev = self.metrics.snapshot()
        self.depth = 1
        self.inverted = False
        self._solution: List[int] = []
        self._solution_inv: List[int] = []
        self.obs_perms, self.act_perms = self._compute_twists() if self.add_perms else ([], [])

        self._init_state()
        self.success = self.solved()
        self.reward_value = 1.0 if self.success else 0.0

    # ----- subclass hooks -------------------------------------------------
    def _init_state(self):
        raise NotImplementedError

    def _apply_gate(self, gate: Gate):
        raise NotImplementedError

    def _invert_state(self):
        raise NotImplementedError

    def solved(self) -> bool:
        raise NotImplementedError

    def _dense_obs(self) -> np.ndarray:
        raise NotImplementedError

    def _compute_twists(self):
        raise NotImplementedError

    def _set_state_impl(self, state: Sequence[int]):
        raise NotImplementedError

    # ----- Env contract ---------------------------------------------------
    def num_actions(self) -> int:
        return len(self.gateset)

    def obs_shape(self) -> List[int]:
        raise NotImplementedError

    def set_difficulty(self, difficulty: int):
        self.difficulty = int(difficulty)

    def get_difficulty(self) -> int:
        return self.difficulty

    def twists(self):
        return ([list(p) for p in self.obs_perms], [list(p) for p in self.act_perms])

    def track_solution(self) -> bool:
        return self._track_solution

    def solution(self) -> List[int]:
        return list(self._solution) + list(reversed(self._solution_inv))

    def masks(self) -> List[bool]:
        return [not self.success] * self.num_actions()

    def is_final(self) -> bool:
        return self.depth == 0 or self.success

    def reward(self) -> float:
        return self.reward_value

    def observe(self) -> List[int]:
        """Sparse indices of set bits in the flattened dense observation."""
        return np.flatnonzero(self._dense_obs().reshape(-1)).tolist()

    def _reset_internals(self):
        self.success = self.solved()
        self.metrics.reset()
        self._metrics_prev = self.metrics.snapshot()
        self.reward_value = 1.0 if self.success else 0.0
        self.inverted = False
        if self._track_solution:
            self._solution = []
            self._solution_inv = []

    def set_state(self, state: Sequence[int]):
        self._set_state_impl(state)
        self.depth = self.max_depth
        self._reset_internals()

    def reset(self, scramble_actions: Optional[Sequence[int]] = None):
        """Scramble the identity by `difficulty` random gateset actions.

        `scramble_actions` injects the random action choices for determinism.
        """
        self._init_state()
        if scramble_actions is None:
            scramble_actions = self.rng.integers(0, self.num_actions(), size=self.difficulty)
        for a in scramble_actions:
            self._apply_scramble_gate(self.gateset[int(a)])
        self.depth = min(self.depth_slope * self.difficulty, self.max_depth)
        self._reset_internals()

    def _apply_scramble_gate(self, gate: Gate):
        self._apply_gate(gate)

    def _maybe_random_invert(self, invert: Optional[bool]):
        if not self.add_inverts:
            return
        if invert is None:
            invert = bool(self.rng.random() < 0.5)
        if invert:
            self._invert_state()
            self.inverted = not self.inverted

    def step(self, action: int, invert: Optional[bool] = None):
        """Apply gateset[action]; `invert` injects the 50% inversion coin-flip."""
        action = int(action)
        penalty = 0.0
        if 0 <= action < self.num_actions():
            gate = self.gateset[action]
            prev = self.metrics.snapshot()
            self.metrics.apply_gate(gate)
            penalty = self.metrics.penalty(prev, self.metrics_weights)
            self._apply_gate(gate)
            if self._track_solution:
                (self._solution_inv if self.inverted else self._solution).append(action)
        self.depth = max(self.depth - 1, 0)
        self._maybe_random_invert(invert)
        self.success = self.solved()
        self.reward_value = (1.0 if self.success else 0.0) - penalty
