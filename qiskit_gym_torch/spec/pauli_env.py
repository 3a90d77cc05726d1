"""Pauli-network synthesis spec env (Clifford + RX/RY/RZ rotations).

Semantics mirror the reference (rust/src/envs/pauli.rs:273-779,
rust/src/pauli/pauli_network.rs:28-265, rust/src/pauli/pauli_dag.rs:19-72),
re-derived from the row-op/Pauli-evolution rules:

- State matrix `data`: uint8[2n, 2n + R]. Left block = the target Clifford's
  transposed phase-less tableau (row-major reading of the set_state payload);
  each extra column = one rotation's (x || z) bits, evolved by the same row
  ops as the tableau.
- A parallel list of phase-tracking Paulis (`rotation_qk`) is evolved by
  conjugation to recover each rotation's sign when it becomes trivial.
- The anti-commutation DAG is built once from the initial rotations (gate
  conjugation preserves pairwise commutation); front layer = rotations with
  no earlier active anti-commuting rotation.
- Gate conventions: gameplay cnot(i, j) XORs row i ^= row j and
  row n+j ^= row n+i (the "transposed-index" convention — the API layer
  reverses CX qubit order when reconstructing circuits); the reset-time
  tableau scramble instead uses row q1 ^= row q0 (Clifford-env convention),
  exactly as the reference does.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from qiskit_gym_torch.quantum.pauli import Pauli

from .base import BaseSpecEnv
from .gates import Gate
from .symmetry import compute_qubit_perms

ROTATION_MARKER = 0x80000000
_AXIS_CODE = {"X": 0, "Y": 1, "Z": 2}
_AXIS_NAME = ["rx", "ry", "rz"]


def encode_rotation(axis: str, qubit: int, index: int, phase_mult: int) -> int:
    """Pack a rotation event (must match the reference bit layout, pauli.rs:685-719)."""
    return (
        ROTATION_MARKER
        | (_AXIS_CODE[axis] << 21)
        | (qubit << 11)
        | (index << 1)
        | (1 if phase_mult == 1 else 0)
    )


def decode_solution(encoded: Sequence[int]) -> List[Tuple[str, int, int, int]]:
    """Unpack to [("gate", action, 0, 0) | ("rx"/"ry"/"rz", qubit, index, +-1)]."""
    out = []
    for val in encoded:
        val = int(val)
        if val >= ROTATION_MARKER:
            axis = (val >> 21) & 0x3
            qubit = (val >> 11) & 0x3FF
            index = (val >> 1) & 0x3FF
            phase_mult = 1 if (val & 1) else -1
            out.append((_AXIS_NAME[axis], qubit, index, phase_mult))
        else:
            out.append(("gate", val, 0, 0))
    return out


def graph_distances(num_qubits: int, edges: Sequence[Tuple[int, int]]) -> Dict[Tuple[int, int], int]:
    adj: List[List[int]] = [[] for _ in range(num_qubits)]
    for a, b in edges:
        if b not in adj[a]:
            adj[a].append(b)
        if a not in adj[b]:
            adj[b].append(a)
    dist: Dict[Tuple[int, int], int] = {}
    for start in range(num_qubits):
        seen = [False] * num_qubits
        seen[start] = True
        q = deque([(start, 0)])
        while q:
            node, d = q.popleft()
            dist[(start, node)] = d
            dist[(node, start)] = d
            for nb in adj[node]:
                if not seen[nb]:
                    seen[nb] = True
                    q.append((nb, d + 1))
    return dist


class PauliNetwork:
    def __init__(self, tableau_flat: Sequence[int], rotations: Sequence[str]):
        n2 = int(round(np.sqrt(len(tableau_flat))))
        self.num_qubits = n2 // 2
        n = self.num_qubits
        self.rotation_qk: List[Pauli] = [Pauli.from_label(r) for r in rotations]
        for p in self.rotation_qk:
            if p.num_qubits != n:
                raise ValueError(
                    f"Rotation width {p.num_qubits} != Clifford width {n}"
                )
        R = len(self.rotation_qk)
        self.data = np.zeros((2 * n, 2 * n + R), dtype=np.uint8)
        self.data[:, : 2 * n] = (
            np.asarray(tableau_flat, dtype=np.int64).reshape(2 * n, 2 * n) > 0
        )
        for i, p in enumerate(self.rotation_qk):
            self.data[:n, 2 * n + i] = p.x
            self.data[n:, 2 * n + i] = p.z
        # anti-commutation DAG over initial rotations: edge later -> earlier
        self._anti = np.zeros((R, R), dtype=bool)
        for i1 in range(R):
            for i2 in range(i1):
                if not self.rotation_qk[i1].commutes_with(self.rotation_qk[i2]):
                    self._anti[i1, i2] = True
        self.active = list(range(R))

    # ------------------------------------------------------------- queries
    def front_layer(self) -> List[int]:
        act = set(self.active)
        out = []
        for i in self.active:
            if not any(self._anti[i, j] for j in act if j < i):
                out.append(i)
        return out

    def _col(self, rindex: int) -> np.ndarray:
        return self.data[:, 2 * self.num_qubits + rindex]

    def is_trivial(self, rindex: int) -> bool:
        n = self.num_qubits
        col = self._col(rindex)
        return int((col[:n] | col[n:]).sum()) <= 1

    def which_qubit(self, rindex: int) -> int:
        n = self.num_qubits
        col = self._col(rindex)
        return int(np.flatnonzero(col[:n] | col[n:])[0])

    def which_axis(self, rindex: int, qubit: int) -> str:
        n = self.num_qubits
        col = self._col(rindex)
        if col[qubit]:
            return "Y" if col[n + qubit] else "X"
        if col[n + qubit]:
            return "Z"
        raise ValueError("Rotation column has no support on the given qubit")

    def clean_and_return_with_phases(self) -> List[Tuple[str, int, int, int]]:
        """Front-layer sweep removing trivial rotations.

        Events are (axis, qubit, rotation_index, phase_mult) with the phase
        read AT EXTRACTION TIME. (The reference reads the phase after the
        enclosing composite gate finishes — rust pauli.rs:616-626 — which is
        wrong for a Y extracted inside CZ/SWAP, where the closing H flips its
        sign; circuit reconstruction places the rotation at the extraction
        point, so the extraction-time phase is the correct one.)"""
        events: List[Tuple[str, int, int, int]] = []
        removed = True
        while removed:
            removed = False
            to_remove = []
            for rindex in self.front_layer():
                if self.is_trivial(rindex):
                    q = self.which_qubit(rindex)
                    axis = self.which_axis(rindex, q)
                    mult = -1 if self.rotation_qk[rindex].coeff_phase() == 2 else 1
                    events.append((axis, q, rindex, mult))
                    to_remove.append(rindex)
                    self._col(rindex)[:] = 0
                    removed = True
            if to_remove:
                self.active = [i for i in self.active if i not in to_remove]
        return events

    def solved(self) -> bool:
        n2 = 2 * self.num_qubits
        return not self.active and bool(
            np.array_equal(self.data[:, :n2], np.eye(n2, dtype=np.uint8))
        )

    def active_rotation_indices(self) -> List[int]:
        return list(self.active)

    # --------------------------------------------------------------- gates
    def _h(self, i: int):
        n = self.num_qubits
        self.data[[i, n + i]] = self.data[[n + i, i]]
        for p in self.rotation_qk:
            p.evolve_h(i)

    def _s(self, i: int):
        n = self.num_qubits
        self.data[n + i] ^= self.data[i]
        for p in self.rotation_qk:
            p.evolve_s(i)

    def _sx(self, i: int):
        n = self.num_qubits
        self.data[i] ^= self.data[n + i]
        for p in self.rotation_qk:
            p.evolve_sx(i)

    def _cnot(self, i: int, j: int) -> List[Tuple[str, int, int]]:
        n = self.num_qubits
        self.data[i] ^= self.data[j]
        self.data[n + j] ^= self.data[n + i]
        for p in self.rotation_qk:
            p.evolve_cx(j, i)
        return self.clean_and_return_with_phases()

    def act(self, gate: Gate) -> List[Tuple[str, int, int]]:
        name, qs = gate
        if name == "H":
            self._h(qs[0])
        elif name == "S":
            self._s(qs[0])
        elif name == "Sdg":
            self._s(qs[0]); self._s(qs[0]); self._s(qs[0])
        elif name == "SX":
            self._sx(qs[0])
        elif name == "SXdg":
            self._sx(qs[0]); self._sx(qs[0]); self._sx(qs[0])
        elif name == "CX":
            return self._cnot(qs[0], qs[1])
        elif name == "CZ":
            self._h(qs[1])
            out = self._cnot(qs[0], qs[1])
            self._h(qs[1])
            return out
        elif name == "SWAP":
            out = self._cnot(qs[0], qs[1])
            out += self._cnot(qs[1], qs[0])
            out += self._cnot(qs[0], qs[1])
            return out
        return []


class PauliSpecEnv(BaseSpecEnv):
    def __init__(
        self,
        num_qubits: int,
        difficulty: int,
        gateset: Sequence,
        depth_slope: int,
        max_depth: int,
        max_rotations: int = 5,
        pauli_diff_scale: int = 8,
        num_qubits_decay: float = 0.5,
        final_pauli_layers: Optional[int] = None,
        metrics_weights: Optional[dict] = None,
        add_perms: bool = True,
        pauli_layer_reward: float = 0.01,
        track_solution: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        self.max_rotations = max(int(max_rotations), 1)
        self.pauli_diff_scale = max(int(pauli_diff_scale), 1)
        self.num_qubits_decay = float(num_qubits_decay)
        self.final_pauli_layers = (
            int(final_pauli_layers) if final_pauli_layers is not None
            else self.max_rotations + 2
        )
        self.pauli_layer_reward = float(pauli_layer_reward)
        self._current_perm_idx = 0
        self.qubit_perms: List[List[int]] = []
        self._act_perms_internal: List[List[int]] = []
        super().__init__(
            num_qubits=num_qubits,
            difficulty=difficulty,
            gateset=gateset,
            depth_slope=depth_slope,
            max_depth=max_depth,
            metrics_weights=metrics_weights,
            add_inverts=False,  # PauliEnv has no inversion augmentation
            add_perms=add_perms,
            track_solution=track_solution,
            rng=rng,
        )
        # distance structure for reset-time Pauli generation
        self.valid_pairs = [qs for name, qs in self.gateset if name == "CX"]
        dist = graph_distances(self.num_qubits, self.valid_pairs)
        self.dist_pairs: Dict[int, List[Tuple[int, int]]] = {}
        for q1 in range(self.num_qubits):
            for q2 in range(q1 + 1, self.num_qubits):
                if (q1, q2) in dist:
                    self.dist_pairs.setdefault(dist[(q1, q2)], []).append((q1, q2))
        self.all_dists = sorted(self.dist_pairs)

    # ------------------------------------------------------------ plumbing
    def _init_state(self):
        dim = 2 * self.num_qubits
        tableau = np.eye(dim, dtype=np.uint8).reshape(-1)
        self.network = PauliNetwork(tableau, [])

    def _compute_twists(self):
        self.qubit_perms, self._act_perms_internal = compute_qubit_perms(
            self.num_qubits, self.gateset
        )
        return ([], [])  # twists() reports empty: perms are applied internally

    def twists(self):
        return ([], [])

    def obs_shape(self) -> List[int]:
        return [2 * self.num_qubits, 2 * self.num_qubits + self.max_rotations]

    def solved(self) -> bool:
        return self.network.solved()

    # ----------------------------------------------------- reset generation
    def _pauli_under_diff(self, difficulty: int) -> Optional[Tuple[str, int]]:
        rng = self.rng
        valid = [d for d in self.all_dists if d <= difficulty]
        if not valid:
            return None
        qubits: set = set()
        budget = difficulty
        first = [d for d in valid if d <= budget]
        if not first:
            return None
        d0 = first[int(rng.integers(len(first)))]
        pairs = self.dist_pairs[d0]
        q1, q2 = pairs[int(rng.integers(len(pairs)))]
        qubits.update((q1, q2))
        budget = max(budget - d0, 0)
        while True:
            diffs = [d for d in valid if d <= budget]
            remaining = [q for q in range(self.num_qubits) if q not in qubits]
            if budget == 0 or not diffs or not remaining:
                break
            if rng.random() <= self.num_qubits_decay:
                break
            d = diffs[int(rng.integers(len(diffs)))]
            cand = [p for p in self.dist_pairs[d] if p[0] in qubits or p[1] in qubits]
            if not cand:
                continue
            q1, q2 = cand[int(rng.integers(len(cand)))]
            qubits.update((q1, q2))
            budget = max(budget - d, 0)
        chars = ["I"] * self.num_qubits
        for q in qubits:
            chars[q] = "XYZ"[int(rng.integers(3))]
        return "".join(chars), difficulty - budget

    def _generate_rotations(self, pauli_difficulty: int) -> List[str]:
        out: List[str] = []
        remaining = pauli_difficulty
        while remaining > 0 and len(out) < self.final_pauli_layers:
            got = self._pauli_under_diff(remaining)
            if got is None:
                break
            pauli, cost = got
            out.append(pauli)
            remaining = max(remaining - max(cost, 1), 0)
        return out

    def _random_tableau(self) -> np.ndarray:
        """Scramble identity with 70% CX / 15% H / 15% S row ops."""
        n = self.num_qubits
        dim = 2 * n
        data = np.eye(dim, dtype=np.uint8)
        if self.difficulty == 0 or not self.valid_pairs:
            return data.reshape(-1)
        rng = self.rng
        for _ in range(self.difficulty):
            r = rng.random()
            if r > 0.3:
                q0, q1 = self.valid_pairs[int(rng.integers(len(self.valid_pairs)))]
                data[q1] ^= data[q0]
                data[n + q0] ^= data[n + q1]
            elif r > 0.15:
                q = int(rng.integers(n))
                data[[q, n + q]] = data[[n + q, q]]
            else:
                q = int(rng.integers(n))
                data[n + q] ^= data[q]
        return data.reshape(-1)

    def reset(
        self,
        rotations: Optional[Sequence[str]] = None,
        tableau: Optional[np.ndarray] = None,
    ):
        if rotations is None:
            rotations = self._generate_rotations(self.difficulty // self.pauli_diff_scale)
        if tableau is None:
            tableau = self._random_tableau()
        self.network = PauliNetwork(np.asarray(tableau).reshape(-1), list(rotations))
        self.network.clean_and_return_with_phases()
        self.depth = min(self.depth_slope * self.difficulty, self.max_depth)
        self._reset_internals()

    def _reset_internals(self):
        self.success = self.solved()
        self.metrics.reset()
        self._metrics_prev = self.metrics.snapshot()
        self.reward_value = 1.0 if self.success else 0.0
        self._current_perm_idx = 0
        if self._track_solution:
            self._solution = []

    # ----------------------------------------------------------- state i/o
    def _set_state_impl(self, state: Sequence[int]):
        state = list(state)
        if not state:
            return
        it = iter(state)
        count = max(int(next(it)), 0)
        dim = 2 * self.num_qubits
        tableau = np.array([int(next(it)) for _ in range(dim * dim)], dtype=np.int64)
        rotations = []
        for idx in range(count):
            length = max(int(next(it)), 0)
            chars = "".join(chr(int(next(it))) for _ in range(length))
            if idx < self.max_rotations:
                rotations.append(chars)
        self.network = PauliNetwork(tableau, rotations)

    def set_state(self, state: Sequence[int]):
        self._set_state_impl(state)
        self.depth = self.max_depth
        self._reset_internals()

    # ------------------------------------------------------------- observe
    def _dense_obs(self) -> np.ndarray:
        n = self.num_qubits
        rows, cols = 2 * n, 2 * n + self.max_rotations
        dense = np.zeros((rows, cols), dtype=np.int8)
        dense[:, : 2 * n] = self.network.data[:, : 2 * n]
        for i, ridx in enumerate(self.network.active_rotation_indices()):
            if i >= self.max_rotations:
                break
            dense[:, 2 * n + i] = self.network.data[:, 2 * n + ridx]
        return dense

    @staticmethod
    def _permute_obs(dense: np.ndarray, perm: Sequence[int], n: int) -> np.ndarray:
        perm = np.asarray(perm)
        ext = np.concatenate([perm, n + perm])
        out = dense[ext, :].copy()        # rows: dst i <- src perm[i]
        out[:, : 2 * n] = out[:, ext]     # tableau cols only
        return out

    def observe(self, perm_idx: Optional[int] = None) -> List[int]:
        dense = self._dense_obs()
        if self.qubit_perms:
            if perm_idx is None:
                perm_idx = int(self.rng.integers(len(self.qubit_perms)))
            self._current_perm_idx = perm_idx
            dense = self._permute_obs(dense, self.qubit_perms[perm_idx], self.num_qubits)
        return np.flatnonzero(dense.reshape(-1)).tolist()

    # ---------------------------------------------------------------- step
    def step(self, action: int, invert=None):
        action = int(action)
        penalty = 0.0
        new_rotations = 0
        if self._act_perms_internal:
            action = self._act_perms_internal[self._current_perm_idx][action]
        if 0 <= action < self.num_actions():
            gate = self.gateset[action]
            prev = self.metrics.snapshot()
            self.metrics.apply_gate(gate)
            penalty = self.metrics.penalty(prev, self.metrics_weights)
            events = self.network.act(gate)
            new_rotations = len(events)
            if self._track_solution:
                self._solution.append(action)
                for axis, qubit, ridx, phase_mult in events:
                    self._solution.append(encode_rotation(axis, qubit, ridx, phase_mult))
        self.depth = max(self.depth - 1, 0)
        self.success = self.solved()
        self.reward_value = (
            (1.0 if self.success else 0.0)
            - penalty
            + self.pauli_layer_reward * new_rotations
        )

    def solution(self) -> List[int]:
        return list(self._solution)
