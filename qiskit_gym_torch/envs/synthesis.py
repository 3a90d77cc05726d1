"""User-facing synthesis gyms for the three matrix families.

Port of the JAX package's `envs/synthesis.py` (PermutationGym,
LinearFunctionGym, CliffordGym): from_coupling_map gateset expansion,
from_json signature filtering, get_state encodings and
build_circuit_from_solution with the per-family post-processing, on the
port's own quantum layer. `PauliGym` and the qiskit-object bridge are not
ported yet.

Each gym owns:
- `core`:  the batched torch env (ops/) used by search, on `device`,
- `spec`:  a numpy single-env twin (spec/) that provides the twists.
"""

from __future__ import annotations

import inspect
from typing import List, Optional, Sequence, Tuple

import numpy as np

from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore
from qiskit_gym_torch.ops.permutation import PermutationEnvCore
from qiskit_gym_torch.quantum import (
    Circuit,
    Clifford,
    gf2_inverse,
    linear_from_circuit,
    linear_from_clifford,
    permutation_pattern,
)
from qiskit_gym_torch.spec import (
    CliffordSpecEnv,
    LinearFunctionSpecEnv,
    PermutationSpecEnv,
)
from qiskit_gym_torch.utils.device import DeviceLike, resolve_device

ONE_Q_GATES = ["H", "S", "Sdg", "SX", "SXdg"]
TWO_Q_GATES = ["CX", "CZ", "SWAP"]


class BaseSynthesisEnv:
    cls_name: str
    allowed_gates: List[str]
    spec_cls = None
    kind: Optional[str] = None  # 'linear' | 'clifford' | None

    def __init__(self, device: DeviceLike = None, **config):
        # Direct construction fills the same defaults from_coupling_map uses
        config.setdefault("difficulty", 1)
        config.setdefault("depth_slope", 2)
        config.setdefault("max_depth", 128)
        self.device = resolve_device(device)
        self.config = dict(config)
        self.spec = self.spec_cls(**config)
        self._difficulty = int(config.get("difficulty", 1))
        self._build_core()

    def _core_kwargs(self) -> dict:
        c = self.config
        return dict(
            num_qubits=c["num_qubits"],
            gateset=c["gateset"],
            depth_slope=c.get("depth_slope", 2),
            max_depth=c.get("max_depth", 128),
            metrics_weights=c.get("metrics_weights"),
            add_inverts=c.get("add_inverts", True),
            device=self.device,
        )

    def _build_core(self):
        self.core = MatrixEnvCore(kind=self.kind, **self._core_kwargs())

    # ------------------------------------------------------------ factories
    @classmethod
    def from_coupling_map(
        cls,
        coupling_map,
        basis_gates: Optional[Tuple[str, ...]] = None,
        difficulty: int = 1,
        depth_slope: int = 2,
        max_depth: int = 128,
        metrics_weights: Optional[dict] = None,
        add_inverts: bool = True,
        add_perms: bool = True,
        device: DeviceLike = None,
        **extra,
    ):
        if basis_gates is None:
            basis_gates = tuple(cls.allowed_gates)
        bad = [g for g in basis_gates if g not in cls.allowed_gates]
        if bad:
            raise ValueError(
                f"Gates {bad} not allowed (allowed: {cls.allowed_gates})"
            )

        if hasattr(coupling_map, "get_edges"):  # qiskit CouplingMap
            coupling_map = list(coupling_map.get_edges())
        coupling_map = sorted((int(a), int(b)) for a, b in coupling_map)
        num_qubits = max(max(edge) for edge in coupling_map) + 1

        gateset: List[Tuple[str, Tuple[int, ...]]] = []
        for name in basis_gates:
            if name in ONE_Q_GATES:
                gateset.extend((name, (q,)) for q in range(num_qubits))
            elif name in TWO_Q_GATES:
                gateset.extend((name, edge) for edge in coupling_map)
            else:
                raise ValueError(f"Gate {name} not supported")

        config = {
            "num_qubits": num_qubits,
            "difficulty": difficulty,
            "gateset": gateset,
            "depth_slope": depth_slope,
            "max_depth": max_depth,
            "metrics_weights": metrics_weights,
            "add_inverts": add_inverts,
            "add_perms": add_perms,
        }
        config.update(extra)
        return cls(device=device, **cls._filter_config(config))

    @classmethod
    def _filter_config(cls, config: dict) -> dict:
        sig = inspect.signature(cls.spec_cls.__init__)
        valid = set(sig.parameters) - {"self", "rng"}
        return {k: v for k, v in config.items() if k in valid}

    @classmethod
    def from_json(cls, env_config: dict, device: DeviceLike = None):
        cfg = dict(env_config)
        # JSON stores gateset entries as [name, [qubits]]
        if "gateset" in cfg:
            cfg["gateset"] = [(g[0], tuple(g[1])) for g in cfg["gateset"]]
        return cls(device=device, **cls._filter_config(cfg))

    def to_json(self) -> dict:
        out = dict(self.config)
        out["gateset"] = [[name, list(qs)] for name, qs in self.spec.gateset]
        return out

    # ------------------------------------------------------------ env proxy
    @property
    def difficulty(self) -> int:
        return self._difficulty

    @difficulty.setter
    def difficulty(self, value: int):
        self._difficulty = int(value)
        self.spec.set_difficulty(value)

    def obs_shape(self):
        return list(self.core.obs_shape)

    def num_actions(self) -> int:
        return self.core.num_actions

    def twists(self):
        return self.spec.twists()

    @property
    def gateset(self):
        return self.spec.gateset

    # ----------------------------------------------------------- encodings
    def get_state(self, input) -> List[int]:
        raise NotImplementedError

    def encoded_to_dense(self, state: Sequence[int]) -> np.ndarray:
        """Encoded get_state() output -> dense array for core.set_state."""
        raise NotImplementedError

    def make_solve_state(self, state_encoded, num_searches: int):
        """Device state with the encoded target tiled over num_searches lanes."""
        single = self.encoded_to_dense(state_encoded)
        return self.core.set_state(np.repeat(single[None], num_searches, axis=0))

    def solution_from_trace(self, _state_encoded, actions, inverted):
        """Episode trace -> reference-format solution list: non-inverted
        actions in order, then inverted actions reversed (valid because the
        phase-less gates are involutions; reference permutation.rs:251-256)."""
        normal = [int(a) for a, inv in zip(actions, inverted) if not inv]
        flipped = [int(a) for a, inv in zip(actions, inverted) if inv]
        return normal + flipped[::-1]

    def post_process_synthesis(self, synth_circuit: Circuit, _input) -> Circuit:
        return synth_circuit

    def build_circuit_from_solution(self, actions: List[int], input) -> Circuit:
        gs = self.spec.gateset
        qc = Circuit.from_gate_list(
            [gs[a] for a in actions], num_qubits=self.config["num_qubits"]
        )
        return self.post_process_synthesis(qc, input)


# --------------------------------------------------------------- Permutation


class PermutationGym(BaseSynthesisEnv):
    cls_name = "PermutationEnv"
    allowed_gates = ["SWAP"]
    spec_cls = PermutationSpecEnv

    def _build_core(self):
        self.core = PermutationEnvCore(**self._core_kwargs())

    def get_state(self, input) -> List[int]:
        if isinstance(input, Circuit):
            input = permutation_pattern(linear_from_circuit(input))
        # argsort = inverse permutation, so the synthesized circuit implements
        # the target rather than its inverse
        return np.argsort(np.asarray(input)).astype(int).tolist()

    def encoded_to_dense(self, state) -> np.ndarray:
        return np.asarray(state, dtype=np.int32)


# ----------------------------------------------------------- LinearFunction


class LinearFunctionGym(BaseSynthesisEnv):
    cls_name = "LinearFunctionEnv"
    allowed_gates = ["CX", "SWAP"]
    spec_cls = LinearFunctionSpecEnv
    kind = "linear"

    def get_state(self, input) -> List[int]:
        # Accepts Circuit/Clifford plus a raw GF(2) matrix. The env state is
        # the *adjoint*'s linear action, i.e. M^{-1}.
        if (isinstance(input, (list, tuple))
                and np.asarray(input).ndim == 2):
            # nested-list GF(2) matrix: without this it would fall through
            # to Clifford(list) and be misread as a 2n/2-qubit tableau
            input = np.asarray(input)
        if isinstance(input, np.ndarray) and input.ndim == 2:
            lin = gf2_inverse(input.astype(np.uint8) % 2)
        else:
            if isinstance(input, Circuit):
                input = Clifford(input)
            lin = linear_from_clifford(Clifford(input).adjoint())
        return lin.flatten().astype(int).tolist()

    def encoded_to_dense(self, state) -> np.ndarray:
        n = self.config["num_qubits"]
        return (np.asarray(state).reshape(n, n) > 0).astype(np.uint8)


# ----------------------------------------------------------------- Clifford


def _solve_phases(clifford: Clifford) -> Circuit:
    """Pauli layer correcting residual stab/destab phases (reference
    envs/synthesis.py:161-176)."""
    n = clifford.num_qubits
    out = Circuit(n)
    for q in range(n):
        stab = bool(clifford.stab_phase[q])
        destab = bool(clifford.destab_phase[q])
        if destab and stab:
            out.y(q)
        elif stab:
            out.x(q)
        elif destab:
            out.z(q)
    return out


class CliffordGym(BaseSynthesisEnv):
    cls_name = "CliffordEnv"
    allowed_gates = ONE_Q_GATES + TWO_Q_GATES
    spec_cls = CliffordSpecEnv
    kind = "clifford"

    def get_state(self, input) -> List[int]:
        if isinstance(input, Circuit):
            input = Clifford(input)
        return (
            input.adjoint().tableau[:, :-1].T.flatten().astype(int).tolist()
        )

    def encoded_to_dense(self, state) -> np.ndarray:
        dim = 2 * self.config["num_qubits"]
        return (np.asarray(state).reshape(dim, dim) > 0).astype(np.uint8)

    def post_process_synthesis(self, synth_circuit: Circuit, input) -> Circuit:
        """The env works on the phase-less tableau; repair the Pauli layer
        (reference envs/synthesis.py:211-217)."""
        synth_circuit = synth_circuit.inverse()
        if isinstance(input, Circuit):
            input = Clifford(input)
        dcliff = Clifford(synth_circuit).compose(input)
        return _solve_phases(dcliff).compose(synth_circuit).inverse()


SYNTH_ENVS = {
    "CliffordEnv": CliffordGym,
    "LinearFunctionEnv": LinearFunctionGym,
    "PermutationEnv": PermutationGym,
}
