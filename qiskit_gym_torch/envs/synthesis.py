"""User-facing synthesis gyms.

Port of the JAX package's `envs/synthesis.py` (PermutationGym,
LinearFunctionGym, CliffordGym, PauliGym): from_coupling_map gateset
expansion, from_json signature filtering, get_state encodings and
build_circuit_from_solution with the per-family post-processing, on the
port's own quantum layer. The qiskit-object bridge is not ported yet.

Each gym owns:
- `core`:  the batched torch env (ops/) used by search, on `device`,
- `spec`:  a numpy single-env twin (spec/) that provides the twists.
"""

from __future__ import annotations

import inspect
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore
from qiskit_gym_torch.ops.pauli import PauliEnvCore
from qiskit_gym_torch.ops.permutation import PermutationEnvCore
from qiskit_gym_torch.quantum import (
    Circuit,
    Clifford,
    Pauli,
    gf2_inverse,
    linear_from_circuit,
    linear_from_clifford,
    permutation_pattern,
)
from qiskit_gym_torch.spec import (
    CliffordSpecEnv,
    LinearFunctionSpecEnv,
    PauliSpecEnv,
    PermutationSpecEnv,
)
from qiskit_gym_torch.spec.pauli_env import PauliNetwork
from qiskit_gym_torch.spec.pauli_env import decode_solution as decode_pauli_solution
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


# -------------------------------------------------------------- PauliNetwork


class PauliGym(BaseSynthesisEnv):
    cls_name = "PauliNetworkEnv"
    allowed_gates = ONE_Q_GATES + TWO_Q_GATES
    spec_cls = PauliSpecEnv

    def __init__(self, device: DeviceLike = None, **config):
        # The Python gym layer defaults pauli_diff_scale to 16, overriding
        # the native default of 8 (reference envs/synthesis.py:388 vs
        # rust/src/envs/pauli.rs:758-775). Rotations thus appear at
        # difficulty >= 16 under a from_coupling_map default build.
        config.setdefault("pauli_diff_scale", 16)
        super().__init__(device=device, **config)
        self._rotation_params: List[float] = []
        self._rotations: List[str] = []
        self._original_circuit: Optional[Circuit] = None
        # rotations/angles remembered per encoded target (keyed on the
        # tableau part of the encoding), so interleaved get_state calls on
        # different targets don't cross-contaminate reconstruction
        self._rotation_memo: "OrderedDict[tuple, tuple]" = OrderedDict()

    @property
    def pauli_diff_scale(self) -> int:
        """Difficulty units per rotation (rotations appear at difficulty >=
        this); forwarded from the core so callers that key their curriculum
        or grading on the artifact's difficulty semantics see the configured
        value."""
        return int(self.core.pauli_diff_scale)

    @property
    def max_rotations(self) -> int:
        return int(self.core.R)

    def _build_core(self):
        c = self.config
        self.core = PauliEnvCore(
            num_qubits=c["num_qubits"],
            gateset=c["gateset"],
            depth_slope=c.get("depth_slope", 2),
            max_depth=c.get("max_depth", 128),
            max_rotations=c.get("max_rotations", 5),
            pauli_diff_scale=c.get("pauli_diff_scale", 16),
            num_qubits_decay=c.get("num_qubits_decay", 0.5),
            final_pauli_layers=c.get("final_pauli_layers"),
            metrics_weights=c.get("metrics_weights"),
            add_perms=c.get("add_perms", True),
            pauli_layer_reward=c.get("pauli_layer_reward", 0.01),
            device=self.device,
        )

    @staticmethod
    def _parse_encoded(state, num_qubits):
        """[count, tableau(4n^2), len, ords..., ...] -> (tableau, labels)."""
        it = iter([int(v) for v in state])
        count = max(next(it), 0)
        dim = 2 * num_qubits
        tableau = np.array([next(it) for _ in range(dim * dim)]) \
            .reshape(dim, dim)
        labels = []
        for _ in range(count):
            length = max(next(it), 0)
            labels.append("".join(chr(next(it)) for _ in range(length)))
        return (tableau > 0).astype(np.int8), labels

    def make_solve_state(self, state_encoded, num_searches: int):
        tableau, labels = self._parse_encoded(state_encoded,
                                              self.config["num_qubits"])
        state = self.core.set_state(tableau[None], [labels])
        return type(state)(*(x.repeat_interleave(num_searches, dim=0)
                             for x in state))

    def solution_from_trace(self, state_encoded, actions, inverted):
        """Replay through the spec twin to recover the packed solution
        (gate indices interleaved with rotation events incl. phases).
        The replay env is cached — constructing one redoes the coupling-
        graph BFS distance tables, wasted work per solved target —
        set_state() fully reinitializes it (spec/base.py:126-129)."""
        replay = getattr(self, "_replay_env", None)
        if replay is None:
            replay = self.spec_cls(**{**self._filter_config(self.config),
                                      "add_perms": False})
            self._replay_env = replay
        replay.set_state(list(state_encoded))
        for a in actions:
            if replay.is_final():
                break
            replay.step(int(a))
        return replay.solution()

    def get_state(self, input, rotations: Optional[List[str]] = None,
                  rotation_params: Optional[List[float]] = None) -> List[int]:
        """Encode a target. Accepts a Circuit, a Clifford (+ optional
        `rotations` labels), or a (Clifford, rotations[, params]) tuple.
        Rotation angles are taken from the circuit when the input is a
        Circuit; for label-based inputs pass `rotation_params` (or a third
        tuple element) — the reference only stores angles for circuit inputs
        (reference envs/synthesis.py:411-412), this extends that to
        tuple/label inputs so build_circuit_from_solution can reconstruct
        parametric rotations for them too."""
        if isinstance(input, tuple):
            if len(input) == 3:
                clifford, rotations, rotation_params = input
            else:
                clifford, rotations = input
            clifford_for_state = Clifford(clifford)
            self._rotation_params = list(rotation_params or [])
            self._original_circuit = None
        elif isinstance(input, Circuit):
            clifford, rotations, params = _parse_pauli_circuit(input)
            clifford_for_state = clifford.adjoint()
            self._rotation_params = params
            self._original_circuit = input
        elif isinstance(input, Clifford):
            clifford_for_state = input.adjoint()
            rotations = rotations or []
            self._rotation_params = list(rotation_params or [])
            self._original_circuit = None
        else:
            raise ValueError(f"Unsupported input type: {type(input)}")

        rotations = list(rotations or [])
        max_r = int(self.config.get("max_rotations", 5))
        if len(rotations) > max_r:
            # the env truncates the target to max_rotations but the
            # reconstruction replays all of them — reject up front instead
            # of synthesizing a wrong circuit
            raise ValueError(
                f"target has {len(rotations)} rotations but this env was "
                f"built with max_rotations={max_r}")
        for rot in rotations:
            if not any(ch in "XYZxyz" for ch in rot):
                raise ValueError(
                    f"rotation label {rot!r} has no X/Y/Z support (an "
                    "identity rotation is a global phase; drop it from the "
                    "target)")
        self._rotations = rotations
        if rotations:
            self._ever_rotations = True
        tableau = (
            clifford_for_state.tableau[:, :-1].T.flatten().astype(int).tolist()
        )
        # remember this target's rotations/angles keyed on its tableau so
        # reconstruction stays correct when targets are encoded interleaved.
        # Distinct rotation sets CAN share a tableau (e.g. rotation-only
        # targets all have the identity Clifford part), so the memo keeps
        # every distinct (rotations, params) seen per key — the rebuild
        # raises on ambiguity instead of silently picking one.
        key = tuple(tableau)
        entry = (list(rotations), list(self._rotation_params))
        bucket = self._rotation_memo.setdefault(key, [])
        if entry not in bucket:
            bucket.append(entry)
        self._rotation_memo.move_to_end(key)
        while len(self._rotation_memo) > 128:
            self._rotation_memo.popitem(last=False)
        state = [len(rotations)]
        state.extend(tableau)
        for rot in rotations:
            state.append(len(rot))
            state.extend(ord(c) for c in rot)
        return state

    @staticmethod
    def _target_key(inp) -> tuple:
        """The rotation-memo key for a non-Circuit target: the same tableau
        flattening get_state encodes (tuple inputs are taken as-is, bare
        Cliffords are adjointed — mirroring the get_state branches)."""
        if isinstance(inp, tuple):
            clifford_for_state = Clifford(inp[0])
        else:
            clifford_for_state = inp.adjoint()
        return tuple(
            clifford_for_state.tableau[:, :-1].T.flatten().astype(int).tolist()
        )

    def build_circuit_from_solution(self, actions: List[int], input,
                                    rotations: Optional[List[str]] = None,
                                    rotation_params: Optional[List[float]]
                                    = None) -> Circuit:
        """Rebuild the circuit from the packed solution.

        Rotations are re-placed by replaying the gate actions through a fresh
        Pauli network at PRIMITIVE granularity: an event fired by the internal
        cnot of a CZ/SWAP belongs between that gate's primitives (after the
        whole composite the frame has changed and the recorded axis/qubit
        would be wrong). The network's cnot(i, j) is the transposed-index
        convention, so it reconstructs as cx(j, i)
        (reference envs/synthesis.py:487-493).

        For Clifford/tuple inputs the rotation labels/angles are restored
        from the per-target memo recorded at get_state time (keyed on the
        target's tableau, so interleaved encodings of different targets
        reconstruct correctly); pass `rotations`/`rotation_params`
        explicitly to override."""
        full = decode_pauli_solution(actions)
        num_qubits = self.config["num_qubits"]
        qc = Circuit(num_qubits)

        # rebuild the replay network from the target encoding; for
        # non-Circuit inputs restore the label/angle kwargs remembered for
        # THIS target (a bare Clifford re-encoded without them would lose
        # the rotations)
        rots, params = rotations, rotation_params
        inp = input
        if not isinstance(inp, Circuit) and (rots is None or params is None):
            bucket = self._rotation_memo.get(self._target_key(inp), [])
            if len(bucket) == 1:
                rots = bucket[0][0] if rots is None else rots
                params = bucket[0][1] if params is None else params
            elif len(bucket) > 1:
                raise ValueError(
                    "multiple targets with this Clifford part but different "
                    "rotations were encoded (e.g. rotation-only targets all "
                    "share the identity tableau) — pass rotations= and "
                    "rotation_params= explicitly to disambiguate")
            elif getattr(self, "_ever_rotations", False):
                # memo miss on an env that HAS encoded rotations: the old
                # fallback (most recent encoding) silently rebuilt with the
                # wrong rotations — fail loudly instead
                raise ValueError(
                    "no remembered rotations for this target (encoded on a "
                    "different env instance, or evicted past the 128-target "
                    "memo) — pass rotations= and rotation_params= explicitly")
            else:  # rotation-free env: nothing to restore
                rots = [] if rots is None else rots
                params = [] if params is None else params
        enc = self.get_state(inp, rotations=rots or None,
                             rotation_params=params or None)
        tableau, labels = self._parse_encoded(enc, num_qubits)
        net = PauliNetwork(tableau.reshape(-1), labels)

        rot_queue = [item for item in full if item[0] != "gate"]

        def emit_events(events):
            for axis, qubit, rindex, ev_mult in events:
                if rot_queue:
                    step_type, q, ridx, mult = rot_queue.pop(0)
                else:  # fall back to the replay's own phase bookkeeping
                    mult = ev_mult
                    step_type = {"X": "rx", "Y": "ry", "Z": "rz"}[axis]
                    q, ridx = qubit, rindex
                if ridx >= len(self._rotation_params):
                    raise RuntimeError(
                        "Too few rotation parameters stored for synthesis"
                    )
                qc.append(step_type, (q,), (mult * self._rotation_params[ridx],))

        def cnot(i, j):
            events = net._cnot(i, j)
            qc.cx(j, i)
            emit_events(events)

        gs = self.spec.gateset
        for step_type, a1, _a2, _a3 in full:
            if step_type != "gate":
                continue  # rotations are emitted at their extraction points
            name, qs = gs[a1]
            if name == "H":
                net._h(qs[0]); qc.h(qs[0])
            elif name == "S":
                net._s(qs[0]); qc.s(qs[0])
            elif name == "Sdg":
                net._s(qs[0]); net._s(qs[0]); net._s(qs[0]); qc.sdg(qs[0])
            elif name == "SX":
                net._sx(qs[0]); qc.sx(qs[0])
            elif name == "SXdg":
                net._sx(qs[0]); net._sx(qs[0]); net._sx(qs[0]); qc.sxdg(qs[0])
            elif name == "CX":
                cnot(qs[0], qs[1])
            elif name == "CZ":
                net._h(qs[1]); qc.h(qs[1])
                cnot(qs[0], qs[1])
                net._h(qs[1]); qc.h(qs[1])
            elif name == "SWAP":
                cnot(qs[0], qs[1])
                cnot(qs[1], qs[0])
                cnot(qs[0], qs[1])

        original = input if isinstance(input, Circuit) else self._original_circuit
        if original is not None:
            correction = Clifford(
                _just_clifford(qc.inverse().compose(original))
            ).to_circuit()
            qc = qc.compose(correction)
        return qc


def _parse_pauli_circuit(circuit: Circuit):
    """Split a Clifford+rotations circuit into (Clifford, rotation labels,
    rotation angles) with rotations commuted to the FRONT of the circuit:
    U = C · exp(-i t/2 P) · C_before = C · C_before · exp(-i t/2 P') with
    P' = C_before^dag P C_before (reference envs/synthesis.py:317-364)."""
    n = circuit.num_qubits
    clifford = Clifford.identity(n)
    acc = Circuit(n)  # Clifford gates so far, for the C^dag P C evolution
    rotations: List[str] = []
    params: List[float] = []
    for name, qubits, gate_params in circuit:
        if name in ("rx", "ry", "rz"):
            p = Pauli.single(n, qubits[0], name[1].upper())
            p = p.evolve_circuit(acc.inverse())  # C^dag P C
            rotations.append(p.adjoint().to_label())
            params.extend(gate_params)
        else:
            clifford.append_gate(name, qubits)
            acc.append(name, qubits)
    return clifford, rotations, params


def _just_clifford(circuit: Circuit) -> Circuit:
    out = circuit.copy_empty()
    for name, qubits, params in circuit:
        if name not in ("rx", "ry", "rz"):
            out.append(name, qubits, params)
    return out


SYNTH_ENVS = {
    "CliffordEnv": CliffordGym,
    "LinearFunctionEnv": LinearFunctionGym,
    "PermutationEnv": PermutationGym,
    "PauliNetworkEnv": PauliGym,
}
