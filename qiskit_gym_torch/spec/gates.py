"""Gate vocabulary and gateset parsing.

Mirrors the reference gate enum and its tuple-parsing semantics
(reference rust/src/envs/common.rs:19-100): case-insensitive names, strict
arity checking, gates stored as (canonical_name, (qubits...)).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

ONE_Q = ("H", "S", "Sdg", "SX", "SXdg")
TWO_Q = ("CX", "CZ", "SWAP")
ALL_GATES = ONE_Q + TWO_Q

_CANON = {g.lower(): g for g in ALL_GATES}

Gate = Tuple[str, Tuple[int, ...]]


def gate_arity(name: str) -> int:
    return 1 if _CANON[name.lower()] in ONE_Q else 2


def parse_gate(item: Sequence) -> Gate:
    name, qubits = item[0], item[1]
    key = str(name).lower()
    if key not in _CANON:
        raise ValueError(f"Unknown gate name {name!r}; supported: {ALL_GATES}")
    canon = _CANON[key]
    qubits = tuple(int(q) for q in qubits)
    arity = 1 if canon in ONE_Q else 2
    if len(qubits) != arity:
        raise ValueError(f"Gate {canon} expects {arity} qubit(s), got {qubits}")
    if arity == 2 and qubits[0] == qubits[1]:
        raise ValueError(f"Gate {canon} requires two distinct qubits, got {qubits}")
    return (canon, qubits)


def parse_gateset(gateset: Sequence[Sequence]) -> List[Gate]:
    return [parse_gate(g) for g in gateset]


def gate_qubits(gate: Gate) -> Tuple[int, ...]:
    return gate[1]


def is_two_qubit(gate: Gate) -> bool:
    return gate[0] in TWO_Q
