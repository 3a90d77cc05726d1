"""Plain Clifford tableaus with signs, and the two circuit verifiers.

A Clifford U is held as the images U P U^dagger of the 2n generators
X_0..X_{n-1}, Z_0..Z_{n-1}: each a signed Hermitian Pauli, as rows of x bits,
z bits and a sign bit r in the convention of Aaronson and Gottesman
("Improved simulation of stabilizer circuits", Phys. Rev. A 70, 052328,
2004), where x = z = 1 on a qubit is Y. Gates are conjugated in by their
rules. A circuit is a list of (name, qubits, params) in time order, with the
gate names of a qiskit circuit: h s sdg sx sxdg x y z id cx cz swap, and the
rotations rx ry rz.

This module imports numpy only. It is a frozen rewrite of the semantics, not
a copy of the program's quantum layer.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

ROTATIONS = ("rx", "ry", "rz")
INVERSE = {"s": "sdg", "sdg": "s", "sx": "sxdg", "sxdg": "sx"}


def conjugate(x: np.ndarray, z: np.ndarray, r: np.ndarray, name: str,
              qs: Sequence[int]) -> None:
    """Rows (x, z, r) <- g (rows) g^dagger for the gate g, in place."""
    if name == "h":
        a = qs[0]
        r ^= x[:, a] & z[:, a]
        x[:, a], z[:, a] = z[:, a].copy(), x[:, a].copy()
    elif name == "s":
        a = qs[0]
        r ^= x[:, a] & z[:, a]
        z[:, a] ^= x[:, a]
    elif name == "sdg":
        for _ in range(3):
            conjugate(x, z, r, "s", qs)
    elif name in ("sx", "sxdg"):
        conjugate(x, z, r, "h", qs)
        conjugate(x, z, r, "s" if name == "sx" else "sdg", qs)
        conjugate(x, z, r, "h", qs)
    elif name == "x":
        r ^= z[:, qs[0]]
    elif name == "z":
        r ^= x[:, qs[0]]
    elif name == "y":
        r ^= x[:, qs[0]] ^ z[:, qs[0]]
    elif name == "id":
        pass
    elif name == "cx":
        c, t = qs
        r ^= x[:, c] & z[:, t] & (x[:, t] ^ z[:, c] ^ 1)
        x[:, t] ^= x[:, c]
        z[:, c] ^= z[:, t]
    elif name == "cz":
        conjugate(x, z, r, "h", (qs[1],))
        conjugate(x, z, r, "cx", qs)
        conjugate(x, z, r, "h", (qs[1],))
    elif name == "swap":
        a, b = qs
        for m in (x, z):
            m[:, [a, b]] = m[:, [b, a]]
    else:
        raise ValueError(f"not a Clifford gate: {name!r}")


def identity_rows(n: int):
    """The 2n generators X_0..X_{n-1}, Z_0..Z_{n-1} as rows."""
    x = np.zeros((2 * n, n), np.uint8)
    z = np.zeros((2 * n, n), np.uint8)
    x[np.arange(n), np.arange(n)] = 1
    z[n + np.arange(n), np.arange(n)] = 1
    return x, z, np.zeros(2 * n, np.uint8)


def clifford_part(circuit) -> list:
    return [(g[0], tuple(g[1])) for g in circuit if g[0] not in ROTATIONS]


def tableau(n: int, gates) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Images (x, z, r) of the generators under the Clifford gates, applied
    in time order."""
    x, z, r = identity_rows(n)
    for name, qs in gates:
        conjugate(x, z, r, name, qs)
    return x, z, r


def adjoint_tableau(n: int, gates):
    """Images of the generators under U^dagger: the inverse gates in
    reverse order."""
    return tableau(n, [(INVERSE.get(name, name), qs)
                       for name, qs in reversed(list(gates))])


def rotation_form(n: int, circuit):
    """(tableau of the Clifford gates, [(x, z, signed angle)]) with every
    rotation commuted to the front: a rotation about P after the Clifford A
    of the gates before it equals A after a rotation about A^dagger P A."""
    gates, rots = [], []
    for name, qs, params in circuit:
        if name in ROTATIONS:
            x = np.zeros((1, n), np.uint8)
            z = np.zeros((1, n), np.uint8)
            r = np.zeros(1, np.uint8)
            x[0, qs[0]] = name in ("rx", "ry")
            z[0, qs[0]] = name in ("rz", "ry")
            for g, gq in reversed(gates):
                conjugate(x, z, r, INVERSE.get(g, g), gq)
            sign = -1.0 if r[0] else 1.0
            rots.append((x[0], z[0], sign * float(params[0])))
        else:
            gates.append((name, tuple(qs)))
    return tableau(n, gates), rots


def _commute(a, b) -> bool:
    return int(np.sum((a[0] & b[1]) ^ (a[1] & b[0]))) % 2 == 0


def same_tableau(ta, tb) -> bool:
    return all(np.array_equal(p, q) for p, q in zip(ta, tb))


def verify_clifford(n: int, out, target) -> bool:
    """Whether the Clifford circuits `out` and `target` implement one
    unitary up to a global phase: equal tableaus, signs included."""
    if any(g[0] in ROTATIONS for g in list(out) + list(target)):
        return False
    return same_tableau(tableau(n, clifford_part(out)),
                        tableau(n, clifford_part(target)))


def verify_pauli(n: int, out, target, atol: float = 1e-9) -> bool:
    """Whether two Clifford + rotation circuits implement one unitary up to
    a global phase: equal tableaus, signs included, once every rotation is
    commuted to the front, and rotation sequences that are equal up to
    exchanges of commuting neighbours."""
    tab_a, rots_a = rotation_form(n, out)
    tab_b, rots_b = rotation_form(n, target)
    if not same_tableau(tab_a, tab_b) or len(rots_a) != len(rots_b):
        return False
    rest: List = list(rots_b)
    for xa, za, ta in rots_a:
        for j, (xb, zb, tb) in enumerate(rest):
            if (np.array_equal(xa, xb) and np.array_equal(za, zb)
                    and abs(ta - tb) <= atol):
                del rest[j]
                break
            if not _commute((xa, za), (xb, zb)):
                return False
        else:
            return False
    return True


def encoded_state(n: int, circuit) -> np.ndarray:
    """The env's starting matrix for a target: the phase-less tableau of the
    target's Clifford part, adjoint, as a 2n x 2n matrix whose row i holds
    the (x | z) bits of generator i's image, transposed."""
    x, z, _ = adjoint_tableau(n, clifford_part(circuit))
    return np.concatenate([x, z], axis=1).T.copy()
