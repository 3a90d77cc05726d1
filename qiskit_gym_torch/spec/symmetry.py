"""Coupling-graph automorphisms -> (observation, action) index permutations.

Capability parity with the reference "twists" subsystem (reference
rust/src/envs/symmetry.rs:115-361): enumerate the automorphism group of the
qubit-adjacency graph induced by the 2-qubit gates in the gateset, keep only
automorphisms that map the gateset onto itself, and emit matching index
permutations for flattened observations and for actions. The enumeration here
is a degree/neighbor-pruned backtracking search (VF2-style) in pure Python —
this runs once at env construction on the host. (The JAX package also has a
native C++ enumerator; loading it here is still to be ported.)

Conventions (must match the reference for checkpoint/config parity):
- obs_perm[idx_old] = idx_new over the flattened obs.
- act_perm[a] = index of the gate obtained by relabeling gate a's qubits.
  The canonical gate key sorts qubits for SWAP only (CX/CZ directions are
  distinct gateset entries).
- Automorphisms that map any gate outside the gateset are dropped.
- Edgeless gatesets: the full symmetric group (n! perms) for n <= 8, identity
  only above that (the reference enumerates n! unconditionally, which is
  intractable for large n; envs without 2q gates are degenerate anyway).
"""

from __future__ import annotations

from itertools import permutations as _all_perms
from typing import Dict, List, Optional, Sequence, Tuple

from .gates import Gate


def _canonical_key(gate: Gate) -> Tuple[str, Tuple[int, ...]]:
    name, qubits = gate
    if name == "SWAP":
        qubits = tuple(sorted(qubits))
    return (name, qubits)


def _adjacency(num_qubits: int, gateset: Sequence[Gate]) -> List[set]:
    adj = [set() for _ in range(num_qubits)]
    for name, qs in gateset:
        if len(qs) == 2:
            a, b = qs
            adj[a].add(b)
            adj[b].add(a)
    return adj


def coupling_automorphisms(num_qubits: int, gateset: Sequence[Gate]) -> List[List[int]]:
    """All automorphisms of the coupling graph (sorted, deduped)."""
    if num_qubits == 0:
        return [[]]
    adj = _adjacency(num_qubits, gateset)
    has_edge = any(adj)
    if not has_edge:
        if num_qubits <= 8:
            return [list(p) for p in _all_perms(range(num_qubits))]
        return [list(range(num_qubits))]

    return _python_automorphisms(num_qubits, adj)


def _python_automorphisms(num_qubits: int, adj: List[set]) -> List[List[int]]:
    degree = [len(a) for a in adj]
    # order vertices by decreasing degree for better pruning
    order = sorted(range(num_qubits), key=lambda v: -degree[v])
    results: List[List[int]] = []
    mapping: Dict[int, int] = {}
    used = [False] * num_qubits

    def backtrack(pos: int):
        if pos == num_qubits:
            perm = [0] * num_qubits
            for k, v in mapping.items():
                perm[k] = v
            results.append(perm)
            return
        u = order[pos]
        for v in range(num_qubits):
            if used[v] or degree[v] != degree[u]:
                continue
            ok = True
            for w in adj[u]:
                if w in mapping and mapping[w] not in adj[v]:
                    ok = False
                    break
            if ok:
                # also check non-edges to already-mapped vertices
                for w in mapping:
                    if (w in adj[u]) != (mapping[w] in adj[v]):
                        ok = False
                        break
            if ok:
                mapping[u] = v
                used[v] = True
                backtrack(pos + 1)
                used[v] = False
                del mapping[u]

    backtrack(0)
    results.sort()
    out = []
    for p in results:
        if not out or out[-1] != p:
            out.append(p)
    return out or [list(range(num_qubits))]


def build_action_perm(
    gateset: Sequence[Gate], perm: Sequence[int]
) -> Optional[List[int]]:
    # Duplicate canonical keys are legal gatesets (a symmetric coupling map
    # expands SWAP on both edge directions; the canonical key sorts SWAP
    # qubits, collapsing the pair). Map the k-th action of a key to the
    # k-th action of the relabeled key so the result stays a BIJECTION —
    # a last-write-wins dict would alias duplicate actions and corrupt the
    # policy's symmetrized logits.
    index: dict = {}
    for i, g in enumerate(gateset):
        index.setdefault(_canonical_key(g), []).append(i)
    seen: dict = {}
    act: List[int] = []
    for name, qubits in gateset:
        src_key = _canonical_key((name, qubits))
        k = seen.get(src_key, 0)
        seen[src_key] = k + 1
        relabeled = tuple(perm[q] for q in qubits)
        targets = index.get(_canonical_key((name, relabeled)))
        if targets is None or k >= len(targets):
            return None
        act.append(targets[k])
    return act


def _twists(
    num_qubits: int,
    gateset: Sequence[Gate],
    obs_perm_builder,
) -> Tuple[List[List[int]], List[List[int]]]:
    obs_perms: List[List[int]] = []
    act_perms: List[List[int]] = []
    for perm in coupling_automorphisms(num_qubits, gateset):
        act = build_action_perm(gateset, perm)
        if act is not None:
            obs_perms.append(obs_perm_builder(perm))
            act_perms.append(act)
    if not obs_perms:
        ident = list(range(num_qubits))
        act = build_action_perm(gateset, ident)
        if act is not None:
            obs_perms.append(obs_perm_builder(ident))
            act_perms.append(act)
    return obs_perms, act_perms


def _obs_perm_square(num_qubits: int, perm: Sequence[int]) -> List[int]:
    out = [0] * (num_qubits * num_qubits)
    for r in range(num_qubits):
        for c in range(num_qubits):
            out[r * num_qubits + c] = perm[r] * num_qubits + perm[c]
    return out


def _obs_perm_clifford(num_qubits: int, perm: Sequence[int]) -> List[int]:
    dim = 2 * num_qubits
    ext = list(perm) + [num_qubits + p for p in perm]
    out = [0] * (dim * dim)
    for r in range(dim):
        for c in range(dim):
            out[r * dim + c] = ext[r] * dim + ext[c]
    return out


def compute_twists_square(num_qubits, gateset):
    """(obs_perms, act_perms) for n x n observations (Permutation/LinearFunction)."""
    return _twists(num_qubits, gateset, lambda p: _obs_perm_square(num_qubits, p))


def compute_twists_clifford(num_qubits, gateset):
    """(obs_perms, act_perms) for 2n x 2n observations with X/Z block structure."""
    return _twists(num_qubits, gateset, lambda p: _obs_perm_clifford(num_qubits, p))


def compute_qubit_perms(num_qubits, gateset):
    """(qubit_perms, act_perms) — raw automorphisms, for PauliEnv internal use."""
    return _twists(num_qubits, gateset, lambda p: list(p))
