"""The plain float32 policy of the shipped artifacts, and the phase-less
env transition of their observed tableaus.

`load_weights` reads an artifact's `.pt` state dict itself. `forward` is the
`BasicPolicy` of the artifacts' JSON (a Linear 'embeddings' on the flattened
observation, ReLU, the 'common.i' ReLU Linears, then the 'action.i' and
'value.i' heads), averaged over the coupling map's symmetry copies as the
artifact's policy bundle is: each copy relabels the qubits of the
observation by an automorphism of the coupling graph that maps the gateset
onto itself, and reads each action's logit at the relabelled action. With
no such automorphism but the identity, it is the plain net.

Matrix products run in float32 with TF32 off (`strict_float32`); `dtype`
bfloat16 gives the lower-precision control. Imports torch and numpy only.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .tableau import tableau


def strict_float32() -> None:
    """Float32 matrix products in full float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def load_artifact(json_path: str) -> dict:
    with open(json_path) as f:
        return json.load(f)


def load_weights(pt_path: str, device) -> Dict[str, torch.Tensor]:
    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}


def _stack(sd: Dict[str, torch.Tensor], prefix: str) -> List[Tuple]:
    n = len([k for k in sd if k.startswith(prefix + ".")
             and k.endswith(".weight")])
    return [(sd[f"{prefix}.{i}.weight"], sd[f"{prefix}.{i}.bias"])
            for i in range(n)]


def net(sd: Dict[str, torch.Tensor], flat: torch.Tensor, dtype=torch.float32):
    """[N, D] observations -> (logits [N, A], value [N]) of the plain net,
    computed in `dtype`; returned in float32."""
    def lin(h, wb):
        return h @ wb[0].to(dtype).T + wb[1].to(dtype)

    h = torch.relu(lin(flat.to(dtype), (sd["embeddings.weight"],
                                        sd["embeddings.bias"])))
    for wb in _stack(sd, "common"):
        h = torch.relu(lin(h, wb))
    outs = []
    for head in ("action", "value"):
        y = h
        layers = _stack(sd, head)
        for wb in layers[:-1]:
            y = torch.relu(lin(y, wb))
        outs.append(lin(y, layers[-1]).float())
    return outs[0], outs[1][:, 0]


# ---------------------------------------------------------------- symmetry
def _key(name: str, qs) -> Tuple:
    return (name, tuple(sorted(qs)) if name == "SWAP" else tuple(qs))


def automorphisms(n: int, gateset) -> List[List[int]]:
    """Every qubit relabelling that maps the undirected coupling graph of
    the gateset's 2q gates onto itself (backtracking)."""
    adj = [set() for _ in range(n)]
    for _, qs in gateset:
        if len(qs) == 2:
            adj[qs[0]].add(qs[1])
            adj[qs[1]].add(qs[0])
    found, perm = [], [-1] * n

    def extend(u):
        if u == n:
            found.append(list(perm))
            return
        for v in range(n):
            if v in perm or len(adj[v]) != len(adj[u]):
                continue
            if all((perm[w] in adj[v]) == (w in adj[u]) for w in range(u)):
                perm[u] = v
                extend(u + 1)
                perm[u] = -1

    extend(0)
    return found


def relabellings(n: int, gateset) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(qubit map, action map) of each automorphism under which the gateset
    maps onto itself, the k-th action of a gate key onto the k-th action
    of the relabelled key; the identity first."""
    index: Dict[Tuple, List[int]] = {}
    for i, (name, qs) in enumerate(gateset):
        index.setdefault(_key(name, qs), []).append(i)
    out = []
    for perm in automorphisms(n, gateset):
        seen: Dict[Tuple, int] = {}
        act = []
        for name, qs in gateset:
            k = seen.get(_key(name, qs), 0)
            seen[_key(name, qs)] = k + 1
            dst = index.get(_key(name, [perm[q] for q in qs]), [])
            if k >= len(dst):
                act = None
                break
            act.append(dst[k])
        if act is not None:
            out.append((np.asarray(perm), np.asarray(act)))
    out.sort(key=lambda pa: not np.array_equal(pa[0], np.arange(n)))
    return out


def rows_map(perm: np.ndarray, dim: int) -> np.ndarray:
    """Where a relabelling sends each row of a dim x dim observation: the
    qubits of an n x n one, the X part then the Z part of a 2n x 2n one."""
    n = len(perm)
    return perm if dim == n else np.concatenate([perm, n + perm])


def symmetry_copies(n: int, gateset, dim: int
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(obs index map, action map) of each relabelling: the obs map gives,
    for each position of the relabelled flattened dim x dim observation,
    the position it is read from."""
    copies = []
    for perm, act in relabellings(n, gateset):
        ext = rows_map(perm, dim)
        new = (ext[:, None] * dim + ext[None, :]).reshape(-1)
        src = np.empty(dim * dim, np.int64)
        src[new] = np.arange(dim * dim)
        copies.append((src, act))
    return copies


class Policy:
    """The artifact's policy: weights from its `.pt`, symmetry copies from
    its JSON (matrix envs with add_perms; the Pauli env observes under its
    own relabelling and has none)."""

    def __init__(self, json_path: str, pt_path: str, device):
        art = load_artifact(json_path)
        env = art["env"]
        self.gateset = [(g[0], tuple(g[1])) for g in env["gateset"]]
        self.n = int(env["num_qubits"])
        self.sd = load_weights(pt_path, device)
        self.device = device
        matrix = not art["env_cls"].endswith("PauliNetworkEnv")
        dim = self.sd["embeddings.weight"].shape[1]
        copies = (symmetry_copies(self.n, self.gateset, int(dim ** 0.5))
                  if matrix and env.get("add_perms", True) else [])
        self.copies = [(torch.as_tensor(o, device=device),
                        torch.as_tensor(a, device=device))
                       for o, a in copies] if len(copies) > 1 else []

    def __call__(self, obs: torch.Tensor, dtype=torch.float32,
                 sd: Optional[Dict[str, torch.Tensor]] = None):
        """obs [N, *obs_shape] (0/1) -> (logits [N, A], value [N])."""
        sd = self.sd if sd is None else sd
        flat = obs.reshape(obs.shape[0], -1).to(torch.float32)
        if not self.copies:
            return net(sd, flat, dtype)
        logits, values = [], []
        for src, act in self.copies:
            lg, v = net(sd, flat[:, src], dtype)
            logits.append(lg[:, act])
            values.append(v)
        return torch.stack(logits).mean(0), torch.stack(values).mean(0)


# -------------------------------------------------------------- transition
def emitted_gates(family: str, name: str, qs) -> list:
    """The gates an action puts into the output circuit. The Clifford env
    emits the gate it names. The Pauli-network env's cnot(i, j) is cx(j, i)
    (its transposed-index convention), so its CX(a, b) emits cx(b, a) and
    its CZ(a, b) h(b) cx(b, a) h(b)."""
    name = name.lower()
    if family == "pauli" and name == "cx":
        return [("cx", (qs[1], qs[0]))]
    if family == "pauli" and name == "cz":
        return [("h", (qs[1],)), ("cx", (qs[1], qs[0])), ("h", (qs[1],))]
    return [(name, tuple(qs))]


class MatrixTransition:
    """The env's phase-less step on its observed 2n x 2n matrix (the
    Clifford env's whole observation, the Pauli env's tableau block): the
    action's emitted gates multiply it on the left by the transpose of
    their symplectic matrix; a random inversion of the state (Clifford env)
    replaces it by its inverse. The Pauli env observes each step under a
    relabelling drawn from the coupling map's automorphisms (rows and
    columns) and reads the policy's action in that frame, so a step is
    sound where some pair of frames, before and after, explains it."""

    def __init__(self, n: int, gateset, family: str):
        self.mats = []
        for name, qs in gateset:
            x, z, _ = tableau(n, emitted_gates(family, name, qs))
            self.mats.append(np.concatenate([x, z], axis=1).T.astype(
                np.int64))
        dim = 2 * n
        frames = ([(rows_map(p, dim), a) for p, a in relabellings(n, gateset)]
                  if family == "pauli"
                  else [(np.arange(dim), np.arange(len(gateset)))])
        self.frames = []
        for ext, act in frames:
            for e in {tuple(ext), tuple(np.argsort(ext))}:
                for a in {tuple(act), tuple(np.argsort(act))}:
                    self.frames.append((np.array(e), np.array(a)))

    def _views(self, m: np.ndarray):
        return [m[np.ix_(e, e)] for e in {tuple(f[0]) for f in self.frames}]

    def start_ok(self, obs0: np.ndarray, encoded: np.ndarray) -> bool:
        return any(np.array_equal(obs0, v) for v in self._views(encoded))

    def _ok(self, before, action, after, flipped) -> bool:
        eye = np.eye(before.shape[-1], dtype=np.int64)
        for e, act in self.frames:
            back = np.empty_like(e)
            back[e] = np.arange(len(e))
            tab = before[np.ix_(back, back)]
            nxt = (self.mats[int(act[action])] @ tab) % 2
            for view in self._views(nxt):
                if flipped:
                    if np.array_equal((after @ view) % 2, eye):
                        return True
                elif np.array_equal(after, view):
                    return True
        return False

    def solves(self, before: np.ndarray, action: int) -> bool:
        """Whether the step from `before` reaches the identity tableau (the
        matrix envs, whose observation is the whole state)."""
        eye = np.eye(before.shape[-1], dtype=np.int64)
        before = before.astype(np.int64)
        for e, act in self.frames:
            back = np.empty_like(e)
            back[e] = np.arange(len(e))
            tab = before[np.ix_(back, back)]
            if np.array_equal((self.mats[int(act[action])] @ tab) % 2, eye):
                return True
        return False

    def errors(self, obs: np.ndarray, action: np.ndarray, valid: np.ndarray,
               done: np.ndarray, inverted: np.ndarray) -> int:
        """Steps of one lane ([T, dim, dim] obs, [T] rest) whose next
        observation disagrees with the step from the observation before:
        every valid step that did not end its episode."""
        obs = obs.astype(np.int64)
        return sum(
            not self._ok(obs[t], action[t], obs[t + 1],
                         inverted[t + 1] != inverted[t])
            for t in range(obs.shape[0] - 1) if valid[t] and not done[t])
