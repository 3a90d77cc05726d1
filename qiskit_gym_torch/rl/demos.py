"""Demonstration bootstrap: constructive planner + behavior cloning.

Port of the JAX package's `rl/demos.py`. The 27q full-gateset rotation
regime is priors-bound: search multiplies the seed rate, but past the onset
the tree cannot discover multi-rotation sweep plans among 303 uninformed
priors. Behavior cloning on constructively solved episodes supplies the
missing prior mass at any difficulty, without search.

Demo targets are drawn from the env's own reset distribution (the spec
twin's `_generate_rotations` plus a recorded replica of its 70/15/15
tableau scramble), so the cloned policy trains on the states the curriculum
evals gate on. Solutions come from an op ledger:

1. **Sweep rotations** in anti-commutation front-layer order. Each active
   rotation's column is reduced to single-qubit support: per-qubit axis
   normalization (S maps Y->X, H maps X->Z in the phase-less bit calculus),
   then contraction of the Z-support along coupling-graph shortest paths
   (2 CX, or 1 SWAP, per routing hop, 1 CX to merge). The closing CX of
   every reduction fires the env's trivial-rotation cleanup, so the
   rotation sweeps the moment it becomes trivial.
2. **Unwind the ledger.** Every op applied so far (the reset scramble
   first, then the reduction ops) is self-inverse on the phase-less
   tableau, so replaying the ledger in reverse returns the tableau block to
   identity; swept rotation columns are zero and stay zero under row XORs,
   so the episode lands exactly on `solved()`.

A scramble CX(a, b) row-op equals the gameplay CX(b, a) action (the
network's transposed-index convention); H and S row-ops equal their own
gameplay actions (S == Sdg on the phase-less tableau).

The planning half is numpy on the spec envs (`spec/`), identical to the JAX
package draw for draw, so both packages record the same corpus from the
same seed. `fit_demos` clones with the AlphaZero loss itself (one-hot visit
targets + undiscounted return-to-go values) through the algorithm's own
`_loss_flat` and optimizer, so BC and self-play fitting are one
optimization and AlphaZero resumes on the same Adam state afterwards. The
corpus lives on the device packed (`np.packbits` bytes, MSB first); each
minibatch unpacks its own rows.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qiskit_gym_torch.parallel.mesh import dp_coords, psum
from qiskit_gym_torch.spec.gates import Gate
from qiskit_gym_torch.spec.pauli_env import PauliSpecEnv


# --------------------------------------------------------------- graph paths
def shortest_path_tables(
    num_qubits: int, pairs: Sequence[Tuple[int, int]]
) -> Tuple[np.ndarray, np.ndarray]:
    """(dist, next_hop) int matrices over the coupling graph; -1 = unreachable."""
    adj: List[List[int]] = [[] for _ in range(num_qubits)]
    for a, b in pairs:
        if b not in adj[a]:
            adj[a].append(b)
        if a not in adj[b]:
            adj[b].append(a)
    dist = np.full((num_qubits, num_qubits), -1, np.int32)
    nxt = np.full((num_qubits, num_qubits), -1, np.int32)
    for src in range(num_qubits):
        dist[src, src] = 0
        q = deque([src])
        while q:
            v = q.popleft()
            for nb in adj[v]:
                if dist[src, nb] < 0:
                    dist[src, nb] = dist[src, v] + 1
                    # first hop on the path src -> nb
                    nxt[src, nb] = nb if v == src else nxt[src, v]
                    q.append(nb)
    return dist, nxt


# --------------------------------------------------------- scramble recording
def record_random_tableau(env: PauliSpecEnv) -> Tuple[np.ndarray, List[Gate]]:
    """Replica of PauliSpecEnv._random_tableau that also returns the ops as
    gameplay-action gates (already convention-flipped for CX). Must stay
    distribution-identical to the spec (and the device core twin)."""
    n = env.num_qubits
    dim = 2 * n
    data = np.eye(dim, dtype=np.uint8)
    ops: List[Gate] = []
    if env.difficulty == 0 or not env.valid_pairs:
        return data.reshape(-1), ops
    rng = env.rng
    for _ in range(env.difficulty):
        r = rng.random()
        if r > 0.3:
            q0, q1 = env.valid_pairs[int(rng.integers(len(env.valid_pairs)))]
            data[q1] ^= data[q0]
            data[n + q0] ^= data[n + q1]
            # scramble CX(q0, q1) row-op == gameplay CX(q1, q0) action
            ops.append(("CX", (q1, q0)))
        elif r > 0.15:
            q = int(rng.integers(n))
            data[[q, n + q]] = data[[n + q, q]]
            ops.append(("H", (q,)))
        else:
            q = int(rng.integers(n))
            data[n + q] ^= data[q]
            ops.append(("S", (q,)))
    return data.reshape(-1), ops


# ------------------------------------------------------------------ planning
class _Planner:
    def __init__(self, env: PauliSpecEnv, prefer_swap: bool = True):
        self.env = env
        self.n = env.num_qubits
        self.gate_index: Dict[Gate, int] = {
            g: i for i, g in enumerate(env.gateset)
        }
        self.dist, self.nxt = shortest_path_tables(self.n, env.valid_pairs)
        self.prefer_swap = prefer_swap and any(
            name == "SWAP" for name, _ in env.gateset
        )
        # a CX action is needed to FIRE cleanup for an already-trivial
        # rotation; pick one per possible support qubit that avoids it
        self._any_cx = [g for g in env.gateset if g[0] == "CX"]

    def _require(self, gate: Gate) -> Gate:
        if gate not in self.gate_index:
            raise KeyError(f"required gate {gate} not in gateset")
        return gate

    def _cx_avoiding(self, qubit: Optional[int]) -> Gate:
        for g in self._any_cx:
            if qubit is None or qubit not in g[1]:
                return g
        raise KeyError(f"no CX action avoiding qubit {qubit}")

    def reduction_ops(self, rindex: int) -> List[Gate]:
        """Gameplay gates reducing rotation `rindex` to single-qubit support,
        ending with a CX (so the env cleanup fires). Simulated on a copy of
        the column's (x, z) bits only — single-qubit ops and pure-Z CX
        contractions never touch other columns' planning state."""
        net = self.env.network
        n = self.n
        col = net.data[:, 2 * n + rindex]
        x = col[:n].astype(bool).copy()
        z = col[n:].astype(bool).copy()
        support = sorted(np.flatnonzero(x | z).tolist())
        ops: List[Gate] = []
        if len(support) <= 1:
            # already trivial: fire cleanup with a CX that cannot touch it
            q = support[0] if support else None
            return [self._cx_avoiding(q)]
        # axis-normalize every support qubit to Z:  S: z ^= x (Y -> X),
        # H: x <-> z (X -> Z)
        for q in support:
            if x[q] and z[q]:
                ops.append(self._require(("S", (q,))))
                z[q] = False
            if x[q] and not z[q]:
                ops.append(self._require(("H", (q,))))
                x[q], z[q] = False, True
        live = set(support)
        # contract the Z-support: route the closest pair together.
        # gameplay CX(i, j) on a pure-Z column does z_j ^= z_i.
        while len(live) > 1:
            pairs = sorted(
                ((int(self.dist[a, b]), a, b) for a in live for b in live
                 if a != b and self.dist[a, b] > 0),
            )
            if not pairs:
                raise KeyError("rotation support spans disconnected qubits")
            _, a, b = pairs[0]
            v = a
            while self.dist[v, b] > 1:
                u = int(self.nxt[v, b])
                if u in live:
                    # v's path runs into another support qubit: merge v there
                    ops.append(self._require(("CX", (u, v))))
                    live.discard(v)
                    v = -1
                    break
                if self.prefer_swap and ("SWAP", (v, u)) in self.gate_index:
                    ops.append(("SWAP", (v, u)))
                elif self.prefer_swap and ("SWAP", (u, v)) in self.gate_index:
                    ops.append(("SWAP", (u, v)))
                else:
                    ops.append(self._require(("CX", (v, u))))  # spread to u
                    ops.append(self._require(("CX", (u, v))))  # clear v
                live.discard(v)
                live.add(u)
                v = u
            if v >= 0:
                ops.append(self._require(("CX", (b, v))))      # merge into b
                live.discard(v)
        return ops


def plan_episode(
    env: PauliSpecEnv, difficulty: Optional[int] = None,
    prefer_swap: bool = True,
) -> Optional[List[int]]:
    """Reset `env` from its own distribution (recording the scramble) and
    return a planned action-index solution, or None when the plan exceeds
    the episode's depth budget (caller resamples). On return the env is
    reset and ready to replay the actions."""
    if difficulty is not None:
        env.set_difficulty(difficulty)
    rotations = env._generate_rotations(env.difficulty // env.pauli_diff_scale)
    tableau, scramble_ops = record_random_tableau(env)
    env.reset(rotations=rotations, tableau=tableau)
    if env.success:
        return []

    planner = _Planner(env, prefer_swap=prefer_swap)
    gate_index = planner.gate_index
    ledger: List[Gate] = list(scramble_ops)
    actions: List[int] = []
    budget = env.depth

    # phase A: sweep every rotation (front-layer order), mutating a scratch
    # network so the real env can replay the finished plan afterwards
    scratch = copy.deepcopy(env.network)
    guard = 0
    while scratch.active:
        guard += 1
        if guard > 4 * max(len(scratch.rotation_qk), 1):
            return None  # should be unreachable; never loop forever
        front = scratch.front_layer()
        # cheapest-first: fewer routing hops keeps plans inside the budget
        scratch_env_net = planner.env.network
        planner.env.network = scratch
        try:
            r = min(
                front,
                key=lambda i: len(
                    np.flatnonzero(
                        scratch.data[: planner.n, 2 * planner.n + i]
                        | scratch.data[planner.n:, 2 * planner.n + i]
                    )
                ),
            )
            ops = planner.reduction_ops(r)
        except KeyError:
            return None
        finally:
            planner.env.network = scratch_env_net
        for gate in ops:
            scratch.act(gate)
            ledger.append(gate)
            actions.append(gate_index[gate])

    # phase B: unwind — every ledger op is self-inverse on the tableau
    for gate in reversed(ledger):
        if gate not in gate_index:
            return None
        actions.append(gate_index[gate])

    if len(actions) > budget:
        return None
    return actions


# ------------------------------------------------------------- matrix envs
def plan_episode_matrix(env, difficulty: Optional[int] = None):
    """Demo plan for the matrix envs (Permutation / LinearFunction /
    Clifford): scramble by recorded gateset actions, then return the
    reversed sequence — every gate's phase-less GF(2) row-op is an
    involution (H/SWAP row swaps; S/Sdg/SX/SXdg/CX/CZ XOR row-ops,
    reference clifford.rs:84-133), so the reversal is a verified solution.
    On return the env is reset and ready to replay."""
    if difficulty is not None:
        env.set_difficulty(difficulty)
    acts = env.rng.integers(0, env.num_actions(), size=env.difficulty)
    env.reset(scramble_actions=acts)
    if env.success:
        return []
    plan = [int(a) for a in reversed(acts)]
    return plan if len(plan) <= env.depth else None


def generate_demos_matrix(
    env,
    difficulties: Sequence[int],
    episodes_per_difficulty: int,
    max_attempts_factor: int = 4,
) -> Dict[str, np.ndarray]:
    """generate_demos for the matrix envs. No symmetry handling is needed
    (their policies apply twists by group averaging, not the env), and the
    in-episode inversion coin-flip is pinned off so labels stay valid."""
    obs_rows: List[np.ndarray] = []
    act_rows: List[int] = []
    rew_rows: List[float] = []
    ep_ends: List[int] = []
    episodes = attempts = 0
    for difficulty in difficulties:
        done = 0
        budget = max_attempts_factor * episodes_per_difficulty
        local = 0
        while done < episodes_per_difficulty and local < budget:
            local += 1
            attempts += 1
            plan = plan_episode_matrix(env, difficulty)
            if plan is None or not plan:
                continue
            start = len(act_rows)
            for a in plan:
                if env.is_final():
                    break  # solved early through a self-canceling prefix
                obs_rows.append(
                    np.packbits(env._dense_obs().reshape(-1) > 0))
                act_rows.append(a)
                env.step(a, invert=False)
                rew_rows.append(env.reward())
            if not env.success:
                del obs_rows[start:], act_rows[start:], rew_rows[start:]
                continue
            ep_ends.append(len(act_rows))
            done += 1
            episodes += 1
    return _pack_demo_rows(env, obs_rows, act_rows, rew_rows, ep_ends,
                           episodes, attempts)


def _pack_demo_rows(env, obs_rows, act_rows, rew_rows, ep_ends,
                    episodes, attempts) -> Dict[str, np.ndarray]:
    N = len(act_rows)
    ret = np.zeros(N, np.float32)
    start = 0
    for end in ep_ends:
        g = 0.0
        for i in range(end - 1, start - 1, -1):
            g += rew_rows[i]
            ret[i] = g
        start = end
    return {
        "obs_packed": np.stack(obs_rows) if obs_rows else
        np.zeros((0, 0), np.uint8),
        "obs_bits": int(np.prod(env.obs_shape())),
        "action": np.asarray(act_rows, np.int32),
        "ret": ret,
        "episodes": episodes,
        "attempts": attempts,
    }


# ----------------------------------------------------------------- recording
def generate_demos(
    env: PauliSpecEnv,
    difficulties: Sequence[int],
    episodes_per_difficulty: int,
    augment: bool = True,
    max_attempts_factor: int = 4,
) -> Dict[str, np.ndarray]:
    """Plan + replay demo episodes, recording (obs, action, return) triples
    in the policy frame (random symmetry automorphism per step when
    `augment`, exactly as the env's own observe/step pair applies them).

    Returns {"obs" uint8 [N, obs_dim], "action" int32 [N], "ret" f32 [N],
    "episodes" int, "attempts" int}. Return-to-go is undiscounted, matching
    the AZ value target (rl/az.py train_step)."""
    n = env.num_qubits
    rng = env.rng
    perms = env.qubit_perms
    act_perms = np.asarray(env._act_perms_internal, dtype=np.int64) \
        if env._act_perms_internal else None
    inv_act = None
    if act_perms is not None:
        inv_act = np.zeros_like(act_perms)
        for p in range(act_perms.shape[0]):
            inv_act[p, act_perms[p]] = np.arange(act_perms.shape[1])

    obs_rows: List[np.ndarray] = []
    act_rows: List[int] = []
    rew_rows: List[float] = []
    ep_ends: List[int] = []
    episodes = attempts = 0
    for difficulty in difficulties:
        done = 0
        budget_attempts = max_attempts_factor * episodes_per_difficulty
        local_attempts = 0
        while done < episodes_per_difficulty and local_attempts < budget_attempts:
            local_attempts += 1
            attempts += 1
            plan = plan_episode(env, difficulty)
            if plan is None or not plan:
                continue
            start = len(act_rows)
            for a_env in plan:
                if env.is_final():
                    # the unwind can pass through identity early (a
                    # self-canceling scramble prefix): the episode solved
                    # ahead of plan — keep the truncated demo
                    break
                dense = env._dense_obs()
                if augment and perms:
                    p = int(rng.integers(len(perms)))
                    dense = env._permute_obs(dense, perms[p], n)
                    env._current_perm_idx = p
                    a_obs = int(inv_act[p, a_env])
                else:
                    if perms:
                        env._current_perm_idx = perms.index(
                            list(range(n))
                        ) if list(range(n)) in perms else 0
                    a_obs = a_env
                env.step(a_obs)
                obs_rows.append(np.packbits(dense.reshape(-1) > 0))
                act_rows.append(a_obs)
                rew_rows.append(env.reward())
            if not env.success:
                # roll back a failed replay (should not happen; plans are
                # verified by construction, but never ship a bad label)
                del obs_rows[start:], act_rows[start:], rew_rows[start:]
                continue
            ep_ends.append(len(act_rows))
            done += 1
            episodes += 1
    return _pack_demo_rows(env, obs_rows, act_rows, rew_rows, ep_ends,
                           episodes, attempts)


def unpack_rows(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 [N, ceil(bits / 8)] rows as `np.packbits` wrote them (MSB
    first, the last byte padded) -> uint8 [N, bits] of 0/1."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, :, None] >> shifts) & 1).reshape(
        packed.shape[0], -1)[:, :bits]


def prepare_demos(algo, demos: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Upload a generate_demos corpus to the algorithm's device once, packed
    (obs bit-bytes uint8, actions int64, returns f32). fit_demos accepts the
    result in place of the raw corpus; keeping the corpus packed is what
    lets million-step corpora fit in device memory."""
    dev = algo.device
    return {
        "obs_packed": torch.as_tensor(
            np.asarray(demos["obs_packed"], np.uint8), device=dev),
        "action": torch.as_tensor(np.asarray(demos["action"]),
                                  dtype=torch.int64, device=dev),
        "ret": torch.as_tensor(np.asarray(demos["ret"]),
                               dtype=torch.float32, device=dev),
        "obs_bits": int(demos["obs_bits"]),
        "prepared": True,
    }


def fit_demos(algo, demos: Dict[str, np.ndarray], epochs: int = 1,
              num_minibatches: int = 16,
              generator: Optional[torch.Generator] = None,
              perm: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Behavior-clone `algo` (an `AZ`, or any algorithm with `policy`,
    `optimizer`, `_update` and the AlphaZero `_loss_flat`) on a
    generate_demos corpus, raw or from prepare_demos.

    Each epoch shuffles the N steps and runs num_minibatches Adam steps of
    N // num_minibatches rows (the remainder is dropped). One-hot demo
    actions are the visit target, the undiscounted return-to-go the value
    target, and every row is valid. The shuffles come from `generator`
    (default `algo.generator`), or `perm` (int [epochs, N], a permutation
    of range(N) per epoch) injects them. The step goes through
    `algo.optimizer` as it is at the call, so an optimizer swapped in
    between calls takes effect on the next one. Under `algo.mesh` every
    process holds the whole corpus and fits its share of each minibatch
    (the gradients are summed over 'dp'). Returns the last epoch's losses
    (mean over its minibatches) and `demo_steps`."""
    if not demos.get("prepared"):
        demos = prepare_demos(algo, demos)
    N = int(demos["action"].shape[0])
    if N == 0:
        return {"loss": float("nan"), "demo_steps": 0}
    bits = int(demos["obs_bits"])
    A = algo.core.num_actions
    obs_shape = tuple(algo.core.obs_shape)
    dev = algo.device
    nmb = max(1, min(num_minibatches, N))
    mb = N // nmb
    if perm is None:
        g = algo.generator if generator is None else generator
        perm = torch.stack([torch.randperm(N, generator=g, device=dev)
                            for _ in range(epochs)])
    perm = torch.as_tensor(perm, device=dev).to(torch.int64)

    mesh = getattr(algo, "mesh", None)
    algo.policy.train()
    for e in range(epochs):
        auxs = []
        for ib in perm[e, : mb * nmb].reshape(nmb, mb):
            if mesh is not None:  # each process fits its share of the rows
                rank, size = dp_coords(mesh)
                ib = ib.tensor_split(size)[rank]
            n = ib.shape[0]
            batch = {
                "obs": unpack_rows(demos["obs_packed"][ib], bits).reshape(
                    (n,) + obs_shape),
                "visit_probs": torch.nn.functional.one_hot(
                    demos["action"][ib], A).to(torch.float32),
                "valid": torch.ones(n, dtype=torch.bool, device=dev),
                "ret": demos["ret"][ib],
            }
            auxs.append(algo._update(algo._loss_flat, batch))
    algo.policy.eval()
    out = {k: float(psum(mesh, torch.stack([a[k] for a in auxs]).mean()))
           for k in auxs[0]}
    out["demo_steps"] = N
    return out
