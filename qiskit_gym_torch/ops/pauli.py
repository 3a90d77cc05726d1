"""Batched Pauli-network env (Clifford + Pauli rotations) in PyTorch.

Port of the JAX package's `ops/pauli.py`; the numpy twin is
`spec/pauli_env.py`. Fixed-shape design:

- Tableau block: BITPACKED int32 [B, W2 * D2] (rows packed 32 to a word, the
  words hold the uint32 bit pattern), updated per step with the action's NET
  gate matrix (the product of its primitive row-ops, in the Pauli network's
  transposed-index cnot convention) in factorized I ^ U S form by
  `packed_apply_left`; the 70/15/15 reset scramble uses the same function
  with per-primitive term tables.
- Rotations: BITPACKED (x, z) bits int32 [B, RT, Wn] (qubits packed 32 to a
  word along the last axis) + phase mod 4 [B, RT], evolved through the
  action's primitive sequence (<= 3 H/S/Sdg/CNOT slots; Sdg = S^3 is one
  primitive, which is exact), because phase updates read intermediate bit
  values. Each primitive touches one or two qubit BITS, so the whole update
  is single-bit mask XORs on packed words. Tensors stay B-major (the batch
  first): the card's threads run along the batch either way, and the JAX
  package's B-minor relayout exists for the TPU's lane registers only.
- The anti-commutation DAG is a bool matrix [B, RT, RT] (edges later ->
  earlier), static per episode; the front layer and the trivial-rotation
  sweep are masked reductions. A sweep runs after every primitive CNOT.
- The observe-time random coupling-map automorphism is explicit env state
  (`perm_idx`, resampled each step/reset); it is applied to the observation
  through the core's `perm_rows` and un-applied to incoming actions via
  `act_perms`.
- Per-action operands come from ONE int32 table row (`op_tab`): the
  metrics descriptor, the primitive sequence and the packed U/S word masks.
- On CUDA tensors the step runs two kernels, each with its plain version
  for CPU tensors: the per-step circuit metrics through `metrics_update`
  (ops/metrics_kernel.py, kernel B2), then the rest of the transition
  through `pauli_step` (ops/pauli_step.py: tableau, rotations, sweeps,
  solved flag, reward, depth), which the JAX package leaves to XLA. The
  observation (`dense`) is one more kernel, `pauli_observe`
  (ops/pauli_observe.py), with its plain version for CPU tensors.
- Reset generation (distance-budgeted random Pauli strings + the 70/15/15
  H/S/CX tableau scramble) runs on the core's device with masked loops of
  fixed bounds, drawing from a `torch.Generator`.

Solution reconstruction (packed rotation events with phases) is a host-side
replay of the chosen action sequence through the spec env.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qiskit_gym_torch.quantum.pauli import Pauli
from qiskit_gym_torch.spec.gates import parse_gateset
from qiskit_gym_torch.spec.metrics import MetricsWeights
from qiskit_gym_torch.spec.pauli_env import graph_distances
from qiskit_gym_torch.spec.symmetry import compute_qubit_perms
from qiskit_gym_torch.utils.device import DeviceLike, resolve_device

from .bitops import popcount, to_i32
from .fused_step import _parity, packed_apply_left
from .matrix_env import _pad_dim, gf2_factor, pack_rows, pack_term_tables
from .metrics_kernel import (SCAL_MAX_C, SCAL_MAX_G, SCAL_N_CNOTS,
                             SCAL_N_GATES, metrics_update)
from .pauli_observe import pauli_observe, unpack_bits_lastdim  # noqa: F401
from .pauli_step import (MAX_PRIMS, P_CNOT, P_H, P_S, P_SDG, cleanup,
                         pauli_step)
from .tables import MT_1Q, MetricsTables

Tensor = torch.Tensor

EXT_CAP = 16   # bound of the rotation generator's extension loop


def pack_bits_lastdim(bits: Tensor, W: int) -> Tensor:
    """0/1 [..., n] -> int32 words [..., W] (bit q of word q//32 = bit q%32)."""
    n = bits.shape[-1]
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, W * 32 - n))
    b = b.reshape(bits.shape[:-1] + (W, 32))
    shifts = torch.arange(32, device=bits.device)
    return to_i32((b << shifts).sum(dim=-1))


def pack_bits_np(bits: np.ndarray, W: int) -> np.ndarray:
    """numpy twin of pack_bits_lastdim (host-side set_state), uint32."""
    bits = np.asarray(bits)
    out = np.zeros(bits.shape[:-1] + (W,), np.uint32)
    for q in range(bits.shape[-1]):
        out[..., q // 32] |= (bits[..., q].astype(np.uint32) & 1) << (q % 32)
    return out


def _primitive_sequence(gate) -> list:
    name, qs = gate
    if name == "H":
        return [(P_H, qs[0], 0)]
    if name == "S":
        return [(P_S, qs[0], 0)]
    if name == "Sdg":
        return [(P_SDG, qs[0], 0)]
    if name == "SX":
        return [(P_H, qs[0], 0), (P_S, qs[0], 0), (P_H, qs[0], 0)]
    if name == "SXdg":
        return [(P_H, qs[0], 0), (P_SDG, qs[0], 0), (P_H, qs[0], 0)]
    if name == "CX":
        return [(P_CNOT, qs[0], qs[1])]
    if name == "CZ":
        return [(P_H, qs[1], 0), (P_CNOT, qs[0], qs[1]), (P_H, qs[1], 0)]
    if name == "SWAP":
        return [(P_CNOT, qs[0], qs[1]), (P_CNOT, qs[1], qs[0]),
                (P_CNOT, qs[0], qs[1])]
    raise ValueError(name)


def _network_gate_matrix(gate, n: int, D2: int) -> np.ndarray:
    """Net tableau left-multiplication matrix (network cnot convention:
    CNOT(i,j): row i ^= row j ; row n+j ^= row n+i)."""
    G = np.eye(D2, dtype=np.uint8)
    for ptype, a, b in _primitive_sequence(gate):
        if ptype == P_H:
            G[[a, n + a]] = G[[n + a, a]]
        elif ptype in (P_S, P_SDG):   # same GF(2) linear part: z ^= x
            G[n + a] ^= G[a]
        elif ptype == P_CNOT:
            G[a] ^= G[b]
            G[n + b] ^= G[n + a]
    return G


def _term_table(mats: Sequence[np.ndarray], D2: int) -> Tuple[np.ndarray, int]:
    """Packed I ^ U S terms of each matrix as rows [len, 2*K*W2] int32 (the
    U words of every term, then the S words), and K."""
    eye = np.eye(D2, dtype=np.uint8)
    facs = [gf2_factor(G ^ eye) for G in mats]
    U32, S32, _, _ = pack_term_tables([U for U, _ in facs],
                                      [S for _, S in facs], D2)
    K = U32.shape[1]
    rows = np.concatenate([U32.reshape(len(mats), -1),
                           S32.reshape(len(mats), -1)], axis=1)
    return rows.view(np.int32), K


class PauliEnvState(NamedTuple):
    tab: Tensor        # int32 [B, W2 * D2] bitpacked (rows 32 to a word)
    rx: Tensor         # int32 [B, RT, Wn] bitpacked qubit bits
    rz: Tensor         # int32 [B, RT, Wn]
    rphase: Tensor     # int8  [B, RT]  (mod 4)
    active: Tensor     # bool  [B, RT]
    anti: Tensor       # bool  [B, RT, RT]  anti-commutation, j < i
    perm_idx: Tensor   # int32 [B] automorphism in effect for observe/step
    depth: Tensor      # int32 [B]
    success: Tensor    # bool  [B]
    reward: Tensor     # f32   [B]
    inverted: Tensor   # bool  [B] (always False; kept for API uniformity)
    last_g: Tensor     # int32 [B, n]
    last_c: Tensor     # int32 [B, n]
    max_g: Tensor
    max_c: Tensor
    n_cnots: Tensor
    n_gates: Tensor

    @property
    def batch(self) -> int:
        return self.tab.shape[0]


class PauliEnvCore:
    def __init__(
        self,
        num_qubits: int,
        gateset: Sequence,
        depth_slope: int = 2,
        max_depth: int = 128,
        max_rotations: int = 5,
        pauli_diff_scale: int = 8,
        num_qubits_decay: float = 0.5,
        final_pauli_layers: Optional[int] = None,
        metrics_weights: Optional[dict] = None,
        add_perms: bool = True,
        pauli_layer_reward: float = 0.01,
        scramble_cap: int = 256,
        device: DeviceLike = None,
    ):
        self.device = dev = resolve_device(device)
        self.num_qubits = n = int(num_qubits)
        self.gateset = parse_gateset(gateset)
        self.R = max(int(max_rotations), 1)   # obs width cap (max_rotations)
        self.dim = 2 * n
        self.Wn = (n + 31) // 32   # packed qubit words per rotation
        self.D2 = _pad_dim(self.dim)
        self.depth_slope = int(depth_slope)
        self.max_depth = int(max_depth)
        self.pauli_diff_scale = max(int(pauli_diff_scale), 1)
        self.num_qubits_decay = float(num_qubits_decay)
        self.final_pauli_layers = (
            int(final_pauli_layers) if final_pauli_layers is not None
            else self.R + 2
        )
        # rotation storage capacity: reset can generate up to
        # final_pauli_layers rotations (> max_rotations); the obs compaction
        # shows at most R of the active ones
        self.RT = max(self.final_pauli_layers, self.R)
        self.pauli_layer_reward = float(pauli_layer_reward)
        self.add_inverts = False
        self.scramble_cap = int(scramble_cap)
        _w = MetricsWeights.from_dict(metrics_weights).as_array()
        self.weights_static = tuple(float(x) for x in _w)
        # see MatrixEnvCore: layer tracking only when a layer weight is set
        self.track_layers = (self.weights_static[1] != 0.0
                             or self.weights_static[2] != 0.0)

        def on_dev(x, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.to(device=dev, dtype=dtype)

        A = len(self.gateset)
        self.noop_action = A
        self.W2 = (self.D2 + 31) // 32
        self.L2 = self.W2 * self.D2
        eye = np.eye(self.D2, dtype=np.uint8)
        self.ident_pk = on_dev(
            pack_rows(eye, self.W2).reshape(self.L2).view(np.int32))

        # net tableau matrices as G = I ^ U S (+ the all-zero no-op at A)
        mats = [_network_gate_matrix(g, n, self.D2) for g in self.gateset]
        mats.append(eye.copy())
        terms, self.K2 = _term_table(mats, self.D2)

        # primitive tables [A+1, MAX_PRIMS]
        pt = np.zeros((A + 1, MAX_PRIMS), np.int32)
        p1 = np.zeros((A + 1, MAX_PRIMS), np.int32)
        p2 = np.zeros((A + 1, MAX_PRIMS), np.int32)
        for a, g in enumerate(self.gateset):
            for k, (c, q1, q2) in enumerate(_primitive_sequence(g)):
                pt[a, k], p1[a, k], p2[a, k] = c, q1, q2
        self.ptype, self.pq1, self.pq2 = pt, p1, p2
        # static loop bounds: actual primitive depth of this gateset, and the
        # slot indices where any action has a CNOT (only those need a sweep)
        self.max_prims = max(
            (len(_primitive_sequence(g)) for g in self.gateset), default=1
        )
        self.cleanup_slots = sorted({
            k for g in self.gateset
            for k, (c, _, _) in enumerate(_primitive_sequence(g))
            if c == P_CNOT
        })

        mt = MetricsTables.build(self.gateset)
        self.mtype = np.concatenate([mt.mtype, [MT_1Q]]).astype(np.int32)
        self.mq1 = np.concatenate([mt.q1, [0]]).astype(np.int32)
        self.mq2 = np.concatenate([mt.q2, [0]]).astype(np.int32)
        # one int32 row per action: mtype, q1, q2 | ptype[3] | pq1[3] |
        # pq2[3] | U words [K2*W2] | S words [K2*W2]
        self.op_tab = on_dev(np.concatenate(
            [np.stack([self.mtype, self.mq1, self.mq2], axis=1), pt, p1, p2,
             terms], axis=1))
        # single-bit word masks by qubit, int32 [n, Wn]
        self.bit_tab = on_dev(
            pack_bits_np(np.eye(n, dtype=np.uint8), self.Wn).view(np.int32))

        # symmetry: qubit automorphisms as row/column indices + action perms
        if add_perms:
            qubit_perms, act_perms = compute_qubit_perms(n, self.gateset)
        else:
            qubit_perms, act_perms = [list(range(n))], [list(range(A))]
        self.num_perms = len(qubit_perms)
        self.qubit_perms = [list(p) for p in qubit_perms]
        perms = np.asarray(self.qubit_perms, np.int64).reshape(
            self.num_perms, n)
        # dst row i <- src row perm[i], on both halves of the tableau
        self.perm_rows = on_dev(np.concatenate([perms, n + perms], axis=1))
        self.act_perms = on_dev(np.asarray(act_perms, np.int64).reshape(
            self.num_perms, A))

        # reset-generation tables
        self.valid_pairs = [qs for name, qs in self.gateset if name == "CX"]
        dist = graph_distances(n, self.valid_pairs)
        dist_pairs = {}
        for q1 in range(n):
            for q2 in range(q1 + 1, n):
                if (q1, q2) in dist:
                    dist_pairs.setdefault(dist[(q1, q2)], []).append((q1, q2))
        self.all_dists = sorted(dist_pairs)
        nd = max(len(self.all_dists), 1)
        mx = max((len(v) for v in dist_pairs.values()), default=1)
        pair_tab = np.zeros((nd, mx, 2), np.int64)
        pair_cnt = np.zeros((nd,), np.int64)
        dist_vals = np.zeros((nd,), np.int64)
        for k, d in enumerate(self.all_dists):
            ps = dist_pairs[d]
            pair_cnt[k] = len(ps)
            dist_vals[k] = d
            for j, p in enumerate(ps):
                pair_tab[k, j] = p
        self.pair_tab = on_dev(pair_tab)
        self.pair_cnt = on_dev(pair_cnt)
        self.dist_vals = on_dev(dist_vals)

        # scramble primitive stack: CX(valid_pairs) / H(q) / S(q) matrices
        prim = []
        for (q0, q1) in self.valid_pairs:
            # row q1 ^= row q0, row n+q0 ^= row n+q1 (Clifford-env convention)
            G = eye.copy()
            G[q1] ^= G[q0]
            G[n + q0] ^= G[n + q1]
            prim.append(G)
        self.n_scramble_cx = max(len(prim), 1)
        for q in range(n):
            G = eye.copy()
            G[[q, n + q]] = G[[n + q, q]]
            prim.append(G)
        for q in range(n):
            G = eye.copy()
            G[n + q] ^= G[q]
            prim.append(G)
        prim.append(eye.copy())  # no-op
        sc_terms, self.scK = _term_table(prim, self.D2)
        self.sc_tab = on_dev(sc_terms)
        self.n_scramble = len(prim)

    # ------------------------------------------------------------ properties
    @property
    def num_actions(self) -> int:
        return len(self.gateset)

    @property
    def obs_shape(self) -> Tuple[int, int]:
        return (self.dim, self.dim + self.R)

    def _terms(self, rows: Tensor, K: int) -> Tuple[Tensor, Tensor]:
        """The U and S word masks [B, K, W2] of gathered term-table rows."""
        B, kw = rows.shape[0], K * self.W2
        return (rows[:, :kw].reshape(B, K, self.W2),
                rows[:, kw:2 * kw].reshape(B, K, self.W2))

    # The JAX package's flag for its Pallas metrics kernel is matrix-env
    # only there; this class keeps the property so that enabling it is
    # rejected instead of silently ignored. The port's Pauli step always
    # goes through `metrics_update` (kernel B2 on CUDA tensors).
    @property
    def use_pallas_metrics(self) -> bool:
        return False

    @use_pallas_metrics.setter
    def use_pallas_metrics(self, value: bool) -> None:
        if value:
            raise ValueError(
                "use_pallas_metrics is matrix-env only; PauliEnvCore's step "
                "uses its own table decode")

    def translate_action(self, state: PauliEnvState, action: Tensor) -> Tensor:
        """Policy-frame -> env-frame action through the active automorphism.
        The noop action (== num_actions) passes through untouched: the
        act_perms table is [P, A] and has no row entry for it."""
        if self.num_perms == 1:
            # trivial automorphism group (such as the 27q heavy-hex): identity
            return action
        a = torch.clamp(action, max=self.num_actions - 1)
        return torch.where(action >= self.num_actions, action,
                           self.act_perms[state.perm_idx.long(), a])

    # ----------------------------------------------------------------- step
    def _draw_perm(self, B: int, generator, perm_idx) -> Tensor:
        if perm_idx is not None:
            return perm_idx.to(device=self.device, dtype=torch.int32)
        return torch.randint(0, self.num_perms, (B,), generator=generator,
                             device=self.device).to(torch.int32)

    def step(
        self,
        state: PauliEnvState,
        action: Tensor,
        generator: Optional[torch.Generator] = None,
        invert_override=None,  # unused; API uniformity
        actual_override: Optional[Tensor] = None,
        perm_idx: Optional[Tensor] = None,
        metrics=metrics_update,
        transition=pauli_step,
    ) -> PauliEnvState:
        """One batched env step. `action` is in the policy frame unless
        `actual_override` carries the already translated env-frame action.
        The automorphism for the next observation is drawn from `generator`
        unless `perm_idx` (int [B]) injects it. `metrics` is the metrics
        update to call and `transition` the rest of the step
        (`metrics_update_plain` and `pauli_step_plain` hold the kernels'
        step against the plain one)."""
        actual = (actual_override if actual_override is not None
                  else self.translate_action(state, action.to(torch.int64)))
        actual = actual.to(torch.int64).contiguous()
        rows = self.op_tab[actual, :3]      # the metrics descriptor
        noop = (actual == self.noop_action).to(torch.int32)
        scal = torch.stack([state.max_g, state.max_c, state.n_cnots,
                            state.n_gates, rows[:, 0], rows[:, 1], rows[:, 2],
                            noop], dim=1)
        last_g, last_c, scal, penalty = metrics(
            state.last_g, state.last_c, scal, self.weights_static,
            self.track_layers)
        t = transition(self, state, actual, penalty)
        return state._replace(
            **t._asdict(),
            perm_idx=self._draw_perm(state.batch, generator, perm_idx),
            last_g=last_g, last_c=last_c,
            max_g=scal[:, SCAL_MAX_G].contiguous(),
            max_c=scal[:, SCAL_MAX_C].contiguous(),
            n_cnots=scal[:, SCAL_N_CNOTS].contiguous(),
            n_gates=scal[:, SCAL_N_GATES].contiguous(),
        )

    def _solved(self, tab: Tensor, active: Tensor) -> Tensor:
        return (~active.any(dim=-1)) & (tab == self.ident_pk[None]).all(dim=1)

    # ---------------------------------------------------------------- reset
    def _fresh(self, B: int) -> PauliEnvState:
        n, RT, dev = self.num_qubits, self.RT, self.device

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return PauliEnvState(
            tab=self.ident_pk[None].repeat(B, 1),
            rx=full((B, RT, self.Wn), 0, torch.int32),
            rz=full((B, RT, self.Wn), 0, torch.int32),
            rphase=full((B, RT), 0, torch.int8),
            active=full((B, RT), False, torch.bool),
            anti=full((B, RT, RT), False, torch.bool),
            perm_idx=full((B,), 0, torch.int32),
            depth=full((B,), 1, torch.int32),
            success=full((B,), True, torch.bool),
            reward=full((B,), 1.0, torch.float32),
            inverted=full((B,), False, torch.bool),
            last_g=full((B, n), -1, torch.int32),
            last_c=full((B, n), -1, torch.int32),
            max_g=full((B,), -1, torch.int32),
            max_c=full((B,), -1, torch.int32),
            n_cnots=full((B,), 0, torch.int32),
            n_gates=full((B,), 0, torch.int32),
        )

    def _build_anti(self, rx: Tensor, rz: Tensor, valid: Tensor) -> Tensor:
        """anti[i, j] (j < i): rotations i, j anticommute; only valid rows.
        The parity of the symplectic product is the parity of the XOR over
        words of (x_i & z_j) ^ (z_i & x_j)."""
        words = ((rx[:, :, None, :] & rz[:, None, :, :])
                 ^ (rz[:, :, None, :] & rx[:, None, :, :]))
        acc = words[..., 0]
        for w in range(1, self.Wn):
            acc = acc ^ words[..., w]
        anti = _parity(acc) != 0
        lower = torch.tril(torch.ones((self.RT, self.RT), dtype=torch.bool,
                                      device=rx.device), diagonal=-1)
        return anti & lower[None] & valid[:, :, None] & valid[:, None, :]

    def _generate_rotations(self, generator, B: int, pauli_difficulty: Tensor):
        """Distance-budgeted random Pauli strings, vectorized with masked
        loops of fixed bounds. The extension loop of the native env is
        unbounded (extend while rng > num_qubits_decay); here it is capped at
        EXT_CAP passes like the JAX package's, which the port is held
        against: each pass first breaks with probability `num_qubits_decay`,
        so the cap bites with probability (1 - decay)^16."""
        n, dev = self.num_qubits, self.device
        qid = torch.arange(n, device=dev)[None, :]

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        def randint(high, *shape):
            return torch.randint(0, high, shape, generator=generator,
                                 device=dev)

        def sample_masked(mask):
            # uniform index among the True entries of mask [B, m]; rows with
            # none draw from all entries (the callers mask the result)
            safe = mask | ~mask.any(dim=-1, keepdim=True)
            return torch.multinomial(safe.to(torch.float32), 1,
                                     generator=generator)[:, 0]

        def members(pair):
            return (qid == pair[:, 0:1]) | (qid == pair[:, 1:2])

        budget = pauli_difficulty.to(torch.int64)
        count = torch.zeros(B, dtype=torch.int64, device=dev)
        xs, zs, made = [], [], []
        for _ in range(self.RT):
            can = (self.dist_vals[None, :] <= budget[:, None]) & (
                self.pair_cnt[None, :] > 0)
            any_valid = (can.any(dim=-1) & (budget > 0)
                         & (count < self.final_pauli_layers))
            d_idx = sample_masked(can)
            pair_i = randint(1 << 30, B) % torch.clamp(self.pair_cnt[d_idx],
                                                       min=1)
            member = members(self.pair_tab[d_idx, pair_i])
            budget_new = torch.clamp(budget - self.dist_vals[d_idx], min=0)
            stopped = torch.zeros(B, dtype=torch.bool, device=dev)
            for _ in range(EXT_CAP):
                can_e = (self.dist_vals[None, :] <= budget_new[:, None]) & (
                    self.pair_cnt[None, :] > 0)
                go = (~stopped & (budget_new > 0) & can_e.any(dim=-1)
                      & (~member).any(dim=-1))
                go = go & (rand(B) > self.num_qubits_decay)   # decay break
                d2 = sample_masked(can_e)
                # pairs at d2 that connect to the member set
                ptab = self.pair_tab[d2]                      # [B, mx, 2]
                conn = (member.gather(1, ptab[:, :, 0])
                        | member.gather(1, ptab[:, :, 1])) & (
                    torch.arange(ptab.shape[1], device=dev)[None, :]
                    < self.pair_cnt[d2][:, None])
                sel = sample_masked(conn)
                chosen = ptab[torch.arange(B, device=dev), sel]   # [B, 2]
                add = go & conn.any(dim=-1)
                member = member | (add[:, None] & members(chosen))
                budget_new = torch.where(
                    add, torch.clamp(budget_new - self.dist_vals[d2], min=0),
                    budget_new)
                stopped = stopped | ~go
            ax = randint(3, B, n)       # random axis for every member
            x = member & ((ax == 0) | (ax == 1))
            z = member & ((ax == 2) | (ax == 1))
            cost = budget - budget_new
            # remaining difficulty -= max(cost, 1), saturating
            budget = torch.clamp(torch.where(
                any_valid, budget - torch.clamp(cost, min=1), budget), min=0)
            count = count + any_valid.to(torch.int64)
            xs.append(pack_bits_lastdim(x & any_valid[:, None], self.Wn))
            zs.append(pack_bits_lastdim(z & any_valid[:, None], self.Wn))
            made.append(any_valid)
        rx = torch.stack(xs, dim=1)                    # int32 [B, RT, Wn]
        rz = torch.stack(zs, dim=1)
        valid = torch.stack(made, dim=1)               # [B, RT]
        num_y = popcount(rx & rz).sum(dim=-1)
        return rx, rz, (num_y % 4).to(torch.int8), valid

    def _scramble_tableau(self, generator, B: int, difficulty,
                          idx_override=None) -> Tensor:
        """70% CX / 15% H / 15% S row-op scramble of the identity.

        `idx_override` (int [B, K], test hook): scramble-op indices into the
        op table: [0, n_scramble_cx) = CX(valid_pairs[i]), then n H ops, then
        n S ops; the last index is a no-op."""
        n, dev = self.num_qubits, self.device
        ncx = self.n_scramble_cx
        noop = self.n_scramble - 1
        if idx_override is not None:
            idx = torch.as_tensor(idx_override).to(device=dev,
                                                   dtype=torch.int64)
        else:
            static_diff = isinstance(difficulty, (int, np.integer))
            K = int(difficulty) if static_diff else self.scramble_cap
            K = max(K, 1)   # difficulty 0 is masked to no-ops below
            r = torch.rand((B, K), generator=generator, device=dev)
            rq = torch.randint(0, 1 << 30, (B, K, 3), generator=generator,
                               device=dev)
            cx_idx = rq[:, :, 0] % max(len(self.valid_pairs), 1)
            h_idx = ncx + rq[:, :, 1] % n
            s_idx = ncx + n + rq[:, :, 2] % n
            idx = torch.where(r > 0.3, cx_idx,
                              torch.where(r > 0.15, h_idx, s_idx))
            if len(self.valid_pairs) == 0:
                idx = torch.full_like(idx, noop)
            if not static_diff:
                # a scalar tensor or a per-lane [B] vector (curriculum replay)
                d = torch.as_tensor(difficulty, device=dev)
                d = d[:, None] if d.ndim else d
                mask = torch.arange(K, device=dev)[None, :] < d
                idx = torch.where(mask, idx, noop)
            elif int(difficulty) == 0:
                # difficulty 0 resets to the identity tableau
                idx = torch.full_like(idx, noop)
        tab = self.ident_pk[None].repeat(B, 1)
        for i in range(idx.shape[1]):
            U32, S32 = self._terms(self.sc_tab[idx[:, i]], self.scK)
            tab = packed_apply_left(U32, S32, tab, self.W2, self.D2)
        return tab

    def reset(
        self,
        B: int,
        difficulty: Union[int, Tensor],
        generator: Optional[torch.Generator] = None,
        scramble_override=None,
        rotations_override=None,
        perm_idx: Optional[Tensor] = None,
    ) -> PauliEnvState:
        """Fresh episodes at `difficulty` (an int, or a per-lane [B] tensor).
        `scramble_override` (int [B, K]) injects the scramble-op indices,
        `rotations_override` = (x bits, z bits [B, RT, n], phase [B, RT],
        valid [B, RT]) the rotations, `perm_idx` the automorphism draw."""
        dev = self.device
        state = self._fresh(B)
        diff_t = torch.as_tensor(difficulty, dtype=torch.int32, device=dev)
        diff_arr = torch.broadcast_to(diff_t, (B,))
        if rotations_override is not None:
            rx, rz, rphase, valid = (torch.as_tensor(np.asarray(x)).to(dev)
                                     for x in rotations_override)
            rx = pack_bits_lastdim(rx, self.Wn)
            rz = pack_bits_lastdim(rz, self.Wn)
            rphase, valid = rphase.to(torch.int8), valid.to(torch.bool)
        else:
            rx, rz, rphase, valid = self._generate_rotations(
                generator, B, diff_arr // self.pauli_diff_scale)
        anti = self._build_anti(rx, rz, valid)
        tab = self._scramble_tableau(generator, B, difficulty,
                                     idx_override=scramble_override)
        # initial trivial sweep
        active, _ = cleanup(rx, rz, valid, anti)
        success = self._solved(tab, active)
        depth = torch.clamp(self.depth_slope * diff_arr, max=self.max_depth)
        return state._replace(
            tab=tab, rx=rx, rz=rz, rphase=rphase, active=active, anti=anti,
            perm_idx=self._draw_perm(B, generator, perm_idx),
            depth=depth.to(torch.int32).contiguous(),
            success=success,
            reward=success.to(torch.float32),
        )

    # ------------------------------------------------------------- state io
    def set_state(self, tableaus: np.ndarray, rotation_labels
                  ) -> PauliEnvState:
        """Host-side: dense tableau(s) [B, 2n, 2n] + per-env rotation label
        lists -> device state. No initial sweep, depth = max_depth; only the
        first R labels of an env are kept."""
        tableaus = np.asarray(tableaus)
        if tableaus.ndim == 2:
            tableaus = tableaus[None]
        B = tableaus.shape[0]
        n, dev = self.num_qubits, self.device
        state = self._fresh(B)
        tab = np.tile(np.eye(self.D2, dtype=np.uint8), (B, 1, 1))
        tab[:, : self.dim, : self.dim] = (tableaus != 0).astype(np.uint8)
        tab = pack_rows(tab, self.W2).reshape(B, self.L2)

        rx = np.zeros((B, self.RT, n), np.int8)
        rz = np.zeros((B, self.RT, n), np.int8)
        ph = np.zeros((B, self.RT), np.int8)
        valid = np.zeros((B, self.RT), bool)
        for b, labels in enumerate(rotation_labels):
            for i, lab in enumerate(labels[: self.R]):
                p = Pauli.from_label(lab)
                rx[b, i] = p.x
                rz[b, i] = p.z
                ph[b, i] = p.phase
                valid[b, i] = True

        def words(x):
            return torch.from_numpy(x.view(np.int32)).to(dev)

        rx_t = words(pack_bits_np(rx, self.Wn))
        rz_t = words(pack_bits_np(rz, self.Wn))
        valid_t = torch.from_numpy(valid).to(dev)
        tab_t = words(tab)
        success = self._solved(tab_t, valid_t)
        return state._replace(
            tab=tab_t, rx=rx_t, rz=rz_t,
            rphase=torch.from_numpy(ph).to(dev),
            active=valid_t, anti=self._build_anti(rx_t, rz_t, valid_t),
            depth=torch.full((B,), self.max_depth, dtype=torch.int32,
                             device=dev),
            success=success,
            reward=success.to(torch.float32),
        )

    # -------------------------------------------------------------- observe
    def dense(self, state: PauliEnvState) -> Tensor:
        """uint8 [B, 2n, 2n + R]: the tableau block and the active rotation
        columns compacted to the left, under the active automorphism (rows of
        everything, columns of the tableau only). One kernel launch on CUDA
        tensors (`pauli_observe`), its plain version on CPU tensors."""
        return pauli_observe(self, state)

    def observe(self, state: PauliEnvState,
                dtype=torch.float32) -> Tensor:
        return self.dense(state).to(dtype)

    def masks(self, state: PauliEnvState) -> Tensor:
        return (~state.success)[:, None].expand(state.batch, self.num_actions)

    def is_final(self, state: PauliEnvState) -> Tensor:
        return (state.depth == 0) | state.success
