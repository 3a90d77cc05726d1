"""Batched GF(2) matrix envs (Permutation, LinearFunction, Clifford) in PyTorch.

Port of the JAX package's `ops/matrix_env.py`. One core implements all three
families; they differ only in matrix dimension and gate matrices
(permutation: n x n one-hot rows, SWAP = row swap; linear: n x n, CX = row
XOR; clifford: 2n x 2n phase-less symplectic).

- Two state representations. The default is BITPACKED: flat [B, W*dim]
  words, rows packed 32 to a word, columns as lanes (word w of column d at
  index w*dim + d); words are int32 tensors holding the uint32 bit pattern.
  `bitpack=False` keeps the DENSE int8 state [B, D, D] (D = dim padded to a
  multiple of 8, identity in the padding block), the spec-shaped fallback.
- Every gate is an involution on the phase-less state and has the rank-2
  form G = I ^ U S, so the tracked inverse updates by right-multiplying the
  same terms, and the random state inversion is a buffer swap.
- On a bitpacked CUDA state, `step` is one launch of the fused env-step
  kernel (ops/fused_step.py, csrc/fused_step.cu) and the reset scramble runs
  its apply-only kernel; on a CPU state both run their plain PyTorch
  versions, which the tests hold bit for bit against the JAX XLA step.
- The dense step applies the rank-2 terms with elementwise ops and
  reductions in plain torch on the core's device (the JAX package has no
  kernel inside its dense step either) and takes its metrics from
  `metrics_update` (ops/metrics_kernel.py). The dense row-op kernel
  (ops/rowop_step.py) stands beside the core as a function of its own.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from qiskit_gym_torch.quantum.linear import gf2_inverse
from qiskit_gym_torch.spec.gates import Gate, parse_gateset
from qiskit_gym_torch.spec.metrics import MetricsWeights
from qiskit_gym_torch.utils.device import DeviceLike, resolve_device

from .bitops import pack_lanes
from .fused_step import (apply_gates, build_op_table, fused_step, solved,
                         step_unfused)
from .metrics_kernel import metrics_update
from .tables import MT_1Q, MetricsTables


def _pad_dim(dim: int, multiple: int = 8) -> int:
    return max(((dim + multiple - 1) // multiple) * multiple, multiple)


def _gate_terms(gate: Gate, num_qubits: int, kind: str):
    """The gate's GF(2) action as <= 2 elementary terms:
    ("x", d, s) = row d ^= row s; ("s", r1, r2) = swap rows r1, r2.

    Row-op semantics per family (phase-less):
      permutation: SWAP(a,b) swaps rows a,b; 1q gates identity.
      linear:      CX(c,t): row t ^= row c; SWAP swaps rows.
      clifford:    H swap(q, n+q); S: n+q ^= q; SX: q ^= n+q;
                   CX(c,t): t ^= c, n+c ^= n+t; CZ(a,b): n+a ^= b, n+b ^= a;
                   SWAP: both row pairs.
    """
    n = num_qubits
    terms = []
    name, qs = gate

    def xor(d, s):
        terms.append(("x", d, s))

    def swap(r1, r2):
        terms.append(("s", r1, r2))

    if kind == "permutation":
        if name == "SWAP":
            swap(qs[0], qs[1])
    elif kind == "linear":
        if name == "CX":
            xor(qs[1], qs[0])
        elif name == "SWAP":
            swap(qs[0], qs[1])
    elif kind == "clifford":
        if name == "H":
            swap(qs[0], n + qs[0])
        elif name in ("S", "Sdg"):
            xor(n + qs[0], qs[0])
        elif name in ("SX", "SXdg"):
            xor(qs[0], n + qs[0])
        elif name == "CX":
            c, t = qs
            xor(t, c)
            xor(n + c, n + t)
        elif name == "CZ":
            a, b = qs
            xor(n + a, b)
            xor(n + b, a)
        elif name == "SWAP":
            a, b = qs
            swap(a, b)
            swap(n + a, n + b)
    else:
        raise ValueError(f"Unknown env kind {kind!r}")
    return terms


def gate_matrix(gate: Gate, num_qubits: int, kind: str, D: int,
                rows: Optional[Sequence[int]] = None) -> np.ndarray:
    """The gate's left-multiplication matrix over GF(2), padded to D x D, or
    only its rows `rows` ([len(rows), D]), which must hold every row that
    the gate's row-ops touch (every other row is the identity's)."""
    rows = np.arange(D) if rows is None else np.asarray(rows)
    at = {int(r): k for k, r in enumerate(rows)}
    G = np.zeros((len(rows), D), np.uint8)
    G[np.arange(len(rows)), rows] = 1
    for tt, i, j in _gate_terms(gate, num_qubits, kind):
        if tt == "x":
            G[at[i], j] ^= 1
        else:
            G[[at[i], at[j]]] = G[[at[j], at[i]]]
    return G


def gf2_factor(M: np.ndarray):
    """GF(2) rank factorization M = U @ S (mod 2), numpy, construction-time.

    S is a subset of M's rows (a row basis); U holds each row's coefficients
    in that basis (rank = rank of G xor I, <= 2 for every gate family here)."""
    M = (np.asarray(M) % 2).astype(np.uint8)
    D = M.shape[0]
    ech, coeffs, chosen = [], [], []
    U = np.zeros((D, D), np.uint8)
    for i in range(D):
        v = M[i].copy()
        c = np.zeros(D, np.uint8)
        c[i] = 1
        # reduce until stable (rows are kept in insertion order, not pivot
        # order; each XOR clears v's bit at that row's first set bit and only
        # touches later bits, so v strictly decreases and this terminates)
        changed = True
        while changed:
            changed = False
            for e, ce in zip(ech, coeffs):
                p = int(np.argmax(e))
                if v[p]:
                    v ^= e
                    c ^= ce
                    changed = True
        if v.any():
            ech.append(v)
            coeffs.append(c)
            chosen.append(i)
            U[i, i] = 1
        else:
            # M[i] = sum of chosen rows j with c[j] = 1 (j != i)
            c[i] = 0
            U[i] = c
    r = len(chosen)
    S = M[chosen] if r else np.zeros((0, D), np.uint8)
    Uc = U[:, chosen] if r else np.zeros((D, 0), np.uint8)
    assert np.array_equal((Uc.astype(np.int64) @ S) % 2, M)
    return Uc, S


def gate_rank2_terms(gate: Gate, num_qubits: int, kind: str, D: int):
    """Decompose the gate's GF(2) matrix as G = I xor U S (U: [D, 2] dest
    one-hot combos, S: [2, D] source selectors).

    A row-XOR `d ^= s` is (e_d, e_s); a row swap (r1, r2) is
    (e_r1+e_r2, e_r1+e_r2).
    """
    U = np.zeros((D, 2), np.int8)
    S = np.zeros((2, D), np.int8)
    for k, (tt, i, j) in enumerate(_gate_terms(gate, num_qubits, kind)):
        if tt == "x":
            U[i, k] = 1
            S[k, j] = 1
        else:
            U[i, k] = U[j, k] = 1
            S[k, i] = S[k, j] = 1
    return U, S


def check_rank2_terms(gate: Gate, num_qubits: int, kind: str, D: int,
                      U: np.ndarray, S: np.ndarray) -> None:
    """Raise unless I ^ U S equals the gate's sequential row-ops. Only the
    rows that either side changes are compared: the rest are the
    identity's on both."""
    touched = {r for _, i, j in _gate_terms(gate, num_qubits, kind)
               for r in (i, j)}
    rows = sorted(touched | set(np.flatnonzero(U.any(axis=1)).tolist()))
    G = gate_matrix(gate, num_qubits, kind, D, rows)
    G2 = U[rows].astype(np.int64) @ S
    G2[np.arange(len(rows)), rows] += 1
    G2 %= 2
    if not np.array_equal(G, G2):
        raise AssertionError(
            f"rank-2 terms disagree with sequential row-ops for {gate}")


_FULL32 = np.uint32(0xFFFFFFFF)


def pack_rows(M: np.ndarray, W: int) -> np.ndarray:
    """[*, D, D] 0/1 -> [*, W, D] uint32; bit i of word g = row 32g + i."""
    M = np.asarray(M)
    out = np.zeros(M.shape[:-2] + (W, M.shape[-1]), np.uint32)
    for d in range(M.shape[-2]):
        out[..., d // 32, :] |= (M[..., d, :].astype(np.uint32) & 1) << (d % 32)
    return out


def pack_term_tables(Us, Ss, D: int):
    """Stacked rank-term tables (lists of U [D, K], S [K, D] 0/1 per action)
    -> packed forms for the bitpacked kernels: U32/S32 [A, K, W] uint32 word
    masks over rows, Ulm/Slm [A, K, D] uint32 full-lane masks."""
    A = len(Us)
    K = max(u.shape[1] for u in Us)
    W = (D + 31) // 32
    Ub = np.zeros((A, K, D), bool)    # term k's destination rows
    Sb = np.zeros((A, K, D), bool)    # term k's source rows
    for ai, (U, S) in enumerate(zip(Us, Ss)):
        Ub[ai, :U.shape[1]] = U.T != 0
        Sb[ai, :S.shape[0]] = S != 0
    U32, S32 = pack_lanes(Ub, W), pack_lanes(Sb, W)
    Ulm = np.where(Ub, _FULL32, np.uint32(0))
    Slm = np.where(Sb, _FULL32, np.uint32(0))
    return U32, S32, Ulm, Slm


def rank_terms_apply_left(U: torch.Tensor, S: torch.Tensor,
                          a: torch.Tensor) -> torch.Tensor:
    """a' = (I ^ U S) a over GF(2) on the dense state.

    U [B, D, K] int8 destination combos, S [B, K, D] int8 source selectors,
    a [B, D, D] int8. Both source-row combinations are read from the
    original matrix. Sums widen (torch sums int8 in int64) before `& 1`."""
    acc = torch.zeros_like(a)
    for k in range(U.shape[-1]):
        r = ((S[:, k, :, None] * a).sum(dim=1) & 1).to(torch.int8)
        acc = acc ^ (U[:, :, k, None] & r[:, None, :])
    return a ^ acc


def rank_terms_apply_right(U: torch.Tensor, S: torch.Tensor,
                           m: torch.Tensor) -> torch.Tensor:
    """m' = m (I ^ U S) over GF(2); mirrors rank_terms_apply_left along the
    column axis (column extraction, row-selector broadcast)."""
    acc = torch.zeros_like(m)
    for k in range(U.shape[-1]):
        c = ((m * U[:, None, :, k]).sum(dim=2) & 1).to(torch.int8)
        acc = acc ^ (c[:, :, None] & S[:, k, None, :])
    return m ^ acc


def unpack_rows(a: torch.Tensor, W: int, D: int, rows: int) -> torch.Tensor:
    """Bitpacked [B, W*D] int32 words -> dense uint8 [B, rows, D]."""
    B = a.shape[0]
    a3 = a.reshape(B, W, 1, D).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=a.device)[None, None, :, None]
    bits = (a3 >> shifts) & 1
    return bits.reshape(B, W * 32, D)[:, :rows, :].to(torch.uint8)


class MatrixEnvState(NamedTuple):
    a: torch.Tensor         # int32 [B, W*dim] packed current matrix, or
    #                         int8 [B, D, D] dense (bitpack=False)
    ainv: torch.Tensor      # its inverse, same layout
    depth: torch.Tensor     # int32  [B]
    success: torch.Tensor   # bool   [B]
    reward: torch.Tensor    # float32[B]
    inverted: torch.Tensor  # bool   [B]
    last_g: torch.Tensor    # int32  [B, n]    per-qubit last gate layer
    last_c: torch.Tensor    # int32  [B, n]    per-qubit last CX layer
    max_g: torch.Tensor     # int32  [B]
    max_c: torch.Tensor     # int32  [B]
    n_cnots: torch.Tensor   # int32  [B]
    n_gates: torch.Tensor   # int32  [B]

    @property
    def batch(self) -> int:
        return self.a.shape[0]


def state_from_arrays(fields: Mapping[str, np.ndarray],
                      device: DeviceLike = None, cls=None):
    """An env state (`cls`, by default `MatrixEnvState`) from numpy arrays
    keyed by field name, as a JAX env state gives them (`np.asarray` of each
    leaf): packed uint32 words become int32 tensors holding the same bits;
    the dense int8 state and every other field keep their type."""
    cls = MatrixEnvState if cls is None else cls
    dev = resolve_device(device)

    def tensor(x):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        return torch.from_numpy(x.copy()).to(dev)

    return cls(**{f: tensor(fields[f]) for f in cls._fields})


class MatrixEnvCore:
    """Static config + batched step/reset for one env family instance."""

    # Route the metrics update through the standalone metrics kernel (B2)
    # instead of the fused step (B1); mirrors the JAX package's
    # use_pallas_metrics. Off by default.
    use_metrics_kernel: bool = False

    def __init__(
        self,
        num_qubits: int,
        gateset: Sequence,
        kind: str,                      # 'permutation' | 'linear' | 'clifford'
        depth_slope: int = 2,
        max_depth: int = 128,
        metrics_weights: Optional[dict] = None,
        add_inverts: bool = True,
        scramble_cap: int = 256,
        bitpack: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        if kind not in ("permutation", "linear", "clifford"):
            raise ValueError(f"Unknown env kind {kind!r}")
        self.device = resolve_device(device)
        self.kind = kind
        self.num_qubits = int(num_qubits)
        self.gateset = parse_gateset(gateset)
        self.dim = 2 * self.num_qubits if kind == "clifford" else self.num_qubits
        self.D = _pad_dim(self.dim)
        self.depth_slope = int(depth_slope)
        self.max_depth = int(max_depth)
        self.add_inverts = bool(add_inverts)
        self.scramble_cap = int(scramble_cap)
        _w = MetricsWeights.from_dict(metrics_weights).as_array()
        # float32 values as Python floats (exact), for the kernels
        self.weights_static = tuple(float(x) for x in _w)
        # Layer tracking is reward-relevant only when either layer weight is
        # nonzero; the reference defaults zero both, and then last_g/last_c/
        # max_g/max_c stay frozen at -1 (as in the JAX XLA step). Set this
        # attribute to True to track them anyway.
        self.track_layers = (self.weights_static[1] != 0.0
                             or self.weights_static[2] != 0.0)
        self.bitpack = True if bitpack is None else bool(bitpack)

        Dr = self.dim if self.bitpack else self.D   # packed rep needs no pad
        Us, Ss = [], []
        for g in self.gateset:
            U, S = gate_rank2_terms(g, self.num_qubits, kind, Dr)
            check_rank2_terms(g, self.num_qubits, kind, Dr, U, S)
            Us.append(U)
            Ss.append(S)
        # index A (one past the end) is the all-zero no-op
        Us.append(np.zeros((Dr, 2), np.int8))
        Ss.append(np.zeros((2, Dr), np.int8))
        mt = MetricsTables.build(self.gateset)
        # identity action is metrics-neutral: type 1Q on a dummy qubit slot
        self.mtype = np.concatenate([mt.mtype, [MT_1Q]]).astype(np.int32)
        self.mq1 = np.concatenate([mt.q1, [0]]).astype(np.int32)
        self.mq2 = np.concatenate([mt.q2, [0]]).astype(np.int32)
        if self.bitpack:
            self.W = (Dr + 31) // 32
            self.L = self.W * Dr
            U32, S32, Ulm, Slm = pack_term_tables(Us, Ss, Dr)
            self.op_tab = torch.from_numpy(build_op_table(
                U32, S32, Ulm, Slm, self.mtype, self.mq1, self.mq2
            )).to(self.device)                             # int32 [A+1, F]
            ident = pack_rows(np.eye(Dr, dtype=np.uint8),
                              self.W).reshape(self.L)
            self.ident_pk = torch.from_numpy(
                ident.view(np.int32)).to(self.device)
        else:
            self.Ug = torch.from_numpy(np.stack(Us)).to(self.device)  # [A+1, D, 2]
            self.Sg = torch.from_numpy(np.stack(Ss)).to(self.device)  # [A+1, 2, D]
            # the dense core's op table holds the metrics columns only
            self.op_tab = torch.from_numpy(np.stack(
                [self.mtype, self.mq1, self.mq2], axis=1)).to(self.device)
        self.ident = torch.eye(self.D, dtype=torch.int8, device=self.device)
        self.noop_action = len(self.gateset)

    # ------------------------------------------------------------ properties
    @property
    def num_actions(self) -> int:
        return len(self.gateset)

    @property
    def obs_shape(self) -> Tuple[int, int]:
        return (self.dim, self.dim)

    # ------------------------------------------------------- matrix updates
    def apply_gates(self, a, ainv, action):
        """Apply gateset[action] to the states: a' = G a and, with
        add_inverts, ainv' = ainv G. Bitpacked: the apply kernel on CUDA,
        its plain version on the CPU. Dense: plain torch on either device."""
        if self.bitpack:
            return apply_gates(self, a, ainv, action)
        U, S = self.Ug[action], self.Sg[action]
        new_a = rank_terms_apply_left(U, S, a)
        if not self.add_inverts:
            # the inverse buffer is only consumed by the random-inversion
            # swap; it is left untouched when the feature is off
            return new_a, ainv
        return new_a, rank_terms_apply_right(U, S, ainv)

    # ----------------------------------------------------------------- step
    def _flips(self, B: int, generator, invert_override):
        if not self.add_inverts:
            return None
        if invert_override is not None:
            return invert_override.to(device=self.device, dtype=torch.bool)
        u = torch.rand(B, generator=generator, device=self.device)
        return u < 0.5

    def step(
        self,
        state: MatrixEnvState,
        action: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        invert_override: Optional[torch.Tensor] = None,
        actual_override: Optional[torch.Tensor] = None,  # unused; API
        #   uniformity with PauliEnvCore (matrix envs have no internal perms)
    ) -> MatrixEnvState:
        """One batched env step. The inversion coin-flip is drawn from
        `generator` unless `invert_override` (bool [B]) injects it."""
        action = action.to(torch.int64).contiguous()
        flip = self._flips(state.batch, generator, invert_override)
        if self.bitpack and not self.use_metrics_kernel:
            return fused_step(self, state, action, flip)
        return step_unfused(
            self, state, action, flip, metrics_update,
            lambda _, act, a, ainv: self.apply_gates(a, ainv, act))

    # ---------------------------------------------------------------- reset
    def _fresh(self, B: int) -> MatrixEnvState:
        n = self.num_qubits
        dev = self.device
        if self.bitpack:
            ident = self.ident_pk[None].repeat(B, 1)
        else:
            ident = self.ident[None].repeat(B, 1, 1)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return MatrixEnvState(
            a=ident,
            ainv=ident.clone(),
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

    def reset(
        self,
        B: int,
        difficulty: Union[int, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        scramble_override: Optional[torch.Tensor] = None,
    ) -> MatrixEnvState:
        """Scramble identity with `difficulty` random gateset actions per env.

        An int difficulty loops exactly that many times; a per-lane [B]
        tensor loops `scramble_cap` times with no-op actions beyond each
        lane's difficulty. `scramble_override` (int [B, K]) injects the
        actions (entries >= num_actions are no-ops)."""
        state = self._fresh(B)
        if scramble_override is not None:
            acts = scramble_override.to(device=self.device, dtype=torch.int64)
            acts = torch.where(acts < self.num_actions, acts,
                               self.noop_action)
        else:
            static_diff = isinstance(difficulty, (int, np.integer))
            K = int(difficulty) if static_diff else self.scramble_cap
            acts = torch.randint(0, self.num_actions, (B, max(K, 1)),
                                 generator=generator, device=self.device)
            if not static_diff:
                d = torch.as_tensor(difficulty, device=self.device)
                d = d[:, None] if d.ndim else d
                mask = torch.arange(K, device=self.device)[None, :] < d
                acts = torch.where(mask, acts, self.noop_action)
            acts = acts[:, :K]
        a, ainv = state.a, state.ainv
        for i in range(acts.shape[1]):
            a, ainv = self.apply_gates(a, ainv, acts[:, i].contiguous())

        success = solved(self, a)
        depth = torch.clamp(
            self.depth_slope * torch.as_tensor(difficulty, dtype=torch.int32,
                                               device=self.device),
            max=self.max_depth)
        return state._replace(
            a=a, ainv=ainv,
            depth=torch.broadcast_to(depth, (B,)).to(torch.int32).contiguous(),
            success=success,
            reward=success.float(),
        )

    # ------------------------------------------------------------- state io
    def _pad(self, dense: np.ndarray) -> np.ndarray:
        """[B, dim, dim] -> [B, D, D] with identity in the padding block."""
        out = np.tile(np.eye(self.D, dtype=np.int8), (dense.shape[0], 1, 1))
        out[:, : self.dim, : self.dim] = dense
        return out

    def set_state(self, dense: np.ndarray) -> MatrixEnvState:
        """Host-side: dense uint8/bool [B, dim, dim] -> device state.

        Mirrors reference set_state semantics: depth budget = max_depth,
        metrics cleared (reference clifford.rs:299-304)."""
        dense = np.asarray(dense)
        if dense.ndim == 2:
            dense = dense[None]
        dense = (dense != 0).astype(np.int8)
        B = dense.shape[0]
        inv = np.stack([gf2_inverse(m) for m in dense]).astype(np.int8)
        state = self._fresh(B)

        def on_device(m):
            if not self.bitpack:
                return torch.from_numpy(self._pad(m)).to(self.device)
            words = pack_rows(m, self.W).reshape(B, self.L)
            return torch.from_numpy(words.view(np.int32)).to(self.device)

        a = on_device(dense)
        success = solved(self, a)
        return state._replace(
            a=a, ainv=on_device(inv),
            depth=torch.full((B,), self.max_depth, dtype=torch.int32,
                             device=self.device),
            success=success,
            reward=success.float(),
        )

    # -------------------------------------------------------------- observe
    def dense(self, state: MatrixEnvState) -> torch.Tensor:
        """uint8 [B, dim, dim] current matrices."""
        if self.bitpack:
            return unpack_rows(state.a, self.W, self.dim, self.dim)
        return state.a[:, : self.dim, : self.dim].to(torch.uint8)

    def observe(self, state: MatrixEnvState,
                dtype=torch.float32) -> torch.Tensor:
        """Policy observation: [B, dim, dim] in the requested float dtype."""
        return self.dense(state).to(dtype)

    def masks(self, state: MatrixEnvState) -> torch.Tensor:
        """bool [B, A]: all actions legal unless already solved."""
        return (~state.success)[:, None].expand(state.batch, self.num_actions)

    def is_final(self, state: MatrixEnvState) -> torch.Tensor:
        return (state.depth == 0) | state.success
