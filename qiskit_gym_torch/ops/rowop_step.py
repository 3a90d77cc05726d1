"""Kernel B3: the dense-state row-op step.

Replaces the JAX package's Pallas TPU kernel `ops/pallas_step.py:
_vpu_kernel` (entry `fused_step_apply`, tables `build_rowop_tables`). The
CUDA source is `csrc/rowop_step.cu`; its header comment gives the bound and
the design.

On the dense int8 state of a `MatrixEnvCore(bitpack=False)` it applies, per
env, the action's <= 2 rank-1 GF(2) updates (term 2 on the result of term 1)
on the left to `a` and on the right to `ainv`, swaps the two where `flips` is
set, and reports `solved = all(a == I)`. The right multiply runs whatever
`add_inverts` says, as in the JAX package.

As in the JAX package this is a function of its own beside the core:
`MatrixEnvCore.step` does not call it. A caller carries `a`/`ainv` through it
step by step (see `chip_smoke.py`, the dense path).

`fused_step_apply` is the wrapper: the plain PyTorch version for CPU tensors,
the kernel for CUDA tensors (or an exception; there is no fallback). It counts
its kernel launches in `.launches`, and those of the streaming kernel that
large tiles take (2 D^2 bytes past a block's shared memory, D >= 344) in
`.large_launches` as well.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from . import cuda_lib
from .matrix_env import gate_rank2_terms

Tensor = torch.Tensor

TABLE_NAMES = ("d1a", "d1b", "s1a", "s1b", "t1",
               "d2a", "d2b", "s2a", "s2b", "t2")
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def build_rowop_tables(core) -> List[np.ndarray]:
    """Per-action index tables, ten int32 [A+1] arrays in `TABLE_NAMES`
    order. Term k of an action has destination rows (dka, dkb), source rows
    (ska, skb) and an enable flag tk; an absent second row, and every row of
    the trailing no-op action, is index D ("no row")."""
    D = core.D
    A = core.num_actions
    table = {k: np.full((A + 1,), D, np.int32) for k in TABLE_NAMES}
    table["t1"][:] = 0
    table["t2"][:] = 0
    for a, gate in enumerate(core.gateset):
        U, S = gate_rank2_terms(gate, core.num_qubits, core.kind, D)
        for k in range(2):
            u_rows = np.flatnonzero(U[:, k])
            s_rows = np.flatnonzero(S[k])
            if len(u_rows) == 0:
                continue
            key = str(k + 1)
            table[f"d{key}a"][a] = u_rows[0]
            table[f"d{key}b"][a] = u_rows[1] if len(u_rows) > 1 else D
            table[f"s{key}a"][a] = s_rows[0]
            table[f"s{key}b"][a] = s_rows[1] if len(s_rows) > 1 else D
            table[f"t{key}"][a] = 1
    return [table[k] for k in TABLE_NAMES]


def rowop_table(core) -> Tensor:
    """The tables as one int32 [A+1, 10] tensor on the core's device (one
    row per action, columns in `TABLE_NAMES` order), built once per core."""
    tab = getattr(core, "_rowop_tab", None)
    if tab is None:
        tab = torch.from_numpy(
            np.stack(build_rowop_tables(core), axis=1)).to(core.device)
        core._rowop_tab = tab
    return tab


def _left_term(m: Tensor, da, db, sa, sb, on) -> Tensor:
    """m ^= u w^T with w = row sa ^ row sb of m, into rows da, db. `m` is
    padded with a zero row at index D, which "no row" indices select."""
    B, D1, _ = m.shape
    lanes = torch.arange(B, device=m.device)
    w = (m[lanes, sa] ^ m[lanes, sb]) & on[:, None]           # [B, D]
    rows = torch.arange(D1, device=m.device)[None, :]
    u = (((rows == da[:, None]) ^ (rows == db[:, None]))
         & (rows < D1 - 1)).to(m.dtype)           # the pad row stays zero
    return m ^ (u[:, :, None] & w[:, None, :])


def fused_step_apply_plain(core, a: Tensor, ainv: Tensor, actions: Tensor,
                           flips: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain PyTorch version of kernel B3, in the kernel's order: term 2
    reads the result of term 1. Returns (new_a, new_ainv, success bool [B]).
    """
    B, D, _ = a.shape
    tab = rowop_table(core).to(a.device)[actions.long()].long()   # [B, 10]
    zrow = torch.zeros((B, 1, D), dtype=a.dtype, device=a.device)
    zcol = torch.zeros((B, D + 1, 1), dtype=a.dtype, device=a.device)

    def pad(m):  # a zero row and column at index D for the "no row" index
        return torch.cat([torch.cat([m, zrow], dim=1), zcol], dim=2)

    m, mi = pad(a), pad(ainv)
    for k in range(2):
        da, db, sa, sb, on = tab[:, 5 * k:5 * k + 5].unbind(1)
        on = (-on).to(a.dtype)                    # 0 or all ones
        m = _left_term(m, da, db, sa, sb, on)
        # the right multiply (w = col da ^ col db, into cols sa, sb) is the
        # left multiply of the transpose with sources and destinations
        # exchanged
        mi = _left_term(mi.transpose(1, 2), sa, sb, da, db,
                        on).transpose(1, 2)
    new_a, new_i = m[:, :D, :D], mi[:, :D, :D]
    f3 = flips.to(torch.bool)[:, None, None]
    sel_a = torch.where(f3, new_i, new_a)
    sel_i = torch.where(f3, new_a, new_i)
    success = (sel_a == core.ident.to(a.device)[None]).flatten(1).all(dim=1)
    return sel_a.contiguous(), sel_i.contiguous(), success


def _lib():
    return cuda_lib.load("rowop_step", {
        "qgt_rowop_step": (_ARGTYPES, ctypes.c_int),
        "qgt_rowop_table_width": ([], ctypes.c_int),
        "qgt_rowop_streams": ([ctypes.c_int], ctypes.c_int),
    })


def fused_step_apply(core, a: Tensor, ainv: Tensor, actions: Tensor,
                     flips: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Apply per-env actions and inversion flips to the dense state in one
    pass: the plain version for CPU tensors, kernel B3 on the current stream
    for CUDA tensors. `a`, `ainv` int8 [B, D, D]; `actions` int64 [B] (the
    no-op action included); `flips` bool [B]. Any B and any D the core
    has: tiles past a block's shared memory take the streaming kernel.

    Returns (new_a, new_ainv, success bool [B])."""
    if core.bitpack:
        raise ValueError("fused_step_apply requires bitpack=False")
    if not a.is_cuda:
        return fused_step_apply_plain(core, a, ainv, actions, flips)
    B, D, dev = a.shape[0], core.D, a.device
    for name, t, dtype, shape in (
            ("a", a, torch.int8, (B, D, D)),
            ("ainv", ainv, torch.int8, (B, D, D)),
            ("actions", actions, torch.int64, (B,)),
            ("flips", flips, torch.bool, (B,))):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"fused_step_apply: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")
    if a.data_ptr() % 16 or ainv.data_ptr() % 16:
        raise ValueError("fused_step_apply: a and ainv must be 16-byte "
                         "aligned")
    tab = rowop_table(core)
    if tab.device != dev:
        raise ValueError(f"state on {dev} but the core's tables on "
                         f"{tab.device}")
    lib = _lib()
    o_a = torch.empty_like(a)
    o_ainv = torch.empty_like(ainv)
    o_succ = torch.empty(B, dtype=torch.bool, device=dev)
    p = cuda_lib.ptr
    err = lib.qgt_rowop_step(
        p(actions), p(flips), p(a), p(ainv), p(tab), p(o_a), p(o_ainv),
        p(o_succ), B, D, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, err, "fused_step_apply")
    fused_step_apply.launches += 1
    if lib.qgt_rowop_streams(D):
        fused_step_apply.large_launches += 1
    return o_a, o_ainv, o_succ


fused_step_apply.launches = 0
fused_step_apply.large_launches = 0
