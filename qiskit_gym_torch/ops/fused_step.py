"""Kernel B1: the whole bitpacked `MatrixEnvCore.step` as one kernel.

Replaces the JAX package's Pallas TPU kernel `ops/pallas_fused.py:
_fused_kernel` (entry `fused_step`). The CUDA source is `csrc/fused_step.cu`;
its header comment gives the bound and the design. What it computes is the
XLA step of the JAX package (`MatrixEnvCore.step`), not the Pallas kernel:
the layer fields follow `track_layers`, and `add_inverts=False` is supported.

Per-action operands come from one int32 table row, built once per core by
`build_op_table` (the TPU kernel's f32 one-hot-matmul table decode has no
counterpart here):

    [0:3]                    mtype, q1, q2
    [3 : 3+K*W]              U32[k][w]   destination-row word masks
    [3+K*W : 3+2*K*W]        S32[k][w]   source-row word masks
    [3+2*K*W : +2*K]         u[k][0..1]  the <= 2 columns U's column k
                                         selects (-1 if absent)
    [.. : +K*max(W, 2)]      Slm[k] as a Dr-bit column mask, max(W, 2)
                                         words (bit d of word j = column
                                         32j + d; for W <= 2 the (lo, hi)
                                         words of a 64-bit mask)

Packed words are int32 tensors holding the uint32 bit pattern; the kernel
reads the same memory as `uint32_t`. The plain versions widen to int64 and
mask where they shift (PyTorch has no shifts on uint32 tensors on the CPU).

`fused_step` and `apply_gates` are the wrappers: the plain PyTorch version
for CPU tensors, the kernel for CUDA tensors (or an exception; there is no
fallback). Each counts its kernel launches in `.launches`, and those of its
wide kernel (W >= 3) among them in `.wide_launches`; `profiling.counter`
registers the step's as `fused_step.wide_launches`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from qiskit_gym_torch.utils.profiling import counter

from . import cuda_lib
from .bitops import pack_lanes, u32
from .metrics_kernel import SCAL_MAX_C, SCAL_MAX_G, SCAL_N_CNOTS, \
    SCAL_N_GATES, metrics_update_plain

K = 2  # rank terms per action (every gate is G = I ^ U S with rank <= 2)

_STEP_ARGTYPES = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 7
                  + [ctypes.c_float] * 4 + [ctypes.c_void_p])
_APPLY_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
_OCCUPANCY_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3

Tensor = torch.Tensor


def slm_words(W: int) -> int:
    """Words per rank term of the op table's Slm column mask."""
    return max(W, 2)


def table_columns(W: int) -> dict:
    """Column offsets of the op table for W words per column."""
    u = 3
    s = u + K * W
    ucol = s + K * W
    slm = ucol + 2 * K
    return {"U": u, "S": s, "ucol": ucol, "slm": slm,
            "F": slm + K * slm_words(W)}


def build_op_table(U32: np.ndarray, S32: np.ndarray, Ulm: np.ndarray,
                   Slm: np.ndarray, mtype, q1, q2) -> np.ndarray:
    """int32 [A+1, F] per-action operand table from the packed term tables
    (U32/S32 [A+1, K, W] uint32, Ulm/Slm [A+1, K, Dr] lane masks) and the
    metrics descriptors (mtype/q1/q2 [A+1])."""
    A1, k_terms, W = U32.shape
    Dr = Ulm.shape[2]
    if k_terms != K:
        raise ValueError(f"expected {K} rank terms per action, got {k_terms}")
    c = table_columns(W)
    tab = np.zeros((A1, c["F"]), np.uint32)
    tab[:, 0] = np.asarray(mtype)
    tab[:, 1] = np.asarray(q1)
    tab[:, 2] = np.asarray(q2)
    tab[:, c["U"]:c["S"]] = U32.reshape(A1, K * W)
    tab[:, c["S"]:c["ucol"]] = S32.reshape(A1, K * W)
    # the <= 2 columns each term of U selects: the first and the last set
    # lane, -1 where there are fewer
    sel = Ulm != 0                                      # [A1, K, Dr]
    count = sel.sum(axis=2)
    if (count > 2).any():
        raise ValueError("a rank term selects more than 2 columns")
    first = sel.argmax(axis=2)
    last = Dr - 1 - sel[:, :, ::-1].argmax(axis=2)
    ucol = np.stack([np.where(count >= 1, first, -1),
                     np.where(count == 2, last, -1)], axis=2)
    tab[:, c["ucol"]:c["slm"]] = ucol.reshape(A1, 2 * K).astype(
        np.int64).astype(np.uint32)
    tab[:, c["slm"]:c["F"]] = pack_lanes(Slm, slm_words(W)).reshape(A1, -1)
    return tab.view(np.int32)



def _parity(x: Tensor) -> Tensor:
    """Parity (0/1, int32) of each uint32 word held in int32 `x`."""
    v = u32(x)
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return (v & 1).to(torch.int32)


def _mask_bits(words: Tensor, count: int) -> Tensor:
    """Bits 0..count-1 of int32 words [B] -> int32 0/1 [B, count]."""
    shifts = torch.arange(count, device=words.device)
    return ((u32(words)[:, None] >> shifts) & 1).to(torch.int32)


def packed_apply_left(U32: Tensor, S32: Tensor, a: Tensor, W: int,
                      D: int) -> Tensor:
    """a' = (I ^ U S) a on a packed int32 [B, W*D] state, from the per-env
    gathered word masks U32/S32 int32 [B, K, W]. Per term, the source-row
    combination of a column is the parity of its masked words; it goes into
    the destination rows through a broadcast word mask."""
    B = a.shape[0]
    a3 = a.reshape(B, W, D)
    acc = torch.zeros_like(a3)
    for k in range(U32.shape[1]):
        x = a3 & S32[:, k, :, None]                     # [B, W, D]
        xw = x[:, 0]
        for w in range(1, W):
            xw = xw ^ x[:, w]
        sel = -_parity(xw)                              # 0 or -1, [B, D]
        acc = acc ^ (U32[:, k, :, None] & sel[:, None, :])
    return (a3 ^ acc).reshape(B, W * D)


def apply_plain(tab_rows: Tensor, a: Tensor, ainv: Tensor, W: int, Dr: int,
                add_inverts: bool) -> Tuple[Tensor, Tensor]:
    """a' = (I ^ U S) a and ainv' = ainv (I ^ U S) on packed int32 [B, W*Dr]
    states, from each env's gathered op-table row `tab_rows` [B, F]."""
    B = a.shape[0]
    c = table_columns(W)
    U = tab_rows[:, c["U"]:c["S"]].reshape(B, K, W)
    S = tab_rows[:, c["S"]:c["ucol"]].reshape(B, K, W)
    new_a = packed_apply_left(U, S, a, W, Dr)
    if not add_inverts:
        return new_a, ainv

    m3 = ainv.reshape(B, W, Dr)
    m3p = torch.cat([m3, torch.zeros_like(m3[:, :, :1])], dim=2)  # col Dr = 0
    ucol = tab_rows[:, c["ucol"]:c["slm"]].reshape(B, K, 2).long()
    ucol = torch.where(ucol < 0, Dr, ucol)
    Ws = slm_words(W)
    slm = tab_rows[:, c["slm"]:c["F"]].reshape(B, K, Ws)
    racc = torch.zeros_like(m3)
    for k in range(K):
        cols = m3p.gather(2, ucol[:, k, None, :].expand(B, W, 2))
        cw = cols[..., 0] ^ cols[..., 1]                # [B, W]
        bits = torch.cat([_mask_bits(slm[:, k, j], min(32, Dr - 32 * j))
                          for j in range(W)], dim=1)    # [B, Dr]
        racc = racc ^ (cw[:, :, None] & (-bits)[:, None, :])
    return new_a, (m3 ^ racc).reshape(B, W * Dr)


def solved(core, a: Tensor) -> Tensor:
    """bool [B]: the state equals the identity (packed words, or the whole
    padded D x D tile of the dense state)."""
    if core.bitpack:
        return (a == core.ident_pk[None]).all(dim=1)
    return (a == core.ident[None]).flatten(1).all(dim=1)


def step_unfused(core, state, action: Tensor, flip, metrics, apply):
    """`MatrixEnvCore.step` from its parts: the metrics update `metrics`
    (B2's signature) and the matrix update `apply` (`apply_plain`'s), then
    the flip swap, depth, solved flag and reward."""
    rows = core.op_tab[action]
    noop = (action == core.noop_action).to(torch.int32)
    scal = torch.stack([state.max_g, state.max_c, state.n_cnots,
                        state.n_gates, rows[:, 0], rows[:, 1], rows[:, 2],
                        noop], dim=1)
    last_g, last_c, scal, penalty = metrics(
        state.last_g, state.last_c, scal, core.weights_static,
        core.track_layers)
    new_a, new_ainv = apply(rows, action, state.a, state.ainv)
    inverted = state.inverted
    if core.add_inverts:
        f = flip.reshape((-1,) + (1,) * (new_a.ndim - 1))
        new_a, new_ainv = (torch.where(f, new_ainv, new_a),
                           torch.where(f, new_a, new_ainv))
        inverted = inverted ^ flip
    success = solved(core, new_a)
    return state._replace(
        a=new_a, ainv=new_ainv,
        depth=torch.clamp(state.depth - 1, min=0),
        success=success,
        reward=success.float() - penalty,
        inverted=inverted,
        last_g=last_g, last_c=last_c,
        max_g=scal[:, SCAL_MAX_G].contiguous(),
        max_c=scal[:, SCAL_MAX_C].contiguous(),
        n_cnots=scal[:, SCAL_N_CNOTS].contiguous(),
        n_gates=scal[:, SCAL_N_GATES].contiguous(),
    )


def fused_step_plain(core, state, action: Tensor, flip):
    """The plain PyTorch version of kernel B1: the XLA `MatrixEnvCore.step`
    of the JAX package, given the inversion coin-flips `flip` (bool [B],
    ignored without add_inverts)."""
    return step_unfused(
        core, state, action, flip, metrics_update_plain,
        lambda rows, _, a, ainv: apply_plain(rows, a, ainv, core.W, core.dim,
                                             core.add_inverts))


def _lib():
    return cuda_lib.load("fused_step", {
        "qgt_fused_step": (_STEP_ARGTYPES, ctypes.c_int),
        "qgt_apply_gates": (_APPLY_ARGTYPES, ctypes.c_int),
        "qgt_op_table_width": ([ctypes.c_int], ctypes.c_int),
        "qgt_wide_occupancy": (_OCCUPANCY_ARGTYPES, ctypes.c_int),
    })


def wide_occupancy(W: int, Dr: int, lib=None) -> dict:
    """On the card: the wide kernels' threads a block at W words and Dr
    rows (16-byte aligned tensors), and the resident blocks an SM of the
    step and apply kernels (untracked, add_inverts) as the CUDA occupancy
    calculator gives them."""
    lib = lib or _lib()
    out = [ctypes.c_int() for _ in range(3)]
    err = lib.qgt_wide_occupancy(W, Dr, *(ctypes.byref(x) for x in out))
    cuda_lib.check(lib, err, "wide_occupancy")
    return dict(zip(("threads", "step_blocks_per_sm", "apply_blocks_per_sm"),
                    (x.value for x in out)))


def _check_cuda(core, action: Tensor, a: Tensor, ainv: Tensor) -> None:
    """Raise on operands the kernels do not take."""
    B = a.shape[0]
    dev = a.device
    if core.op_tab.device != dev:
        raise ValueError(f"state on {dev} but the core's tables on "
                         f"{core.op_tab.device}")
    for name, t, shape in (("a", a, (B, core.L)), ("ainv", ainv, (B, core.L))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {dev}")
    if (action.dtype != torch.int64 or tuple(action.shape) != (B,)
            or not action.is_contiguous() or action.device != dev):
        raise ValueError(f"action must be a contiguous int64 [{B}] tensor "
                         f"on {dev}")
    if (core.W != (core.dim + 31) // 32
            or core.op_tab.shape[1] != table_columns(core.W)["F"]):
        raise ValueError(f"W={core.W} words and a table of width "
                         f"{core.op_tab.shape[1]} do not fit dim {core.dim}")


def _check_field(name: str, t: Tensor, dtype, shape, dev) -> None:
    if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                         f"tensor on {dev}")


def fused_step(core, state, action: Tensor, flip):
    """One whole env step: the plain version for CPU tensors, kernel B1 on
    the current stream for CUDA tensors. `flip` is bool [B] (None without
    add_inverts). Fields the step does not change come back as the same
    tensors (ainv and inverted without add_inverts, the layer fields when
    untracked)."""
    if not core.bitpack:
        raise ValueError("fused_step requires bitpack=True")
    if not state.a.is_cuda:
        return fused_step_plain(core, state, action, flip)
    _check_cuda(core, action, state.a, state.ainv)
    B, dev = state.a.shape[0], state.a.device
    n = core.num_qubits
    for name in ("depth", "max_g", "max_c", "n_cnots", "n_gates"):
        _check_field(name, getattr(state, name), torch.int32, (B,), dev)
    for name in ("last_g", "last_c"):
        _check_field(name, getattr(state, name), torch.int32, (B, n), dev)
    _check_field("inverted", state.inverted, torch.bool, (B,), dev)
    inv, track = core.add_inverts, core.track_layers
    if inv:
        _check_field("flip", flip, torch.bool, (B,), dev)
    lib = _lib()

    o_a = torch.empty_like(state.a)
    o_ainv = torch.empty_like(state.ainv) if inv else state.ainv
    o_inverted = torch.empty_like(state.inverted) if inv else state.inverted
    if track:
        o_lg, o_lc = torch.empty_like(state.last_g), torch.empty_like(state.last_c)
        o_max_g, o_max_c = torch.empty_like(state.max_g), torch.empty_like(state.max_c)
    else:
        o_lg, o_lc = state.last_g, state.last_c
        o_max_g, o_max_c = state.max_g, state.max_c
    o_depth = torch.empty_like(state.depth)
    o_success = torch.empty(B, dtype=torch.bool, device=dev)
    o_reward = torch.empty(B, dtype=torch.float32, device=dev)
    o_n_cnots = torch.empty_like(state.n_cnots)
    o_n_gates = torch.empty_like(state.n_gates)

    p = cuda_lib.ptr

    def out(t, written):
        return p(t) if written else None

    w0, w1, w2, w3 = core.weights_static
    err = lib.qgt_fused_step(
        p(action), p(flip) if inv else None, p(state.a), p(state.ainv),
        p(state.last_g), p(state.last_c), p(state.depth), p(state.inverted),
        p(state.max_g), p(state.max_c), p(state.n_cnots), p(state.n_gates),
        p(core.op_tab),
        p(o_a), out(o_ainv, inv), out(o_lg, track), out(o_lc, track),
        p(o_depth), p(o_success), p(o_reward), out(o_inverted, inv),
        out(o_max_g, track), out(o_max_c, track), p(o_n_cnots), p(o_n_gates),
        B, core.W, core.dim, n, core.noop_action, int(track), int(inv),
        w0, w1, w2, w3, torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, err, "fused_step")
    fused_step.launches += 1
    fused_step.wide_launches += int(core.W >= 3)
    return state._replace(
        a=o_a, ainv=o_ainv, depth=o_depth, success=o_success,
        reward=o_reward, inverted=o_inverted, last_g=o_lg, last_c=o_lc,
        max_g=o_max_g, max_c=o_max_c, n_cnots=o_n_cnots, n_gates=o_n_gates)


fused_step.launches = 0
fused_step.wide_launches = 0
counter("fused_step.wide_launches", lambda: fused_step.wide_launches)


def apply_gates(core, a: Tensor, ainv: Tensor, action: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """The apply part of B1 alone (left and, with add_inverts, right
    multiply), as the reset scramble loop uses it: the plain version for CPU
    tensors, the apply kernel for CUDA tensors."""
    if not a.is_cuda:
        return apply_plain(core.op_tab[action], a, ainv, core.W, core.dim,
                           core.add_inverts)
    _check_cuda(core, action, a, ainv)
    lib = _lib()
    inv = core.add_inverts
    o_a = torch.empty_like(a)
    o_ainv = torch.empty_like(ainv) if inv else ainv
    p = cuda_lib.ptr
    err = lib.qgt_apply_gates(
        p(action), p(a), p(ainv), p(core.op_tab), p(o_a),
        p(o_ainv) if inv else None, a.shape[0], core.W, core.dim, int(inv),
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(lib, err, "apply_gates")
    apply_gates.launches += 1
    apply_gates.wide_launches += int(core.W >= 3)
    return o_a, o_ainv


apply_gates.launches = 0
apply_gates.wide_launches = 0
