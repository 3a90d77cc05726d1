"""The Pauli-network env step's transition as one kernel.

`PauliEnvCore.step` (ops/pauli.py) runs the metrics update (kernel B2,
`metrics_kernel.py`) and then this transition: the action's net tableau
matrix on the packed tableau, its primitive slots on the rotations with the
trivial-rotation sweep after each CNOT, the solved flag, the reward and the
depth. The CUDA source is `csrc/pauli_step.cu`; its header gives the bound
and the design. It replaces no Pallas kernel: the JAX package runs this step
as plain XLA, which fuses it.

`pauli_step_plain` is the plain PyTorch version, the step as the JAX
package's XLA writes it: what the wrapper runs for CPU tensors and what the
kernel is held against on the card. `pauli_step` is the wrapper: the plain
version for CPU tensors, the kernel on the current stream for CUDA tensors
(or an exception; there is no fallback). It counts its launches in
`.launches`, which `profiling.counter` registers as `pauli_step.launches`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from qiskit_gym_torch.utils.profiling import counter

from . import cuda_lib
from .bitops import popcount
from .fused_step import packed_apply_left

Tensor = torch.Tensor

# primitive op codes (P_SDG = S^3 as one slot: z ^= x, ph += 3x, exact since
# S^3 = Sdg as a unitary and H^2 = I makes (H S H)^3 = H S^3 H)
P_NOP, P_H, P_S, P_CNOT, P_SDG = 0, 1, 2, 3, 4
MAX_PRIMS = 3  # SX = H S H, SXdg = H Sdg H, SWAP = 3 CNOTs, CZ = H CX H
# op-table row: mtype, q1, q2 | codes, first, second qubits of each slot |
# U words [K2*W2] | S words [K2*W2]; CODES and TERMS are column offsets
CODES = 3
TERMS = CODES + 3 * MAX_PRIMS
# what the kernel takes: rotations as 64-bit masks, packed words in
# registers and shared memory, rank terms of a net matrix
MAX_RT, MAX_W2, MAX_WN, MAX_K = 64, 32, 16, 4

_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_void_p])


class Transition(NamedTuple):
    tab: Tensor        # int32 [B, W2 * D2]
    rx: Tensor         # int32 [B, RT, Wn]
    rz: Tensor         # int32 [B, RT, Wn]
    rphase: Tensor     # int8  [B, RT]
    active: Tensor     # bool  [B, RT]
    success: Tensor    # bool  [B]
    reward: Tensor     # f32   [B]
    depth: Tensor      # int32 [B]


def cleanup(rx: Tensor, rz: Tensor, active: Tensor, anti: Tensor):
    """Repeated front-layer sweep removing trivial rotations: rx/rz
    [B, RT, Wn], active [B, RT], anti [B, RT, RT]. Returns (new_active,
    removed_count int32 [B])."""
    weight = popcount(rx | rz).sum(dim=-1)
    trivial = weight <= 1                                  # [B, RT]
    removed = torch.zeros(active.shape[0], dtype=torch.int32,
                          device=active.device)
    for _ in range(active.shape[1]):
        blocked = (anti & active[:, None, :]).any(dim=-1)  # [B, RT]
        t = active & ~blocked & trivial
        active = active & ~t
        removed = removed + t.sum(dim=-1, dtype=torch.int32)
    return active, removed


def apply_primitives(core, state, pt: Tensor, p1: Tensor, p2: Tensor):
    """Evolve rotations (bits + phases) through the action's primitive
    sequence (pre-decoded tables pt/p1/p2 [B, MAX_PRIMS]), running the
    trivial sweep after every CNOT.

    Each primitive reads one or two qubit BITS per rotation (xa/za/xb at
    dynamic qubit positions, via single-bit word masks) and writes back
    single-bit XOR terms."""
    rx, rz = state.rx, state.rz
    ph = state.rphase.to(torch.int32)
    active = state.active
    removed = torch.zeros(state.batch, dtype=torch.int32, device=rx.device)
    # CNOT-capable slots run the trivial sweep; tail slots (such as
    # SXdg's trailing H) never hold a CNOT across the gateset and skip it
    slots = core.cleanup_slots
    n_cx_slots = (max(slots) + 1) if slots else 0
    if slots and slots != list(range(n_cx_slots)):
        n_cx_slots = core.max_prims  # non-prefix CNOT slots: sweep all
    zero = torch.zeros((), dtype=torch.int32, device=rx.device)
    for k in range(core.max_prims):
        c = pt[:, k, None]                                 # [B, 1]
        mask_a = core.bit_tab[p1[:, k]][:, None, :]        # [B, 1, Wn]
        mask_b = core.bit_tab[p2[:, k]][:, None, :]
        is_h, is_s = c == P_H, c == P_S
        is_sdg, is_cx = c == P_SDG, c == P_CNOT

        xa = ((rx & mask_a) != 0).any(dim=-1)              # bool [B, RT]
        za = ((rz & mask_a) != 0).any(dim=-1)
        xb = ((rx & mask_b) != 0).any(dim=-1)

        # H(a): swap x_a <-> z_a == both ^= (x_a ^ z_a); ph += 2 x_a z_a
        # S(a): z_a ^= x_a ; ph += x_a
        # Sdg(a) = S(a)^3: z_a ^= x_a ; ph += 3 x_a
        # CNOT(a,b) == evolve_cx(ctrl=b, trgt=a): x_a ^= x_b ; z_b ^= z_a
        d = xa ^ za
        dx_a = torch.where(is_h, d, is_cx & xb)
        dz_a = torch.where(is_h, d, (is_s | is_sdg) & xa)
        dz_b = is_cx & za

        rx = rx ^ torch.where(dx_a[:, :, None], mask_a, zero)
        rz = (rz ^ torch.where(dz_a[:, :, None], mask_a, zero)
              ^ torch.where(dz_b[:, :, None], mask_b, zero))
        xai = xa.to(torch.int32)
        dph = torch.where(
            is_h, 2 * (xa & za).to(torch.int32),
            torch.where(is_s, xai, torch.where(is_sdg, 3 * xai, zero)))
        ph = (ph + dph) % 4

        if k < n_cx_slots:
            new_active, rem = cleanup(rx, rz, active, state.anti)
            active = torch.where(is_cx, new_active, active)
            removed = removed + torch.where(is_cx[:, 0], rem, zero)
    return rx, rz, ph.to(torch.int8), active, removed


def pauli_step_plain(core, state, actual: Tensor, penalty: Tensor
                     ) -> Transition:
    """The transition in plain PyTorch, from the env-frame actions `actual`
    (int64 [B]) and B2's `penalty` (f32 [B])."""
    rows = core.op_tab[actual]
    pt, p1, p2 = (rows[:, CODES + i * MAX_PRIMS:CODES + (i + 1) * MAX_PRIMS]
                  for i in range(3))
    U32, S32 = core._terms(rows[:, TERMS:], core.K2)
    tab = packed_apply_left(U32, S32, state.tab, core.W2, core.D2)
    rx, rz, ph, active, removed = apply_primitives(core, state, pt,
                                                   p1.long(), p2.long())
    success = core._solved(tab, active)
    reward = (success.to(torch.float32) - penalty
              + core.pauli_layer_reward * removed.to(torch.float32))
    return Transition(tab, rx, rz, ph, active, success, reward,
                      torch.clamp(state.depth - 1, min=0))


def _lib():
    return cuda_lib.load("pauli_step", {
        "qgt_pauli_step": (_ARGTYPES, ctypes.c_int)})


def _check(core, state, actual: Tensor, penalty: Tensor) -> None:
    """Raise on operands the kernel does not take."""
    B, dev = state.tab.shape[0], state.tab.device
    RT, Wn = core.RT, core.Wn
    if (RT > MAX_RT or core.W2 > MAX_W2 or Wn > MAX_WN or core.K2 > MAX_K
            or core.max_prims > MAX_PRIMS):
        raise ValueError(
            f"pauli_step takes RT <= {MAX_RT}, W2 <= {MAX_W2}, Wn <= "
            f"{MAX_WN}, K2 <= {MAX_K}, max_prims <= {MAX_PRIMS}; this core "
            f"has {RT}, {core.W2}, {Wn}, {core.K2}, {core.max_prims}")
    fields = (("tab", state.tab, torch.int32, (B, core.L2)),
              ("rx", state.rx, torch.int32, (B, RT, Wn)),
              ("rz", state.rz, torch.int32, (B, RT, Wn)),
              ("rphase", state.rphase, torch.int8, (B, RT)),
              ("active", state.active, torch.bool, (B, RT)),
              ("anti", state.anti, torch.bool, (B, RT, RT)),
              ("depth", state.depth, torch.int32, (B,)),
              ("actual", actual, torch.int64, (B,)),
              ("penalty", penalty, torch.float32, (B,)),
              ("op_tab", core.op_tab, torch.int32,
               (core.num_actions + 1, TERMS + 2 * core.K2 * core.W2)))
    for name, t, dtype, shape in fields:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"pauli_step: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")


def pauli_step(core, state, actual: Tensor, penalty: Tensor) -> Transition:
    """The transition: the plain version for CPU tensors, the kernel on the
    current stream for CUDA tensors. New tensors for every field; `state`
    is left as it was."""
    if not state.tab.is_cuda:
        return pauli_step_plain(core, state, actual, penalty)
    _check(core, state, actual, penalty)
    lib = _lib()
    B, dev = state.tab.shape[0], state.tab.device
    out = Transition(
        torch.empty_like(state.tab), torch.empty_like(state.rx),
        torch.empty_like(state.rz), torch.empty_like(state.rphase),
        torch.empty_like(state.active),
        torch.empty(B, dtype=torch.bool, device=dev),
        torch.empty(B, dtype=torch.float32, device=dev),
        torch.empty_like(state.depth))
    p = cuda_lib.ptr
    err = lib.qgt_pauli_step(
        p(actual), p(penalty), p(state.tab), p(state.rx), p(state.rz),
        p(state.rphase), p(state.active), p(state.anti), p(state.depth),
        p(core.op_tab), *(p(t) for t in out), B, core.RT, core.Wn, core.W2,
        core.D2, core.K2, core.max_prims, core.pauli_layer_reward,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, err, "pauli_step")
    pauli_step.launches += 1
    return out


pauli_step.launches = 0
counter("pauli_step.launches", lambda: pauli_step.launches)
