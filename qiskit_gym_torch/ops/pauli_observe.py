"""The Pauli-network env's observation as one kernel.

`PauliEnvCore.dense` (ops/pauli.py) turns the packed state into the uint8
observation [B, 2n, 2n + R] the policy reads: the tableau block and the
active rotation columns, compacted to the left, under the lane's coupling-map
automorphism. The CUDA source is `csrc/pauli_observe.cu`; its header gives
the bound and the design. It replaces no Pallas kernel: the JAX package
leaves `dense` to XLA, which fuses it.

`pauli_observe_plain` is the plain PyTorch version, the observation as the
JAX package's XLA writes it: what the wrapper runs for CPU tensors and what
the kernel is held against on the card. `pauli_observe` is the wrapper: the
plain version for CPU tensors, the kernel on the current stream for CUDA
tensors (or an exception; there is no fallback). It counts its launches in
`.launches`, which `profiling.counter` registers as
`pauli_observe.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from qiskit_gym_torch.utils.profiling import counter

from . import cuda_lib
from .bitops import u32
from .matrix_env import unpack_rows

Tensor = torch.Tensor

# what the kernel takes: the active set as two 32-slot ballots, rotations
# of at most 16 words (n <= 512, so an env's bit stream fits a block's
# shared memory)
MAX_RT, MAX_WN = 64, 16

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def unpack_bits_lastdim(words: Tensor, n: int) -> Tensor:
    """int32 words [..., W] -> uint8 bits [..., n]."""
    shifts = torch.arange(32, device=words.device)
    bits = (u32(words)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].to(torch.uint8)


def pauli_observe_plain(core, state) -> Tensor:
    """uint8 [B, 2n, 2n + R]: the tableau block and the active rotation
    columns compacted to the left, under the active automorphism (rows of
    everything, columns of the tableau only)."""
    n, dim, R = core.num_qubits, core.dim, core.R
    B = state.batch
    tab = unpack_rows(state.tab, core.W2, core.D2, dim)[:, :, :dim]
    rx_b = unpack_bits_lastdim(state.rx, n)          # [B, RT, n]
    rz_b = unpack_bits_lastdim(state.rz, n)
    cols = torch.cat([rx_b.transpose(1, 2), rz_b.transpose(1, 2)],
                     dim=1)                          # [B, 2n, RT]
    # stable left-compaction: output column d shows the (d+1)-th active
    # rotation, or zeros when there are fewer
    active = state.active
    pos = torch.cumsum(active.to(torch.int32), dim=-1) - 1    # [B, RT]
    dst = torch.arange(R, device=pos.device)
    sel = (pos[:, :, None] == dst[None, None, :]) & active[:, :, None]
    src = sel.to(torch.int32).argmax(dim=1)                   # [B, R]
    cols = cols.gather(2, src[:, None, :].expand(B, dim, R)) \
        * sel.any(dim=1)[:, None, :].to(torch.uint8)
    # a trivial automorphism group (such as the 27q heavy-hex) has one
    # identity perm: nothing to permute
    if core.num_perms == 1 and core.qubit_perms[0] == list(range(n)):
        return torch.cat([tab, cols], dim=2)
    e = core.perm_rows[state.perm_idx.long()]                 # [B, 2n]
    tab = tab.gather(1, e[:, :, None].expand(B, dim, dim))
    tab = tab.gather(2, e[:, None, :].expand(B, dim, dim))
    cols = cols.gather(1, e[:, :, None].expand(B, dim, R))
    return torch.cat([tab, cols], dim=2)


def _lib():
    return cuda_lib.load("pauli_observe", {
        "qgt_pauli_observe": (_ARGTYPES, ctypes.c_int)})


def _check(core, state) -> None:
    """Raise on operands the kernel does not take."""
    B, dev = state.tab.shape[0], state.tab.device
    RT, Wn = core.RT, core.Wn
    if RT > MAX_RT or Wn > MAX_WN:
        raise ValueError(
            f"pauli_observe takes RT <= {MAX_RT}, Wn <= {MAX_WN}; this core "
            f"has {RT}, {Wn}")
    fields = (("tab", state.tab, torch.int32, (B, core.L2)),
              ("rx", state.rx, torch.int32, (B, RT, Wn)),
              ("rz", state.rz, torch.int32, (B, RT, Wn)),
              ("active", state.active, torch.bool, (B, RT)),
              ("perm_idx", state.perm_idx, torch.int32, (B,)),
              ("perm_rows", core.perm_rows, torch.int64,
               (core.num_perms, core.dim)))
    for name, t, dtype, shape in fields:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"pauli_observe: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")


def pauli_observe(core, state) -> Tensor:
    """The observation: the plain version for CPU tensors, the kernel on the
    current stream for CUDA tensors. A new uint8 tensor [B, 2n, 2n + R]."""
    if not state.tab.is_cuda:
        return pauli_observe_plain(core, state)
    _check(core, state)
    lib = _lib()
    B, dev = state.tab.shape[0], state.tab.device
    out = torch.empty((B,) + core.obs_shape, dtype=torch.uint8, device=dev)
    p = cuda_lib.ptr
    err = lib.qgt_pauli_observe(
        p(state.tab), p(state.rx), p(state.rz), p(state.active),
        p(state.perm_idx), p(core.perm_rows), p(out), B, core.num_qubits,
        core.R, core.RT, core.Wn, core.W2, core.D2, core.num_perms,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(lib, err, "pauli_observe")
    pauli_observe.launches += 1
    return out


pauli_observe.launches = 0
counter("pauli_observe.launches", lambda: pauli_observe.launches)
