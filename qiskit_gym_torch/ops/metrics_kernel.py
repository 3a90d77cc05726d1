"""Kernel B2: the per-step circuit-metrics update, standalone.

Replaces the JAX package's Pallas TPU kernel `ops/pallas_metrics.py:_kernel`
(entry `metrics_update_pallas`). The CUDA kernel is `csrc/metrics.cu`; its
per-env arithmetic lives in `csrc/metrics.cuh`, which the fused env step
(kernel B1, `csrc/fused_step.cu`) inlines too. The kernel moves tiles of 64
consecutive envs through shared memory with bulk asynchronous copies and an
`mbarrier` ring (see the note at the top of `csrc/metrics.cu`); the last,
partial tile and tensors that do not start on a 16-byte boundary take ordinary
loads and stores inside the same kernel. `PauliEnvCore.step` calls it on every
step; `MatrixEnvCore.step` routes through it when `use_metrics_kernel` is set
or the state is dense.

`metrics_update_plain` is the plain PyTorch version: it is what the wrapper
runs for CPU tensors, what the fused step's plain version calls, and what the
kernel is held against on the card. It is `MatrixEnvCore._metrics_update_terms`
of the JAX package on the `scal` operand layout of the Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import cuda_lib
from .tables import MT_1Q, MT_CX, MT_SWAP

# scal columns
SCAL_MAX_G, SCAL_MAX_C, SCAL_N_CNOTS, SCAL_N_GATES = 0, 1, 2, 3
SCAL_MTYPE, SCAL_Q1, SCAL_Q2, SCAL_NOOP = 4, 5, 6, 7

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])

Tensor = torch.Tensor


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


def metrics_update_plain(last_g: Tensor, last_c: Tensor, scal: Tensor,
                         weights: Sequence[float], track_layers: bool
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """last_g/last_c int32 [B, n]; scal int32 [B, 8] = (max_g, max_c,
    n_cnots, n_gates, mtype, q1, q2, is_noop). Returns (last_g, last_c,
    scal, penalty f32 [B]). Untracked, last_g/last_c come back unchanged
    (the same tensors) and max_g/max_c keep their values."""
    max_g, max_c, n_cnots, n_gates, mtype, q1, q2, noop = scal.unbind(1)
    noop = noop != 0
    w = torch.tensor(list(weights), dtype=torch.float32, device=scal.device)
    is1q = mtype == MT_1Q
    iscx = mtype == MT_CX
    issw = mtype == MT_SWAP
    one, three, zero = 1, 3, 0
    d_gates = _i32(torch.where(noop, zero, torch.where(is1q | iscx, one,
                                                       three)))
    d_cnots = _i32(torch.where(is1q | noop, zero, torch.where(issw, three,
                                                              one)))

    if not track_layers:
        penalty = w[0] * d_cnots.float() + w[3] * d_gates.float()
        out = torch.stack([max_g, max_c, n_cnots + d_cnots, n_gates + d_gates,
                           mtype, q1, q2, scal[:, SCAL_NOOP]], dim=1)
        return last_g, last_c, out, penalty

    n = last_g.shape[1]
    qid = torch.arange(n, device=scal.device)[None, :]
    oh1 = q1[:, None] == qid
    oh2 = q2[:, None] == qid
    i1 = q1.long()[:, None]
    i2 = q2.long()[:, None]
    lg1 = last_g.gather(1, i1)[:, 0]
    lg2 = last_g.gather(1, i2)[:, 0]
    lc1 = last_c.gather(1, i1)[:, 0]
    lc2 = last_c.gather(1, i2)[:, 0]

    m_cx = torch.maximum(lg1, lg2) + 1
    m_sw = torch.maximum(lg1, lg2) + 3
    m_cz = torch.maximum(lg1, lg2 + 1) + 1
    v1 = torch.where(is1q, lg1 + 1,
                     torch.where(iscx, m_cx, torch.where(issw, m_sw, m_cz)))
    v2 = torch.where(is1q, lg1 + 1,
                     torch.where(iscx, m_cx,
                                 torch.where(issw, m_sw, m_cz + 1)))
    v1 = torch.where(noop, lg1, v1)
    v2 = torch.where(noop, lg2, v2)
    new_last_g = torch.where(oh2, v2[:, None],
                             torch.where(oh1, v1[:, None], last_g))

    c_new = torch.maximum(lc1, lc2) + _i32(torch.where(issw, three, one))
    has_cx = (~is1q) & (~noop)
    w1 = torch.where(has_cx, c_new, lc1)
    w2 = torch.where(has_cx, c_new, lc2)
    new_last_c = torch.where(oh2, w2[:, None],
                             torch.where(oh1, w1[:, None], last_c))

    new_max_g = torch.maximum(max_g, torch.maximum(v1, v2))
    new_max_c = torch.maximum(max_c, torch.maximum(w1, w2))
    d_layers = new_max_g - max_g
    d_layers_c = new_max_c - max_c
    penalty = (w[0] * d_cnots.float() + w[1] * d_layers_c.float()
               + w[2] * d_layers.float() + w[3] * d_gates.float())
    out = torch.stack([new_max_g, new_max_c, n_cnots + d_cnots,
                       n_gates + d_gates, mtype, q1, q2, scal[:, SCAL_NOOP]],
                      dim=1)
    return _i32(new_last_g), _i32(new_last_c), _i32(out), penalty


def _lib():
    return cuda_lib.load("metrics", {
        "qgt_metrics_update": (_ARGTYPES, ctypes.c_int)})


def metrics_update(last_g: Tensor, last_c: Tensor, scal: Tensor,
                   weights: Sequence[float], track_layers: bool
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Metrics update: the plain version for CPU tensors, kernel B2 for CUDA
    tensors (launched on the current stream; raises if it cannot launch)."""
    if not scal.is_cuda:
        return metrics_update_plain(last_g, last_c, scal, weights,
                                    track_layers)
    B, n = last_g.shape
    for name, t, shape in (("last_g", last_g, (B, n)),
                           ("last_c", last_c, (B, n)), ("scal", scal, (B, 8))):
        if (t.device != scal.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"metrics_update: {name} must be a contiguous "
                             f"int32 {shape} tensor on {scal.device}")
    lib = _lib()
    o_scal = torch.empty_like(scal)
    pen = torch.empty(B, dtype=torch.float32, device=scal.device)
    if track_layers:
        o_lg, o_lc = torch.empty_like(last_g), torch.empty_like(last_c)
        o_lg_p, o_lc_p = cuda_lib.ptr(o_lg), cuda_lib.ptr(o_lc)
    else:
        o_lg, o_lc = last_g, last_c
        o_lg_p = o_lc_p = None
    w0, w1, w2, w3 = (float(x) for x in weights)
    stream = torch.cuda.current_stream(scal.device).cuda_stream
    err = lib.qgt_metrics_update(
        cuda_lib.ptr(last_g), cuda_lib.ptr(last_c), cuda_lib.ptr(scal),
        o_lg_p, o_lc_p, cuda_lib.ptr(o_scal), cuda_lib.ptr(pen), B, n,
        int(bool(track_layers)), w0, w1, w2, w3, stream)
    cuda_lib.check(lib, err, "metrics_update")
    metrics_update.launches += 1
    return o_lg, o_lc, o_scal, pen


metrics_update.launches = 0
