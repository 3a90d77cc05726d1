"""What a kernel or a policy forward must move or compute, from its shapes,
and the card's published peaks.

The bytes of a kernel count each input it needs read once and each output
written once, from the step's inputs and outputs, whatever the kernel
implementing them reads again. The check values are the bounds of the
port's kernel table at B = 32768 on the 27q heavy-hex Clifford env (W = 2
words a column, dim 54): kernel B1 58.0 MB (17.30 us at 3.35 TB/s), kernel
B2 16.4 MB tracked and 2.2 MB untracked.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM (80 GB HBM3), published dense rates at 700 W.
PEAK_FP32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # bytes/s


def b1_bytes(B: int, W: int, dim: int, n: int, track: bool = False,
             invert: bool = True) -> int:
    """One matrix env step (B1, `fused_step_kernel`) of B envs: it reads the
    int64 action, the packed matrix (W words of 4 bytes a column), depth
    and the 2q and gate counts, with inversion the flip, the inverse matrix
    and the inverted flag; with layer tracking the last-layer rows and their
    maxima. It writes the same state, with success and reward."""
    words = 4 * W * dim
    scal = 4 + 4 + 4                         # depth, n_cnots, n_gates
    layers = (2 * 4 * n + 2 * 4) if track else 0
    read = 8 + words + scal + layers + ((1 + words + 1) if invert else 0)
    written = words + scal + 1 + 4 + layers + ((words + 1) if invert else 0)
    return B * (read + written)


def b2_bytes(B: int, n: int, track: bool) -> int:
    """One metrics update (B2, `metrics_kernel`) of B envs: eight int32
    scalars read and written, the float32 penalty written, and with layer
    tracking the two int32 [n] last-layer rows read and written."""
    return B * (2 * 8 * 4 + 4 + (4 * 4 * n if track else 0))


def linear_flops(widths: Sequence[int]) -> int:
    """2 * sum(in * out) over a chain of Linear layers of these widths."""
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def policy_flops(obs_size: int, embedding: int, common: Sequence[int],
                 num_actions: int, policy_layers: Sequence[int] = (),
                 value_layers: Sequence[int] = (), copies: int = 1) -> int:
    """Forward FLOPs of one row of `BasicPolicy` (torso, action head and
    value head), times the symmetry copies the policy bundle runs."""
    torso = [obs_size, embedding, *common]
    return copies * (linear_flops(torso)
                     + linear_flops([torso[-1], *policy_layers, num_actions])
                     + linear_flops([torso[-1], *value_layers, 1]))


def roofline_share(nbytes: float, seconds: float) -> float:
    """Percent of the HBM roofline: the least time the bytes need over the
    time taken."""
    return 100.0 * nbytes / PEAK_HBM_BYTES / seconds


def mfu(flops: float, seconds: float) -> float:
    """Percent of the float32 peak."""
    return 100.0 * flops / PEAK_FP32_FLOPS / seconds
