"""Kernel B1's whole step against the plain step on the card.

Port of the JAX package's `scripts/bench_fused.py`. For each 27q heavy-hex
matrix family (Clifford: dim 54, W = 2; permutation and linear function:
dim 27, W = 1), `bench_core` twice: once through the plain PyTorch step
(`ops/fused_step.py` `fused_step_plain`, the counterpart of the JAX
script's XLA step) and once through kernel B1. Both packages default to
the bitpacked state, so the JAX script's forced-bitpack row occurs only
for a family whose default is dense.

Usage: python -m qiskit_gym_torch.tools.bench_fused [B] [K]
       [--device cuda|cpu]   (defaults 32768, 128)

Prints one line per (family, variant) and the ratio per family.
"""

from __future__ import annotations

import argparse
import time

import torch

from qiskit_gym_torch.ops.fused_step import fused_step_plain
from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore

from .bench import family_core, measure_core

MATRIX_FAMILIES = (("clifford", "clifford_27q_heavy_hex"),
                   ("permutation", "permutation_27q"),
                   ("linear", "linear_function_27q"))


class PlainStep:
    """`core` with its step through `fused_step_plain`: no kernel runs."""

    def __init__(self, core):
        self._core = core

    def __getattr__(self, name):
        return getattr(self._core, name)

    def step(self, state, action, generator=None, invert_override=None,
             actual_override=None):
        flip = self._core._flips(state.batch, generator, invert_override)
        return fused_step_plain(self._core, state, action.to(torch.int64),
                                flip)


def run(tag: str, core, B: int, K: int, b1_per_step: float) -> float:
    """bench_core's rate for one variant, its line printed; on the card,
    fails unless B1 ran `b1_per_step` times a step."""
    r = measure_core(core, B, K)
    if core.device.type == "cuda" and r["b1_per_step"] != b1_per_step:
        raise RuntimeError(f"{tag}: {r['b1_per_step']} B1 launches a step, "
                           f"expected {b1_per_step}")
    v = r["steps_per_s"]
    print(f"  {tag:42s} {v / 1e6:8.2f}M steps/s", flush=True)
    return v


def main(B: int = 32768, K: int = 128, device=None) -> dict:
    """(plain, kernel) steps/s by family."""
    t0 = time.time()
    results = {}
    for kind, name in MATRIX_FAMILIES:
        base = family_core(name, device)
        print(f"{kind} 27q heavy-hex (dim {base.dim}):", flush=True)
        plain = run(f"plain step (bitpack={base.bitpack})",
                    PlainStep(base) if base.bitpack else base, B, K, 0.0)
        packed = base if base.bitpack else MatrixEnvCore(
            base.num_qubits, base.gateset, kind, bitpack=True,
            device=base.device)
        if not base.bitpack:
            run(f"plain step forced bitpack (W={packed.W})",
                PlainStep(packed), B, K, 0.0)
        fused = run(f"B1 kernel step (W={packed.W})", packed, B, K, 1.0)
        results[kind] = (plain, fused)
        print(f"  -> B1 is {fused / plain:.2f}x the plain step", flush=True)
    print(f"total {time.time() - t0:.0f}s")
    return results


def cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", nargs="?", type=int, default=32768)
    p.add_argument("K", nargs="?", type=int, default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    main(args.B, args.K, args.device)


if __name__ == "__main__":
    cli()
