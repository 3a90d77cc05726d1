#!/usr/bin/env python3
"""Try tile sizes, ring depths and blocks per SM for kernel B2 on the card.

    python3 scripts/tune_metrics_kernel.py [--baseline old_metrics.cu] [--quick]

Needs one CUDA card and nvcc. Builds `qiskit_gym_torch/csrc/metrics.cu` once
per variant with `-DQGT_B2_TILE=..`, `-DQGT_B2_TILE_UNTRACKED=..`,
`-DQGT_B2_STAGES=..` and `-DQGT_B2_BLOCKS_PER_SM=..` (all nvcc processes
started together, into a temporary directory), holds every variant against
`metrics_update_plain` (B=32768, a ragged B=1001, B=3, and a view that is not
16-byte aligned, tracked and untracked: bit-identical or the variant is
reported as wrong), and times it at B=32768, n=27 by replaying a CUDA graph
of one launch per ring entry (median of 20 replays), tracked and untracked,
over a ring of 4 input sets (as `chip_smoke.py` times it) and over a ring of
16 (inputs and outputs well beyond the 50 MB L2). `--baseline` adds another
source with the same C entry point (an earlier version of the kernel) to the
same run, so both are timed on one card in one process. `--quick` builds the
default variant only. Prints one line per variant and, last, a JSON object
with every number and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import b2_inputs, unaligned  # noqa: E402  (seeded operands)

B_BIG, N_QUBITS = 32768, 27
WEIGHTS = (0.01, 0.02, 0.005, 0.001)


class Variant:
    def __init__(self, label, source, defines):
        self.label, self.source, self.defines = label, source, defines
        self.lib = None

    def start_build(self, outdir, cuda_lib):
        self.path = os.path.join(outdir, f"lib{self.label}.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
               *[f"-D{k}={v}" for k, v in self.defines.items()],
               "-I", str(cuda_lib.CSRC), "-o", self.path, self.source]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish_build(self, argtypes):
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"{self.label}: nvcc failed:\n{log}")
        self.lib = ctypes.CDLL(self.path)
        self.lib.qgt_metrics_update.argtypes = argtypes
        self.lib.qgt_metrics_update.restype = ctypes.c_int

    def __call__(self, lg, lc, scal, track, torch):
        B, n = lg.shape
        o_scal = torch.empty_like(scal)
        pen = torch.empty(B, dtype=torch.float32, device=scal.device)
        o_lg = torch.empty_like(lg) if track else lg
        o_lc = torch.empty_like(lc) if track else lc
        p = lambda t: ctypes.c_void_p(t.data_ptr())
        err = self.lib.qgt_metrics_update(
            p(lg), p(lc), p(scal), p(o_lg) if track else None,
            p(o_lc) if track else None, p(o_scal), p(pen), B, n, int(track),
            *WEIGHTS, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.label}: launch failed, CUDA error {err}")
        return o_lg, o_lc, o_scal, pen


def graph_us(fn, ring, torch, reps=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in ring:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in ring:
            fn(x)
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(1e3 * start.elapsed_time(end) / len(ring))
    return statistics.median(samples)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another metrics.cu to time beside")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tune_metrics_kernel: CUDA is not available", file=sys.stderr)
        return 2
    from qiskit_gym_torch.ops import cuda_lib
    from qiskit_gym_torch.ops import metrics_kernel as mk

    src = str(cuda_lib.CSRC / "metrics.cu")
    variants = [Variant("default", src, {})]
    if not args.quick:
        for tile, stages, bps in itertools.product((32, 64, 128, 256),
                                                   (2, 3), (1, 2, 4, 8)):
            # skip rings that cannot be resident: bps blocks of `stages`
            # tracked tiles must fit an SM's 227 KB
            if bps * stages * tile * (2 * N_QUBITS + 8) * 4 > 232448:
                continue
            variants.append(Variant(
                f"E{tile}_S{stages}_P{bps}", src,
                {"QGT_B2_TILE": tile, "QGT_B2_TILE_UNTRACKED": tile,
                 "QGT_B2_STAGES": stages, "QGT_B2_BLOCKS_PER_SM": bps}))
    if args.baseline:
        variants.append(Variant("baseline", args.baseline, {}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    checks = []
    for B, n in ((B_BIG, N_QUBITS), (1001, N_QUBITS), (3, N_QUBITS),
                 (1000, 12), (4097, 5)):
        lg, lc, scal = b2_inputs(B, n, g)
        checks.append((f"B={B} n={n}", lg, lc, scal))
        checks.append((f"B={B} n={n} unaligned", unaligned(lg),
                       unaligned(lc), unaligned(scal)))
    rings = {r: [b2_inputs(B_BIG, N_QUBITS, g) for _ in range(r)]
             for r in (4, 16)}
    out = {"card": smi, "B": B_BIG, "n": N_QUBITS, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for v in variants:
            v.start_build(tmp, cuda_lib)
        for v in variants:
            v.finish_build(mk._ARGTYPES)
            wrong = []
            for what, lg, lc, scal in checks:
                for track in (True, False):
                    got = v(lg, lc, scal, track, torch)
                    want = mk.metrics_update_plain(lg, lc, scal, WEIGHTS,
                                                   track)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        wrong.append(f"{what} track={track}")
            row = {"wrong": wrong}
            for r, ring in rings.items():
                for track in (True, False):
                    row[f"{'tracked' if track else 'untracked'}_us_ring{r}"] \
                        = graph_us(lambda x: v(*x, track, torch), ring, torch)
            out["variants"][v.label] = row
            print(f"{v.label:14s} tracked {row['tracked_us_ring4']:6.2f} / "
                  f"{row['tracked_us_ring16']:6.2f} us, untracked "
                  f"{row['untracked_us_ring4']:6.2f} / "
                  f"{row['untracked_us_ring16']:6.2f} us (ring 4 / ring 16)"
                  + (f"  WRONG: {wrong}" if wrong else ""), flush=True)
    print(json.dumps(out))
    return 1 if any(r["wrong"] for r in out["variants"].values()) else 0


if __name__ == "__main__":
    sys.exit(main())
