#!/usr/bin/env python3
"""Host seconds to build the port's Clifford gym on an n-qubit line.

    python scripts/line_build_probe.py [qubits ...]       (default 127 433)

For each width it prints, on the CPU of the machine it runs on: the
automorphism search of the line's coupling graph by the native enumerator
(`utils/native.py`, `csrc/vf2.cpp`) and by the pure-Python one
(`spec/symmetry.py`), each with the number of automorphisms found (a line
has 2), then the whole `CliffordGym.from_coupling_map(line, device="cpu")`:
the spec twin with its twists and the bitpacked core with its op table. The
gym takes the native enumerator wherever a C++ compiler exists.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(widths):
    from qiskit_gym_torch.envs import CliffordGym
    from qiskit_gym_torch.spec import symmetry
    from qiskit_gym_torch.utils import native

    native.build()
    for n in widths:
        line = [(i, i + 1) for i in range(n - 1)]
        adj = symmetry._adjacency(n, [("CX", e) for e in line])
        t0 = time.perf_counter()
        found = native.graph_automorphisms(n, adj)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = symmetry._python_automorphisms(n, adj)
        t_python = time.perf_counter() - t0
        if found is not None and found != python:
            raise AssertionError(f"{n}q: the two enumerators disagree")
        print(f"{n}q line: native enumerator "
              f"{'unavailable' if found is None else f'{t_native:.3f} s'}, "
              f"pure Python {t_python:.3f} s ({len(python)} automorphisms)",
              flush=True)
        t0 = time.perf_counter()
        gym = CliffordGym.from_coupling_map(line, device="cpu")
        t_gym = time.perf_counter() - t0
        print(f"{n}q line: CliffordGym build {t_gym:.3f} s (dim "
              f"{gym.core.dim}, W={gym.core.W}, {gym.core.num_actions} "
              "actions)", flush=True)


if __name__ == "__main__":
    main([int(x) for x in sys.argv[1:]] or [127, 433])
