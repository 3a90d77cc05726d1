#!/usr/bin/env python3
"""Kernel B1's wide kernels (W >= 3) on the card: registers, occupancy,
bit-for-bit checks and device times, against an earlier version and against
a copy of the same bytes.

    python3 scripts/wide_kernel_probe.py [--baseline LABEL=old/fused_step.cu]
        [--variant LABEL=-DQGT_B1_WIDE_UNROLL=8] [--out FILE]

Needs one CUDA card and nvcc. Builds `qiskit_gym_torch/csrc/fused_step.cu`;
each `--baseline` adds another source with the same C entry points (an
earlier version of the kernel, e.g. from a `git archive` of an earlier
commit unpacked under `runs/`) and each `--variant` the current source with
`-D` settings (comma-separated; `QGT_B1_WIDE_THREADS`, `QGT_B1_WIDE_UNROLL`),
all nvcc processes started together into a temporary directory. Prints each
wide kernel's ptxas line (registers, spills) and, for the current source and
its variants, the occupancy calculator's resident blocks an SM. Then, on the
JAX package's `bench.py --scale` shapes (Clifford on
the 127-qubit line at B=8192, W=8, and on the 433-qubit line at B=1024,
W=28; `chip_smoke.scale_run`'s ring of 4 cold states from reset at
difficulty 8), it holds each version's step (tracked and untracked) and
apply part against the plain versions, bit for bit, and times them by
replaying a CUDA graph of one call per ring entry (median of 20 replays),
in turns: the copy, each version in order, then each again in reverse
order, and the copy again. The copy is
`o_a.copy_(a); o_ainv.copy_(ainv)` on the same tensors, captured the same
way: it computes nothing of the step and moves the same bytes, the rate the
card reaches for them. Prints one line per measurement, the card's name and
power limit, and last a JSON object with every number (also written to
`--out` when given).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (timing helpers, cores, bounds)

SHAPES = ((127, 8192), (433, 1024))   # (qubits on the line, B)


def start_build(label: str, source: str, outdir: str, cuda_lib,
                defines=()):
    path = os.path.join(outdir, f"lib{label}.so")
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *defines, "-I",
           os.path.dirname(os.path.abspath(source)), "-o", path, source]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return label, proc, path


def finish_build(label, proc, path, fs):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: nvcc failed:\n{log}")
    lib = ctypes.CDLL(path)
    lib.qgt_error_string.argtypes = [ctypes.c_int]
    lib.qgt_error_string.restype = ctypes.c_char_p
    for fn, (argtypes, restype) in {
            "qgt_fused_step": (fs._STEP_ARGTYPES, ctypes.c_int),
            "qgt_apply_gates": (fs._APPLY_ARGTYPES, ctypes.c_int)}.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    if hasattr(lib, "qgt_wide_occupancy"):
        lib.qgt_wide_occupancy.argtypes = fs._OCCUPANCY_ARGTYPES
        lib.qgt_wide_occupancy.restype = ctypes.c_int
    return lib, log


def ptxas_wide(log: str) -> dict:
    """{kernel: 'Used N registers ...; spills'} for the wide kernels."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and "wide" in name and ("registers" in line
                                        or "spill" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1]
                         .strip()).strip()
    return out


def with_lib(fs, lib, fn):
    """`fn` with the wrappers of ops/fused_step.py calling `lib`."""
    def run(*args):
        saved = fs._lib
        fs._lib = lambda: lib
        try:
            return fn(*args)
        finally:
            fs._lib = saved
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="LABEL=path of an earlier fused_step.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL=-DNAME=VALUE[,-DNAME=VALUE]")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wide_kernel_probe: CUDA is not available", file=sys.stderr)
        return 2
    from qiskit_gym_torch.ops import cuda_lib
    from qiskit_gym_torch.ops import fused_step as fs

    smi = cs.nvidia_smi_line()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    tmp = tempfile.mkdtemp(prefix="qgt_wide_probe_")
    source = str(cuda_lib.CSRC / "fused_step.cu")
    builds = [start_build(*b.split("=", 1), tmp, cuda_lib)
              for b in args.baseline]
    for v in args.variant:
        label, defines = v.split("=", 1)
        builds.append(start_build(label, source, tmp, cuda_lib,
                                  defines.split(",")))
    builds.append(start_build("current", source, tmp, cuda_lib))
    ours = ["current"] + [v.split("=", 1)[0] for v in args.variant]
    libs, report = {}, {"card": smi, "ptxas": {}, "occupancy": {},
                        "shapes": {}}
    for label, proc, path in builds:
        libs[label], log = finish_build(label, proc, path, fs)
        report["ptxas"][label] = ptxas_wide(log)
        for k, v in report["ptxas"][label].items():
            cs.log(f"  {label} ptxas {k}: {v}")
    labels = list(libs)
    order = ["copy"] + labels + labels[::-1] + ["copy"]

    g = torch.Generator(device="cuda")
    g.manual_seed(cs.LARGE_SEED)
    for n, B in SHAPES:
        core = cs.line_gym("clifford", n)[0].core
        W, Dr = core.W, core.dim
        occ = {k: fs.wide_occupancy(W, Dr, libs[k]) for k in ours}
        report["occupancy"][n] = occ
        cs.log(f"clifford_{n}q_line (dim {Dr}, W={W}, B={B}): occupancy "
               f"{occ}")
        ring = []
        for _ in range(4):
            st = core.reset(B, 8, generator=g)
            a = torch.randint(0, core.num_actions + 1, (B,), generator=g,
                              device="cuda")
            f = torch.rand(B, generator=g, device="cuda") < 0.5
            ring.append((st, a, f))
        st, a, f = ring[0]
        for label, lib in libs.items():  # bit for bit, tracked and not
            for track in (False, True):
                core.track_layers = track
                got = with_lib(fs, lib, fs.fused_step)(core, st, a, f)
                cs.assert_identical(got, fs.fused_step_plain(core, st, a, f),
                                    f"{label} step {n}q track={track}")
            core.track_layers = False
            ka, ki = with_lib(fs, lib, fs.apply_gates)(core, st.a, st.ainv,
                                                       a)
            pa, pi = fs.apply_plain(core.op_tab[a], st.a, st.ainv, W, Dr,
                                    True)
            if not (torch.equal(ka, pa) and torch.equal(ki, pi)):
                raise AssertionError(f"{label} apply {n}q differs")
        cs.log(f"  every version's step and apply bit-identical to the "
               f"plain versions")

        o_a, o_ainv = torch.empty_like(st.a), torch.empty_like(st.ainv)

        def copy(x):
            o_a.copy_(x[0].a)
            o_ainv.copy_(x[0].ainv)

        step_bytes = 4 * cs.nbytes(st.a)
        times = {"copy": [], "step": {k: [] for k in libs},
                 "apply": {k: [] for k in libs}}
        for label in order:
            if label == "copy":
                times["copy"].append(cs.graph_ms(copy, ring))
                continue
            lib = libs[label]
            times["step"][label].append(cs.graph_ms(with_lib(
                fs, lib, lambda x: fs.fused_step(core, *x)), ring))
            times["apply"][label].append(cs.graph_ms(with_lib(
                fs, lib, lambda x: fs.apply_gates(core, x[0].a, x[0].ainv,
                                                  x[1])), ring))
        bound_ms = 1e3 * step_bytes / cs.HBM_BYTES_PER_S
        cs.log(f"  bound (a and ainv read and written once, "
               f"{step_bytes / 1e6:.1f} MB at 3.35 TB/s): "
               f"{1e3 * bound_ms:.2f} us")
        cs.log(f"  copy: {[round(1e3 * t, 2) for t in times['copy']]} us")
        for kind in ("step", "apply"):
            for label in libs:
                us = [round(1e3 * t, 2) for t in times[kind][label]]
                share = [round(100 * bound_ms / t, 1)
                         for t in times[kind][label]]
                cs.log(f"  {kind} {label}: {us} us ({share} % of the bound)")
        report["shapes"][n] = {"B": B, "W": W, "dim": Dr,
                               "bytes": step_bytes, "bound_ms": bound_ms,
                               "order": order, "times_ms": times}
        del ring, o_a, o_ainv
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    cs.log(smi)
    cs.log(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
