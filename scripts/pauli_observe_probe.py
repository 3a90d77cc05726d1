#!/usr/bin/env python3
"""The Pauli observation kernel (`csrc/pauli_observe.cu`) on the card
against its plain version, which is the observation as the env computed it
before the kernel.

    python3 scripts/pauli_observe_probe.py [--variant LABEL=-DNAME=VALUE]
        [--out FILE]

Needs one CUDA card and nvcc. Prints the kernel's ptxas lines, then for the
27q heavy-hex Pauli artifact's core at B=32768 and a 127q Eagle core (every
1q gate, CX both ways on each coupler) at B=4096: over a ring of 4 states
(reset at difficulty 64, then one random step, so rotations are live and
both automorphisms drawn) the kernel against the plain version byte for
byte; the device time of each (median of 20 replays of a CUDA graph of one
call per ring state), the eager call of each (CUDA events, host work
included), the bytes the observation has to move and their time at
3.35 TB/s, a fill of an output-sized buffer (the card's write rate for
them, nothing computed), and the device kernels a call of each launches
(torch.profiler).
Last, the card's name and power limit and a JSON object with every number
(also written to `--out` when given). Each `--variant` builds the source
again with `-D` settings (comma-separated: `QGT_OBSERVE_TILE`, the most envs
a block, `QGT_OBSERVE_THREADS` and `QGT_OBSERVE_SMEM_KB`) into a temporary
directory; on both cores' rings each is held against the plain version and
timed the same way, in turns with the built kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

RING = 4


def eagle_core():
    from qiskit_gym_torch.envs.coupling_maps import eagle_127q
    from qiskit_gym_torch.ops.pauli import PauliEnvCore

    gs = [(g, (q,)) for g in ("H", "S", "Sdg", "SX", "SXdg")
          for q in range(127)]
    gs += [("CX", e) for a, b in eagle_127q() for e in ((a, b), (b, a))]
    return PauliEnvCore(127, gs, device="cuda")


def build_variant(label: str, defines: list, outdir: str):
    """The library of the source built with `defines`, loaded."""
    from qiskit_gym_torch.ops import cuda_lib
    from qiskit_gym_torch.ops import pauli_observe as po

    path = os.path.join(outdir, f"lib{label}.so")
    proc = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *defines, "-o", path,
         str(cuda_lib.CSRC / "pauli_observe.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: nvcc failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(path)
    lib.qgt_error_string.argtypes = [ctypes.c_int]
    lib.qgt_error_string.restype = ctypes.c_char_p
    lib.qgt_pauli_observe.argtypes = po._ARGTYPES
    lib.qgt_pauli_observe.restype = ctypes.c_int
    return lib


def variants(core, batch: int, libs: dict, g) -> dict:
    """Each variant and the built kernel on a ring of `batch` states of
    `core`, in turns: the built kernel, the variants, the variants in
    reverse, the built one."""
    import torch
    from qiskit_gym_torch.ops import pauli_observe as po

    ring = []
    for _ in range(RING):
        st = core.reset(batch, 64, generator=g)
        a = torch.randint(0, core.num_actions + 1, (batch,), generator=g,
                          device="cuda")
        ring.append(core.step(st, a, generator=g))
    saved = po._lib
    times = {label: [] for label in libs}
    order = list(libs) + list(libs)[::-1]
    try:
        for label in order:
            po._lib = lambda lib=libs[label]: lib
            for st in ring:
                if not torch.equal(po.pauli_observe(core, st),
                                   po.pauli_observe_plain(core, st)):
                    raise AssertionError(f"variant {label} differs from "
                                         "the plain version")
            times[label].append(1e3 * cs.graph_ms(
                lambda x: po.pauli_observe(core, x), ring))
    finally:
        po._lib = saved
    for label, us in times.items():
        cs.log(f"  variant {label}, n={core.num_qubits} B={batch}: "
               f"{', '.join(f'{u:.2f}' for u in us)} us")
    return times


def device_kernels(fn, st) -> int:
    """Device kernels one call of `fn(st)` launches, by the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(st)
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA)


def measure(name: str, core, batch: int, g) -> dict:
    import torch
    from qiskit_gym_torch.ops import pauli_observe as po

    ring = []
    for _ in range(RING):
        st = core.reset(batch, 64, generator=g)
        a = torch.randint(0, core.num_actions + 1, (batch,), generator=g,
                          device="cuda")
        ring.append(core.step(st, a, generator=g))
    for i, st in enumerate(ring):
        if not torch.equal(po.pauli_observe(core, st),
                           po.pauli_observe_plain(core, st)):
            raise AssertionError(f"{name}: the kernel differs from the "
                                 f"plain version on ring state {i}")

    def kernel(st):
        return po.pauli_observe(core, st)

    def plain(st):
        return po.pauli_observe_plain(core, st)

    st, out = ring[0], kernel(ring[0])
    r = {"B": batch, "n": core.num_qubits, "W2": core.W2, "Wn": core.Wn,
         "RT": core.RT, "R": core.R, "perms": core.num_perms,
         "bytes": cs.nbytes(st.tab, st.rx, st.rz, st.active, st.perm_idx,
                            out)}
    r["bound_us"] = 1e6 * r["bytes"] / cs.HBM_BYTES_PER_S
    r["kernel_us"] = 1e3 * cs.graph_ms(kernel, ring)
    r["plain_us"] = 1e3 * cs.graph_ms(plain, ring)
    r["kernel_eager_us"] = 1e3 * cs.time_ms(kernel, ring)
    r["plain_eager_us"] = 1e3 * cs.time_ms(plain, ring)
    r["bound_share_pct"] = 100 * r["bound_us"] / r["kernel_us"]
    # a yardstick: a fill of an output-sized buffer, the rate the card
    # writes these bytes at with nothing computed
    buf = torch.empty_like(out)
    r["fill_us"] = 1e3 * cs.graph_ms(lambda st: buf.fill_(1), ring)
    r["kernel_launches"] = device_kernels(kernel, st)
    r["plain_launches"] = device_kernels(plain, st)
    cs.log(f"  {name} B={batch}: kernel {r['kernel_us']:.2f} us (graph), "
           f"eager {r['kernel_eager_us']:.2f} us, {r['kernel_launches']} "
           f"device kernel(s); plain {r['plain_us']:.2f} us (graph), eager "
           f"{r['plain_eager_us']:.2f} us, {r['plain_launches']} device "
           f"kernels; bound {r['bound_us']:.2f} us ({r['bytes'] / 1e6:.1f} "
           f"MB), {r['bound_share_pct']:.1f} % of it; a fill of the output "
           f"{r['fill_us']:.2f} us")
    return r


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="LABEL=-DNAME=VALUE[,-DNAME=VALUE]")
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args()
    import torch
    from qiskit_gym_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        print("pauli_observe_probe: CUDA is not available", file=sys.stderr)
        return 2
    secs = cuda_lib.build(["pauli_observe"])
    for line in cuda_lib.BUILD_LOGS.get("pauli_observe", "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  pauli_observe.cu ptxas: {line.strip()}")
    smi = cs.nvidia_smi_line()
    cs.log(f"  built in {secs:.2f} s; card: {smi}; torch {torch.__version__}")
    g = torch.Generator(device="cuda")
    g.manual_seed(20)
    result = {
        "card": smi,
        "pauli_heavy_hex_27q": measure(
            "pauli_heavy_hex_27q", cs.load_core("pauli_heavy_hex_27q"),
            cs.B_BIG, g),
        "eagle_127q": measure("eagle_127q", eagle_core(), 4096, g),
    }
    if args.variant:
        from qiskit_gym_torch.ops import pauli_observe as po

        tmp = tempfile.mkdtemp(prefix="qgt_observe_probe_")
        libs = {"built": po._lib()}
        for spec in args.variant:
            label, defines = spec.split("=", 1)
            libs[label] = build_variant(label, defines.split(","), tmp)
        result["variants"] = {
            "pauli_heavy_hex_27q": variants(
                cs.load_core("pauli_heavy_hex_27q"), cs.B_BIG, libs, g),
            "eagle_127q": variants(eagle_core(), 4096, libs, g)}
    cs.log(smi)
    line = json.dumps(result)
    cs.log(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
