"""Batched env steps a second on one card.

Port of the JAX package's `bench.py`. Headline configuration: the four env
families on the 27-qubit heavy-hex coupling map (BASELINE.json config #3/#5
scale) with full training semantics (the metrics and reward update, a 50 %
random inversion where the core has `add_inverts`, the Pauli core's rotation
tracking and automorphism draw), B device-resident envs a family, K steps of
random actions. Every draw is made up front on the device from one seeded
generator; the K steps then run through `ops/lanes.py:env_step`.

The JAX package runs the K steps as one jitted scan. Here they run as the
Python loop that the library's collectors run, with no CUDA graph and no
`torch.compile`: a matrix step is one launch of kernel B1, so those three
families measure the card's step; a Pauli step launches B2 and the
transition kernel (`ops/pauli_step.py`) among a handful of small torch ops
(the action's translation, the metrics operands), so the Pauli family still
measures the host more than the card.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"card"}. `vs_baseline` is value / 1e7, BASELINE.json's north-star target
(not a measurement); `card` is `nvidia-smi`'s name and power limit. Per
family on stderr: the rate, the median and spread of the repeats, kernel
B1's and B2's launches a step and, on the card, the device's time and
kernels a step from a `torch.profiler` run of PROFILE_STEPS steps, and its
busy share: that time over the median run's time a step.

Usage: python -m qiskit_gym_torch.tools.bench [B] [K] [--mesh | --scale]
       [--device cuda|cpu]
       torchrun --nproc-per-node N -m qiskit_gym_torch.tools.bench --mesh

`--mesh` runs the same bench over the 'dp' axis of `parallel/mesh.py`
(B = 32768 lanes a card and K = 128 under NCCL, 2048 a process and K = 32
under gloo on the CPU); a lone process runs over a group of one. `--scale`
runs Clifford on the 127- and 433-qubit lines (stderr only).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from time import perf_counter

import numpy as np
import torch

from qiskit_gym_torch import parallel
from qiskit_gym_torch.envs import (CliffordGym, LinearFunctionGym, PauliGym,
                                   PermutationGym)
from qiskit_gym_torch.examples._common import HEAVY_HEX_27
from qiskit_gym_torch.ops import fused_step as fs
from qiskit_gym_torch.ops import metrics_kernel as mk
from qiskit_gym_torch.ops.lanes import draw_step_noise, env_step
from qiskit_gym_torch.ops.pauli import PauliEnvCore
from qiskit_gym_torch.parallel.mesh import (dp_size, shard_env_state,
                                           shard_lanes)
from qiskit_gym_torch.utils.device import resolve_device

NORTH_STAR = 1e7  # steps/sec (BASELINE.json)
DIFFICULTY = 8
FAMILIES = {
    "clifford_27q_heavy_hex": (CliffordGym, {}),
    "linear_function_27q": (LinearFunctionGym, {}),
    "permutation_27q": (PermutationGym, {}),
    # pauli_diff_scale=8 (the native core's default): the difficulty-8 reset
    # then carries one active rotation a lane, so the workload includes
    # rotation tracking (the gym's default of 16 would reset rotation-free)
    "pauli_network_27q": (PauliGym, {"max_rotations": 5,
                                     "pauli_diff_scale": 8}),
}
SCALE = ((127, 8192), (433, 1024))   # (qubits on the line, B)
SCALE_STEPS = 32
PROFILE_STEPS = 16


def family_core(name: str, device=None):
    gym, kw = FAMILIES[name]
    return gym.from_coupling_map(HEAVY_HEX_27, max_depth=128, device=device,
                                 **kw).core


def draw(core, B: int, K: int, generator):
    """(actions, flips, perms) for K steps of B lanes: actions [K, B] in
    [0, num_actions), flips [K, B] (fair coins, all False without
    add_inverts), perms [K, B] for a core with automorphisms, else None."""
    actions = torch.randint(0, core.num_actions, (K, B), generator=generator,
                            device=core.device)
    return (actions, *draw_step_noise(core, generator, (K, B)))


def run_steps(core, state, actions, flips, perms=None):
    """bench.py's scan body: one env step a row of the draws."""
    for t in range(actions.shape[0]):
        state = env_step(core, state, actions[t], flips[t],
                         None if perms is None else perms[t])
    return state


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(core, state, draws) -> dict:
    """The first PROFILE_STEPS steps of `draws` under torch.profiler: the
    device's time (kernels and copies) and its kernels a step, from the
    trace's raw device events, and of those the launches of kernels B1
    (`fused_step*`) and B2 (`metrics_kernel`) a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = min(PROFILE_STEPS, draws[0].shape[0])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_steps(core, state, *(None if x is None else x[:steps]
                                 for x in draws))
        _sync(core.device)
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA]

    def traced(tag):
        return sum(tag in ev.name() for ev in events) / steps

    return {"device_s_per_step": 1e-9 * sum(
                ev.duration_ns() for ev in events) / steps,
            "kernels_per_step": len(events) / steps,
            "traced_b1_b2": (traced("fused_step"), traced("metrics_kernel"))}


def measure_core(core, B: int, K: int, repeats: int = 3, mesh=None,
                 generator=None, profile: bool = False) -> dict:
    """bench_core's run and what it saw. One reset at difficulty 8, then a
    warm-up run and `repeats` timed runs of K steps, each from that same
    reset state with a fresh draw made before its clock starts. With
    `mesh`, every process draws the global reset and draws for B lanes and
    steps its block of them. Returns the rate B * K / min(times), the
    times, B1's and B2's launches a step over the timed runs, the last
    run's final state (this process's lanes) and, with `profile` on the
    card, `_profile` of the last draw's first steps and the device's busy
    share: its time a step over the median timed run's time a step (the
    profiled run's own wall time holds the profiler's cost), or None where
    the trace does not hold every launch of B1 and B2."""
    dev = core.device
    g = generator if generator is not None else torch.Generator(
        device=dev).manual_seed(0)

    def local_draw():
        return tuple(None if x is None else shard_lanes(mesh, x, 1)
                     for x in draw(core, B, K, g))

    start = shard_env_state(mesh, core.reset(B, DIFFICULTY, generator=g))
    run_steps(core, start, *local_draw())   # warm-up
    b1, b2 = fs.fused_step.launches, mk.metrics_update.launches
    times = []
    for _ in range(repeats):
        draws = local_draw()
        _sync(dev)
        t0 = perf_counter()
        state = run_steps(core, start, *draws)
        _sync(dev)
        times.append(perf_counter() - t0)
    steps = repeats * K
    out = {"steps_per_s": B * K / min(times), "times": times,
           "b1_per_step": (fs.fused_step.launches - b1) / steps,
           "b2_per_step": (mk.metrics_update.launches - b2) / steps,
           "state": state, "B": B, "K": K}
    if profile and dev.type == "cuda":
        out.update(_profile(core, start, draws))
        seen = out["traced_b1_b2"] == (out["b1_per_step"],
                                       out["b2_per_step"])
        out["busy_share"] = (out["device_s_per_step"] * K
                             / statistics.median(times) if seen else None)
    return out


def bench_core(core, B: int, K: int, repeats: int = 3, mesh=None,
               generator=None) -> float:
    """Steps/sec for K random-action steps over B envs with full training
    semantics (`measure_core`). With `mesh`, the env batch is split over
    its 'dp' axis (the rollout-DP layout of parallel/mesh.py)."""
    return measure_core(core, B, K, repeats, mesh, generator)["steps_per_s"]


def check_launches(name: str, core, r: dict) -> None:
    """On the card, a matrix step is one launch of kernel B1 and a Pauli
    step one launch of kernel B2."""
    if core.device.type != "cuda":
        return
    want = ((0.0, 1.0) if isinstance(core, PauliEnvCore) else (1.0, 0.0))
    if (r["b1_per_step"], r["b2_per_step"]) != want:
        raise RuntimeError(
            f"{name}: {r['b1_per_step']} B1 and {r['b2_per_step']} B2 "
            f"launches a step, expected {want[0]} and {want[1]}")


def card_line(device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip()


def report(name: str, r: dict) -> None:
    """bench.py's stderr line for a family, and what the port adds."""
    v, times = r["steps_per_s"], r["times"]
    print(f"  {name}: {v / 1e6:.2f}M steps/s", file=sys.stderr)
    if "busy_share" not in r:
        busy = "device busy share not measured"
    elif r["busy_share"] is None:
        busy = ("device busy share not measured: the trace holds "
                "{:g} B1 and {:g} B2 launches a step".format(
                    *r["traced_b1_b2"]))
    else:
        busy = (f"device busy {100 * r['busy_share']:.1f} % "
                f"({1e6 * r['device_s_per_step']:.1f} us a step), "
                f"{r['kernels_per_step']:.1f} device kernels a step")
    median = r["B"] * r["K"] / statistics.median(times)
    print(f"    B={r['B']} K={r['K']}: median {median / 1e6:.2f}M steps/s, "
          f"runs {min(times) * 1e3:.2f}-{max(times) * 1e3:.2f} ms "
          f"({len(times)}); B1 {r['b1_per_step']:g}, B2 "
          f"{r['b2_per_step']:g} launches a step; {busy}", file=sys.stderr)


def run_families(B: int, K: int, device=None, mesh=None,
                 log: bool = True) -> dict:
    """measure_core on each family (profiled), its launches checked; the
    stats by family, each final state replaced by whether its rewards are
    finite."""
    results = {}
    for name in FAMILIES:
        core = family_core(name, device)
        r = measure_core(core, B, K, mesh=mesh, profile=True)
        check_launches(name, core, r)
        r["rewards_finite"] = bool(torch.isfinite(r.pop("state").reward)
                                   .all())
        results[name] = r
        if log:
            report(name, r)
    return results


def geomean(results: dict) -> float:
    vals = [r["steps_per_s"] for r in results.values()]
    return float(np.prod(vals)) ** (1.0 / len(vals))


def main(B=None, K: int = 128, device=None):
    """The headline: the four 27q families at B (32768) and K; prints its
    JSON line and returns (line, stats by family)."""
    dev = resolve_device(device)
    results = run_families(B or 32768, K, dev)
    value = geomean(results)
    line = {
        "metric": (
            "batched env steps/sec/chip, geomean over the four 27q "
            "heavy-hex env families (full training semantics incl. "
            "metrics, random inversion, Pauli rotation tracking)"
        ),
        "value": round(value, 1),
        "unit": "steps/sec",
        "vs_baseline": round(value / NORTH_STAR, 4),
        "card": card_line(dev),
    }
    print(json.dumps(line), flush=True)
    return line, results


def main_mesh(mesh=None, device=None):
    """`--mesh`: the same bench with the lanes split over 'dp' of `mesh`,
    or of a mesh over the group that `parallel.initialize()` joins (a
    group of one for a lone process), which it leaves at the end. Runs on
    the card over NCCL unless `device` is "cpu" (gloo); a group joined
    with the other backend raises. The primary process prints the JSON
    line; returns (line, stats by family)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    backend = "nccl" if on_card else "gloo"
    store_dir = None
    owned = mesh is None
    if owned:
        parallel.initialize(backend=backend)
        if not dist.is_initialized():   # a lone process: a group of one
            store_dir = tempfile.mkdtemp(prefix="qgt_bench_")
            parallel.initialize(
                store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                num_processes=1, process_id=0, backend=backend)
    try:
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"bench --mesh on {dev} needs a {backend} process group, "
                f"joined with {dist.get_backend()}")
        if on_card and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if mesh is None:
            mesh = parallel.make_mesh()
        ndev = dp_size(mesh)
        # per-device lane width 32768 on a card; the CPU run stays small
        B = (32768 if on_card else 2048) * ndev
        K = 128 if on_card else 32
        primary = parallel.is_primary()
        results = run_families(B, K, dev, mesh=mesh, log=primary)
        value = geomean(results)
        line = {
            "metric": (
                f"batched env steps/sec dp-sharded over {ndev} "
                f"{'GPU' if on_card else 'VIRTUAL CPU'} devices, "
                "geomean over the four 27q heavy-hex env families "
                "(full training semantics)"
            ),
            "value": round(value, 1),
            "unit": "steps/sec",
            "devices": ndev,
            "hardware": "gpu" if on_card else "virtual-cpu-mesh",
            "vs_baseline": round(value / NORTH_STAR, 4),
            "card": card_line(dev),
        }
        if primary:
            print(json.dumps(line), flush=True)
        return line, results
    finally:
        if owned:
            parallel.shutdown()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)


def scale_sweep(device=None) -> dict:
    """`--scale` (stderr only): Clifford on the 127- and 433-qubit lines,
    bitpacked (254 x 254 and 866 x 866 bits, W = 8 and 28 words a column),
    at batch widths that fit the card; stats by qubit count."""
    out = {}
    for n, B in SCALE:
        line = [(i, i + 1) for i in range(n - 1)]
        core = CliffordGym.from_coupling_map(line, max_depth=128,
                                             device=device).core
        r = measure_core(core, B, SCALE_STEPS)
        check_launches(f"clifford_{n}q_line", core, r)
        print(f"  clifford_{n}q_line (B={B}): "
              f"{r['steps_per_s'] / 1e6:.2f}M steps/s", file=sys.stderr)
        del r["state"]
        out[n] = r
    return out


def cli(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", nargs="?", type=int, default=None)
    p.add_argument("K", nargs="?", type=int, default=128)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--mesh", action="store_true")
    mode.add_argument("--scale", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.scale:
        scale_sweep(args.device)
    elif args.mesh:
        main_mesh(device=args.device)
    else:
        main(args.B, args.K, args.device)


if __name__ == "__main__":
    cli()
