#!/usr/bin/env python3
"""Time one batched MCTS search of the PyTorch port at the width of a
shipped AlphaZero artifact, and count its kernel launches.

    python3 scripts/mcts_search_probe.py [--device cuda|cpu]
        [--artifact az_clifford_heavy_hex_27q] [--lanes 256] [--sims 64]
        [--difficulty 8] [--moves 2]

Loads the artifact with its weights, resets `--lanes` seeded states at
`--difficulty`, runs one warm-up search of 4 simulations and then `--moves`
full searches under a host clock that ends in a synchronize; then one more
search under torch.profiler (on CUDA) for the number of kernel launches per
simulation, the device-busy share and the share of the hand-written
kernels. Prints one JSON line. On the CPU it runs the plain versions, at
whatever size is asked for: keep that small.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MODELS = os.path.join(ROOT, "examples", "models")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--artifact", default="az_clifford_heavy_hex_27q")
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--sims", type=int, default=64)
    ap.add_argument("--difficulty", type=int, default=8)
    ap.add_argument("--moves", type=int, default=2)
    args = ap.parse_args()

    import torch
    from qiskit_gym_torch.rl import RLSynthesis, mcts_search

    cuda = args.device == "cuda"
    rls = RLSynthesis.from_config_json(
        os.path.join(MODELS, args.artifact + ".json"),
        os.path.join(MODELS, args.artifact + ".pt"), device=args.device)
    core, policy = rls.env.core, rls.algorithm.policy
    g = torch.Generator(device=core.device)
    g.manual_seed(1)
    state = core.reset(args.lanes, args.difficulty, generator=g)
    depth = min(core.max_depth, 32)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def search(sims):
        return mcts_search(core, policy, state, sims, 1.41, depth,
                           generator=g)

    search(4)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    samples = []
    for _ in range(args.moves):
        t0 = time.perf_counter()
        visits, value, _ = search(args.sims)
        sync()
        samples.append(time.perf_counter() - t0)
    assert bool((visits.sum(-1) == args.sims).all())
    assert bool(torch.isfinite(value).all())
    out = {"artifact": args.artifact, "device": args.device,
           "lanes": args.lanes, "sims": args.sims,
           "difficulty": args.difficulty,
           "move_seconds": samples,
           "ms_per_sim": 1e3 * min(samples) / args.sims}
    if cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        out["device_name"] = torch.cuda.get_device_name(0)
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            search(args.sims)
            sync()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kernels = [(ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total]
        busy = sum(k[0] for k in kernels)
        own = sum(k[0] for k in kernels
                  if "fused_step" in k[1] or "metrics" in k[1]
                  or "apply_kernel" in k[1])
        out.update(
            profiled_wall_us=wall_us, device_busy_us=busy,
            device_busy_share=busy / wall_us,
            launches_per_sim=sum(k[2] for k in kernels) / args.sims,
            own_kernels_share_of_device=own / max(busy, 1e-9),
            top=[{"kernel": n[:70], "us": us, "count": c}
                 for us, n, c in sorted(kernels, reverse=True)[:6]])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
