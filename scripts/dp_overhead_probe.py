#!/usr/bin/env python3
"""What a PPO train_step with a one-process mesh costs over the plain step.

    python scripts/dp_overhead_probe.py [--device cuda] [--lanes 2048]
        [--difficulty 8] [--rounds 3] [--artifact clifford_heavy_hex_27q]
        [--out runs/dp_overhead.json]

Starts one process group of one process (NCCL on CUDA, gloo on the CPU,
through a FileStore in a temporary directory), loads the artifact's config
and weights three times, and runs `train_step` in turns on three copies:

- `plain`: no mesh;
- `mesh`: the mesh as the port runs it; at one process `psum`, the
  gradient all-reduce and the lane gathers return their input, so no
  collective runs;
- `forced`: the mesh with every `psum` and the gradient all-reduce issued
  as collectives all the same (what the step costs when they run; at one
  process each is the identity, so the weights stay equal).

Each round is plain, mesh, forced, forced, mesh, plain; after each round the
three copies' weights must be equal (within 1e-6), or the probe fails. It
prints the median wall s a step of each variant over the rounds after the
first, and a torch.profiler count of one more step of each: CUDA kernels,
NCCL kernels and their device µs, the collectives issued, and host synchronisations (runtime calls
named *Synchronize*). It also times, on the host, the mesh accessor the
lane helpers use (`dp_size`) against slicing the mesh by name
(`mesh["dp"].size()`), in µs a call. The result goes to `--out` as JSON
too.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
MODELS = os.path.join(ROOT, "examples", "models")


COLLECTIVES = [0]  # the collectives the forced copies issued


def forced_psum(mesh, x):
    import torch.distributed as dist

    if mesh is None:
        return x
    COLLECTIVES[0] += 1
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.get_group("dp"))
    return out


def forced_all_reduce_grads(mesh, params):
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    if mesh is None:
        return
    COLLECTIVES[0] += 1
    grads = [p.grad for p in params if p.grad is not None]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.get_group("dp"))
    for g, f in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(f)


class Forced:
    """Inside the block, the training code issues its collectives even
    where 'dp' has one process."""

    def __enter__(self):
        from qiskit_gym_torch.rl import algorithm, ppo

        self.saved = (algorithm.psum, algorithm.all_reduce_grads, ppo.psum)
        algorithm.psum = ppo.psum = forced_psum
        algorithm.all_reduce_grads = forced_all_reduce_grads

    def __exit__(self, *exc):
        from qiskit_gym_torch.rl import algorithm, ppo

        algorithm.psum, algorithm.all_reduce_grads, ppo.psum = self.saved


def profile_step(step, sync):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    before = COLLECTIVES[0]
    with profile(activities=acts) as prof:
        step()
        sync()
    kernels = nccl = nccl_us = syncs = 0
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            kernels += 1
            if "nccl" in ev.name.lower():
                nccl += 1
                nccl_us += ev.device_time
        elif "Synchronize" in ev.name:
            syncs += 1
    return {"collectives": COLLECTIVES[0] - before, "cuda_kernels": kernels, "nccl_kernels": nccl,
            "nccl_us": nccl_us, "host_syncs": syncs}


def accessor_us(fn, n=2000):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=2048)
    ap.add_argument("--difficulty", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--artifact", default="clifford_heavy_hex_27q")
    ap.add_argument("--out", default=os.path.join(ROOT, "runs",
                                                  "dp_overhead.json"))
    args = ap.parse_args()

    import contextlib

    import torch
    from qiskit_gym_torch import parallel
    from qiskit_gym_torch.rl import RLSynthesis

    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    store_dir = tempfile.mkdtemp(prefix="qgt_store_")
    parallel.initialize(
        store=torch.distributed.FileStore(os.path.join(store_dir, "s"), 1),
        num_processes=1, process_id=0, backend="nccl" if cuda else "gloo")
    try:
        mesh = parallel.make_mesh()
        paths = (os.path.join(MODELS, args.artifact + ".json"),
                 os.path.join(MODELS, args.artifact + ".pt"))
        copies = {
            "plain": RLSynthesis.from_config_json(*paths, device=args.device),
            "mesh": RLSynthesis.from_config_json(*paths, device=args.device,
                                                 mesh=mesh),
            "forced": RLSynthesis.from_config_json(*paths,
                                                   device=args.device,
                                                   mesh=mesh),
        }
        T = copies["plain"].algorithm._horizon(args.difficulty)

        def step(tag):
            ctx = Forced() if tag == "forced" else contextlib.nullcontext()
            with ctx:
                copies[tag].algorithm.train_step(T, args.lanes,
                                                 args.difficulty)

        secs = {k: [] for k in copies}
        errs = []
        for r in range(args.rounds):
            for tag in ("plain", "mesh", "forced", "forced", "mesh",
                        "plain"):
                sync()
                t0 = time.perf_counter()
                step(tag)
                sync()
                if r:  # the first round is the warm-up
                    secs[tag].append(time.perf_counter() - t0)
            ref = copies["plain"].params
            err = max(float((c.params[k] - v).abs().max())
                      for tag in ("mesh", "forced")
                      for c in (copies[tag],) for k, v in ref.items())
            errs.append(err)
            if err > 1e-6:
                raise AssertionError(f"round {r}: the copies differ by {err}")
        prof = {}
        for tag in copies:
            prof[tag] = profile_step(lambda: step(tag), sync)
        from qiskit_gym_torch.parallel.mesh import dp_size
        accessors = {"dp_size(mesh)": accessor_us(lambda: dp_size(mesh)),
                     'mesh["dp"].size()': accessor_us(
                         lambda: mesh["dp"].size())}
        backend = torch.distributed.get_backend()
    finally:
        parallel.shutdown()
        shutil.rmtree(store_dir, ignore_errors=True)

    out = {"device": (torch.cuda.get_device_name(0) if cuda else "cpu"),
           "backend": backend, "lanes": args.lanes, "T": T,
           "difficulty": args.difficulty, "rounds": args.rounds,
           "step_s": {k: v for k, v in secs.items()},
           "median_step_s": {k: statistics.median(v)
                             for k, v in secs.items() if v},
           "max_params_err": max(errs), "profile": prof,
           "accessor_us": accessors}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
