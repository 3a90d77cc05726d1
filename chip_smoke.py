#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`qiskit_gym_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It imports
nothing of JAX or of the JAX package. Phases, each printed as it runs:

1. build the three hand-written kernels from `qiskit_gym_torch/csrc/` (one
   nvcc per source, all at once) and print the card's name and power limit;
2. kernel B1 (the fused env step, and its apply-only part that the reset
   scramble runs) against its plain PyTorch version on the card, on the 27q
   heavy-hex Clifford core (W=2) and the 27q permutation core (W=1), at
   B=32768 states from reset(difficulty=16), 8 steps of random actions (the
   no-op included) and flips, with track_layers on and off and once with
   add_inverts off: every field must be bit-identical;
3. kernel B2 (the standalone metrics update) against its plain version: on
   the two 27q cores at B=32768, then at its edges (a ragged B=1000, a
   B=1001 that is no multiple of 4, B=3 below one tile; n = 5, 12 and 27;
   tracked and untracked; operands on and off a 16-byte mark);
   then kernel B3 (the dense row-op step) against its plain version and
   against the dense core's own apply_gates + swap + solved, on the dense
   (bitpack=False) 27q Clifford (D=56), 27q permutation and 5q linear cores
   at B=32768 and a ragged B=1000, 4 steps of random actions and flips;
4. the serving path: RLSynthesis.from_config_json(..., device="cuda").synth()
   on the six shipped matrix artifacts, every returned circuit verified by
   the port's quantum layer, >= 7/8 solved on the 27q pair at difficulty 8,
   and B1's launch count rising by exactly the collect length per call;
   then two synth calls with `use_metrics_kernel` set, which step through
   kernel B2 and the apply kernel instead of B1;
5. the dense path: a bitpack=False 27q Clifford core at B=32768, reset at
   difficulty 8, then 128 steps in which kernel B3 carries the state, checked
   at the end against the plain dense `step` from the same start with the
   same actions and flips;
6. the training path at full width: RLSynthesis.learn for 3 iterations on
   `clifford_heavy_hex_27q.json` with its shipped weights and the JSON
   unchanged (2048 episodes, packing, 4 x 16 minibatches): the shipped
   weights pass the eval gate, the metrics are finite, the weights change,
   the difficulty follows the gate, B1 is launched once per step of
   collection and evals, and `train_state.pt` round-trips; then
   `perm_grid_3x3.json` from scratch for 6 iterations, in which the
   curriculum must advance;
7. the Pauli-network step on the 27q heavy-hex core at B=32768, through
   kernel B2, against the same step with the plain metrics update from the
   same start, actions and automorphism draws: every state field identical;
8. the Pauli serving path: RLSynthesis.synth on the five shipped PPO Pauli
   artifacts (5, 12, 18 and 27 qubits; 303 and 137 actions at 27) on seeded
   Clifford + rotation targets, every returned circuit verified (tableau and
   rotation sequence, and a statevector up to 18 qubits), at least the
   floor of `PAULI_TARGETS` solved, B2 launched once per collect step;
9. times with CUDA events (median of 20): each kernel's device time (from
   replays of a CUDA graph) and its eager call time, its plain version, and
   the least time the card could take; B2 tracked and untracked over rings
   of 4 and 16 operand sets; one 100-lane policy_solve and a 128-step
   collect at B=32768 on the 27q Clifford and the 27q Pauli artifact; a
   128-step collect_packed and a whole PPO iteration at B=2048 (difficulty
   64) on the 27q Clifford config; a torch.profiler breakdown of a 16-step
   collect by kernel for both artifacts; and, for the MCTS path, a profile
   of each full-width search (launches per simulation, device-busy share,
   share of the hand-written kernels, peak device memory), one MCTS solve
   end to end and one AlphaZero iteration without evals at difficulty 4 on
   the 27q Clifford AZ artifact. It runs last, after phases 10 to 12;
10. the search: `mcts_search` on the card at full width with the shipped
   weights, from seeded reset states with injected draws and root noise:
   `az_clifford_heavy_hex_27q` at B=256 with 64 simulations and
   `az_pauli_heavy_hex_27q` at B=100 with 96. Every row of visits sums to
   the simulation count, no visit lies on a masked action, the root values
   are finite, and B1 (B2 for the Pauli core) is launched once per
   simulation. Timed (ms a move and a simulation), and the share of lanes
   whose visit counts equal those of the same search on the CPU with the
   plain versions is printed, not asserted (cuBLAS and CPU logits differ in
   the last bits, so a near-tie may break the other way);
11. the AlphaZero serving path: the seven shipped `az_*` artifacts load
   through RLSynthesis.from_config_json with their JSONs unchanged; each
   synthesizes the seeded targets of `AZ_TARGETS` by policy search, and
   `az_perm_grid_3x3`, `az_perm_heavy_hex_27q`, `az_clifford_heavy_hex_27q`
   and `az_pauli_heavy_hex_27q` also by MCTS at the simulation count of
   their own gate eval (64, 96, 64, 100) on 16 lanes. Every circuit is
   verified, the solved counts meet the floors, and the step kernel is
   launched (simulations + 1) times per move;
12. the AlphaZero training path: RLSynthesis.learn on `az_perm_grid_3x3`
   from scratch for 4 iterations, then one iteration each of
   `az_clifford_heavy_hex_27q.json` (aligned collector, 256 lanes, 64
   simulations) and `az_pauli_heavy_hex_27q.json` (packed collector, 512
   lanes, 96 simulations, diff_replay 4) with their shipped weights: finite
   metrics, changed weights, difficulty and `best_params` following the
   gate eval, the step kernel launched once per simulation and per played
   move of the collection and of every eval, `train_state.pt` round trip;
13. demos and behavior cloning at full width: `generate_demos` on the spec
   env of `az_pauli_heavy_hex_27q_full` (27 qubits, 303 actions, R = 5) and
   `generate_demos_matrix` on `clifford_heavy_hex_27q`, each corpus packed
   onto the card (`prepare_demos`) and fitted for 2 epochs x 16 minibatches
   from the shipped weights through an AlphaZero algorithm (`fit_demos`):
   finite losses, changed weights, the card's weights within 1e-4 of the
   same fit on the CPU with the same injected permutation; then the fitted
   policies serve seeded targets (every circuit verified; B1 and B2
   launched; solved counts printed, not gated);
14. the action-head graft: `az_pauli_heavy_hex_27q_dense` (137 actions)
   grafted into a fresh `az_pauli_heavy_hex_27q_full` policy (303 actions),
   shared logits and value within 1e-5 of the source's on 256 seeded
   observations, and both serving the same seeded Pauli targets through B2
   (every circuit verified, solved counts printed side by side);
15. data parallelism: one NCCL process (world 1, a FileStore) and its mesh;
   a PPO train_step of `clifford_heavy_hex_27q.json` at 2048 lanes with the
   mesh equals the same step without it within 1e-6, and a policy_solve
   with the mesh verifies (at world 1 no collective runs in either: the
   gradient all-reduce is held against one process only by the 2-process
   gloo tests); the process group is destroyed at the end;
16. checkpoint formats and host runtime: the 27q Clifford params round-trip
   bit-exact through flax msgpack and through a torch.distributed.checkpoint
   directory written by `async_checkpointer()`; the native automorphism
   loader builds and agrees with the pure-Python enumerator on
   `heavy_hex_27q` and `grid_3x3`, and must be the one that answered; a
   `utils/profiling.device_trace` of a 16-step B=32768 collect holds 16 B1
   events;
17. the user programs of `qiskit_gym_torch/examples/`: the tour
   (`intro`: PPO on `perm_grid_3x3` with save and load, the phase-exact
   Clifford synth, the Pauli synth of `pauli_5_line`, each circuit verified;
   manual stepping only where gymnasium is installed); one burst of the
   flagship walk (`walk_pauli_az.build("az_pauli_heavy_hex_27q")`, the
   shipped JSON unchanged: 27 qubits, 303 actions, 512 lanes, 96
   simulations, packed collector, diff_replay 4) from difficulty 25, where
   T = 50 and the search descends its full cap of 32 levels: one learn
   iteration with its mcts_100 gate eval, then the recipe's demo refit
   (corpus cut to `WALK_CORPUS_PER_DIFF` episodes a difficulty): finite
   metrics, changed weights, the difficulty and best_difficulty following
   the gate, 32 levels reached, B2 launched once per simulation and per
   played move; timed (iteration, ms a move and a simulation, a profiled
   search's launches a simulation and device-busy share, peak memory);
   `resume_training` on the walk's run directory restores iteration,
   difficulty and weights bit for bit; one burst of
   `finetune_clifford_27q_demos` (its corpus of difficulties 12-36 x 400,
   BC 2 x 64 minibatches, evals before and after) and one AlphaZero
   iteration of its stack, through B1 and its apply part;
18. large instances, where the matrix is wider than 64 rows (W >= 3 words
   a column, kernel B1's wide kernels: a block per env streaming its
   words): B1 and its apply part
   against their plain versions, bit for bit over 16 steps of seeded
   actions (no-ops included) and flips, tracked and untracked, add_inverts
   on and off, on Clifford lines of 33 (W=3), 48 (three whole words), 127
   (W=8, B=8192) and 433 qubits (W=28, B=1024) and on the 65-qubit linear
   function and permutation lines; B2 at n = 127 and 433. Then the JAX
   package's `bench.py --scale` configuration through the port's core
   (Clifford on the 127-qubit line at B=8192 and the 433-qubit line at
   B=1024; reset at difficulty 8, 32 steps of pregenerated random actions
   and flips, one B1 launch a step): env steps/s, the kernels' device
   times against their bounds and against a copy of the same bytes
   (`copy_` of a and ainv, captured the same way), peak device memory,
   host seconds to build each core. On each line `RLSynthesis(CliffordGym.from_coupling_map(line),
   PPOConfig(), BasicPolicyConfig())` with a seeded fresh policy serves
   seeded targets (100 lanes at 127 qubits, 16 at 433; max_depth B1
   launches a call; any returned circuit verified), and a solve by
   construction (set_state, then the target's own gates on the card)
   fires success and reward at exactly the last step with a verified
   decoded circuit. Last, one `RLSynthesis.learn` iteration at 127 qubits
   (256 lanes, T=32, collect_packed, no evals): finite metrics, changed
   weights. No width is cut;
19. the quality and artifact tools of `qiskit_gym_torch/tools/`: one row
   of `bench_quality`'s eval table for each of the 18 shipped artifacts at
   its first difficulty, with the row's own episodes, searches and
   simulations, each at least the JAX package's row (`JAX_EVAL_ROWS`, from
   docs/QUALITY.md) less max(0.05, 3 standard errors), its solved
   targets' mean 2q count at most 15 % (and a quarter gate) above the JAX
   row's; the first depth of
   each policy-path synth row and of one MCTS-path row, every circuit
   verified, at least the JAX count less one target in four; BASELINE
   config #5 (`bench_baseline5`: 100 lanes x 1000 simulations a move) on
   one target at difficulty 4, which must be solved; `optimal_bc` on
   `perm_grid_3x3` and `clifford_3q_custom` (the JAX script's 362,880 and
   1,451,520 states, diameters 16 and 23, the spec replay validation, one
   fit_demos burst scored on a few targets); one burst each of
   `finetune_brevity` (lf_5_line) and `finetune_pauli_ppo`, and the
   graft's two measurements, into a temporary directory, with the sha256
   of every file under examples/models/ unchanged. Then kernel B3's
   streaming path (D >= 344) on the dense Clifford lines of 172 and 433
   qubits (D = 344 and 872) at a B whose tiles fill 1 GiB: a dense walk
   carried by B3 against the dense core's own step, the kernel against its
   plain version bit for bit, and its device time against its bound. Each
   tool's seconds are printed. Depth is what is cut (targets, corpus,
   episodes of the finetunes' scoring).
20. the bench surface of `qiskit_gym_torch/tools/`: `bench` (the JAX
   package's `bench.py`: the four 27q heavy-hex families at B=32768, K=128,
   reset at difficulty 8, every draw made up front, the steps as a Python
   loop; its JSON line, the rate of each family, B1's and B2's launches a
   step and the device's busy share from a profile), `bench --mesh` over a
   mesh of one NCCL process, `bench_fused` (the plain step against B1 on
   the three matrix families), `entry()`'s step on the card against the
   same step on the CPU with the same state and draws (reward and state
   bit for bit, value within 1e-4), and the two MCTS probes on their
   smallest case at a cut depth (`PROBE_EPISODES` episodes,
   `PROBE_SIMS` simulations). One B1 launch a step on every matrix family,
   finite rewards and a positive rate on every family.
21. the tour notebook, `qiskit_gym_torch/examples/intro.ipynb`: every code
   cell executed from its JSON as a user runs it without Jupyter
   (`examples/notebook.py`), with DEVICE = "cuda" and OUT a temporary
   directory: manual Gymnasium stepping, PPO on `perm_grid_3x3` (with save
   and reload), on `lf_5_line` and on the custom 3q Clifford gateset, the
   synths of the shipped artifacts with their round-trip and tableau
   checks, the `az_perm_grid_3x3` MCTS synth and the `pauli_5_line` synth.
   Every assert of the notebook must pass; the seconds of each section are
   printed. Then `rl.rollout.sample_action` at [4096, 303]: its argmax
   equals the CPU's on the same logits, and its samples equal the
   Gumbel-max of `draw_gumbel`'s noise from a clone of the same generator.

The launch counts are set to 0 just before each of the sixteen paths
(serving, dense, training, pauli, search, mcts, az_training, bc, graft, dp,
formats, recipes, large, tools, bench, notebook) and read just after it; a
kernel of a path that was not launched in it fails the run. Where a phase
also runs something else between the path's own runs (the plain train steps
beside the mesh steps of dp, the source artifact's solves beside the grafted
ones), only the path's own runs are counted, each in a window of its own.
It prints a `{"timings": ...}` line, a `{"kernels": [...]}` line (B1's wide
kernels as rows of their own, at 433 qubits, and B3's streaming kernel at
D = 872), the `nvidia-smi` name/power-limit line, and last `{"ok": true,
"device": {...}}`. Any failed phase raises and the script exits nonzero
without that last line. Without CUDA, or without the package beside it, it
exits 2 before doing anything.

A user program of phase 17 runs alone on the card as, for example,
`python -m qiskit_gym_torch.examples.walk_pauli_az az_pauli_heavy_hex_27q 5
25 --out runs/torch/walk` (artifact, minutes, start difficulty); its CPU
tests are `JAX_PLATFORMS=cpu python -m pytest tests/test_torch_examples.py`.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
MODELS = os.path.join(ROOT, "examples", "models")
HEAVY_HEX = ("clifford_heavy_hex_27q", "perm_heavy_hex_27q")
SMALL = ("perm_grid_3x3", "lf_5_line", "clifford_3q_line",
         "clifford_3q_custom")
B_BIG = 32768
B_RAGGED = 1000
DENSE_CORES = ("clifford_heavy_hex_27q", "perm_heavy_hex_27q", "lf_5_line")
KINDS = {"CliffordEnv": "clifford", "PermutationEnv": "permutation",
         "LinearFunctionEnv": "linear"}
# The PPO Pauli-network artifacts: (targets, Clifford gates per target,
# rotations per target, least number solved). The two CX-only artifacts
# trained on lines and the dense heavy-hex get shorter targets, which they
# solve. A floor is what the JAX package solves on the same seeded targets
# on the CPU (scripts/pauli_solve_probe.py jax: 6/6, 4/4, 5/6, 4/4, 6/6),
# less one target in four: the two packages sample from different streams.
PAULI_TARGETS = {
    "pauli_5_line": (6, 8, 2, 4),
    "pauli_12_line": (4, 6, 2, 3),
    "pauli_18_line": (6, 4, 1, 3),
    "pauli_heavy_hex_27q": (4, 6, 2, 3),
    "pauli_heavy_hex_27q_dense": (6, 4, 1, 4),
}
PAULI_SEED = 2027
# The AlphaZero artifacts: seeded targets of `gates` gateset gates (and
# `rotations` rx/ry/rz among them for the Pauli family). All `count` are
# served by policy search (num_searches=100); the first `mcts_count` also by
# MCTS with `sims` simulations per move (the count of the artifact's own
# gate eval) on AZ_MCTS_LANES lanes. The floors are what the JAX package
# solves on the same targets on the CPU (scripts/mcts_solve_probe.py jax),
# less one target in four: the two packages sample from different streams.
# The 27q Pauli artifact is served by MCTS on its first target only: its
# host-bound solve takes 26 and 40 moves at 1.3-2.5 s a move, and the
# whole script has to keep inside its time limit on a slow host.
AZ_TARGETS = {
    "az_perm_grid_3x3": dict(count=4, gates=4, rotations=0, floor=3,
                             sims=64, mcts_count=2, mcts_floor=1),
    "az_perm_heavy_hex_27q": dict(count=4, gates=6, rotations=0, floor=3,
                                  sims=96, mcts_count=2, mcts_floor=1),
    "az_clifford_heavy_hex_27q": dict(count=4, gates=6, rotations=0, floor=3,
                                      sims=64, mcts_count=2, mcts_floor=1),
    "az_pauli_18_line": dict(count=4, gates=4, rotations=1, floor=3,
                             sims=0, mcts_count=0, mcts_floor=0),
    "az_pauli_heavy_hex_27q": dict(count=4, gates=6, rotations=2, floor=3,
                                   sims=100, mcts_count=1, mcts_floor=1),
    "az_pauli_heavy_hex_27q_dense": dict(count=4, gates=4, rotations=1,
                                         floor=3, sims=0, mcts_count=0,
                                         mcts_floor=0),
    "az_pauli_heavy_hex_27q_full": dict(count=4, gates=4, rotations=1,
                                        floor=3, sims=0, mcts_count=0,
                                        mcts_floor=0),
}
AZ_SEED = 2028
AZ_MCTS_LANES = 16
STATEVECTOR_MAX_QUBITS = 18
TRAIN_ITERATIONS = 3       # on the 27q Clifford config, shipped weights
SCRATCH_ITERATIONS = 6     # on perm_grid_3x3, random weights
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12     # 32-bit rate outside the tensor cores (fp32 peak)
# The Pallas TPU kernel each port kernel replaces: (file in the JAX package's
# ops/, function). Located as file:line by `tpu_kernel_location`.
REPLACES = {
    "fused_step": ("pallas_fused.py", "_fused_kernel"),
    "apply_gates": ("pallas_fused.py", "_fused_kernel"),
    "fused_step_wide": ("pallas_fused.py", "_fused_kernel"),
    "apply_gates_wide": ("pallas_fused.py", "_fused_kernel"),
    "metrics_update": ("pallas_metrics.py", "_kernel"),
    "fused_step_apply": ("pallas_step.py", "_vpu_kernel"),
    "fused_step_apply_large": ("pallas_step.py", "_vpu_kernel"),
}
SOURCES = {
    "fused_step": "qiskit_gym_torch/csrc/fused_step.cu",
    "apply_gates": "qiskit_gym_torch/csrc/fused_step.cu",
    "fused_step_wide": "qiskit_gym_torch/csrc/fused_step.cu",
    "apply_gates_wide": "qiskit_gym_torch/csrc/fused_step.cu",
    "metrics_update": "qiskit_gym_torch/csrc/metrics.cu",
    "fused_step_apply": "qiskit_gym_torch/csrc/rowop_step.cu",
    "fused_step_apply_large": "qiskit_gym_torch/csrc/rowop_step.cu",
}
# B1's wide kernels (W >= 3) are launched by the same wrappers, which count
# them among their launches and again in `.wide_launches`; the `{"kernels"}`
# line lists them as kernels of their own.
WIDE_OF = {"fused_step_wide": "fused_step", "apply_gates_wide": "apply_gates"}
# B3's streaming kernel (one env's two tiles past a block's shared memory,
# D >= 344) likewise, counted in `.large_launches`.
LARGE_OF = {"fused_step_apply_large": "fused_step_apply"}


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tpu_kernel_location(filename: str, func: str) -> str:
    """`file:line` of the Pallas kernel `func` in the JAX package's
    `ops/<filename>`, found in the checkout's sources (read as text; the
    JAX package is never imported)."""
    port = os.path.join(ROOT, "qiskit_gym_torch")
    for path in sorted(glob.glob(os.path.join(ROOT, "*", "ops", filename))):
        if path.startswith(port + os.sep):
            continue
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if line.startswith(f"def {func}("):
                    return f"{os.path.relpath(path, ROOT)}:{i}"
    raise FileNotFoundError(f"no Pallas kernel {func} in */ops/{filename}")


def max_abs_err(got, want) -> float:
    """Largest |got - want| over two states' fields (or two tensors)."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            g, w = g.to(torch.int32), w.to(torch.int32)
        if g.dtype == torch.int32:
            # packed words: compare as the uint32 values they hold
            d = (g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64)
                                                     & 0xFFFFFFFF)
        else:
            d = g.double() - w.double()
        if d.numel():
            worst = max(worst, float(d.abs().max()))
    return worst


def assert_identical(got, want, what: str) -> None:
    import torch

    for name, g, w in zip(got._fields, got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: field {name} differs from the "
                                 "plain version")


def _event_median(run, count: int, reps: int) -> float:
    """Median over `reps` of the CUDA-event time of `run()`, over `count`."""
    import torch

    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / count)
    return statistics.median(samples)


def time_ms(fn, inputs, reps: int = 20) -> float:
    """Eager time of one call, host work included: the median over `reps`
    samples of one pass over the ring `inputs`, timed with CUDA events. The
    ring is larger than the 50 MB L2, so every call reads cold inputs."""
    import torch

    def run():
        for x in inputs:
            fn(x)

    run()
    torch.cuda.synchronize()
    return _event_median(run, len(inputs), reps)


def graph_ms(fn, inputs, reps: int = 20) -> float:
    """Device time of one call: one call per ring input captured in a CUDA
    graph, replayed `reps` times (median), so no host work is timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    graph.replay()
    torch.cuda.synchronize()
    return _event_median(graph.replay, len(inputs), reps)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def b2_inputs(B: int, n: int, g):
    """Seeded operands of kernel B2 on the card: last_g, last_c int32
    [B, n] and scal int32 [B, 8] with every gate type, 1q gates on one
    qubit, and one no-op in ten."""
    import torch

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    lg, lc = ints(-1, 64, B, n), ints(-1, 64, B, n)
    mtype, q = ints(0, 4, B), ints(0, n, B, 2)
    q[:, 1] = torch.where(mtype == 0, q[:, 0], q[:, 1])
    noop = (torch.rand(B, generator=g, device="cuda") < 0.1).to(torch.int32)
    scal = torch.stack([lg.max(1).values, lc.max(1).values, ints(0, 200, B),
                        ints(0, 200, B), mtype, q[:, 0], q[:, 1], noop],
                       dim=1).contiguous()
    return lg, lc, scal


def unaligned(t):
    """A contiguous copy of `t` that starts 4 bytes past a 16-byte mark."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0 or not view.is_contiguous():
        raise AssertionError("the view is aligned after all")
    return view


def pauli_target_gates(gateset, n: int, rng, depth: int, nrot: int) -> list:
    """A seeded Pauli-network target as (name, qubits, params) tuples:
    `depth` gates of the env's gateset with `nrot` rx/ry/rz rotations of
    seeded angles placed among them."""
    where = set(rng.choice(depth, size=min(nrot, depth),
                           replace=False).tolist())
    gates = []
    for i in range(depth):
        name, qs = gateset[int(rng.integers(len(gateset)))]
        gates.append((name.lower(), tuple(int(q) for q in qs), ()))
        if i in where:
            gates.append((("rx", "ry", "rz")[int(rng.integers(3))],
                          (int(rng.integers(n)),),
                          (float(rng.uniform(0.1, 3.0)),)))
    return gates


def _rotation_form(circuit):
    """(Clifford tableau, [(unsigned Pauli label, signed angle)]) with the
    rotations commuted to the front of the circuit."""
    from qiskit_gym_torch.envs.synthesis import _parse_pauli_circuit

    clifford, labels, params = _parse_pauli_circuit(circuit)
    rots = []
    for label, theta in zip(labels, params):
        sign = -1.0 if label.startswith("-") else 1.0
        body = label.lstrip("+-")
        if not set(body) <= set("IXYZ"):
            raise ValueError(f"rotation about a non-Hermitian Pauli {label}")
        rots.append((body, sign * theta))
    return clifford.tableau, rots


def _commute(a: str, b: str) -> bool:
    return sum(x != "I" and y != "I" and x != y for x, y in zip(a, b)) % 2 == 0


def pauli_circuits_equivalent(out, target, atol: float = 1e-9) -> bool:
    """Whether two Clifford + rotation circuits implement one unitary up to
    a global phase, without a statevector: equal Clifford tableaus (signs
    included) once every rotation is commuted to the front, and rotation
    sequences that are equal up to exchanges of commuting neighbours."""
    import numpy as np

    tab_a, rots_a = _rotation_form(out)
    tab_b, rots_b = _rotation_form(target)
    if not np.array_equal(tab_a, tab_b) or len(rots_a) != len(rots_b):
        return False
    rest = list(rots_b)
    for label, theta in rots_a:
        for j, (lab_j, th_j) in enumerate(rest):
            if lab_j == label and abs(th_j - theta) <= atol:
                del rest[j]
                break
            if not _commute(lab_j, label):
                return False
        else:
            return False
    return True


def statevectors_agree(out, target, seed: int, atol: float = 1e-7) -> bool:
    """One seeded random state through both circuits: the overlap of the
    results has modulus 1."""
    import numpy as np
    from qiskit_gym_torch.quantum.statevector import Statevector

    rng = np.random.default_rng(seed)
    dim = 2 ** target.num_qubits
    psi = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    psi /= np.linalg.norm(psi)
    a = Statevector(out.num_qubits, psi).apply_circuit(out).data
    b = Statevector(target.num_qubits, psi).apply_circuit(target).data
    return bool(abs(abs(np.vdot(a, b)) - 1.0) <= atol)


def verify_pauli(out, target) -> bool:
    """Whether `out` implements the Clifford + rotations circuit `target`:
    by the tableau and the rotation sequence at every width, and by a seeded
    statevector too where the width allows one."""
    ok = pauli_circuits_equivalent(out, target)
    if target.num_qubits <= STATEVECTOR_MAX_QUBITS:
        ok = ok and statevectors_agree(out, target, seed=PAULI_SEED)
    return ok


def load_core(name: str, **kw):
    """The env core of a shipped artifact's JSON, on the card."""
    from qiskit_gym_torch.envs import SYNTH_ENVS

    with open(os.path.join(MODELS, name + ".json")) as f:
        full = json.load(f)
    env_cfg = dict(full["env"])
    env_cfg.update(kw)
    env = SYNTH_ENVS[full["env_cls"].split(".")[-1]].from_json(
        env_cfg, device="cuda")
    return env.core


def load_dense_core(name: str):
    """The dense (bitpack=False) env core of a shipped artifact's JSON."""
    from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore

    with open(os.path.join(MODELS, name + ".json")) as f:
        full = json.load(f)
    env = full["env"]
    return MatrixEnvCore(
        env["num_qubits"], [(g[0], tuple(g[1])) for g in env["gateset"]],
        KINDS[full["env_cls"].split(".")[-1]], max_depth=env["max_depth"],
        add_inverts=env.get("add_inverts", True), bitpack=False,
        device="cuda")


def kernel_counters() -> dict:
    """The wrappers whose `.launches` count kernel launches, by name."""
    from qiskit_gym_torch.ops import fused_step as fs
    from qiskit_gym_torch.ops import metrics_kernel as mk
    from qiskit_gym_torch.ops import rowop_step as rs

    return {"fused_step": fs.fused_step, "apply_gates": fs.apply_gates,
            "metrics_update": mk.metrics_update,
            "fused_step_apply": rs.fused_step_apply}


def launch_counts() -> dict:
    """Every kernel's launches since the counts were last set to 0."""
    counters = kernel_counters()
    counts = {k: fn.launches for k, fn in counters.items()}
    counts.update({k: counters[w].wide_launches for k, w in WIDE_OF.items()})
    counts.update({k: counters[w].large_launches
                   for k, w in LARGE_OF.items()})
    return counts


def zero_counters() -> None:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    for w in WIDE_OF.values():
        counters[w].wide_launches = 0
    for w in LARGE_OF.values():
        counters[w].large_launches = 0


@contextlib.contextmanager
def counting(acc: dict):
    """Adds to `acc` the launches made inside the block: the counts are set
    to 0 just before it and read just after, so a path driven in several
    windows counts only its own runs."""
    zero_counters()
    yield
    for k, n in launch_counts().items():
        acc[k] = acc.get(k, 0) + n
    zero_counters()


def read_counters(path: str, must_launch, launches=None) -> dict:
    """The launch counts since `zero_counters` (or those that `counting`
    windows gathered in `launches`); fails if a kernel of this path
    (`must_launch`) was not launched in them."""
    if launches is None:
        launches = launch_counts()
    idle = [k for k in must_launch if launches[k] == 0]
    if idle:
        raise AssertionError(f"the {path} path never launched {idle}")
    log(f"  {path}-path launches: {launches}")
    return launches


# ----------------------------------------------------------------- phase 2
def phase_b1(results: dict) -> None:
    import torch
    from qiskit_gym_torch.ops import fused_step as fs

    variants = [("clifford_heavy_hex_27q", {}, False),
                ("clifford_heavy_hex_27q", {}, True),
                ("clifford_heavy_hex_27q", {"add_inverts": False}, False),
                ("perm_heavy_hex_27q", {}, False),
                ("perm_heavy_hex_27q", {}, True)]
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    for name, kw, track in variants:
        core = load_core(name, **kw)
        core.track_layers = track
        state = core.reset(B_BIG, 16, generator=g)
        # the apply kernel alone, against its plain version
        acts = torch.randint(0, core.num_actions + 1, (B_BIG,),
                             generator=g, device="cuda")
        ka, ki = fs.apply_gates(core, state.a, state.ainv, acts)
        pa, pi = fs.apply_plain(core.op_tab[acts], state.a, state.ainv,
                                core.W, core.dim, core.add_inverts)
        if not (torch.equal(ka, pa) and torch.equal(ki, pi)):
            raise AssertionError(f"apply_gates differs on {name}")
        results["apply_gates"]["err"] = max(
            results["apply_gates"]["err"], max_abs_err((ka, ki), (pa, pi)))
        for t in range(8):
            action = torch.randint(0, core.num_actions + 1, (B_BIG,),
                                   generator=g, device="cuda")
            flip = (torch.rand(B_BIG, generator=g, device="cuda") < 0.5
                    if core.add_inverts else None)
            got = fs.fused_step(core, state, action, flip)
            want = fs.fused_step_plain(core, state, action, flip)
            assert_identical(got, want, f"fused_step {name} {kw} "
                             f"track={track} t={t}")
            results["fused_step"]["err"] = max(
                results["fused_step"]["err"], max_abs_err(got, want))
            state = got
        torch.cuda.synchronize()
        log(f"  B1 {name} {kw or ''} track_layers={track}: 8 steps at "
            f"B={B_BIG} bit-identical to the plain version "
            f"(solved lanes {int(state.success.sum())})")


# ----------------------------------------------------------------- phase 3
def phase_b2(results: dict) -> None:
    import torch
    from qiskit_gym_torch.ops import fused_step as fs
    from qiskit_gym_torch.ops import metrics_kernel as mk

    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    for name in HEAVY_HEX:
        core = load_core(name)
        core.track_layers = True
        state = core.reset(B_BIG, 16, generator=g)
        for _ in range(6):  # non-trivial layer fields
            a = torch.randint(0, core.num_actions + 1, (B_BIG,), generator=g,
                              device="cuda")
            state = fs.fused_step(core, state, a, torch.rand(
                B_BIG, generator=g, device="cuda") < 0.5)
        for track in (True, False):
            a = torch.randint(0, core.num_actions + 1, (B_BIG,), generator=g,
                              device="cuda")
            rows = core.op_tab[a]
            scal = torch.stack(
                [state.max_g, state.max_c, state.n_cnots, state.n_gates,
                 rows[:, 0], rows[:, 1], rows[:, 2],
                 (a == core.noop_action).to(torch.int32)], dim=1).contiguous()
            got = mk.metrics_update(state.last_g, state.last_c, scal,
                                    core.weights_static, track)
            want = mk.metrics_update_plain(state.last_g, state.last_c, scal,
                                           core.weights_static, track)
            for gt, wt in zip(got, want):
                if gt.dtype != wt.dtype or not torch.equal(gt, wt):
                    raise AssertionError(f"metrics_update differs on {name} "
                                         f"track={track}")
            results["metrics_update"]["err"] = max(
                results["metrics_update"]["err"], max_abs_err(got, want))
        torch.cuda.synchronize()
        log(f"  B2 {name}: B={B_BIG} bit-identical to the plain version "
            "(track_layers on and off)")
    # the edges: a ragged last tile, a B that is no multiple of 4, a B below
    # one tile, three widths, and operands that start off a 16-byte mark
    weights = (0.01, 0.02, 0.005, 0.001)
    cases = 0
    for B in (B_BIG, B_RAGGED, 1001, 3):
        for n in (5, 12, 27):
            ops = b2_inputs(B, n, g)
            for operands in (ops, tuple(unaligned(t) for t in ops)):
                for track in (True, False):
                    got = mk.metrics_update(*operands, weights, track)
                    want = mk.metrics_update_plain(*operands, weights, track)
                    for gt, wt in zip(got, want):
                        if gt.dtype != wt.dtype or not torch.equal(gt, wt):
                            raise AssertionError(
                                f"metrics_update differs at B={B} n={n} "
                                f"track={track} aligned="
                                f"{operands[0].data_ptr() % 16 == 0}")
                    results["metrics_update"]["err"] = max(
                        results["metrics_update"]["err"],
                        max_abs_err(got, want))
                    cases += 1
    torch.cuda.synchronize()
    log(f"  B2 edges: {cases} cases (B in {B_BIG}, {B_RAGGED}, 1001, 3; n in "
        "5, 12, 27; tracked and untracked; 16-byte aligned and not) "
        "bit-identical to the plain version")


def phase_b3(results: dict) -> None:
    import torch
    from qiskit_gym_torch.ops import fused_step as fs
    from qiskit_gym_torch.ops import rowop_step as rs

    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    for name in DENSE_CORES:
        core = load_dense_core(name)
        for B in (B_BIG, B_RAGGED):
            state = core.reset(B, 16, generator=g)
            a, ainv = state.a, state.ainv
            for t in range(4):
                act = torch.randint(0, core.num_actions + 1, (B,),
                                    generator=g, device="cuda")
                flip = torch.rand(B, generator=g, device="cuda") < 0.5
                got = rs.fused_step_apply(core, a, ainv, act, flip)
                want = rs.fused_step_apply_plain(core, a, ainv, act, flip)
                na, ni = core.apply_gates(a, ainv, act)
                f3 = flip[:, None, None]
                dense_a = torch.where(f3, ni, na)
                dense = (dense_a, torch.where(f3, na, ni),
                         fs.solved(core, dense_a))
                for what, ref in (("its plain version", want),
                                  ("the dense apply_gates", dense)):
                    for field, x, y in zip(("new_a", "new_ainv", "success"),
                                           got, ref):
                        if x.dtype != y.dtype or not torch.equal(x, y):
                            raise AssertionError(
                                f"fused_step_apply {name} B={B} t={t}: "
                                f"{field} differs from {what}")
                results["fused_step_apply"]["err"] = max(
                    results["fused_step_apply"]["err"],
                    max_abs_err(got, want))
                a, ainv = got[0], got[1]
            torch.cuda.synchronize()
            log(f"  B3 {name} D={core.D}: 4 steps at B={B} identical to the "
                "plain version and to the dense apply_gates + swap + solved")


# ----------------------------------------------------------------- phase 5
def phase_dense_path(results: dict) -> dict:
    """128 steps of the dense 27q Clifford state carried by kernel B3."""
    import torch
    from qiskit_gym_torch.ops import rowop_step as rs

    T = 128
    core = load_dense_core("clifford_heavy_hex_27q")
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    start = core.reset(B_BIG, 8, generator=g)
    acts = torch.randint(0, core.num_actions, (T, B_BIG), generator=g,
                         device="cuda")
    flips = torch.rand((T, B_BIG), generator=g, device="cuda") < 0.5
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, ainv = start.a, start.ainv
    for t in range(T):
        a, ainv, success = rs.fused_step_apply(core, a, ainv, acts[t],
                                               flips[t])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counters("dense", ["fused_step_apply"])
    if launches["fused_step_apply"] != T:
        raise AssertionError(f"B3 launched {launches['fused_step_apply']} "
                             f"times in {T} steps")
    # the same walk with the dense core's own step (torch ops and B2)
    state = start
    for t in range(T):
        state = core.step(state, acts[t], invert_override=flips[t])
    for field, got, want in (("a", a, state.a), ("ainv", ainv, state.ainv),
                             ("success", success, state.success)):
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"dense path: {field} differs from the "
                                 f"dense step after {T} steps")
    torch.cuda.synchronize()
    log(f"  dense path: {T} B3 steps at B={B_BIG} in {sec:.3f} s "
        f"({T * B_BIG / sec:.4g} env steps/s, eager), final state and "
        f"success identical to the dense step ({int(success.sum())} solved)")
    results["_dense_steps_per_s"] = T * B_BIG / sec
    return launches


# ----------------------------------------------------------------- phase 6
def read_metrics(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def assert_finite_rows(rows: list, what: str) -> None:
    import math

    for row in rows:
        bad = {k: v for k, v in row.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"{what}: training metrics not finite: "
                                 f"{bad}")
        if row["steps_collected"] <= 0:
            raise AssertionError(f"{what}: an iteration collected no step")


def assert_gate_logic(rls, rows: list, start: int, what: str) -> None:
    """The difficulty rose once per iteration whose gate eval passed, and
    `best_params` exists exactly if one did."""
    cfg = rls.rl_config
    passed = [r for r in rows
              if r["eval/" + cfg.diff_metric] >= cfg.diff_threshold]
    if rls.env.difficulty != start + len(passed):
        raise AssertionError(
            f"{what}: {len(passed)} iterations passed the gate but the "
            f"difficulty is {rls.env.difficulty}")
    if (rls.algorithm.best_params is None) != (not passed):
        raise AssertionError(f"{what}: best_params does not follow the gate")


def assert_train_state_round_trip(rls, paths, run_dir: str) -> None:
    """`train_state.pt` written from `rls` restores iteration, difficulty,
    weights and Adam state into a fresh object made from `paths`."""
    import torch
    from qiskit_gym_torch.rl import RLSynthesis

    algo = rls.algorithm
    snap = os.path.join(run_dir, "train_state.pt")
    algo.save_training_state(snap)
    back = RLSynthesis.from_config_json(*paths, device="cuda").algorithm
    back.restore_training_state(snap)
    if (back.iteration, back.env.difficulty, back.best_difficulty) != (
            algo.iteration, rls.env.difficulty, algo.best_difficulty):
        raise AssertionError("train_state.pt: iteration or difficulty "
                             "not restored")
    want, got = algo.optimizer.state_dict(), back.optimizer.state_dict()
    if want["param_groups"] != got["param_groups"]:
        raise AssertionError("train_state.pt: Adam groups differ")
    for i, st in want["state"].items():
        for k, v in st.items():
            if not torch.equal(got["state"][i][k].cpu(), v.cpu()):
                raise AssertionError(f"train_state.pt: Adam {k} of "
                                     f"parameter {i} not restored")
    for k, v in algo.params.items():
        if not torch.equal(back.params[k], v):
            raise AssertionError(f"train_state.pt: weight {k} differs")


def phase_training(results: dict) -> dict:
    import torch
    from qiskit_gym_torch.rl import RLSynthesis

    name = "clifford_heavy_hex_27q"
    paths = (os.path.join(MODELS, name + ".json"),
             os.path.join(MODELS, name + ".pt"))
    rls = RLSynthesis.from_config_json(*paths, device="cuda")
    cfg = rls.rl_config
    if (cfg.num_episodes, cfg.episode_packing, cfg.num_epochs,
            cfg.num_minibatches) != (2048, True, 4, 16):
        raise AssertionError("the 27q Clifford config is not the shipped one")
    before = {k: v.clone() for k, v in rls.params.items()}
    # the curriculum gate on the shipped weights, before any update
    gate = rls.algorithm.run_evals(1)[cfg.diff_metric]
    if gate < cfg.diff_threshold:
        raise AssertionError(f"the shipped weights fail the eval gate at "
                             f"difficulty 1: {gate} < {cfg.diff_threshold}")
    log(f"  {name}: {cfg.diff_metric} of the shipped weights at difficulty "
        f"1: {gate:.3f} (gate {cfg.diff_threshold})")
    run_dir = tempfile.mkdtemp(prefix="qgt_smoke_")
    try:
        zero_counters()
        rls.learn(initial_difficulty=1, num_iterations=TRAIN_ITERATIONS,
                  tb_path=run_dir)
        torch.cuda.synchronize()
        launches = read_counters("training", ["fused_step", "apply_gates"])
        rows = read_metrics(run_dir)
        algo = rls.algorithm
        if len(rows) != TRAIN_ITERATIONS or algo.iteration != len(rows):
            raise AssertionError(f"{len(rows)} metric rows after "
                                 f"{TRAIN_ITERATIONS} iterations")
        assert_finite_rows(rows, name)
        for row in rows:
            log(f"  {name} iteration {row['step']}: difficulty "
                f"{row['difficulty']:.0f}, loss {row['loss']:.4f}, "
                f"success_rate {row['success_rate']:.3f}, eval "
                f"{row['eval/' + cfg.diff_metric]:.3f}, "
                f"{row['steps_collected']:.0f} steps, "
                f"{row['iter_seconds']:.3f} s")
        if not any(not torch.equal(before[k], v)
                   for k, v in rls.params.items()):
            raise AssertionError("training did not change the weights")
        # Whether the gate still passes after an iteration is the config's
        # own matter: 64 Adam steps at difficulty 1 move the shipped policy
        # below the gate in the JAX package too
        # (scripts/ppo_iteration_probe.py). The gate and the snapshot must
        # agree with each other.
        assert_gate_logic(rls, rows, 1, name)
        # one B1 launch per step of collection and of each eval
        core = rls.env.core
        steps = sum((1 + len(cfg.evals))
                    * min(core.depth_slope * int(r["difficulty"]),
                          core.max_depth) for r in rows)
        if launches["fused_step"] != steps:
            raise AssertionError(f"B1 launched {launches['fused_step']} "
                                 f"times in training, expected {steps}")
        assert_train_state_round_trip(rls, paths, run_dir)
        log(f"  {name}: difficulty 1 -> {rls.env.difficulty} in "
            f"{TRAIN_ITERATIONS} iterations, {steps} B1 launches, "
            "train_state.pt restores iteration, difficulty, weights and "
            "Adam state")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    results["_train_iter_seconds"] = [r["iter_seconds"] for r in rows]

    # from scratch: random weights on the small permutation config
    scratch = RLSynthesis.from_config_json(
        os.path.join(MODELS, "perm_grid_3x3.json"), device="cuda")
    t0 = time.perf_counter()
    scratch.learn(initial_difficulty=1, num_iterations=SCRATCH_ITERATIONS)
    torch.cuda.synchronize()
    if scratch.env.difficulty < 2:
        raise AssertionError("perm_grid_3x3 from scratch: the curriculum did "
                             f"not advance in {SCRATCH_ITERATIONS} "
                             "iterations")
    log(f"  perm_grid_3x3 from scratch: difficulty 1 -> "
        f"{scratch.env.difficulty} in {SCRATCH_ITERATIONS} iterations, "
        f"{time.perf_counter() - t0:.2f} s")
    results["_trainer"] = rls
    return launches


# ----------------------------------------------------------------- phase 4
def make_target(env, rng, depth: int):
    from qiskit_gym_torch.quantum import Circuit

    gs = env.gateset
    acts = rng.integers(0, len(gs), depth)
    return Circuit.from_gate_list([gs[int(a)] for a in acts],
                                  num_qubits=env.config["num_qubits"])


def verify(env, out, target) -> bool:
    import numpy as np
    from qiskit_gym_torch.quantum import (Clifford, linear_from_circuit,
                                          permutation_pattern)

    if env.cls_name == "PermutationEnv":
        return (permutation_pattern(linear_from_circuit(out)).tolist()
                == permutation_pattern(linear_from_circuit(target)).tolist())
    if env.cls_name == "LinearFunctionEnv":
        return bool(np.array_equal(linear_from_circuit(out),
                                   linear_from_circuit(target)))
    return bool(np.array_equal(Clifford(out).tableau,
                               Clifford(target).tableau))


def az_targets(env, name: str) -> list:
    """The seeded targets of an AlphaZero artifact (`AZ_TARGETS[name]`), as
    circuits of the port's quantum layer."""
    import numpy as np
    from qiskit_gym_torch.quantum import Circuit

    spec = AZ_TARGETS[name]
    rng = np.random.default_rng(AZ_SEED)
    n = env.config["num_qubits"]
    targets = []
    for _ in range(spec["count"]):
        if env.cls_name != "PauliNetworkEnv":
            targets.append(make_target(env, rng, spec["gates"]))
            continue
        qc = Circuit(n)
        for gate in pauli_target_gates(env.gateset, n, rng, spec["gates"],
                                       spec["rotations"]):
            qc.append(*gate)
        targets.append(qc)
    return targets


def verify_any(env, out, target) -> bool:
    """`verify` for the matrix families, `verify_pauli` for the Pauli one."""
    if env.cls_name == "PauliNetworkEnv":
        return verify_pauli(out, target)
    return verify(env, out, target)


def phase_main_path(results: dict) -> dict:
    import numpy as np
    import torch
    from qiskit_gym_torch.ops import fused_step as fs
    from qiskit_gym_torch.rl import RLSynthesis

    counters = kernel_counters()
    artifacts = {}
    for name in HEAVY_HEX + SMALL:
        artifacts[name] = RLSynthesis.from_config_json(
            os.path.join(MODELS, name + ".json"),
            os.path.join(MODELS, name + ".pt"), device="cuda")
    rng = np.random.default_rng(2026)
    zero_counters()
    for name, rls in artifacts.items():
        env = rls.env
        count, depth = (8, 8) if name in HEAVY_HEX else (4, 4)
        solved = 0
        t0 = time.perf_counter()
        for _ in range(count):
            target = make_target(env, rng, depth)
            before = fs.fused_step.launches
            out = rls.synth(target, num_searches=100)
            steps = fs.fused_step.launches - before
            if steps != env.core.max_depth:
                raise AssertionError(
                    f"{name}: B1 launched {steps} times in one synth, "
                    f"expected {env.core.max_depth} (one per collect step)")
            if out is None:
                continue
            if not verify(env, out, target):
                raise AssertionError(f"{name}: synthesized circuit does not "
                                     "implement the target")
            solved += 1
        torch.cuda.synchronize()
        log(f"  {name}: solved {solved}/{count} at difficulty {depth}, "
            f"num_searches=100, {env.core.max_depth} B1 launches per synth, "
            f"{time.perf_counter() - t0:.2f} s")
        if name in HEAVY_HEX and solved < 7:
            raise AssertionError(f"{name}: {solved}/8 solved, need >= 7")
        if solved < 1:
            raise AssertionError(f"{name}: nothing solved")
    # the same path with the standalone metrics kernel (B2) and the apply
    # kernel in place of the fused step (MatrixEnvCore.use_metrics_kernel)
    name = "clifford_heavy_hex_27q"
    env = artifacts[name].env
    env.core.use_metrics_kernel = True
    for _ in range(2):
        target = make_target(env, rng, 8)
        before = {k: fn.launches for k, fn in counters.items()}
        out = artifacts[name].synth(target, num_searches=100)
        rose = {k: fn.launches - before[k] for k, fn in counters.items()}
        want = {"fused_step": 0, "apply_gates": env.core.max_depth,
                "metrics_update": env.core.max_depth, "fused_step_apply": 0}
        if rose != want:
            raise AssertionError(f"{name} with use_metrics_kernel: launches "
                                 f"{rose} in one synth, expected {want}")
        if out is not None and not verify(env, out, target):
            raise AssertionError(f"{name} with use_metrics_kernel: circuit "
                                 "does not implement the target")
    env.core.use_metrics_kernel = False
    torch.cuda.synchronize()
    log(f"  {name} with use_metrics_kernel: {env.core.max_depth} B2 and "
        "apply launches per synth")
    launches = read_counters(
        "serving", ["fused_step", "apply_gates", "metrics_update"])
    results["_artifacts"] = artifacts
    return launches


# ------------------------------------------------------------ Pauli phases
def phase_pauli_step(results: dict) -> None:
    """The Pauli step with kernel B2 against the same step with the plain
    metrics update, from one start with the same actions and automorphism
    draws, at B=32768 on the 27q heavy-hex core, untracked (as shipped) and
    tracked."""
    import torch
    from qiskit_gym_torch.ops import metrics_kernel as mk

    g = torch.Generator(device="cuda")
    g.manual_seed(19)
    for track in (False, True):
        core = load_core("pauli_heavy_hex_27q")
        core.track_layers = track
        got = want = core.reset(B_BIG, 32, generator=g)
        before = mk.metrics_update.launches
        steps = 6
        for _ in range(steps):
            act = torch.randint(0, core.num_actions + 1, (B_BIG,),
                                generator=g, device="cuda")
            perm = torch.randint(0, core.num_perms, (B_BIG,), generator=g,
                                 device="cuda")
            got = core.step(got, act, perm_idx=perm)
            want = core.step(want, act, perm_idx=perm,
                             metrics=mk.metrics_update_plain)
            assert_identical(got, want, f"Pauli step track={track}")
        if mk.metrics_update.launches - before != steps:
            raise AssertionError("the Pauli step did not launch B2 once")
        torch.cuda.synchronize()
        log(f"  Pauli step pauli_heavy_hex_27q track_layers={track}: {steps} "
            f"steps at B={B_BIG} through B2 bit-identical to the step with "
            f"the plain metrics update ({int(got.active.sum())} rotations "
            f"active, {int(got.n_gates.sum())} gates counted)")


def phase_pauli_path(results: dict) -> dict:
    """RLSynthesis.synth on the five PPO Pauli artifacts at full width."""
    import numpy as np
    import torch
    from qiskit_gym_torch.ops import metrics_kernel as mk
    from qiskit_gym_torch.quantum import Circuit
    from qiskit_gym_torch.rl import RLSynthesis

    artifacts = {
        name: RLSynthesis.from_config_json(
            os.path.join(MODELS, name + ".json"),
            os.path.join(MODELS, name + ".pt"), device="cuda")
        for name in PAULI_TARGETS}
    zero_counters()
    solved_by = {}
    for name, rls in artifacts.items():
        env, core = rls.env, rls.env.core
        count, depth, nrot, floor = PAULI_TARGETS[name]
        n = env.config["num_qubits"]
        rng = np.random.default_rng(PAULI_SEED)
        solved, two_q = 0, []
        t0 = time.perf_counter()
        for _ in range(count):
            target = Circuit(n)
            for gate in pauli_target_gates(env.gateset, n, rng, depth, nrot):
                target.append(*gate)
            before = mk.metrics_update.launches
            out = rls.synth(target, num_searches=100)
            steps = mk.metrics_update.launches - before
            if steps != core.max_depth:
                raise AssertionError(
                    f"{name}: B2 launched {steps} times in one synth, "
                    f"expected {core.max_depth} (one per collect step)")
            if out is None:
                continue
            if not verify_pauli(out, target):
                raise AssertionError(f"{name}: synthesized circuit does not "
                                     "implement the target")
            solved += 1
            two_q.append(out.num_2q_gates())
        torch.cuda.synchronize()
        log(f"  {name}: {n} qubits, {core.num_actions} actions, solved "
            f"{solved}/{count} (floor {floor}) at {depth} gates + {nrot} "
            f"rotations, num_searches=100, {core.max_depth} B2 launches per "
            f"synth, 2q gates {two_q}, {time.perf_counter() - t0:.2f} s")
        if solved < floor:
            raise AssertionError(f"{name}: {solved}/{count} solved, the "
                                 f"floor is {floor}")
        solved_by[name] = [solved, count]
    launches = read_counters("pauli", ["metrics_update"])
    results["_pauli_artifacts"] = artifacts
    results["_pauli_solved"] = solved_by
    return launches


# ------------------------------------------------- AlphaZero and MCTS phases
# The two full-width searches: (artifact, lanes, simulations, difficulty of
# the seeded reset states).
SEARCHES = (("az_clifford_heavy_hex_27q", 256, 64, 8),
            ("az_pauli_heavy_hex_27q", 100, 96, 4))
AZ_SCRATCH_ITERATIONS = 4   # az_perm_grid_3x3 from random weights
STEP_KERNEL = {"PauliNetworkEnv": "metrics_update"}   # others: fused_step


def step_kernel(env) -> str:
    """The hand-written kernel that every env step of `env` launches."""
    return STEP_KERNEL.get(env.cls_name, "fused_step")


def load_artifact(name: str, device: str = "cuda", weights: bool = True):
    from qiskit_gym_torch.rl import RLSynthesis

    return RLSynthesis.from_config_json(
        os.path.join(MODELS, name + ".json"),
        os.path.join(MODELS, name + ".pt") if weights else None,
        device=device)


def search_inputs(name: str, lanes: int, sims: int, difficulty: int):
    """Seeded inputs of one full-width search, made on the CPU so that the
    card and the CPU search the same roots with the same draws: (the
    artifact on the CPU, its reset state, the injected draws)."""
    import torch

    cpu = load_artifact(name, "cpu")
    core = cpu.env.core
    gen = torch.Generator().manual_seed(AZ_SEED)
    state = core.reset(lanes, difficulty, generator=gen)
    draws = dict(
        root_gamma=torch._standard_gamma(
            torch.full((lanes, core.num_actions), 0.3), generator=gen),
        flips=torch.rand((sims, 1, lanes), generator=gen) < 0.5,
        perms=(torch.randint(0, core.num_perms, (sims, 1, lanes),
                             generator=gen)
               if hasattr(core, "translate_action") else None))
    return cpu, state, draws


def phase_search(results: dict) -> dict:
    """`mcts_search` on the card at full width, from seeded roots with
    injected draws and root noise; structure asserted, the env step of every
    simulation one launch of the family's kernel; the share of lanes whose
    visit counts equal the CPU's (plain versions, same draws) printed."""
    import torch
    from qiskit_gym_torch.rl import mcts_search

    counters = kernel_counters()
    zero_counters()
    results["_search"] = {}
    for name, lanes, sims, difficulty in SEARCHES:
        cpu, state_cpu, draws = search_inputs(name, lanes, sims, difficulty)
        rls = load_artifact(name)
        core, policy = rls.env.core, rls.algorithm.policy
        state = type(state_cpu)(*(x.cuda() for x in state_cpu))
        depth = min(core.max_depth, 32)

        def search(on, pol, st):
            return mcts_search(on, pol, st, sims, 1.41, depth,
                               noise_eps=0.25, **draws)

        mcts_search(core, policy, state, 4, 1.41, depth)     # warm-up
        kernel = counters[step_kernel(rls.env)]
        samples = []
        for _ in range(2):
            before = kernel.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            visits, value, priors = search(core, policy, state)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
            if kernel.launches - before != sims:
                raise AssertionError(
                    f"{name}: {step_kernel(rls.env)} launched "
                    f"{kernel.launches - before} times in a search of "
                    f"{sims} simulations")
        live = ~core.is_final(state)
        if not bool((visits.sum(-1) == sims).all()):
            raise AssertionError(f"{name}: a row of visits does not sum to "
                                 f"{sims}")
        if float((visits * ~core.masks(state))[live].sum()) != 0.0:
            raise AssertionError(f"{name}: visits on a masked action")
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"{name}: root_value not finite")
        if visits.shape != (lanes, core.num_actions):
            raise AssertionError(f"{name}: visits have shape {visits.shape}")
        t0 = time.perf_counter()
        cpu_visits, _, cpu_priors = search(cpu.env.core,
                                           cpu.algorithm.policy, state_cpu)
        cpu_sec = time.perf_counter() - t0
        same = float((cpu_visits == visits.cpu()).all(-1).float().mean())
        prior_err = float((cpu_priors - priors.cpu()).abs().max())
        if prior_err > 1e-5:
            raise AssertionError(f"{name}: root priors differ from the CPU's "
                                 f"by {prior_err}")
        sec = min(samples)
        log(f"  search {name}: B={lanes}, {sims} simulations, "
            f"{core.num_actions} actions, {int(live.sum())} live roots: "
            f"{1e3 * sec:.1f} ms a move, {1e3 * sec / sims:.2f} ms a "
            f"simulation, {sims} {step_kernel(rls.env)} launches; visit "
            f"counts equal to the CPU search on {100 * same:.1f}% of lanes "
            f"(root priors within {prior_err:.1e}; the CPU took "
            f"{cpu_sec:.1f} s)")
        results["_search"][name] = {
            "lanes": lanes, "sims": sims, "move_ms": [1e3 * x
                                                      for x in samples],
            "ms_per_sim": 1e3 * sec / sims,
            "lanes_equal_to_cpu": same}
    return read_counters("search", ["fused_step", "metrics_update"])


def phase_az_serving(results: dict) -> dict:
    """RLSynthesis.synth on the seven AlphaZero artifacts: by policy search
    on every target and by MCTS on the first targets of four of them."""
    import torch

    counters = kernel_counters()
    artifacts = {name: load_artifact(name) for name in AZ_TARGETS}
    zero_counters()
    solved_by = {}
    for name, rls in artifacts.items():
        env, spec = rls.env, AZ_TARGETS[name]
        if not type(rls.algorithm).__name__ == "AZ":
            raise AssertionError(f"{name} did not load as an AZ artifact")
        kernel = counters[step_kernel(env)]
        targets = az_targets(env, name)
        modes = [("policy", targets, spec["floor"], dict(num_searches=100))]
        if spec["mcts_count"]:
            modes.append(("mcts", targets[:spec["mcts_count"]],
                          spec["mcts_floor"],
                          dict(num_searches=AZ_MCTS_LANES,
                               num_mcts_searches=spec["sims"])))
        for mode, todo, floor, kw in modes:
            per_move = kw.get("num_mcts_searches", 0) + 1
            solved, two_q, moves = 0, [], []
            t0 = time.perf_counter()
            for target in todo:
                before = kernel.launches
                out = rls.synth(target, **kw)
                steps, rest = divmod(kernel.launches - before, per_move)
                if rest or not 1 <= steps <= env.core.max_depth:
                    raise AssertionError(
                        f"{name} {mode}: {kernel.launches - before} "
                        f"{step_kernel(env)} launches in one synth are not "
                        f"{per_move} per move")
                moves.append(steps)
                if out is None:
                    continue
                if not verify_any(env, out, target):
                    raise AssertionError(f"{name} {mode}: synthesized "
                                         "circuit does not implement the "
                                         "target")
                solved += 1
                two_q.append(out.num_2q_gates())
            torch.cuda.synchronize()
            log(f"  {name} {mode}: solved {solved}/{len(todo)} (floor "
                f"{floor}) at {spec['gates']} gates + {spec['rotations']} "
                f"rotations, {kw}, moves {moves}, 2q gates {two_q}, "
                f"{time.perf_counter() - t0:.2f} s")
            if solved < floor:
                raise AssertionError(f"{name} {mode}: {solved}/{len(todo)} "
                                     f"solved, the floor is {floor}")
            solved_by[f"{name}:{mode}"] = [solved, len(todo)]
    results["_az_artifacts"] = artifacts
    results["_az_solved"] = solved_by
    return read_counters("mcts", ["fused_step", "metrics_update"])


def az_iteration_launches(rls, rows: list) -> int:
    """Env steps of the AZ iterations `rows`: per move of the collection
    num_mcts_searches simulations and the played step, and the same per
    move of every eval (one step a move for an eval without MCTS)."""
    cfg, core = rls.rl_config, rls.env.core
    per_move = cfg.num_mcts_searches + 1 + sum(
        ev.num_mcts_searches + 1 for ev in cfg.evals.values())
    return sum(per_move * min(core.depth_slope * int(r["difficulty"]),
                              core.max_depth) for r in rows)


def phase_az_training(results: dict) -> dict:
    """RLSynthesis.learn with AlphaZero: `az_perm_grid_3x3` from scratch,
    then one iteration each of the 27q Clifford config (aligned collector,
    256 lanes, 64 simulations) and the 27q Pauli config (packed collector,
    512 lanes, 96 simulations, diff_replay 4) with their shipped weights
    and their JSONs unchanged."""
    import torch

    zero_counters()
    scratch = load_artifact("az_perm_grid_3x3", weights=False)
    run_dir = tempfile.mkdtemp(prefix="qgt_smoke_az_")
    try:
        t0 = time.perf_counter()
        scratch.learn(initial_difficulty=1,
                      num_iterations=AZ_SCRATCH_ITERATIONS, tb_path=run_dir)
        torch.cuda.synchronize()
        rows = read_metrics(run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    assert_finite_rows(rows, "az_perm_grid_3x3")
    assert_gate_logic(scratch, rows, 1, "az_perm_grid_3x3")
    gate = "eval/" + scratch.rl_config.diff_metric
    log(f"  az_perm_grid_3x3 from scratch: difficulty 1 -> "
        f"{scratch.env.difficulty} in {AZ_SCRATCH_ITERATIONS} iterations "
        f"({gate} {[round(r[gate], 3) for r in rows]}), "
        f"{time.perf_counter() - t0:.2f} s")
    want = {"az_clifford_heavy_hex_27q": (256, False, 64, 0),
            "az_pauli_heavy_hex_27q": (512, True, 96, 4)}
    results["_az_iter_seconds"] = {}
    for name, shipped in want.items():
        paths = (os.path.join(MODELS, name + ".json"),
                 os.path.join(MODELS, name + ".pt"))
        rls = results["_az_artifacts"][name]
        cfg, algo = rls.rl_config, rls.algorithm
        if (cfg.num_episodes, cfg.episode_packing, cfg.num_mcts_searches,
                cfg.diff_replay) != shipped:
            raise AssertionError(f"the {name} config is not the shipped one")
        before = {k: v.clone() for k, v in rls.params.items()}
        kernel = kernel_counters()[step_kernel(rls.env)]
        launched = kernel.launches
        run_dir = tempfile.mkdtemp(prefix="qgt_smoke_az_")
        try:
            rls.learn(initial_difficulty=1, num_iterations=1,
                      tb_path=run_dir)
            torch.cuda.synchronize()
            launched = kernel.launches - launched
            rows = read_metrics(run_dir)
            if len(rows) != 1 or algo.iteration != 1:
                raise AssertionError(f"{name}: {len(rows)} metric rows after "
                                     "one iteration")
            assert_finite_rows(rows, name)
            assert_gate_logic(rls, rows, 1, name)
            if not any(not torch.equal(before[k], v)
                       for k, v in rls.params.items()):
                raise AssertionError(f"{name}: training did not change the "
                                     "weights")
            steps = az_iteration_launches(rls, rows)
            if launched != steps:
                raise AssertionError(
                    f"{name}: {step_kernel(rls.env)} launched {launched} "
                    f"times in one iteration, expected {steps}")
            assert_train_state_round_trip(rls, paths, run_dir)
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        row = rows[0]
        evals = {k[5:]: round(v, 3) for k, v in row.items()
                 if k.startswith("eval/")}
        log(f"  {name}: one iteration at difficulty 1 ({cfg.num_episodes} "
            f"lanes, {cfg.num_mcts_searches} simulations, "
            f"{'packed' if cfg.episode_packing else 'aligned'}): loss "
            f"{row['loss']:.4f}, success_rate {row['success_rate']:.3f}, "
            f"evals {evals}, "
            f"{row['steps_collected']:.0f} moves, {launched} "
            f"{step_kernel(rls.env)} launches, {row['iter_seconds']:.2f} s; "
            "train_state.pt round-trips")
        results["_az_iter_seconds"][name] = row["iter_seconds"]
    return read_counters("az_training",
                         ["fused_step", "apply_gates", "metrics_update"])


def search_profile(name: str, lanes: int, sims: int, difficulty: int,
                   rls) -> dict:
    """torch.profiler over one full-width search: kernel launches per
    simulation, the device's busy share of the wall time and the share of
    the hand-written kernels in the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qiskit_gym_torch.rl import mcts_search

    core, policy = rls.env.core, rls.algorithm.policy
    g = torch.Generator(device="cuda")
    g.manual_seed(AZ_SEED)
    state = core.reset(lanes, difficulty, generator=g)
    depth = min(core.max_depth, 32)
    mcts_search(core, policy, state, 4, 1.41, depth, generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mcts_search(core, policy, state, sims, 1.41, depth, generator=g)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**20
    kernels = sorted(
        ((ev.self_device_time_total, ev.key, ev.count)
         for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total),
        reverse=True)
    busy_us = sum(k[0] for k in kernels)
    own_us = sum(us for us, key, _ in kernels
                 if any(tag in key for tag in ("fused_step_kernel",
                                               "apply_kernel", "metrics")))
    launches = sum(k[2] for k in kernels) / sims
    log(f"  profile: one search {name} (B={lanes}, {sims} simulations): "
        f"wall {wall_us:.0f} us under the profiler, device busy "
        f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
        f"{launches:.0f} launches a simulation, hand-written kernels "
        f"{100 * own_us / max(busy_us, 1e-9):.2f}% of device time, peak "
        f"device memory {peak:.0f} MiB")
    for us, key, count in kernels[:5]:
        log(f"    {100 * us / max(busy_us, 1e-9):5.1f}% {us:10.0f} us "
            f"x{count:<6d} {key[:90]}")
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "launches_per_sim": launches,
            "own_kernels_share": own_us / max(busy_us, 1e-9),
            "peak_mib": peak,
            "top": [{"kernel": key[:90], "us": us, "count": c}
                    for us, key, c in kernels[:5]]}


def time_mcts(results: dict) -> None:
    """Profiles of the two full-width searches, one MCTS solve end to end,
    and one AlphaZero iteration without evals at difficulty 4, both on the
    27q Clifford AZ artifact."""
    import torch
    from qiskit_gym_torch.ops import fused_step as fs

    artifacts = results["_az_artifacts"]
    results["_search_profile"] = {
        name: search_profile(name, lanes, sims, difficulty, artifacts[name])
        for name, lanes, sims, difficulty in SEARCHES}
    name = "az_clifford_heavy_hex_27q"
    rls, spec = artifacts[name], AZ_TARGETS[name]
    target = az_targets(rls.env, name)[0]
    before = fs.fused_step.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rls.synth(target, num_searches=AZ_MCTS_LANES,
                    num_mcts_searches=spec["sims"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    moves = (fs.fused_step.launches - before) // (spec["sims"] + 1)
    log(f"  mcts_solve {name}: {AZ_MCTS_LANES} lanes x {spec['sims']} "
        f"simulations, {moves} moves until every lane was final "
        f"({'solved' if out is not None else 'unsolved'}): {sec:.2f} s = "
        f"{1e3 * sec / moves:.0f} ms a move")
    results["_mcts_solve"] = {"seconds": sec, "moves": moves,
                              "lanes": AZ_MCTS_LANES, "sims": spec["sims"]}
    algo, cfg, difficulty = rls.algorithm, rls.rl_config, 4
    T = algo._horizon(difficulty)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = algo.train_step(T, cfg.num_episodes, difficulty)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"  AZ train_step {name}: difficulty {difficulty} (T={T}), "
        f"B={cfg.num_episodes}, {cfg.num_mcts_searches} simulations, "
        f"{cfg.num_epochs} epochs: {sec:.2f} s without evals "
        f"({metrics['steps_collected']:.0f} moves), peak device memory "
        f"{peak:.0f} MiB")
    results["_az_train_step"] = {"seconds": sec, "difficulty": difficulty,
                                 "moves": metrics["steps_collected"],
                                 "peak_mib": peak}


def time_b2(results: dict, g) -> None:
    """Kernel B2 at B=32768, n=27, tracked (its layer rows are what it is
    for; this is the kernel's row) and untracked (what the Pauli serving
    path launches): device time by CUDA-graph replay over a ring of 4
    operand sets, as the other kernels are timed, and over a ring of 16
    (inputs and outputs well beyond the L2, and the graph's own launch
    spread over more kernels)."""
    from qiskit_gym_torch.ops import metrics_kernel as mk

    n = 27
    w = (0.01, 0.02, 0.005, 0.001)
    ring = [b2_inputs(B_BIG, n, g) for _ in range(16)]
    lg, lc, scal = ring[0]
    b2 = {}
    for track, key in ((True, "tracked"), (False, "untracked")):
        r = {"ms": graph_ms(lambda x: mk.metrics_update(*x, w, track),
                            ring[:4]),
             "ms_ring16": graph_ms(lambda x: mk.metrics_update(*x, w, track),
                                   ring),
             "eager_ms": time_ms(lambda x: mk.metrics_update(*x, w, track),
                                 ring[:4]),
             "plain_ms": time_ms(
                 lambda x: mk.metrics_update_plain(*x, w, track), ring[:4]),
             "bytes": (2 * nbytes(lg, lc, scal) if track
                       else 2 * nbytes(scal)) + 4 * B_BIG,
             "ops": B_BIG * ((4 * n if track else 0) + 40)}
        b2[key] = r
    results["metrics_update"].update(b2["tracked"])
    u = b2["untracked"]
    u["bound_ms"] = 1e3 * max(u["bytes"] / HBM_BYTES_PER_S,
                              u["ops"] / INT32_OPS_PER_S)
    log(f"  metrics_update untracked: kernel {1e3 * u['ms']:.2f} us (CUDA "
        f"graph, ring of 4), {1e3 * u['ms_ring16']:.2f} us (ring of 16), "
        f"eager call {1e3 * u['eager_ms']:.2f} us, plain "
        f"{1e3 * u['plain_ms']:.2f} us, bound {1e3 * u['bound_ms']:.2f} us "
        f"({u['bytes'] / 1e6:.1f} MB at B={B_BIG}, n={n}); tracked over the "
        f"ring of 16: {1e3 * b2['tracked']['ms_ring16']:.2f} us")
    results["_b2"] = b2


def time_pauli(results: dict, g) -> None:
    """One 100-lane policy_solve, a 128-step collect at B=32768 and a
    16-step profile on the 27q heavy-hex Pauli artifact."""
    import numpy as np
    import torch
    from qiskit_gym_torch.quantum import Circuit
    from qiskit_gym_torch.rl.rollout import collect
    from qiskit_gym_torch.rl.solve import policy_solve

    n = 27
    name = "pauli_heavy_hex_27q"
    rls = results["_pauli_artifacts"][name]
    env, policy, core = rls.env, rls.algorithm.policy, rls.env.core
    count, depth, nrot, _ = PAULI_TARGETS[name]
    target = Circuit(n)
    for gate in pauli_target_gates(env.gateset, n, np.random.default_rng(3),
                                   depth, nrot):
        target.append(*gate)
    enc = env.get_state(target)
    samples = []
    for i in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        policy_solve(env, policy, enc, num_searches=100, generator=g)
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            samples.append(time.perf_counter() - t0)
    solve_ms = 1e3 * statistics.median(samples)
    log(f"  policy_solve {name}: {core.max_depth} steps x 100 lanes, median "
        f"of 10: {solve_ms:.2f} ms")
    samples = []
    for i in range(4):
        st = core.reset(B_BIG, 32, generator=g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj = collect(core, policy, st, 128, generator=g)
        torch.cuda.synchronize()
        if i:
            samples.append(time.perf_counter() - t0)
        del traj
    sec = statistics.median(samples)
    log(f"  collect {name}: 128 steps x {B_BIG} lanes, median of 3: "
        f"{sec:.3f} s = {128 * B_BIG / sec:.4g} env steps/s")
    results["_pauli_solve_ms"] = solve_ms
    results["_pauli_collect_steps_per_s"] = 128 * B_BIG / sec
    results["_pauli_collect_profile"] = collect_profile(core, policy, g,
                                                        difficulty=32)


# ----------------------------------------------------------------- phase 7
def time_b3(results: dict, g) -> None:
    """Kernel B3 at B=32768 on the dense 27q Clifford state (D=56): a ring
    of 4 states (4 x 206 MB), so every call reads cold data."""
    import torch
    from qiskit_gym_torch.ops import rowop_step as rs

    core = load_dense_core("clifford_heavy_hex_27q")
    ring = []
    for _ in range(4):
        st = core.reset(B_BIG, 16, generator=g)
        a = torch.randint(0, core.num_actions + 1, (B_BIG,), generator=g,
                          device="cuda")
        f = torch.rand(B_BIG, generator=g, device="cuda") < 0.5
        ring.append((st.a, st.ainv, a, f))
    a, ainv, act, f = ring[0]
    out = rs.fused_step_apply(core, a, ainv, act, f)
    r = results["fused_step_apply"]
    r["ms"] = graph_ms(lambda x: rs.fused_step_apply(core, *x), ring)
    r["eager_ms"] = time_ms(lambda x: rs.fused_step_apply(core, *x), ring)
    r["plain_ms"] = time_ms(lambda x: rs.fused_step_apply_plain(core, *x),
                            ring, reps=5)
    r["bytes"] = nbytes(a, ainv, act, f, rs.rowop_table(core), *out)
    # per env: 2 terms x 2 sides x D lanes x ~6 byte operations, and the
    # identity compare of D*D/4 words at ~4 operations each
    r["ops"] = B_BIG * (2 * 2 * core.D * 6 + core.D * core.D)


def time_training(results: dict, g) -> None:
    """A 128-step collect_packed and one whole PPO iteration (collection,
    GAE, 4 epochs x 16 minibatches) at B=2048 lanes and difficulty 64 on the
    27q Clifford config, host clock around work that ends in a synchronize."""
    import torch
    from qiskit_gym_torch.rl.rollout import collect_packed

    rls = results["_trainer"]
    algo, cfg = rls.algorithm, rls.rl_config
    core, B, difficulty = rls.env.core, cfg.num_episodes, 64
    T = algo._horizon(difficulty)
    samples, steps = [], 0
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj, _ = collect_packed(core, algo.policy, T, B, difficulty,
                                    pool_slots=cfg.pack_pool_slots,
                                    generator=g)
        steps = int(traj.valid.sum())
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            samples.append(time.perf_counter() - t0)
        del traj
    sec = statistics.median(samples)
    log(f"  collect_packed clifford_heavy_hex_27q: {T} steps x {B} lanes "
        f"(pool reset included), median of 3: {sec:.3f} s = "
        f"{steps / sec:.4g} env steps/s")
    results["_packed_steps_per_s"] = steps / sec
    samples = []
    for i in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        algo.train_step(T, B, difficulty)
        torch.cuda.synchronize()
        if i:
            samples.append(time.perf_counter() - t0)
    sec = statistics.median(samples)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"  PPO train_step clifford_heavy_hex_27q: T={T}, B={B}, "
        f"{cfg.num_epochs} epochs x {cfg.num_minibatches} minibatches, "
        f"median of 2: {sec:.3f} s per iteration without evals, peak "
        f"device memory {peak:.0f} MiB")
    results["_train_step_seconds"] = sec
    results["_train_step_peak_mib"] = peak


# ------------------------------- phases 13-16: BC, graft, DP, formats
BC_SEED = 2029
# (artifact, difficulties, episodes per difficulty) of the two demo corpora
BC_PAULI = ("az_pauli_heavy_hex_27q_full", (2, 4, 6, 8), 100)
BC_MATRIX = ("clifford_heavy_hex_27q", (4, 8, 12, 16), 100)
BC_EPOCHS, BC_MINIBATCHES = 2, 16
BC_TARGETS = 4          # seeded targets served with each fitted policy
GRAFT = ("az_pauli_heavy_hex_27q_dense", "az_pauli_heavy_hex_27q_full")
GRAFT_TARGETS = 6       # PAULI_TARGETS-style: 4 gates + 1 rotation each
DP_LANES, DP_DIFFICULTY = 2048, 8
TRACE_STEPS = 16
GRID_3x3 = [(0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8), (0, 3), (3, 6),
            (1, 4), (4, 7), (2, 5), (5, 8)]


def bc_artifact(name: str, device: str):
    """The AlphaZero algorithm that fit_demos trains: the shipped AZ
    artifact as it is, or for a PPO artifact an AZ with its env, policy and
    weights (as examples/finetune_clifford_27q_demos.py builds it)."""
    from qiskit_gym_torch.rl import (AlphaZeroConfig, BasicPolicyConfig,
                                     EvalConfig, RLSynthesis)

    with open(os.path.join(MODELS, name + ".json")) as f:
        full = json.load(f)
    if full["algorithm_cls"].endswith("AZ"):
        return load_artifact(name, device)
    ppo = load_artifact(name, device, weights=False)
    cfg = AlphaZeroConfig(num_episodes=8, num_mcts_searches=4, lr=1e-4,
                          evals={"ppo_deterministic": EvalConfig()},
                          diff_metric="ppo_deterministic")
    return RLSynthesis(ppo.env, cfg,
                       BasicPolicyConfig.from_json(full["policy"]),
                       os.path.join(MODELS, name + ".pt"), seed=3)


def bc_targets(env, count: int, rng) -> list:
    """Seeded targets: 4 gates + 1 rotation for a Pauli env, 8 gateset
    gates for a matrix env."""
    from qiskit_gym_torch.quantum import Circuit

    n = env.config["num_qubits"]
    if env.cls_name != "PauliNetworkEnv":
        return [make_target(env, rng, 8) for _ in range(count)]
    targets = []
    for _ in range(count):
        qc = Circuit(n)
        for gate in pauli_target_gates(env.gateset, n, rng, 4, 1):
            qc.append(*gate)
        targets.append(qc)
    return targets


def serve(rls, targets) -> tuple:
    """synth() every target by policy search (100 lanes); every circuit must
    verify. Returns (solved, 2q gate counts)."""
    solved, two_q = 0, []
    for target in targets:
        out = rls.synth(target, num_searches=100)
        if out is None:
            continue
        if not verify_any(rls.env, out, target):
            raise AssertionError(f"{rls.env.cls_name}: synthesized circuit "
                                 "does not implement the target")
        solved += 1
        two_q.append(out.num_2q_gates())
    return solved, two_q


def phase_bc(results: dict) -> dict:
    """Demos and BC at full width: a Pauli corpus on the 27q full gateset
    (303 actions, R = 5) and a matrix corpus on the 27q Clifford env, each
    packed onto the card, fitted from the shipped weights, held against the
    same fit on the CPU, then served."""
    import numpy as np
    import torch
    from qiskit_gym_torch.rl import fit_demos
    from qiskit_gym_torch.rl.demos import (generate_demos,
                                           generate_demos_matrix,
                                           prepare_demos, unpack_rows)

    zero_counters()
    out = {}
    for name, diffs, episodes in (BC_PAULI, BC_MATRIX):
        rls = bc_artifact(name, "cuda")
        cpu = bc_artifact(name, "cpu")
        algo = rls.algorithm
        spec = rls.env.spec
        spec.rng = np.random.default_rng(BC_SEED)
        gen = (generate_demos if rls.env.cls_name == "PauliNetworkEnv"
               else generate_demos_matrix)
        t0 = time.perf_counter()
        demos = gen(spec, list(diffs), episodes)
        gen_s = time.perf_counter() - t0
        N = int(demos["action"].shape[0])
        prepared = prepare_demos(algo, demos)
        packed_mib = sum(prepared[k].numel() * prepared[k].element_size()
                         for k in ("obs_packed", "action", "ret")) / 2**20
        g = torch.Generator().manual_seed(BC_SEED)
        perm = torch.stack([torch.randperm(N, generator=g)
                            for _ in range(BC_EPOCHS)])
        before = {k: v.clone() for k, v in rls.params.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = fit_demos(algo, prepared, epochs=BC_EPOCHS,
                        num_minibatches=BC_MINIBATCHES, perm=perm)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        if not all(np.isfinite(aux[k]) for k in ("loss", "pg_loss",
                                                 "v_loss")):
            raise AssertionError(f"{name}: BC losses {aux}")
        if all(torch.equal(before[k], v) for k, v in rls.params.items()):
            raise AssertionError(f"{name}: BC did not change the weights")
        cpu_aux = fit_demos(cpu.algorithm, demos, epochs=BC_EPOCHS,
                            num_minibatches=BC_MINIBATCHES, perm=perm)
        err = max(float((v.cpu() - cpu.params[k]).abs().max())
                  for k, v in rls.params.items())
        if err > 1e-4:
            raise AssertionError(f"{name}: BC on the card differs from BC "
                                 f"on the CPU by {err} > 1e-4")
        # a second, warm fit for the time a minibatch takes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_demos(algo, prepared, epochs=BC_EPOCHS,
                  num_minibatches=BC_MINIBATCHES, perm=perm)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        # the plain unpack of one minibatch's rows, on the card
        mb = N // BC_MINIBATCHES
        rows = prepared["obs_packed"][perm[0, :mb].cuda()]
        unpack_ms = time_ms(lambda x: unpack_rows(x, demos["obs_bits"]),
                            [rows])
        solved, two_q = serve(rls, bc_targets(
            rls.env, BC_TARGETS, np.random.default_rng(BC_SEED)))
        torch.cuda.synchronize()
        r = {"demo_gen_s": gen_s, "corpus_steps": N,
             "episodes": demos["episodes"], "attempts": demos["attempts"],
             "packed_mib": packed_mib, "fit_s": fit_s, "warm_fit_s": warm_s,
             "minibatch_ms": 1e3 * warm_s / (BC_EPOCHS * BC_MINIBATCHES),
             "unpack_ms": unpack_ms, "loss": aux["loss"],
             "cpu_loss": cpu_aux["loss"], "card_vs_cpu_err": err,
             "solved": [solved, BC_TARGETS], "two_q": two_q}
        log(f"  {name}: {demos['episodes']} demo episodes "
            f"({demos['attempts']} attempts), {N} steps in {gen_s:.2f} s; "
            f"{packed_mib:.3f} MiB packed on the card; fit {BC_EPOCHS} x "
            f"{BC_MINIBATCHES} minibatches of {mb} rows in {fit_s:.3f} s "
            f"(again, warm: {warm_s:.3f} s, {r['minibatch_ms']:.2f} ms a "
            f"minibatch, unpack "
            f"{1e3 * unpack_ms:.1f} us of it), loss {aux['loss']:.4f} "
            f"(CPU {cpu_aux['loss']:.4f}), card vs CPU weights {err:.2e}; "
            f"served {solved}/{BC_TARGETS} (2q gates {two_q})")
        out[name] = r
    launches = read_counters("bc", ["fused_step", "metrics_update"])
    results["_bc"] = out
    return launches


def phase_graft(results: dict) -> dict:
    """The 137-action dense-gateset Pauli artifact grafted into a fresh
    303-action full-gateset policy: shared logits and the value equal the
    source's on 256 seeded observations, then both serve the same seeded
    targets through B2."""
    import numpy as np
    import torch
    from qiskit_gym_torch.models import graft_action_head

    src_name, dst_name = GRAFT
    src = load_artifact(src_name)
    dst = load_artifact(dst_name, weights=False)
    src_gs, dst_gs = src.env.gateset, dst.env.gateset
    dst.algorithm.policy.module.load_state_dict(graft_action_head(
        dst.params, src.params, src_gs, dst_gs))
    core = dst.env.core
    g = torch.Generator(device="cuda").manual_seed(BC_SEED)
    obs = core.dense(core.reset(256, 8, generator=g))
    cols = [dst_gs.index(gate) for gate in src_gs]
    errs = {}
    # float64 holds the graft itself; float32 adds the rounding of a GEMM
    # 303 wide against one 137 wide (cuBLAS picks another kernel)
    for dtype in (torch.float64, torch.float32):
        nets = [copy.deepcopy(r.algorithm.policy).to(dtype)
                for r in (src, dst)]
        with torch.no_grad():
            (s_logits, s_value), (d_logits, d_value) = (
                net(obs.to(dtype)) for net in nets)
        errs[str(dtype)[6:]] = max(
            float((d_logits[:, cols] - s_logits).abs().max()),
            float((d_value - s_value).abs().max()))
        scale = float(s_logits.abs().max())
    err = errs["float64"]
    if err > 1e-5:
        raise AssertionError(f"grafted logits differ from the source's by "
                             f"{err} > 1e-5")
    if errs["float32"] > 1e-5 * max(scale, 1.0):
        raise AssertionError(f"float32 grafted logits differ by "
                             f"{errs['float32']}, over 1e-5 of {scale}")
    # only the grafted policy's solves count for the path; the source's
    # solves of the same targets run outside the window
    solved, counts = {}, {}
    for tag, rls in (("grafted", dst), ("source", src)):
        targets = bc_targets(src.env, GRAFT_TARGETS,
                             np.random.default_rng(PAULI_SEED))
        with (counting(counts) if tag == "grafted"
              else contextlib.nullcontext()):
            solved[tag] = serve(rls, targets)
    torch.cuda.synchronize()
    launches = read_counters("graft", ["metrics_update"], counts)
    log(f"  graft {src_name} ({len(src_gs)} actions) -> {dst_name} "
        f"({len(dst_gs)} actions): shared logits and value within "
        f"{err:.2e} in float64, {errs['float32']:.2e} in float32 (largest "
        f"logit {scale:.2f}), on 256 observations; solved "
        f"{solved['grafted'][0]}/"
        f"{GRAFT_TARGETS} grafted, {solved['source'][0]}/{GRAFT_TARGETS} "
        f"source (2q gates {solved['grafted'][1]} / {solved['source'][1]})")
    results["_graft"] = {"logits_err": errs, "solved": {
        k: [v[0], GRAFT_TARGETS] for k, v in solved.items()}}
    return launches


def phase_dp(results: dict) -> dict:
    """Data parallelism on the card: one NCCL process (world 1) and its
    mesh; a PPO train_step of the 27q Clifford config at 2048 lanes with
    the mesh equals the same step without it, and a policy_solve with the
    mesh verifies."""
    import numpy as np
    import torch
    from qiskit_gym_torch import parallel
    from qiskit_gym_torch.rl import RLSynthesis
    from qiskit_gym_torch.rl.solve import policy_solve

    name = "clifford_heavy_hex_27q"
    store_dir = tempfile.mkdtemp(prefix="qgt_store_")
    parallel.initialize(
        store=torch.distributed.FileStore(
            os.path.join(store_dir, "store"), 1),
        num_processes=1, process_id=0, backend="nccl")
    try:
        mesh = parallel.make_mesh()
        plain = load_artifact(name)
        dp = RLSynthesis.from_config_json(  # same weights and seed
            os.path.join(MODELS, name + ".json"),
            os.path.join(MODELS, name + ".pt"), device="cuda", mesh=mesh)
        T = plain.algorithm._horizon(DP_DIFFICULTY)
        secs, counts = {"plain": [], "dp": []}, {}
        # the first pair is the check (and the warm-up); then, in turns,
        # plain, dp, dp, plain for the times: every pair of steps keeps the
        # two copies equal. Only the steps with the mesh count for the path.
        for tag in ("plain", "dp", "plain", "dp", "dp", "plain"):
            rls = plain if tag == "plain" else dp
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (counting(counts) if tag == "dp"
                  else contextlib.nullcontext()):
                rls.algorithm.train_step(T, DP_LANES, DP_DIFFICULTY)
                torch.cuda.synchronize()
            secs[tag].append(time.perf_counter() - t0)
            if len(secs["dp"]) == 1 and tag == "dp":
                err = max(float((dp.params[k] - v).abs().max())
                          for k, v in plain.params.items())
                if err > 1e-6:
                    raise AssertionError(
                        f"the train_step with a mesh differs from the one "
                        f"without by {err} > 1e-6")
        secs = {k: statistics.median(v[1:]) for k, v in secs.items()}
        env = dp.env
        target = make_target(env, np.random.default_rng(BC_SEED), 8)
        with counting(counts):
            actions = policy_solve(
                env, dp.algorithm.policy, env.get_state(target),
                num_searches=100, generator=torch.Generator(
                    device="cuda").manual_seed(1), mesh=mesh)
        if actions is None:
            raise AssertionError("the policy_solve with a mesh solved nothing")
        out = env.build_circuit_from_solution(actions, target)
        if not verify(env, out, target):
            raise AssertionError("the policy_solve with a mesh gave a wrong "
                                 "circuit")
        launches = read_counters("dp", ["fused_step"], counts)
        backend = torch.distributed.get_backend()
    finally:
        parallel.shutdown()
        shutil.rmtree(store_dir, ignore_errors=True)
    log(f"  {backend} world 1, mesh {tuple(mesh.mesh.shape)}: train_step "
        f"T={T} x {DP_LANES} lanes, params with and without the mesh within "
        f"{err:.2e}; median of 2 after a warm-up: with the mesh "
        f"{secs['dp']:.3f} s, without {secs['plain']:.3f} s; the "
        f"policy_solve with the mesh verified ({len(actions)} gates)")
    results["_dp"] = {"backend": backend, "train_step_s": secs,
                      "params_err": err}
    return launches


def phase_formats(results: dict) -> dict:
    """msgpack and torch.distributed.checkpoint round trips of the 27q
    Clifford params, the native automorphism loader against the pure-Python
    enumerator, and a torch.profiler trace of a B=32768 collect."""
    import torch
    from qiskit_gym_torch.rl.rollout import collect
    from qiskit_gym_torch.spec import symmetry
    from qiskit_gym_torch.utils import native, profiling
    from qiskit_gym_torch.utils.serialization import (async_checkpointer,
                                                      load_params,
                                                      save_params)

    rls = results["_artifacts"]["clifford_heavy_hex_27q"]
    params = rls.params
    tmp = tempfile.mkdtemp(prefix="qgt_formats_")
    try:
        path = os.path.join(tmp, "params.msgpack")
        t0 = time.perf_counter()
        save_params(params, path)
        back = load_params(path)
        msgpack_s = time.perf_counter() - t0
        ckptr = async_checkpointer()
        t0 = time.perf_counter()
        ckptr.save(os.path.join(tmp, "params.orbax"), params)
        ckptr.wait_until_finished()
        dcp = load_params(os.path.join(tmp, "params.orbax"), template=params)
        dcp_s = time.perf_counter() - t0
        msgpack_mib = os.path.getsize(path) / 2**20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for tag, got in (("msgpack", back), ("DCP", dcp)):
        if set(got) != set(params) or not all(
                torch.equal(got[k].cpu(), v.cpu()) for k, v in params.items()):
            raise AssertionError(f"the {tag} round trip is not bit-exact")

    if native.build() is None:
        raise AssertionError("the native automorphism loader did not build")
    autos = {}
    for tag, (n, edges) in (("heavy_hex_27q", (27, None)),
                            ("grid_3x3", (9, GRID_3x3))):
        gateset = (rls.env.gateset if edges is None else
                   [("CX", e) for e in edges] + [("CX", e[::-1])
                                                  for e in edges])
        before = native.graph_automorphisms.calls
        got = symmetry.coupling_automorphisms(n, gateset)
        if native.graph_automorphisms.calls != before + 1:
            raise AssertionError("the pure-Python enumerator answered where "
                                 "the native one should have")
        want = sorted(symmetry._python_automorphisms(
            n, symmetry._adjacency(n, gateset)))
        if got != want:
            raise AssertionError(f"native automorphisms of {tag} differ")
        autos[tag] = len(got)

    core, policy = rls.env.core, rls.algorithm.policy
    g = torch.Generator(device="cuda").manual_seed(BC_SEED)
    st = core.reset(B_BIG, 64, generator=g)
    collect(core, policy, st, 2, generator=g)  # warm-up outside the trace
    tdir = tempfile.mkdtemp(prefix="qgt_trace_")
    zero_counters()
    try:
        with profiling.device_trace(tdir) as prof:
            collect(core, policy, st, TRACE_STEPS, generator=g)
        b1_events = sum(1 for ev in prof.events()
                        if "fused_step_kernel" in ev.name
                        and ev.device_type.name == "CUDA")
        trace_mib = os.path.getsize(os.path.join(tdir, "trace.json")) / 2**20
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    launches = read_counters("formats", ["fused_step"])
    if b1_events != TRACE_STEPS:
        raise AssertionError(f"{b1_events} B1 events in the trace of a "
                             f"{TRACE_STEPS}-step collect")
    log(f"  msgpack {msgpack_mib:.2f} MiB written and read back bit-exact in "
        f"{msgpack_s:.3f} s; DCP (async_checkpointer) bit-exact in "
        f"{dcp_s:.3f} s; native automorphisms {autos} equal the pure-Python "
        f"enumerator's; device_trace of a {TRACE_STEPS}-step collect at "
        f"B={B_BIG}: {b1_events} B1 events, trace {trace_mib:.1f} MiB")
    results["_formats"] = {"msgpack_s": msgpack_s, "dcp_s": dcp_s,
                           "automorphisms": autos, "b1_events": b1_events}
    return launches


# ---------------------------------------------------------------- phase 17
# The flagship walk: the artifact and the difficulty its last walk started
# from (its `trained_with` field). The corpus is cut from the recipe's 1375
# episodes per difficulty (33000 in all, minutes of host time) to this
# many; the difficulties, the seed and everything on the card are the
# recipe's own (PERF.md section 4).
WALK = ("az_pauli_heavy_hex_27q", 25)
WALK_CORPUS_PER_DIFF = 50
WALK_SHAPE = dict(qubits=27, actions=303, lanes=512, sims=96, replay=4)
FINETUNE_AZ_DIFFICULTY = 24


@contextlib.contextmanager
def wrapped(module, name: str, before=None):
    """Replaces `module.name` inside the block with a wrapper that calls
    `before(*args, **kwargs)` first, then the function between two device
    synchronizations; yields the list of (seconds, kwargs) of the calls."""
    import torch

    fn, calls = getattr(module, name), []

    def wrapper(*args, **kwargs):
        if before is not None:
            before(*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, kwargs))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def phase_recipes(results: dict) -> dict:
    """The user programs of `qiskit_gym_torch/examples/` on the card: the
    tour, one burst of the flagship walk at full width and depth, one burst
    of the Clifford demo finetune, and the resume script on the walk's run
    directory."""
    import importlib.util

    import torch
    from qiskit_gym_torch.examples import (_common, intro, resume_training,
                                           walk_pauli_az)
    from qiskit_gym_torch.examples import finetune_clifford_27q_demos as ft
    from qiskit_gym_torch.rl import az as az_mod

    counts, out = {}, {}
    tmp = tempfile.mkdtemp(prefix="qgt_smoke_recipes_")
    try:
        # ---- the tour; each section verifies its own circuit
        t0 = time.perf_counter()
        with counting(counts):
            if importlib.util.find_spec("gymnasium") is not None:
                intro.manual_stepping("cuda")
            else:
                log("  tour section 1 (manual stepping) skipped: gymnasium "
                    "is not installed (the section runs on the host only)")
            intro.run(intro.build("cuda"), os.path.join(tmp, "intro"))
            exact = intro.clifford_phase_exact("cuda")
            if exact is False:
                raise AssertionError("tour: the Clifford circuit is not "
                                     "phase-exact")
            if intro.pauli_network_synthesis("cuda") is not True:
                raise AssertionError("tour: the Pauli circuit is not exact")
        out["tour_seconds"] = time.perf_counter() - t0
        log(f"  tour: sections 2-4 verified (Clifford search "
            f"{'missed' if exact is None else 'exact'}) in "
            f"{out['tour_seconds']:.1f} s")

        # ---- the walk at full width and depth
        stem, start = WALK
        rls = walk_pauli_az.build(stem, device="cuda")
        algo, cfg, core = rls.algorithm, rls.rl_config, rls.env.core
        shape = dict(qubits=core.num_qubits, actions=core.num_actions,
                     lanes=cfg.num_episodes, sims=cfg.num_mcts_searches,
                     replay=cfg.diff_replay)
        if shape != WALK_SHAPE or not cfg.episode_packing:
            raise AssertionError(f"walk: {shape} is not the shipped shape")
        T = algo._horizon(start)
        depth = az_mod._search_depth(T, None)
        if depth != 32:
            raise AssertionError(f"walk: search depth {depth} at T={T}")
        # a checkpoint after the iteration, so that resume has a state
        rls.rl_config = cfg.with_updates(checkpoint_freq=1)
        algo.config = rls.rl_config
        run_dir = os.path.join(tmp, "walk")
        os.makedirs(run_dir)
        evidence = _common.Evidence(run_dir, "evidence.jsonl")
        t0 = time.perf_counter()
        demos = walk_pauli_az.corpus(rls, evidence,
                                     per_diff=WALK_CORPUS_PER_DIFF)
        corpus_s = time.perf_counter() - t0
        before = rls.params             # a copy
        snap = {}

        def keep_params(algo_, *args, **kwargs):
            snap.update(algo_.params)   # the weights the checkpoint holds

        walk_counts = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with counting(walk_counts), \
                wrapped(az_mod, "mcts_search") as searches, \
                wrapped(walk_pauli_az, "fit_demos", keep_params) as refits:
            difficulty, refit = walk_pauli_az.burst(rls, demos, start,
                                                    run_dir, iterations=1)
        burst_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        for k, v in walk_counts.items():
            counts[k] = counts.get(k, 0) + v
        rows = read_metrics(run_dir)
        if len(rows) != 1 or algo.iteration != 1:
            raise AssertionError(f"walk: {len(rows)} metric rows")
        assert_finite_rows(rows, "walk")
        if not math.isfinite(refit["loss"]):
            raise AssertionError(f"walk: refit loss {refit['loss']}")
        if not any(not torch.equal(before[k], v)
                   for k, v in rls.params.items()):
            raise AssertionError("walk: the weights did not change")
        # only a gate-proven promotion raises best_difficulty (the build
        # set it to 0 beside the loaded weights as the best snapshot)
        passed = rows[0]["eval/mcts_100"] >= cfg.diff_threshold
        if (difficulty, algo.best_difficulty) != (
                (start + 1, start) if passed else (start, 0)):
            raise AssertionError("walk: the difficulty does not follow the "
                                 "gate")
        levels = max(min(kw["max_depth"], kw["num_sims"])
                     for _, kw in searches)
        if levels != 32:
            raise AssertionError(f"walk: the descent reached {levels} levels")
        want = az_iteration_launches(rls, rows)
        if walk_counts["metrics_update"] != want:
            raise AssertionError(
                f"walk: B2 launched {walk_counts['metrics_update']} times, "
                f"expected {want} (one per simulation and per played move)")
        collect = [s for s, kw in searches
                   if kw["num_sims"] == cfg.num_mcts_searches]
        gate = [(s, kw["num_sims"]) for s, kw in searches
                if kw["num_sims"] != cfg.num_mcts_searches]
        move_ms = 1e3 * statistics.mean(collect)
        gate_ms = 1e3 * statistics.mean(s for s, _ in gate)
        prof = search_profile(stem, cfg.num_episodes, cfg.num_mcts_searches,
                              start, rls)
        with open(os.path.join(run_dir, "evidence.jsonl")) as f:
            corpus_row = json.loads(f.readline())
        out["walk"] = {
            "difficulty": start, "T": T, "search_depth": levels,
            "corpus_episodes": corpus_row["episodes"],
            "corpus_steps": corpus_row["steps"],
            "corpus_seconds": corpus_s,
            "iter_seconds": rows[0]["iter_seconds"],
            "burst_seconds": burst_s,
            "collect_moves": len(collect), "ms_a_move": move_ms,
            "ms_a_simulation": move_ms / cfg.num_mcts_searches,
            "gate_moves": len(gate), "gate_ms_a_move": gate_ms,
            "gate_ms_a_simulation": gate_ms / gate[0][1],
            "refit_seconds": refits[0][0],
            "b2_launches": walk_counts["metrics_update"],
            "launches_per_sim": prof["launches_per_sim"],
            "device_busy_share": prof["device_busy_us"] / prof["wall_us"],
            "peak_mib": peak, "search_peak_mib": prof["peak_mib"],
            "eval": {k[5:]: v for k, v in rows[0].items()
                     if k.startswith("eval/")},
            "loss": rows[0]["loss"], "refit_loss": refit["loss"],
            "difficulty_after": difficulty,
            "best_difficulty": algo.best_difficulty,
        }
        log(f"  walk {stem} from difficulty {start} (T={T}, descent "
            f"{levels} levels, {cfg.num_episodes} lanes x "
            f"{cfg.num_mcts_searches} simulations, packed, diff_replay "
            f"{cfg.diff_replay}): one learn iteration "
            f"{rows[0]['iter_seconds']:.1f} s (burst {burst_s:.1f} s); self-play {len(collect)} "
            f"moves at {move_ms:.0f} ms a move = "
            f"{move_ms / cfg.num_mcts_searches:.2f} ms a simulation; gate "
            f"eval {len(gate)} moves at {gate_ms:.0f} ms a move; refit "
            f"{refits[0][0]:.2f} s (loss {refit['loss']:.4f}); "
            f"{walk_counts['metrics_update']} B2 launches as expected; "
            f"evals {out['walk']['eval']}; difficulty {start} -> "
            f"{difficulty}, best {algo.best_difficulty}; peak device memory "
            f"{peak:.0f} MiB; corpus {corpus_row['episodes']} episodes, "
            f"{corpus_row['steps']} steps in {corpus_s:.1f} s")

        # ---- resume on the walk's run directory
        back = resume_training.build(_common.shipped(stem), run_dir,
                                     device="cuda")
        if (back.algorithm.iteration, back.env.difficulty) != (
                algo.iteration, rls.env.difficulty):
            raise AssertionError("resume: iteration or difficulty differs")
        for k, v in back.params.items():
            if not torch.equal(v, snap[k]):
                raise AssertionError(f"resume: weight {k} differs")
        log(f"  resume_training on the walk's run directory: iteration "
            f"{back.algorithm.iteration}, difficulty {back.env.difficulty}, "
            "weights bit for bit")

        # ---- the Clifford demo finetune, one burst
        ft_rls = ft.build("cuda")
        ft_dir = os.path.join(tmp, "finetune")
        os.makedirs(ft_dir)
        t0 = time.perf_counter()
        ft_demos = ft.corpus(ft_rls, _common.Evidence(ft_dir, "corpus.jsonl"))
        ft_corpus_s = time.perf_counter() - t0
        with counting(counts), wrapped(ft, "fit_demos") as fits:
            t0 = time.perf_counter()
            lift = ft.run(ft_rls, minutes=1e-3, out=ft_dir, demos=ft_demos)
            ft_burst_s = time.perf_counter() - t0
            az_dir = os.path.join(tmp, "finetune_az")
            ft_rls.learn(initial_difficulty=FINETUNE_AZ_DIFFICULTY,
                         num_iterations=1, tb_path=az_dir)
            torch.cuda.synchronize()
        az_rows = read_metrics(az_dir)
        assert_finite_rows(az_rows, "finetune AZ")
        bc_ms = 1e3 * fits[0][0] / (2 * 64)
        out["finetune"] = {
            "corpus_steps": int(ft_demos["action"].shape[0]),
            "corpus_seconds": ft_corpus_s, "burst_seconds": ft_burst_s,
            "bc_ms_a_minibatch": bc_ms, "lift_best10@24": lift,
            "az_iter_seconds": az_rows[0]["iter_seconds"],
            "az_difficulty": FINETUNE_AZ_DIFFICULTY}
        log(f"  finetune {ft.SOURCE}: corpus {ft_demos['action'].shape[0]} "
            f"steps (12..36 x {ft.PER_DIFF}) in {ft_corpus_s:.1f} s; one "
            f"burst {ft_burst_s:.1f} s, BC {bc_ms:.2f} ms a minibatch (2 x "
            f"64), lift best-of-10 @ d24 {lift:+.3f}; one AZ iteration of "
            f"its stack at difficulty {FINETUNE_AZ_DIFFICULTY} "
            f"{az_rows[0]['iter_seconds']:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["_recipes"] = out
    return read_counters("recipes", ["fused_step", "apply_gates",
                                     "metrics_update"], counts)


# ----------------------------------------------------------------- phase 18
# The large instances: Clifford on the 127- and 433-qubit lines at the batch
# widths of the JAX package's `bench.py --scale` (the port's bench_core,
# `tools/bench.py`: reset at difficulty 8, SCALE_STEPS steps of pregenerated
# random actions and flips), and lanes of the serving checks.
LARGE = ((127, 8192, 100), (433, 1024, 16))   # (qubits, B, synth lanes)
SCALE_STEPS = 32
# cores of the bit-for-bit check, (kind, qubits, B): W = 3 (33q Clifford,
# 65q linear function and permutation), three whole words (48q Clifford),
# W = 8 and W = 28 at the scale widths
WIDE_CHECKS = (("clifford", 33, 4096), ("clifford", 48, 4096),
               ("linear", 65, 4096), ("permutation", 65, 4096),
               ("clifford", 127, 8192), ("clifford", 433, 1024))
WIDE_STEPS = 16
LARGE_SEED = 2030
LARGE_LEARN = dict(qubits=127, lanes=256, difficulty=16)   # T = 32
CONSTRUCT_GATES = 12      # gates of each solve-by-construction target
LARGE_GYMS = {"clifford": "CliffordGym", "linear": "LinearFunctionGym",
              "permutation": "PermutationGym"}


def dense_line_core(n: int, device: str = "cuda"):
    """The dense (bitpack=False) Clifford core on the n-qubit line, with
    the gateset `CliffordGym.from_coupling_map` gives the line: D = 2n
    rounded up to a multiple of 8 (344 at 172 qubits, 872 at 433)."""
    from qiskit_gym_torch.envs.synthesis import ONE_Q_GATES, TWO_Q_GATES
    from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore

    gateset = ([(g, (q,)) for g in ONE_Q_GATES for q in range(n)]
               + [(g, (i, i + 1)) for g in TWO_Q_GATES for i in range(n - 1)])
    return MatrixEnvCore(n, gateset, "clifford", bitpack=False,
                         device=device)


def line_gym(kind: str, n: int, **kw):
    """The gym of `kind` on the n-qubit line, on the card, and the host
    seconds its construction took."""
    from qiskit_gym_torch import envs

    line = [(i, i + 1) for i in range(n - 1)]
    t0 = time.perf_counter()
    gym = getattr(envs, LARGE_GYMS[kind]).from_coupling_map(
        line, device="cuda", **kw)
    return gym, time.perf_counter() - t0


def hold_b1(results: dict, core, B: int, steps: int, g, what: str) -> None:
    """Kernel B1 (and its apply part) against the plain versions on `core`
    at batch B, from a reset on the card: `steps` steps of seeded actions
    (no-ops included) and flips where the core adds inverses, tracked and
    untracked. The errors go to the W <= 2 or the wide rows by the core's
    W; the core's own `track_layers` is restored."""
    import torch
    from qiskit_gym_torch.ops import fused_step as fs

    inv, kept = core.add_inverts, core.track_layers
    wide = "_wide" if core.W >= 3 else ""
    try:
        for track in (False, True):
            core.track_layers = track
            state = core.reset(B, 8, generator=g)
            acts = torch.randint(0, core.num_actions + 1, (steps, B),
                                 generator=g, device="cuda")
            acts[:, ::7] = core.noop_action
            flips = torch.rand((steps, B), generator=g,
                               device="cuda") < 0.5
            ka, ki = fs.apply_gates(core, state.a, state.ainv, acts[0])
            pa, pi = fs.apply_plain(core.op_tab[acts[0]], state.a,
                                    state.ainv, core.W, core.dim, inv)
            if not (torch.equal(ka, pa) and torch.equal(ki, pi)):
                raise AssertionError(f"apply_gates differs on {what}")
            results["apply_gates" + wide]["err"] = max(
                results["apply_gates" + wide]["err"],
                max_abs_err((ka, ki), (pa, pi)))
            for t in range(steps):
                flip = flips[t] if inv else None
                got = fs.fused_step(core, state, acts[t], flip)
                want = fs.fused_step_plain(core, state, acts[t], flip)
                assert_identical(got, want, f"fused_step {what} "
                                 f"track={track} t={t}")
                results["fused_step" + wide]["err"] = max(
                    results["fused_step" + wide]["err"],
                    max_abs_err(got, want))
                state = got
    finally:
        core.track_layers = kept
    torch.cuda.synchronize()


def wide_check(results: dict, kind: str, n: int, B: int, g) -> None:
    """Kernel B1 against the plain versions on one wide core (`hold_b1`),
    add_inverts on and off."""
    for inv in (True, False):
        core = line_gym(kind, n, add_inverts=inv)[0].core
        hold_b1(results, core, B, WIDE_STEPS, g,
                f"{kind} {n}q add_inverts={inv}")
    log(f"  B1 {kind} {n}q (dim {core.dim}, W={core.W}): {WIDE_STEPS} "
        f"steps at B={B}, tracked and untracked, add_inverts on and off, "
        "and the apply kernel: bit-identical to the plain versions")


def b2_large_check(results: dict, g) -> None:
    """Kernel B2 at n = 127 and 433 (the scale widths), tracked and
    untracked, operands on and off a 16-byte mark."""
    import torch
    from qiskit_gym_torch.ops import metrics_kernel as mk

    weights = (0.01, 0.02, 0.005, 0.001)
    for n, B, _ in LARGE:
        ops = b2_inputs(B, n, g)
        for operands in (ops, tuple(unaligned(t) for t in ops)):
            for track in (True, False):
                got = mk.metrics_update(*operands, weights, track)
                want = mk.metrics_update_plain(*operands, weights, track)
                for gt, wt in zip(got, want):
                    if gt.dtype != wt.dtype or not torch.equal(gt, wt):
                        raise AssertionError(f"metrics_update differs at "
                                             f"n={n} B={B} track={track}")
                results["metrics_update"]["err"] = max(
                    results["metrics_update"]["err"], max_abs_err(got, want))
    torch.cuda.synchronize()
    log(f"  B2 at n = {', '.join(str(n) for n, _, _ in LARGE)} (B = "
        f"{', '.join(str(B) for _, B, _ in LARGE)}), tracked and untracked, "
        "aligned and not: bit-identical to the plain version")


def scale_run(core, B: int, g, acc: dict) -> dict:
    """The bench's run on the port's core (`tools/bench.measure_core`,
    bench_core's semantics: reset at difficulty 8, a warm-up and 3 timed
    runs of SCALE_STEPS steps of pregenerated random actions and flips),
    its launches counted into `acc`: one B1 launch a step and finite
    rewards. Returns the throughput, the peak device memory and kernel
    times."""
    import torch
    from qiskit_gym_torch.ops import fused_step as fs
    from qiskit_gym_torch.ops import metrics_kernel as mk
    from qiskit_gym_torch.tools import bench

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting(acc):
        run = bench.measure_core(core, B, SCALE_STEPS, generator=g)
    if run["b1_per_step"] != 1.0:
        raise AssertionError(f"B1 launched {run['b1_per_step']} times a "
                             "step")
    if not bool(torch.isfinite(run["state"].reward).all()):
        raise AssertionError("a reward of the scale run is not finite")
    del run["state"]
    peak = torch.cuda.max_memory_allocated() / 2**20
    steps_per_s = run["steps_per_s"]

    # device times, CUDA graph replays: B1 and apply over a ring of 4
    # states (133 MB each at 127 qubits, 198 MB at 433: every call reads
    # cold data), B2 over a ring of 16 operand sets
    ring = []
    for _ in range(4):
        st = core.reset(B, 8, generator=g)
        a = torch.randint(0, core.num_actions + 1, (B,), generator=g,
                          device="cuda")
        f = torch.rand(B, generator=g, device="cuda") < 0.5
        ring.append((st, a, f))
    st, a, f = ring[0]
    out = fs.fused_step(core, st, a, f)
    b1_bytes = (nbytes(a, f, st.a, st.ainv, st.depth, st.inverted,
                       st.n_cnots, st.n_gates)
                + nbytes(out.a, out.ainv, out.depth, out.success, out.reward,
                         out.inverted, out.n_cnots, out.n_gates))
    ops = B * core.dim * core.W * 2 * 8 * 2
    o_a, o_ainv = torch.empty_like(st.a), torch.empty_like(st.ainv)

    def copy(x):  # the same bytes as the apply part, nothing computed
        o_a.copy_(x[0].a)
        o_ainv.copy_(x[0].ainv)

    r = {"B": B, "dim": core.dim, "W": core.W,
         "env_steps_per_s": steps_per_s, "peak_mib": peak,
         "fused_step": {
             "ms": graph_ms(lambda x: fs.fused_step(core, *x), ring),
             "eager_ms": time_ms(lambda x: fs.fused_step(core, *x), ring),
             "plain_ms": time_ms(lambda x: fs.fused_step_plain(core, *x),
                                 ring),
             "bytes": b1_bytes, "ops": ops},
         "apply_gates": {
             "ms": graph_ms(lambda x: fs.apply_gates(
                 core, x[0].a, x[0].ainv, x[1]), ring),
             "eager_ms": time_ms(lambda x: fs.apply_gates(
                 core, x[0].a, x[0].ainv, x[1]), ring),
             "plain_ms": time_ms(lambda x: fs.apply_plain(
                 core.op_tab[x[1]], x[0].a, x[0].ainv, core.W, core.dim,
                 True), ring),
             "bytes": nbytes(a, st.a, st.ainv) + 2 * nbytes(st.a),
             "ops": ops},
         "copy": {"ms": graph_ms(copy, ring), "bytes": 4 * nbytes(st.a),
                  "ops": 0}}
    b2_ring = [b2_inputs(B, core.num_qubits, g) for _ in range(16)]
    w = (0.01, 0.02, 0.005, 0.001)
    for track in (True, False):
        lg, lc, scal = b2_ring[0]
        moved = nbytes(scal) * 2 + (4 * nbytes(lg) if track else 0)
        r[f"metrics_update_{'tracked' if track else 'untracked'}"] = {
            "ms": graph_ms(lambda x: mk.metrics_update(*x, w, track),
                           b2_ring),
            "plain_ms": time_ms(lambda x: mk.metrics_update_plain(
                *x, w, track), b2_ring),
            "bytes": moved, "ops": B * 64}
    for k, v in r.items():
        if isinstance(v, dict):
            v["bound_ms"] = 1e3 * max(v["bytes"] / HBM_BYTES_PER_S,
                                      v["ops"] / INT32_OPS_PER_S)
    return r


def construct_targets(env, rng, count: int):
    """`count` seeded targets of CONSTRUCT_GATES gateset gates each, with
    no gate repeated back to back: (circuits, action lists)."""
    from qiskit_gym_torch.quantum import Circuit

    targets, actions = [], []
    for _ in range(count):
        acts = [int(rng.integers(len(env.gateset)))]
        while len(acts) < CONSTRUCT_GATES:
            a = int(rng.integers(len(env.gateset)))
            if a != acts[-1]:
                acts.append(a)
        targets.append(Circuit.from_gate_list(
            [env.gateset[a] for a in acts],
            num_qubits=env.config["num_qubits"]))
        actions.append(acts)
    return targets, actions


def solve_by_construction(env, rng, lanes: int = 4) -> None:
    """set_state a target of CONSTRUCT_GATES gates on each lane, then step
    the target's own gates, in order, on the card: the state holds the
    target's inverse, which they undo. Success and the reward fire at
    exactly the last step, and the decoded circuit implements the target."""
    import numpy as np
    import torch

    core = env.core
    targets, actions = construct_targets(env, rng, lanes)
    enc = [env.get_state(t) for t in targets]
    state = core.set_state(np.stack([env.encoded_to_dense(e) for e in enc]))
    plan = torch.tensor(actions, device="cuda")
    no_flip = torch.zeros(lanes, dtype=torch.bool, device="cuda")
    fired = []
    for t in range(CONSTRUCT_GATES):
        state = core.step(state, plan[:, t].contiguous(),
                          invert_override=no_flip)
        fired.append((state.success.cpu(), state.reward.cpu()))
    for t, (success, reward) in enumerate(fired):
        last = t == CONSTRUCT_GATES - 1
        if bool(success.any()) != last or (last and not success.all()):
            raise AssertionError(f"solve by construction: success at step "
                                 f"{t} is {success.tolist()}")
        if bool((reward > 0.5).any()) != last or (last and not
                                                  (reward > 0.5).all()):
            raise AssertionError(f"solve by construction: reward at step "
                                 f"{t} is {reward.tolist()}")
    for lane in range(lanes):
        sol = env.solution_from_trace(enc[lane], plan[lane].tolist(),
                                      [False] * CONSTRUCT_GATES)
        out = env.build_circuit_from_solution(sol, targets[lane])
        if not verify(env, out, targets[lane]):
            raise AssertionError("solve by construction: the decoded "
                                 "circuit does not implement the target")


def phase_large(results: dict) -> dict:
    """Large instances on the card: the wide B1 and apply kernels and B2 at
    127 and 433 qubits against their plain versions, `bench.py --scale`'s
    configuration through the port's core, RLSynthesis.synth with a seeded
    fresh policy, the solve-by-construction check, and one learn iteration
    at 127 qubits through collect_packed."""
    import numpy as np
    import torch
    from qiskit_gym_torch.ops import fused_step as fs
    from qiskit_gym_torch.rl import RLSynthesis
    from qiskit_gym_torch.rl.configs import BasicPolicyConfig, PPOConfig

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(LARGE_SEED)
    for kind, n, B in WIDE_CHECKS:
        wide_check(results, kind, n, B, g)
    b2_large_check(results, g)

    launches: dict = {}
    out = {"scale": {}, "synth": {}}
    rng = np.random.default_rng(LARGE_SEED)
    gyms = {}
    for n, B, lanes in LARGE:
        gym, build_s = line_gym("clifford", n, max_depth=128)
        gyms[n] = gym
        r = scale_run(gym.core, B, g, launches)
        r["build_s"] = build_s
        out["scale"][n] = r
        r["occupancy"] = fs.wide_occupancy(r["W"], r["dim"])
        log(f"  scale clifford_{n}q_line (dim {r['dim']}, W={r['W']}, "
            f"B={B}; wide kernels {r['occupancy']}): core built in "
            f"{build_s:.2f} s of host time, "
            f"{r['env_steps_per_s']:.4g} env steps/s over {SCALE_STEPS} "
            f"steps (eager, bench_core: the fastest of 3 after a warm-up), "
            f"peak device memory "
            f"{r['peak_mib']:.0f} MiB")
        for k in ("fused_step", "apply_gates", "metrics_update_tracked",
                  "metrics_update_untracked"):
            v = r[k]
            copy = (f", same-bytes copy {1e3 * r['copy']['ms']:.2f} us"
                    if k in WIDE_OF.values() else "")
            log(f"    {k}: kernel {1e3 * v['ms']:.2f} us (CUDA graph, median "
                f"of 20; {100 * v['bound_ms'] / v['ms']:.1f} % of its "
                f"bound), plain {1e3 * v['plain_ms']:.2f} us, bound "
                f"{1e3 * v['bound_ms']:.2f} us ({v['bytes'] / 1e6:.1f} "
                f"MB){copy}")
        log(f"    copy of a and ainv (o.copy_ x 2, the yardstick): "
            f"{1e3 * r['copy']['ms']:.2f} us, "
            f"{r['copy']['bytes'] / r['copy']['ms'] / 1e9:.3f} TB/s")

        # serving through the user's entry point, a seeded fresh policy
        torch.manual_seed(LARGE_SEED)
        rls = RLSynthesis(gym, PPOConfig(), BasicPolicyConfig())
        targets, _ = construct_targets(gym, rng, 2)
        solved = 0
        t0 = time.perf_counter()
        for target in targets:
            with counting(launches):
                before = fs.fused_step.launches
                circ = rls.synth(target, num_searches=lanes)
                steps = fs.fused_step.launches - before
            if steps != gym.core.max_depth:
                raise AssertionError(f"{n}q synth: B1 launched {steps} "
                                     f"times, expected {gym.core.max_depth}")
            if circ is not None:
                if not verify(gym, circ, target):
                    raise AssertionError(f"{n}q synth: the circuit does not "
                                         "implement the target")
                solved += 1
        torch.cuda.synchronize()
        synth_s = (time.perf_counter() - t0) / len(targets)
        weights = sum(p.numel() for p in rls.algorithm.policy.parameters())
        out["synth"][n] = {"lanes": lanes, "solved": solved,
                           "targets": len(targets), "seconds": synth_s,
                           "policy_weights": weights}
        log(f"  synth clifford_{n}q_line: {lanes} lanes, "
            f"{gym.core.max_depth} B1 launches a call, {synth_s:.2f} s a "
            f"target, {solved}/{len(targets)} solved by the fresh policy "
            f"({weights / 1e6:.1f} M weights; every returned circuit "
            "verified)")
        del rls

        with counting(launches):
            solve_by_construction(gym, rng)
        log(f"  solve by construction clifford_{n}q_line: {CONSTRUCT_GATES}"
            "-gate targets on 4 lanes, success and reward at exactly the "
            "last step, decoded circuits verified")

    # one learn iteration at 127 qubits through collect_packed
    spec = LARGE_LEARN
    gym = gyms[spec["qubits"]]
    torch.manual_seed(LARGE_SEED)
    cfg = PPOConfig(num_episodes=spec["lanes"], episode_packing=True,
                    evals={})
    rls = RLSynthesis(gym, cfg, BasicPolicyConfig())
    before = {k: v.clone() for k, v in rls.params.items()}
    run_dir = tempfile.mkdtemp(prefix="qgt_large_")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with counting(launches):
            b1 = fs.fused_step.launches
            rls.learn(initial_difficulty=spec["difficulty"],
                      num_iterations=1, tb_path=run_dir)
            torch.cuda.synchronize()
            b1 = fs.fused_step.launches - b1
        learn_s = time.perf_counter() - t0
        rows = read_metrics(run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    T = rls.algorithm._horizon(spec["difficulty"])
    if len(rows) != 1:
        raise AssertionError(f"{len(rows)} metric rows after one iteration")
    assert_finite_rows(rows, "large learn")
    if b1 != T:
        raise AssertionError(f"B1 launched {b1} times in a {T}-step "
                             "collection")
    if not any(not torch.equal(before[k], v)
               for k, v in rls.params.items()):
        raise AssertionError("the learn iteration did not change the "
                             "weights")
    row = rows[0]
    peak = torch.cuda.max_memory_allocated() / 2**20
    out["learn"] = {"seconds": learn_s, "T": T, "lanes": spec["lanes"],
                    "loss": row["loss"], "steps": row["steps_collected"],
                    "peak_mib": peak}
    log(f"  learn clifford_{spec['qubits']}q_line: one iteration, "
        f"{spec['lanes']} lanes x T={T} (collect_packed, "
        f"{cfg.num_epochs} epochs, no evals) in {learn_s:.2f} s, loss "
        f"{row['loss']:.4f}, {row['steps_collected']:.0f} steps, weights "
        f"changed, peak device memory {peak:.0f} MiB")
    del rls
    launches = read_counters("large", list(WIDE_OF), launches)
    # the wide rows of the {"kernels"} line: the 433-qubit shape
    scale = out["scale"][LARGE[-1][0]]
    for k, w in WIDE_OF.items():
        results[k].update(scale[w], B=scale["B"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 18: {out['seconds']:.1f} s")
    results["_large"] = out
    return launches


# ---------------------------------------------------------------- phase 19
# The JAX package's quality rows that phase 19 is held against: the first
# difficulty of every `eval_specs` row and the first depth of the synth
# rows it runs, copied from docs/QUALITY.md (the JAX package's table:
# label -> (difficulty, solve rate, mean 2q, episodes or targets of the
# port's row)). The two artifacts that table leaves out have rows of the
# JAX package's own eval_artifact on the CPU at 512 episodes
# (probes/jax_quality_rows.py): a 128-episode draw spreads by more than
# its binomial error between seeds (probes/eval_seed_probe.py).
JAX_EVAL_ROWS = {
    "perm_grid_3x3 (PPO, 10 searches)": (4, 1.00, 10.2, 256),
    "lf_5_line (PPO, 10 searches)": (4, 1.00, 3.0, 256),
    "clifford_3q_line (PPO, 10 searches)": (4, 0.99, 0.7, 256),
    "clifford_3q_custom (PPO, 10 searches)": (4, 1.00, 3.4, 256),
    "perm_heavy_hex_27q (PPO, 10 searches)": (8, 1.00, 19.9, 128),
    "clifford_heavy_hex_27q (PPO, 10 searches)": (8, 1.00, 5.0, 128),
    "pauli_5_line (PPO, 10 searches)": (16, 1.00, 7.6, 128),
    "pauli_12_line (PPO, 10 searches)": (4, 1.00, 4.2, 128),
    "pauli_heavy_hex_27q (PPO, 10 searches)": (4, 1.00, 2.7, 128),
    "az_pauli_18_line (MCTS-64, argmax)": (4, 1.00, 4.4, 64),
    "az_perm_grid_3x3 (MCTS-64, argmax)": (4, 1.00, 12.9, 64),
    "az_perm_heavy_hex_27q (MCTS-96, argmax)": (4, 1.00, 10.7, 64),
    "az_clifford_heavy_hex_27q (MCTS-48, argmax)": (8, 1.00, 5.1, 64),
    "az_pauli_heavy_hex_27q (MCTS-96, argmax)": (4, 1.00, 2.6, 64),
    "az_pauli_heavy_hex_27q_dense (MCTS-96, argmax)": (4, 1.00, 4.6, 64),
    "az_pauli_heavy_hex_27q_full (MCTS-96, argmax)": (4, 1.00, 4.5, 64),
    "pauli_18_line (PPO, 10 searches)": (2, 0.740234375, 1.47, 128),
    "pauli_heavy_hex_27q_dense (PPO, 10 searches)": (2, 0.869140625, 1.31,
                                                     128),
}
JAX_SYNTH_ROWS = {
    "perm_grid_3x3": (4, 1.00, 3.2, 24),
    "lf_5_line": (4, 1.00, 3.0, 24),
    "clifford_3q_line": (4, 1.00, 0.6, 24),
    "clifford_3q_custom": (4, 1.00, 2.3, 24),
    "pauli_5_line (2 rotations)": (3, 1.00, 3.0, 24),
    "pauli_12_line (2 rotations)": (3, 1.00, 1.7, 24),
    "pauli_heavy_hex_27q (Clifford regime)": (4, 1.00, 7.6, 24),
    "az_pauli_18_line (2 rotations)": (3, 1.00, 3.2, 12),
    "az_pauli_heavy_hex_27q (MCTS-32, 4 searches)": (4, 1.00, 6.0, 12),
}
# What phase 19 cuts is depth: the synth rows' target counts, the BC
# corpus, the finetunes' scoring targets and eval episodes. Widths,
# simulation counts, lanes and eval episodes of the table rows are the
# table's own. Two synth rows take one target: the MCTS row (about 20 s a
# target on the card) and pauli_12_line's, whose unitary check of two
# 4096 x 4096 unitaries takes about 15 s of host time a target.
TOOLS_SYNTH_TARGETS = 4
MCTS_SYNTH_ROW = "az_pauli_heavy_hex_27q (MCTS-32, 4 searches)"
ONE_TARGET_SYNTH_ROWS = (MCTS_SYNTH_ROW, "pauli_12_line (2 rotations)")
CONFIG5 = dict(difficulty=4, targets=1)        # 100 lanes x 1000 sims
BFS_TABLES = {"perm_grid_3x3": (362880, 16),   # the JAX script's evidence
              "clifford_3q_custom": (1451520, 23)}
BC_PER_SHELL = 200
TOOLS_SCORE_TARGETS = 2
PAULI_BC_PER_DIFF = 5
GRAFT_EPISODES = 16
# kernel B3's streaming path: dense Clifford line cores (qubits, D) at a B
# whose two tiles fill at least 1 GiB, and the steps of the dense walk
B3_LARGE = ((172, 344), (433, 872))
B3_LARGE_TILE_BYTES = 1 << 30
B3_LARGE_STEPS = 8


def models_digest() -> dict:
    """sha256 of every file under examples/models/."""
    import hashlib

    out = {}
    for path in sorted(glob.glob(os.path.join(MODELS, "*"))):
        with open(path, "rb") as f:
            out[os.path.basename(path)] = hashlib.sha256(f.read()).hexdigest()
    return out


def eval_floor(rate: float, n: int) -> float:
    """The least solve rate an eval row may show against a JAX row of
    `rate` over `n` episodes: less max(0.05, 3 standard errors)."""
    return rate - max(0.05, 3 * math.sqrt(rate * (1 - rate) / n))


def eval_ceiling_2q(two_q: float) -> float:
    """The most 2q gates a solved target of an eval row may take on
    average against a JAX row of `two_q`: 15 % more, and a quarter gate
    for rows of one or two gates (the rows of phase 19 read 16 % fewer to
    10 % more than the JAX rows, PERF.md section 6)."""
    return 1.15 * two_q + 0.25


def b3_large_check(results: dict, n: int, g, launches: dict) -> dict:
    """Kernel B3's streaming path on the dense n-qubit Clifford line: a
    dense walk of B3_LARGE_STEPS steps carried by B3 (counted: the path)
    checked against the dense core's own step, then the kernel against its
    plain version bit for bit (not counted), and timed."""
    import torch
    from qiskit_gym_torch.ops import rowop_step as rs

    core = dense_line_core(n)
    D = core.D
    B = -(-B3_LARGE_TILE_BYTES // (2 * D * D))   # tiles of >= 1 GiB
    start = core.reset(B, 8, generator=g)
    acts = torch.randint(0, core.num_actions + 1, (B3_LARGE_STEPS, B),
                         generator=g, device="cuda")
    flips = torch.rand((B3_LARGE_STEPS, B), generator=g, device="cuda") < 0.5
    a, ainv = start.a, start.ainv
    with counting(launches):
        for t in range(B3_LARGE_STEPS):
            a, ainv, success = rs.fused_step_apply(core, a, ainv, acts[t],
                                                   flips[t])
        torch.cuda.synchronize()
    state = start
    for t in range(B3_LARGE_STEPS):
        state = core.step(state, acts[t], invert_override=flips[t])
    for field, got, want in (("a", a, state.a), ("ainv", ainv, state.ainv),
                             ("success", success, state.success)):
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"B3 D={D}: {field} differs from the "
                                 f"dense step after {B3_LARGE_STEPS} steps")
    del state
    r = results["fused_step_apply_large"]
    x = (a, ainv, acts[0], flips[0])
    got = rs.fused_step_apply(core, *x)
    want = rs.fused_step_apply_plain(core, *x)
    for field, gt, wt in zip(("new_a", "new_ainv", "success"), got, want):
        if gt.dtype != wt.dtype or not torch.equal(gt, wt):
            raise AssertionError(f"B3 D={D} B={B}: {field} differs from "
                                 "its plain version")
    r["err"] = max(r["err"], max_abs_err(got, want))
    del got, want
    ring = [x, (start.a, start.ainv, acts[1], flips[1])]
    out = {"D": D, "B": B, "tile_gib": 2 * B * D * D / 2**30}
    out["ms"] = graph_ms(lambda y: rs.fused_step_apply(core, *y), ring)
    out["eager_ms"] = time_ms(lambda y: rs.fused_step_apply(core, *y), ring,
                              reps=5)
    out["plain_ms"] = time_ms(lambda y: rs.fused_step_apply_plain(core, *y),
                              ring[:1], reps=3)
    # a and ainv read and written once, the actions, flips, table, solved
    out["bytes"] = (4 * B * D * D + nbytes(acts[0], flips[0],
                                           rs.rowop_table(core)) + B)
    out["ops"] = B * (2 * 2 * D * 6 + D * D // 2)
    out["bound_ms"] = 1e3 * max(out["bytes"] / HBM_BYTES_PER_S,
                                out["ops"] / INT32_OPS_PER_S)
    log(f"  B3 streaming, dense clifford_{n}q_line (D={D}, B={B}, "
        f"{out['tile_gib']:.2f} GiB of tiles): {B3_LARGE_STEPS}-step walk "
        f"identical to the dense step, the kernel bit for bit its plain "
        f"version; device {1e3 * out['ms']:.2f} us (CUDA graph, median of "
        f"20), bound {1e3 * out['bound_ms']:.2f} us "
        f"({100 * out['bound_ms'] / out['ms']:.1f} %), eager "
        f"{1e3 * out['eager_ms']:.2f} us, plain {1e3 * out['plain_ms']:.2f}"
        " us")
    return out


def phase_tools(results: dict) -> dict:
    """The quality and artifact tools of qiskit_gym_torch/tools/ on the
    card, at the artifacts' widths with depth cut; B3's streaming path."""
    import torch
    from qiskit_gym_torch.tools import (bench_baseline5, bench_quality,
                                        finetune_brevity, finetune_pauli_ppo,
                                        graft_pauli_ppo, optimal_bc)

    t_phase = time.perf_counter()
    digest = models_digest()
    launches: dict = {}
    out = {"evals": {}, "synth": {}, "seconds": {}}
    tmp = tempfile.mkdtemp(prefix="qgt_tools_")

    def timed(what, fn):
        t0 = time.perf_counter()
        with counting(launches):
            value = fn()
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out["seconds"][what] = sec
        log(f"  tool {what}: {sec:.1f} s")
        return value

    try:
        # the eval table: one row a shipped artifact, its first difficulty
        specs = {**bench_quality.EVAL_SPECS, **bench_quality.EXTRA_EVAL_SPECS}
        failed = []
        for label, (name, kw) in specs.items():
            d, rate, two_q, n = JAX_EVAL_ROWS[label]
            kw = dict(kw, difficulties=[d])
            (row,) = timed(f"eval {label}", lambda: bench_quality.
                           eval_artifact(name, device="cuda", **kw))
            floor, ceiling = eval_floor(rate, n), eval_ceiling_2q(two_q)
            out["evals"][label] = dict(row, jax_rate=rate, jax_2q=two_q,
                                       floor=floor, ceiling_2q=ceiling)
            log(f"  eval {label} d{d}: {row['solve_rate']:.3f} (JAX "
                f"{rate:.2f}, floor {floor:.3f}), mean 2q "
                f"{row['mean_2q']:.2f} (JAX {two_q}, ceiling {ceiling:.2f})")
            if row["solve_rate"] < floor or not row["mean_2q"] <= ceiling:
                failed.append(label)
        if failed:
            raise AssertionError(f"eval rows below their solve floor or "
                                 f"above their 2q ceiling: {failed}")

        # the synth table: the policy-path rows and one MCTS-path row
        for label, (name, kw) in bench_quality.SYNTH_SPECS.items():
            if label not in JAX_SYNTH_ROWS:
                continue
            d, rate, two_q, n = JAX_SYNTH_ROWS[label]
            count = (1 if label in ONE_TARGET_SYNTH_ROWS
                     else TOOLS_SYNTH_TARGETS)
            kw = dict(kw, depths=[d], num_targets=count)
            (row,) = timed(f"synth {label}", lambda: bench_quality.
                           synth_quality(name, device="cuda", **kw))
            solved = round(row["solve_rate"] * count)
            floor = round(rate * count) - count // 4
            out["synth"][label] = dict(row, solved=solved, targets=count,
                                       jax_rate=rate, jax_2q=two_q)
            log(f"  synth {label} d{d}: {solved}/{count} verified (JAX "
                f"{rate:.2f} of {n}, floor {floor}), mean 2q "
                f"{row['mean_2q']:.2f} (JAX {two_q})")
            if solved < floor:
                raise AssertionError(f"synth {label}: {solved} < {floor}")

        # BASELINE config #5 at its width: 100 lanes x 1000 simulations
        rls = bench_quality.load(bench_baseline5.ARTIFACT, "cuda")
        (row,) = timed("bench_baseline5", lambda: bench_baseline5.run(
            rls, [CONFIG5["difficulty"]], CONFIG5["targets"], log=log))
        del rls
        out["config5"] = row
        if row["solve_rate"] < 1.0:
            raise AssertionError(f"config #5 did not solve: {row}")
        log(f"  config #5: difficulty {row['difficulty']} solved with "
            f"{row['mean_swaps']:.0f} SWAPs in {row['mean_seconds']:.1f} s "
            f"({bench_baseline5.NUM_SEARCHES} lanes x "
            f"{bench_baseline5.NUM_MCTS} simulations a move)")

        # the exact BFS tables and one optimal-demo BC burst each
        out["optimal_bc"] = {}
        for stem, (states, diameter) in BFS_TABLES.items():
            run_dir = os.path.join(tmp, f"{stem}_optimal_bc")
            final = timed(f"optimal_bc {stem}", lambda: optimal_bc.run(
                stem, minutes=1e-3, out=run_dir,
                num_targets=TOOLS_SCORE_TARGETS, device="cuda",
                per_shell=BC_PER_SHELL))
            rows = [json.loads(line) for line in open(
                os.path.join(run_dir, "evidence.jsonl"))]
            bfs = rows[0]
            if (bfs["states"], bfs["diameter"]) != (states, diameter):
                raise AssertionError(f"{stem}: {bfs} against the JAX "
                                     f"script's {states} states, diameter "
                                     f"{diameter}")
            burst = rows[3]
            if not math.isfinite(burst["bc_loss"]):
                raise AssertionError(f"{stem}: BC loss {burst['bc_loss']}")
            out["optimal_bc"][stem] = {"bfs": bfs, "corpus": rows[1],
                                       "baseline": rows[2], "burst": burst,
                                       "final": final}
            log(f"  optimal_bc {stem}: {bfs['states']} states, diameter "
                f"{bfs['diameter']} in {bfs['seconds']} s (the JAX "
                f"script's), spec replay validated; corpus "
                f"{rows[1]['steps']} steps; burst BC loss "
                f"{burst['bc_loss']}, solve {burst['solve']} mean 2q "
                f"{burst['mean_2q']} (baseline {rows[2]['solve']} / "
                f"{rows[2]['mean_2q']})")

        # the finetunes and the graft: one burst each, into a run directory
        rls = bench_quality.load("lf_5_line", "cuda")
        out["brevity"] = timed("finetune_brevity lf_5_line", lambda:
                               finetune_brevity.run(
                                   rls, "lf_5_line", minutes=1e-3,
                                   out=os.path.join(tmp, "brevity"),
                                   num_targets=TOOLS_SCORE_TARGETS))
        rls = bench_quality.load(finetune_pauli_ppo.STEM, "cuda")
        demos = finetune_pauli_ppo.corpus(rls, PAULI_BC_PER_DIFF, log)
        out["pauli_bc"] = timed("finetune_pauli_ppo", lambda:
                                finetune_pauli_ppo.run(
                                    rls, minutes=1e-3,
                                    out=os.path.join(tmp, "pauli_bc"),
                                    demos=demos,
                                    num_targets=TOOLS_SCORE_TARGETS,
                                    num_episodes=GRAFT_EPISODES))
        rls = bench_quality.load(graft_pauli_ppo.STEM, "cuda")
        out["graft"] = timed("graft_pauli_ppo", lambda: graft_pauli_ppo.run(
            rls, out=os.path.join(tmp, "graft"), ship=True,
            num_episodes=GRAFT_EPISODES, num_targets=TOOLS_SCORE_TARGETS))
        graft_rows = [json.loads(line) for line in open(
            os.path.join(tmp, "graft", "evidence.jsonl"))]
        for r in graft_rows[:2]:
            log(f"  graft {r['tag']}: evals " + ", ".join(
                f"d{e['difficulty']} {e['solve_rate']:.2f}"
                for e in r["evals"]) + "; synth " + ", ".join(
                f"d{e['difficulty']} {e['solve_rate']:.2f}"
                for e in r["synth"]))
        del rls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if models_digest() != digest:
        raise AssertionError("a tool changed a file under examples/models/")
    log(f"  examples/models: the sha256 of all {len(digest)} files is "
        "unchanged")

    # kernel B3 past D = 340
    g = torch.Generator(device="cuda")
    g.manual_seed(2031)
    out["b3_large"] = {}
    for n, D in B3_LARGE:
        r = b3_large_check(results, n, g, launches)
        if r["D"] != D:
            raise AssertionError(f"{n}q dense core has D={r['D']}, not {D}")
        out["b3_large"][n] = r
        torch.cuda.empty_cache()
    # the row of the {"kernels"} line: the 433-qubit shape
    results["fused_step_apply_large"].update(
        {k: v for k, v in out["b3_large"][B3_LARGE[-1][0]].items()
         if k != "bound_ms"})
    launches = read_counters("tools", ["fused_step", "apply_gates",
                                       "metrics_update",
                                       "fused_step_apply_large"], launches)
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"  phase 19: {out['seconds']['phase']:.1f} s")
    results["_tools"] = out
    return launches


# ---------------------------------------------------------------- phase 20
# The bench surface of `qiskit_gym_torch/tools/`: the JAX package's
# `bench.py` headline (four 27q families at B = 32768, K = 128) and its
# `--mesh` (NCCL, world 1), `scripts/bench_fused.py`, `__graft_entry__`'s
# entry() and the two MCTS probes. Widths are the tools' own; the probes'
# depth is cut: their smallest case, PROBE_EPISODES episodes, PROBE_SIMS
# simulations a move.
PROBE_EPISODES = 4
PROBE_SIMS = 8


def check_bench_families(results: dict, what: str) -> None:
    """A positive rate and finite rewards on every family (the bench
    itself raises on the card unless a matrix step launched B1 once and
    a Pauli step B2 once)."""
    for name, r in results.items():
        if not r["steps_per_s"] > 0 or not r["rewards_finite"]:
            raise AssertionError(f"{what} {name}: rate {r['steps_per_s']}, "
                                 f"finite rewards {r['rewards_finite']}")


def phase_bench(results: dict) -> dict:
    """The bench surface on the card, through the tools a user runs."""
    import torch
    from qiskit_gym_torch.tools import (bench, bench_fused, entry,
                                        probe_depth_cap,
                                        probe_sims_vs_priors)

    t_phase = time.perf_counter()
    launches: dict = {}
    out = {"seconds": {}}

    def timed(key, fn):
        t0 = time.perf_counter()
        with counting(launches):
            value = fn()
            torch.cuda.synchronize()
        out["seconds"][key] = time.perf_counter() - t0
        return value

    line, fams = timed("bench", bench.main)
    check_bench_families(fams, "bench")
    out["bench"] = {"line": line, "families": fams}
    log(f"  bench: geomean {line['value']:.6g} env steps/s ("
        + ", ".join(f"{k} {v['steps_per_s']:.6g}" for k, v in fams.items())
        + f"), {line['card']}")
    for k, v in fams.items():
        busy = ("not measured (the trace missed launches of B1 or B2)"
                if v["busy_share"] is None
                else f"{100 * v['busy_share']:.1f} %")
        log(f"    {k}: B1 {v['b1_per_step']:g} and B2 {v['b2_per_step']:g} "
            f"launches a step, {v['kernels_per_step']:.1f} device kernels "
            f"and {1e6 * v['device_s_per_step']:.1f} us of device time a "
            f"step in the trace, device busy {busy}; runs "
            + ", ".join(f"{1e3 * t:.2f}" for t in v["times"]) + " ms")

    mesh_line, mesh_fams = timed("mesh", bench.main_mesh)
    check_bench_families(mesh_fams, "bench --mesh")
    if (mesh_line["devices"], mesh_line["hardware"]) != (1, "gpu"):
        raise AssertionError(f"bench --mesh at world 1: {mesh_line}")
    out["mesh"] = {"line": mesh_line, "families": mesh_fams}
    log(f"  bench --mesh (NCCL, world 1): geomean "
        f"{mesh_line['value']:.6g} env steps/s")

    fused = timed("bench_fused", bench_fused.main)
    if not all(p > 0 and f > 0 for p, f in fused.values()):
        raise AssertionError(f"bench_fused: {fused}")
    out["bench_fused"] = fused

    def entry_check():
        fn, (policy, state, g) = entry.entry()
        fn_cpu, (policy_cpu, _, _) = entry.entry("cpu")
        gumbel = -torch.log(torch.empty(
            (entry.B, policy.num_actions), device="cuda").exponential_(
                generator=g))
        flip = torch.rand(entry.B, generator=g, device="cuda") < 0.5
        got = fn(policy, state, g, gumbel=gumbel, flip=flip)
        want = fn_cpu(policy_cpu, type(state)(*(x.cpu() for x in state)),
                      None, gumbel=gumbel.cpu(), flip=flip.cpu())
        return got, want

    (reward, value, new), (reward_c, value_c, new_c) = timed("entry",
                                                             entry_check)
    value_err = float((value.cpu() - value_c).abs().max())
    if value_err > 1e-4:
        raise AssertionError(f"entry: value differs from the CPU's by "
                             f"{value_err}")
    if not torch.equal(reward.cpu(), reward_c):
        raise AssertionError("entry: the reward differs from the CPU's")
    assert_identical(type(new)(*(x.cpu() for x in new)), new_c,
                     "entry step against the CPU")
    out["entry"] = {"value_err": value_err}
    log(f"  entry(): one step of {entry.B} lanes on the card, reward and "
        f"every state field identical to the CPU's, value within "
        f"{value_err:.2e}")

    with tempfile.TemporaryDirectory(prefix="qgt_probes_") as tmp:
        stem, diffs, _ = probe_depth_cap.CASES[-1]   # the smallest case
        cap_rows = timed("probe_depth_cap", lambda: probe_depth_cap.run(
            cases=((stem, diffs, PROBE_SIMS),), episodes=PROBE_EPISODES,
            out=os.path.join(tmp, "depth_cap.jsonl")))
        first = probe_sims_vs_priors.DIFFICULTIES[:1]
        sims_doc = timed("probe_sims_vs_priors",
                         lambda: probe_sims_vs_priors.run(
                             "smoke", PROBE_EPISODES,
                             os.path.join(tmp, "sims.json"),
                             difficulties=first, sims=(PROBE_SIMS,)))
    rates = ([r["solve_rate"] for r in cap_rows]
             + [r["argmax_solve_rate"] for r in sims_doc["rows"]])
    if len(rates) != 3 or not all(0.0 <= x <= 1.0 for x in rates):
        raise AssertionError(f"probes: {cap_rows}, {sims_doc['rows']}")
    out["probes"] = {"depth_cap": cap_rows, "sims_vs_priors": sims_doc}
    launches = read_counters("bench", ["fused_step", "apply_gates",
                                       "metrics_update"], launches)
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log("  phase 20 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["seconds"].items()))
    results["_bench"] = out
    return launches


# ----------------------------------------------------------------- phase 21
# Lines the notebook prints that the log repeats, the steps that kernel B1
# is held for at each of the notebook's shapes, and the shape of the
# `sample_action` check (the 27q Pauli artifacts' 303 actions).
NOTEBOOK_ECHO = ("difficulty reached", "round-trip", "unitary-exact",
                 "tableau", "phase-exact")
NOTEBOOK_B1_STEPS = 8
SAMPLE_SHAPE = (4096, 303)
SAMPLE_SEED = 2031


def check_sample_action() -> dict:
    """`rl.rollout.sample_action` on the card: the masked argmax equals the
    CPU's on the same logits (ties and an all-masked row among them), and a
    sample equals the argmax of the masked logits plus `draw_gumbel`'s noise
    drawn from a clone of the same CUDA generator, with no masked action
    drawn."""
    import torch
    from qiskit_gym_torch.rl import rollout

    B, A = SAMPLE_SHAPE
    g = torch.Generator(device="cuda").manual_seed(SAMPLE_SEED)
    logits = torch.randn(B, A, device="cuda", generator=g)
    logits[::2, 1::7] = logits[::2].max(dim=1, keepdim=True).values  # ties
    masks = torch.rand(B, A, device="cuda", generator=g) > 0.3
    masks[:, 0] = True
    masks[-1] = False
    got = rollout.sample_action(logits, masks, True)
    want = rollout.sample_action(logits.cpu(), masks.cpu(), True)
    if not torch.equal(got.cpu(), want) or int(got[-1]) != 0:
        raise AssertionError("sample_action: the card's argmax differs "
                             "from the CPU's")
    twin = torch.Generator(device="cuda")
    twin.set_state(g.get_state())
    drawn = rollout.sample_action(logits, masks, False, generator=g)
    masked = torch.where(masks, logits, torch.finfo(logits.dtype).min)
    core = types.SimpleNamespace(device=logits.device)
    gumbel_max = torch.argmax(
        masked + rollout.draw_gumbel(core, twin, (B, A)), dim=-1)
    if not torch.equal(drawn, gumbel_max):
        raise AssertionError("sample_action: a sample is not the Gumbel-max "
                             "of draw_gumbel's noise")
    if not bool(masks[:-1].gather(1, drawn[:-1, None]).all()):
        raise AssertionError("sample_action drew a masked action")
    resampled = float((drawn != got).double().mean())
    log(f"  sample_action at [{B}, {A}]: argmax equal to the CPU's, samples "
        f"equal to the Gumbel-max of draw_gumbel's noise, no masked action "
        f"drawn; {100 * resampled:.1f} % of the samples leave the argmax")
    return {"shape": [B, A], "samples_off_argmax": resampled}


@contextlib.contextmanager
def b1_shapes():
    """Records, inside the block, every call by which the matrix env
    reaches kernel B1 (`fused_step`, `apply_gates`): yields the calls'
    counts by wrapper and their cores by (core, batch)."""
    from qiskit_gym_torch.ops import matrix_env

    kept = {k: getattr(matrix_env, k) for k in ("fused_step", "apply_gates")}
    seen = {"calls": dict.fromkeys(kept, 0), "cores": {}}

    def recorder(name):
        def call(core, *args):
            seen["calls"][name] += 1
            batch = args[0 if name == "apply_gates" else 1].shape[0]
            seen["cores"].setdefault((id(core), batch), core)
            return kept[name](core, *args)
        return call

    for k in kept:
        setattr(matrix_env, k, recorder(k))
    try:
        yield seen
    finally:
        for k, fn in kept.items():
            setattr(matrix_env, k, fn)


def phase_notebook(results: dict) -> dict:
    """Every code cell of the tour notebook on the card, as a user runs it
    without Jupyter (`examples/notebook.run_cells`, DEVICE = "cuda", OUT a
    temporary directory): the notebook's own asserts check its circuits.
    Then kernel B1 against its plain versions on every core and batch at
    which the notebook launched it, and `sample_action` on the card."""
    import torch
    from qiskit_gym_torch.examples import notebook

    t_phase = time.perf_counter()
    cells, sections = {}, {}
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="qgt_smoke_notebook_") as tmp:
        with b1_shapes() as seen, counting(launches):
            for run in notebook.run_cells(device="cuda", out=tmp):
                cells[run.index] = run.seconds
                sections[run.section] = (sections.get(run.section, 0.0)
                                         + run.seconds)
                for line in run.stdout.splitlines():
                    if line.startswith(NOTEBOOK_ECHO):
                        log(f"    cell {run.index}: {line}")
    launches = read_counters("notebook", ["fused_step", "metrics_update"],
                             launches)
    if seen["calls"] != {k: launches[k] for k in seen["calls"]}:
        raise AssertionError(f"notebook: the matrix env made {seen['calls']}"
                             " calls to B1, the wrappers counted others")
    log("  notebook seconds by cell: " + ", ".join(
        f"{i} {v:.2f}" for i, v in cells.items()))
    log("  notebook seconds by section: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sections.items()))
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    shapes = []
    for (_, B), core in seen["cores"].items():
        what = (f"{core.kind} {core.num_qubits}q, dim {core.dim}, "
                f"{core.num_actions} actions, B={B}")
        hold_b1(results, core, B, NOTEBOOK_B1_STEPS, g, what)
        shapes.append(what)
    log(f"  B1 at the notebook's {len(shapes)} shapes ({'; '.join(shapes)}):"
        f" {NOTEBOOK_B1_STEPS} steps tracked and untracked, and the apply "
        "kernel, bit-identical to the plain versions")
    out = {"seconds": {"cells": cells, "sections": sections},
           "b1_shapes": shapes, "sample_action": check_sample_action()}
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"  phase 21 seconds: {out['seconds']['phase']:.1f}")
    results["_notebook"] = out
    return launches


def phase_times(results: dict) -> None:
    import torch
    from qiskit_gym_torch.ops import fused_step as fs
    from qiskit_gym_torch.rl.rollout import collect
    from qiskit_gym_torch.rl.solve import policy_solve

    core = load_core("clifford_heavy_hex_27q")  # untracked, add_inverts on
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    ring = []
    for _ in range(4):  # 4 x ~56 MB of state: every call reads cold data
        st = core.reset(B_BIG, 16, generator=g)
        a = torch.randint(0, core.num_actions + 1, (B_BIG,), generator=g,
                          device="cuda")
        f = torch.rand(B_BIG, generator=g, device="cuda") < 0.5
        ring.append((st, a, f))

    # B1, fused step: untracked, so the layer fields are neither read nor
    # written; the op table is read once
    st, a, f = ring[0]
    out = fs.fused_step(core, st, a, f)
    read = nbytes(a, f, st.a, st.ainv, st.depth, st.inverted, st.n_cnots,
                  st.n_gates, core.op_tab)
    written = nbytes(out.a, out.ainv, out.depth, out.success, out.reward,
                     out.inverted, out.n_cnots, out.n_gates)
    ops = B_BIG * core.dim * core.W * 2 * 8 * 2  # left+right, K=2, ~8 ops
    r = results["fused_step"]
    r["ms"] = graph_ms(lambda x: fs.fused_step(core, *x), ring)
    r["eager_ms"] = time_ms(lambda x: fs.fused_step(core, *x), ring)
    r["plain_ms"] = time_ms(lambda x: fs.fused_step_plain(core, *x), ring)
    r["bytes"] = read + written
    r["ops"] = ops

    r = results["apply_gates"]
    r["ms"] = graph_ms(
        lambda x: fs.apply_gates(core, x[0].a, x[0].ainv, x[1]), ring)
    r["eager_ms"] = time_ms(
        lambda x: fs.apply_gates(core, x[0].a, x[0].ainv, x[1]), ring)
    r["plain_ms"] = time_ms(lambda x: fs.apply_plain(
        core.op_tab[x[1]], x[0].a, x[0].ainv, core.W, core.dim,
        core.add_inverts), ring)
    r["bytes"] = nbytes(a, st.a, st.ainv, core.op_tab) + 2 * nbytes(st.a)
    r["ops"] = ops

    time_b2(results, g)
    time_b3(results, g)
    for name, r in results.items():
        if name.startswith("_"):
            continue
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["ops"] / INT32_OPS_PER_S)
        log(f"  {name}: kernel {1e3 * r['ms']:.2f} us (CUDA graph), eager "
            f"call {1e3 * r['eager_ms']:.2f} us, plain "
            f"{1e3 * r['plain_ms']:.2f} us, bound {1e3 * r['bound_ms']:.2f} "
            f"us ({r['bytes'] / 1e6:.1f} MB at B={r.get('B', B_BIG)})")

    # one full 128-step policy_solve with 100 lanes on the 27q Clifford net
    rls = results["_artifacts"]["clifford_heavy_hex_27q"]
    env, policy = rls.env, rls.algorithm.policy
    target = make_target(env, __import__("numpy").random.default_rng(3), 8)
    enc = env.get_state(target)
    samples = []
    for i in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        policy_solve(env, policy, enc, num_searches=100, generator=g)
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            samples.append(time.perf_counter() - t0)
    solve_ms = 1e3 * statistics.median(samples)
    log(f"  policy_solve clifford_heavy_hex_27q: {env.core.max_depth} steps "
        f"x 100 lanes, median of 20: {solve_ms:.2f} ms")

    # a 128-step collect at B=32768 (reset at difficulty 64: budget 128)
    core = env.core
    samples = []
    for i in range(4):
        st = core.reset(B_BIG, 64, generator=g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj = collect(core, policy, st, 128, generator=g)
        torch.cuda.synchronize()
        if i:
            samples.append(time.perf_counter() - t0)
        del traj
    sec = statistics.median(samples)
    log(f"  collect clifford_heavy_hex_27q: 128 steps x {B_BIG} lanes, "
        f"median of 3: {sec:.3f} s = {128 * B_BIG / sec:.4g} env steps/s")
    results["_solve_ms"] = solve_ms
    results["_collect_steps_per_s"] = 128 * B_BIG / sec
    results["_collect_profile"] = collect_profile(core, policy, g)
    time_training(results, g)
    time_pauli(results, g)
    time_mcts(results)


def collect_profile(core, policy, g, T: int = 16,
                    difficulty: int = 64) -> dict:
    """torch.profiler over a T-step collect at B=32768: device time by
    kernel and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qiskit_gym_torch.rl.rollout import collect

    st = core.reset(B_BIG, difficulty, generator=g)
    collect(core, policy, st, 2, generator=g)  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect(core, policy, st, T, generator=g)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = sorted(
        ((ev.self_device_time_total, ev.key, ev.count)
         for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total),
        reverse=True)
    busy_us = sum(k[0] for k in kernels)
    log(f"  profile: {T}-step collect at B={B_BIG}: wall {wall_us:.0f} us, "
        f"device busy {busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%)")
    for us, name, count in kernels[:8]:
        log(f"    {100 * us / max(busy_us, 1e-9):5.1f}% {us:10.0f} us "
            f"x{count:<5d} {name[:90]}")
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "top": [{"kernel": n[:90], "us": us, "count": c}
                    for us, n, c in kernels[:8]]}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "qiskit_gym_torch")):
        print("chip_smoke: qiskit_gym_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from qiskit_gym_torch.ops import cuda_lib

    marks = []   # (heading, start) of every phase, for its seconds

    def phase(heading: str) -> None:
        marks.append((heading.split(":")[0], time.perf_counter()))
        log(heading)

    phase("phase 1: build")
    secs = cuda_lib.build()
    for name, text in cuda_lib.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}.cu ptxas: {line.strip()}")
    smi = nvidia_smi_line()
    log(f"  built {list(cuda_lib.KERNEL_SOURCES)} in {secs:.2f} s")
    log(f"  card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    results = {k: {"err": 0.0} for k in REPLACES}
    phase("phase 2: kernel B1 against its plain version")
    phase_b1(results)
    phase("phase 3: kernels B2 and B3 against their plain versions")
    phase_b2(results)
    phase_b3(results)
    phase("phase 4: serving path (RLSynthesis.synth on six artifacts)")
    by_path = {"serving": phase_main_path(results)}
    phase("phase 5: dense path (kernel B3 carries the dense 27q state)")
    by_path["dense"] = phase_dense_path(results)
    phase("phase 6: training path (RLSynthesis.learn at full width)")
    by_path["training"] = phase_training(results)
    phase("phase 7: the Pauli step through B2 against the plain metrics "
          "update")
    phase_pauli_step(results)
    phase("phase 8: Pauli serving path (RLSynthesis.synth on five artifacts)")
    by_path["pauli"] = phase_pauli_path(results)
    phase("phase 10: full-width MCTS searches on the card and on the CPU")
    by_path["search"] = phase_search(results)
    phase("phase 11: AlphaZero serving path (policy search and MCTS synth on "
          "seven artifacts)")
    by_path["mcts"] = phase_az_serving(results)
    phase("phase 12: AlphaZero training path (RLSynthesis.learn)")
    by_path["az_training"] = phase_az_training(results)
    phase("phase 13: demos and behavior cloning at full width")
    by_path["bc"] = phase_bc(results)
    phase("phase 14: the action-head graft at full width")
    by_path["graft"] = phase_graft(results)
    phase("phase 15: data parallelism on the card (NCCL, world 1)")
    by_path["dp"] = phase_dp(results)
    phase("phase 16: checkpoint formats, the native loader, a device trace")
    by_path["formats"] = phase_formats(results)
    phase("phase 17: the user programs (tour, flagship walk at full width and "
          "depth, Clifford demo finetune, resume)")
    by_path["recipes"] = phase_recipes(results)
    phase("phase 18: large instances (Clifford on the 127- and 433-qubit "
          "lines, the wide B1 kernels)")
    by_path["large"] = phase_large(results)
    phase("phase 19: the quality and artifact tools over the 18 shipped "
          "artifacts, config #5, the BFS tables, the finetunes, B3 past "
          "D = 340")
    by_path["tools"] = phase_tools(results)
    phase("phase 20: the bench surface (bench.py's headline and --mesh, "
          "bench_fused, entry(), the two MCTS probes)")
    by_path["bench"] = phase_bench(results)
    phase("phase 21: the tour notebook (every code cell of "
          "qiskit_gym_torch/examples/intro.ipynb on the card), sample_action")
    by_path["notebook"] = phase_notebook(results)
    launches = {k: sum(p[k] for p in by_path.values()) for k in SOURCES}
    for k, w in {**WIDE_OF, **LARGE_OF}.items():  # a row: its own kernel
        launches[w] -= launches[k]
    phase("phase 9: times (CUDA events, median of 20) and profiles")
    phase_times(results)

    marks.append(("end", time.perf_counter()))
    phase_seconds = {a[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    log("  seconds by phase: " + ", ".join(
        f"{k[6:]} {v:.1f}" for k, v in phase_seconds.items()))
    kernels = []
    for name, route_src in SOURCES.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": route_src,
            "replaces": tpu_kernel_location(*REPLACES[name]),
            "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["ops"] / INT32_OPS_PER_S else "operations"),
            "library_ms": None,
        })
    log(json.dumps({"timings": {
        "eager_call_ms": {k: results[k]["eager_ms"] for k in SOURCES},
        "policy_solve_ms": results["_solve_ms"],
        "collect_env_steps_per_s": results["_collect_steps_per_s"],
        "collect_packed_env_steps_per_s": results["_packed_steps_per_s"],
        "ppo_train_step_seconds": results["_train_step_seconds"],
        "ppo_train_step_peak_mib": results["_train_step_peak_mib"],
        "ppo_learn_iter_seconds": results["_train_iter_seconds"],
        "dense_path_env_steps_per_s": results["_dense_steps_per_s"],
        "launches_by_path": by_path,
        "collect_profile": results["_collect_profile"],
        "metrics_update": results["_b2"],
        "pauli_solved": results["_pauli_solved"],
        "pauli_policy_solve_ms": results["_pauli_solve_ms"],
        "pauli_collect_env_steps_per_s":
            results["_pauli_collect_steps_per_s"],
        "pauli_collect_profile": results["_pauli_collect_profile"],
        "mcts_search": results["_search"],
        "mcts_search_profile": results["_search_profile"],
        "mcts_solve": results["_mcts_solve"],
        "az_solved": results["_az_solved"],
        "az_learn_iter_seconds": results["_az_iter_seconds"],
        "az_train_step": results["_az_train_step"],
        "bc": results["_bc"], "graft": results["_graft"],
        "dp": results["_dp"], "formats": results["_formats"],
        "recipes": results["_recipes"], "large": results["_large"],
        "tools": results["_tools"], "bench": results["_bench"],
        "notebook": results["_notebook"],
        "phase_seconds": phase_seconds}}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
