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
   events.

The launch counts are set to 0 just before each of the eleven paths
(serving, dense, training, pauli, search, mcts, az_training, bc, graft, dp,
formats) and read just after it; a kernel of a path that was not launched
in it fails the run. Where a phase also runs something else between the
path's own runs (the plain train steps beside the mesh steps of dp, the
source artifact's solves beside the grafted ones), only the path's own
runs are counted, each in a window of its own. It prints a `{"timings": ...}` line, a
`{"kernels": [...]}` line, the `nvidia-smi` name/power-limit line, and last
`{"ok": true, "device": {...}}`. Any failed phase raises and the script exits
nonzero without that last line. Without CUDA, or without the package beside
it, it exits 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

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
                                   sims=100, mcts_count=2, mcts_floor=1),
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
    "metrics_update": ("pallas_metrics.py", "_kernel"),
    "fused_step_apply": ("pallas_step.py", "_vpu_kernel"),
}
SOURCES = {
    "fused_step": "qiskit_gym_torch/csrc/fused_step.cu",
    "apply_gates": "qiskit_gym_torch/csrc/fused_step.cu",
    "metrics_update": "qiskit_gym_torch/csrc/metrics.cu",
    "fused_step_apply": "qiskit_gym_torch/csrc/rowop_step.cu",
}


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


def zero_counters() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


@contextlib.contextmanager
def counting(acc: dict):
    """Adds to `acc` the launches made inside the block: the counts are set
    to 0 just before it and read just after, so a path driven in several
    windows counts only its own runs."""
    zero_counters()
    yield
    for k, fn in kernel_counters().items():
        acc[k] = acc.get(k, 0) + fn.launches
    zero_counters()


def read_counters(path: str, must_launch, launches=None) -> dict:
    """The launch counts since `zero_counters` (or those that `counting`
    windows gathered in `launches`); fails if a kernel of this path
    (`must_launch`) was not launched in them."""
    if launches is None:
        launches = {k: fn.launches for k, fn in kernel_counters().items()}
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
            f"us ({r['bytes'] / 1e6:.1f} MB at B={B_BIG})")

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

    log("phase 1: build")
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
    log("phase 2: kernel B1 against its plain version")
    phase_b1(results)
    log("phase 3: kernels B2 and B3 against their plain versions")
    phase_b2(results)
    phase_b3(results)
    log("phase 4: serving path (RLSynthesis.synth on six artifacts)")
    by_path = {"serving": phase_main_path(results)}
    log("phase 5: dense path (kernel B3 carries the dense 27q state)")
    by_path["dense"] = phase_dense_path(results)
    log("phase 6: training path (RLSynthesis.learn at full width)")
    by_path["training"] = phase_training(results)
    log("phase 7: the Pauli step through B2 against the plain metrics update")
    phase_pauli_step(results)
    log("phase 8: Pauli serving path (RLSynthesis.synth on five artifacts)")
    by_path["pauli"] = phase_pauli_path(results)
    log("phase 10: full-width MCTS searches on the card and on the CPU")
    by_path["search"] = phase_search(results)
    log("phase 11: AlphaZero serving path (policy search and MCTS synth on "
        "seven artifacts)")
    by_path["mcts"] = phase_az_serving(results)
    log("phase 12: AlphaZero training path (RLSynthesis.learn)")
    by_path["az_training"] = phase_az_training(results)
    log("phase 13: demos and behavior cloning at full width")
    by_path["bc"] = phase_bc(results)
    log("phase 14: the action-head graft at full width")
    by_path["graft"] = phase_graft(results)
    log("phase 15: data parallelism on the card (NCCL, world 1)")
    by_path["dp"] = phase_dp(results)
    log("phase 16: checkpoint formats, the native loader, a device trace")
    by_path["formats"] = phase_formats(results)
    launches = {k: sum(p[k] for p in by_path.values()) for k in SOURCES}
    log("phase 9: times (CUDA events, median of 20) and profiles")
    phase_times(results)

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
        "dp": results["_dp"], "formats": results["_formats"]}}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
