"""The PyTorch port imports without JAX and without the JAX package."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "qiskit_gym_torch")
# JAX, the JAX package, and the JAX tree's root modules that import it
FORBIDDEN = re.compile(r"import jax|qiskit_gym_tpu|"
                       r"^\s*(from|import)\s+(bench|__graft_entry__)\b",
                       re.MULTILINE)


MODULES = (
    "qiskit_gym_torch", "rl.synthesis", "ops.fused_step", "ops.metrics_kernel",
    "ops.rowop_step", "ops.pauli", "spec.pauli_env", "rl.checkpoint",
    "utils.logging", "parallel.mesh", "parallel.distributed", "rl.demos",
    "models.transfer", "quantum.qiskit_interop", "utils.serialization",
    "utils.flax_msgpack", "utils.native", "utils.profiling",
) + tuple(f"examples.{m}" for m in (
    "_common", "intro", "resume_training", "train_clifford_3q_custom",
    "train_pauli_5line", "train_pauli_line", "train_pauli_12q",
    "train_pauli_27q", "train_pauli_27q_dense", "train_pauli_18q_az",
    "train_pauli_27q_az", "train_pauli_27q_az_dense", "train_pauli_bc",
    "train_pauli_27q_full_bc", "finetune_clifford_27q_demos",
    "train_pauli_27q_full_az", "walk_pauli_az", "notebook")) + tuple(
    f"tools.{m}" for m in (
        "bench_quality", "bench_baseline5", "vs_reference", "optimal_bc",
        "finetune_brevity", "finetune_pauli_ppo", "graft_pauli_ppo", "bench",
        "bench_fused", "entry", "probe_depth_cap", "probe_sims_vs_priors"))
# none of these may be loaded by importing the port
FORBIDDEN_MODULES = ("jax", "qiskit_gym_tpu", "flax", "orbax", "msgpack",
                     "optax", "bench", "__graft_entry__")


def test_import_leaves_jax_out():
    names = [MODULES[0]] + [f"qiskit_gym_torch.{m}" for m in MODULES[1:]]
    code = (
        f"import sys, {', '.join(names)}\n"
        f"roots = {FORBIDDEN_MODULES!r}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        if "build" in dirpath.split(os.sep):
            continue
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp", ".ipynb"))]
    return sorted(files)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_reference_in_source(path):
    with open(path) as f:
        text = f.read()
    assert not FORBIDDEN.search(text), path
