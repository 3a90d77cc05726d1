"""The PyTorch port imports without JAX and without the JAX package."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "qiskit_gym_torch")
FORBIDDEN = re.compile(r"import jax|qiskit_gym_tpu")


def test_import_leaves_jax_out():
    code = (
        "import sys, qiskit_gym_torch, qiskit_gym_torch.rl.synthesis, "
        "qiskit_gym_torch.ops.fused_step, qiskit_gym_torch.ops.metrics_kernel, "
        "qiskit_gym_torch.ops.rowop_step, qiskit_gym_torch.ops.pauli, "
        "qiskit_gym_torch.spec.pauli_env, qiskit_gym_torch.rl.checkpoint, "
        "qiskit_gym_torch.utils.logging\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('qiskit_gym_tpu') or m.startswith('flax')]\n"
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
                  if n.endswith((".py", ".cu", ".cuh"))]
    return sorted(files)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_reference_in_source(path):
    with open(path) as f:
        text = f.read()
    assert not FORBIDDEN.search(text), path
