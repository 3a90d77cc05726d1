"""The 127-qubit Eagle Clifford training path on the card: one profiled
`train_step` whose wide launches in the trace equal the change of the
`fused_step.wide_launches` counter. (`test_torch_cuda.py` holds the wide
step and apply kernels bit for bit against their plain versions on the
Eagle map's tables at 2048 lanes.) Marked `cuda`; skips without a card:

    python -m pytest tests/test_torch_cuda_clifford127.py -m cuda -q
"""

import os

import pytest
import torch

from qiskit_gym_torch.ops import fused_step as fs
from qiskit_gym_torch.rl.synthesis import RLSynthesis
from qiskit_gym_torch.utils import profiling

pytestmark = pytest.mark.cuda

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "portbench",
                        "configs", "clifford127.artifact.json")


@pytest.fixture(scope="module")
def rls():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return RLSynthesis.from_config_json(ARTIFACT, None, device="cuda")


def test_traced_train_step_counts_its_wide_steps(rls):
    from torch.profiler import ProfilerActivity, profile

    T, B = 8, 256
    algo = rls.algorithm
    algo.train_step(T, B, 64)   # warm-up
    profiling.clear_spans()
    before = fs.fused_step.wide_launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        algo.train_step(T, B, 64)
        torch.cuda.synchronize()
    changed = fs.fused_step.wide_launches - before
    root, = [s for s in profiling.spans() if s.parent is None]
    assert changed == T == root.counters["fused_step.wide_launches"]
    traced = sum(1 for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA")
                 and not e.is_user_annotation()
                 and "fused_step_wide_kernel" in e.name())
    assert traced == changed
