"""The port's timing and tracing helpers (`utils/profiling.py`) on the CPU,
where they run without the CUDA synchronize."""

import json
import os

import torch

from qiskit_gym_torch.utils import profiling


def test_timed_and_benchmark():
    sink = []
    with profiling.timed("matmul", sink):
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert sink[0][0] == "matmul" and sink[0][1] > 0
    calls = []
    best = profiling.benchmark(lambda x: calls.append(x), 1, repeats=3,
                               warmup=2)
    assert best >= 0 and len(calls) == 5


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    names = {e.name for e in prof.events()}
    assert any("mm" in n for n in names)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    tb = tmp_path / "tb"
    with profiling.device_trace(str(tb), tensorboard=True):
        torch.randn(8).sum()
    assert any(n.endswith(".pt.trace.json") for n in os.listdir(tb))
