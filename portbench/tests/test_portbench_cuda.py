"""One short run of each cell on the card (marked `cuda`; skips without
one): the kernels build, the timed path runs, the reference judges it."""

from pathlib import Path

import pytest
import torch

from portbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
ONE_TARGET = {"pool": 1, "quality_calls": 1, "check_window": 1,
              "check_calls": 1, "trace_calls": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("workload,overrides", [
    ("pauli27.synth_wide", dict(ONE_TARGET, num_searches=1024)),
    ("clifford27.train", {"lanes": 256, "trace_calls": 1})])
@pytest.mark.parametrize("trace", [False, True])
def test_one_call_on_the_card(workload, overrides, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run_cell(ROOT, workload, 2_718_281_828, 0.1, trace,
                   overrides=overrides)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0
