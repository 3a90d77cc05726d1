"""The Pauli step's transition wrapper (`ops/pauli_step.py`) on the CPU:
a CPU core steps through the plain version and launches nothing, the
launch counter is one that root spans keep, and the wrapper's operand
check refuses what the kernel does not take. The kernel itself is held
against the plain version on the card, in `tests/test_torch_cuda.py`."""

import json
import os

import pytest
import torch

from qiskit_gym_torch.envs import SYNTH_ENVS
from qiskit_gym_torch.ops import pauli_step as ps
from qiskit_gym_torch.ops.pauli import PauliEnvCore
from qiskit_gym_torch.utils import profiling

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
B = 24


@pytest.fixture(scope="module")
def core():
    with open(os.path.join(MODELS, "pauli_5_line.json")) as f:
        cfg = json.load(f)["env"]
    return SYNTH_ENVS["PauliNetworkEnv"].from_json(cfg, device="cpu").core


def _start(core, seed=3):
    g = torch.Generator().manual_seed(seed)
    state = core.reset(B, 24, generator=g)
    act = torch.randint(0, core.num_actions + 1, (B,), generator=g)
    return state, act


def test_a_cpu_core_steps_through_the_plain_version(core):
    state, act = _start(core)
    before = ps.pauli_step.launches
    profiling.clear_spans()
    with profiling.recording(), profiling.span("synth"):
        got = core.step(state, act, perm_idx=torch.zeros(B, dtype=torch.int32))
    want = core.step(state, act, perm_idx=torch.zeros(B, dtype=torch.int32),
                     transition=ps.pauli_step_plain)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert ps.pauli_step.launches == before
    root, = profiling.spans()
    assert root.counters["pauli_step.launches"] == 0


def _fault(core, state, act, fault):
    """(core, state, actual, penalty) with one operand the kernel refuses."""
    pen = torch.zeros(B, dtype=torch.float32)
    if fault == "rphase_int32":
        state = state._replace(rphase=state.rphase.to(torch.int32))
    elif fault == "anti_uint8":
        state = state._replace(anti=state.anti.to(torch.uint8))
    elif fault == "tab_strided":
        wide = torch.cat([state.tab, state.tab], dim=1)
        state = state._replace(tab=wide[:, ::2])
    elif fault == "rx_shape":
        state = state._replace(rx=state.rx[:, :-1].contiguous())
    elif fault == "actual_int32":
        act = act.to(torch.int32)
    elif fault == "penalty_float64":
        pen = pen.double()
    elif fault == "rotations_past_64":
        core = PauliEnvCore(5, [("H", (0,)), ("CX", (0, 1))],
                            max_rotations=70, device="cpu")
        state, act = _start(core)
    return core, state, act, pen


@pytest.mark.parametrize("fault", [
    "rphase_int32", "anti_uint8", "tab_strided", "rx_shape", "actual_int32",
    "penalty_float64", "rotations_past_64"])
def test_the_operand_check_refuses(core, fault):
    state, act = _start(core)
    ps._check(core, state, act, torch.zeros(B))   # as the step passes them
    with pytest.raises(ValueError, match="pauli_step"):
        ps._check(*_fault(core, state, act, fault))
