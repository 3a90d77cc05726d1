"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card with `nvcc` (a CUDA kernel has no CPU mode) and
skip elsewhere. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

They import torch and the port only. Every comparison is bit for bit."""

import json
import os

import pytest
import torch

from qiskit_gym_torch.envs import SYNTH_ENVS
from qiskit_gym_torch.ops import fused_step as fs
from qiskit_gym_torch.ops import metrics_kernel as mk

pytestmark = pytest.mark.cuda

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
B = 301  # not a multiple of the 8 envs a block takes: the ragged edge


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _core(name, **kw):
    with open(os.path.join(MODELS, name + ".json")) as f:
        full = json.load(f)
    cfg = dict(full["env"], **kw)
    return SYNTH_ENVS[full["env_cls"].split(".")[-1]].from_json(
        cfg, device="cuda").core


def _equal(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("name,track,inv", [
    ("clifford_heavy_hex_27q", False, True),
    ("clifford_heavy_hex_27q", True, True),
    ("clifford_heavy_hex_27q", False, False),
    ("perm_heavy_hex_27q", True, True),
    ("lf_5_line", True, False),
])
def test_fused_step_kernel_equals_plain(card, name, track, inv):
    core = _core(name, add_inverts=inv)
    core.track_layers = track
    g = torch.Generator(device=card).manual_seed(1)
    state = core.reset(B, 6, generator=g)
    before = fs.fused_step.launches
    for _ in range(5):
        act = torch.randint(0, core.num_actions + 1, (B,), generator=g,
                            device=card)
        flip = (torch.rand(B, generator=g, device=card) < 0.5) if inv else None
        got = fs.fused_step(core, state, act, flip)
        _equal(got, fs.fused_step_plain(core, state, act, flip))
        state = got
    torch.cuda.synchronize()
    assert fs.fused_step.launches == before + 5


def test_apply_kernel_equals_plain(card):
    core = _core("clifford_heavy_hex_27q")
    g = torch.Generator(device=card).manual_seed(2)
    state = core.reset(B, 6, generator=g)
    act = torch.randint(0, core.num_actions + 1, (B,), generator=g,
                        device=card)
    got = fs.apply_gates(core, state.a, state.ainv, act)
    want = fs.apply_plain(core.op_tab[act], state.a, state.ainv, core.W,
                          core.dim, core.add_inverts)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("track", [False, True])
def test_metrics_kernel_equals_plain(card, track):
    core = _core("perm_heavy_hex_27q")
    g = torch.Generator(device=card).manual_seed(3)
    n = core.num_qubits
    lg = torch.randint(-1, 40, (B, n), generator=g, device=card,
                       dtype=torch.int32)
    lc = torch.randint(-1, 40, (B, n), generator=g, device=card,
                       dtype=torch.int32)
    act = torch.randint(0, core.num_actions + 1, (B,), generator=g,
                        device=card)
    rows = core.op_tab[act]
    scal = torch.stack([lg.max(1).values, lc.max(1).values,
                        torch.zeros_like(rows[:, 0]), rows[:, 0] * 0 + 3,
                        rows[:, 0], rows[:, 1], rows[:, 2],
                        (act == core.noop_action).to(torch.int32)],
                       dim=1).contiguous()
    w = (0.01, 0.02, 0.03, 0.04)
    got = mk.metrics_update(lg, lc, scal, w, track)
    want = mk.metrics_update_plain(lg, lc, scal, w, track)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_kernel_op_table_layout_matches_builder(card):
    lib = fs._lib()
    for W in (1, 2):
        assert lib.qgt_op_table_width(W) == fs.table_columns(W)["F"]


def test_wrapper_raises_on_operands_it_does_not_take(card):
    core = _core("lf_5_line")
    state = core.reset(4, 2)
    act = torch.zeros(4, dtype=torch.int32, device=card)  # not int64
    with pytest.raises(ValueError, match="action"):
        fs.fused_step(core, state, act, torch.zeros(4, dtype=torch.bool,
                                                    device=card))
