"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card with `nvcc` (a CUDA kernel has no CPU mode) and
skip elsewhere. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

They import torch and the port only (and `chip_smoke.py`'s input makers).
Every comparison is bit for bit."""

import json
import os

import pytest
import torch

import chip_smoke
from qiskit_gym_torch.envs import SYNTH_ENVS
from qiskit_gym_torch.ops import fused_step as fs
from qiskit_gym_torch.ops import metrics_kernel as mk
from qiskit_gym_torch.ops import rowop_step as rs
from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore

pytestmark = pytest.mark.cuda

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
B = 301  # not a multiple of any kernel's envs per block: the ragged edge


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


KINDS = {"CliffordEnv": "clifford", "PermutationEnv": "permutation",
         "LinearFunctionEnv": "linear"}


def _dense_core(name):
    """The dense (bitpack=False) core of a shipped artifact's env."""
    with open(os.path.join(MODELS, name + ".json")) as f:
        full = json.load(f)
    env = full["env"]
    return MatrixEnvCore(
        env["num_qubits"], [(g[0], tuple(g[1])) for g in env["gateset"]],
        KINDS[full["env_cls"].split(".")[-1]], max_depth=env["max_depth"],
        bitpack=False, device="cuda")


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


@pytest.mark.parametrize("name,batch", [
    ("clifford_heavy_hex_27q", B),       # D = 56, ragged batch
    ("clifford_heavy_hex_27q", 4096),
    ("perm_heavy_hex_27q", B),           # D = 32
    ("lf_5_line", B),                    # D = 8 (dim 5 padded)
    ("clifford_3q_line", 1),
])
def test_rowop_kernel_equals_plain_and_dense_step(card, name, batch):
    """Kernel B3 against its plain version and against the dense core's own
    apply_gates + swap + solved, no-op action included."""
    core = _dense_core(name)
    g = torch.Generator(device=card).manual_seed(4)
    state = core.reset(batch, 6, generator=g)
    a, ainv = state.a, state.ainv
    before = rs.fused_step_apply.launches
    for _ in range(5):
        act = torch.randint(0, core.num_actions + 1, (batch,), generator=g,
                            device=card)
        flip = torch.rand(batch, generator=g, device=card) < 0.5
        got = rs.fused_step_apply(core, a, ainv, act, flip)
        want = rs.fused_step_apply_plain(core, a, ainv, act, flip)
        na, ni = core.apply_gates(a, ainv, act)
        f3 = flip[:, None, None]
        dense = (torch.where(f3, ni, na), torch.where(f3, na, ni))
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert torch.equal(got[0], dense[0]) and torch.equal(got[1], dense[1])
        assert torch.equal(got[2], fs.solved(core, dense[0]))
        a, ainv = got[0], got[1]
    torch.cuda.synchronize()
    assert rs.fused_step_apply.launches == before + 5


def test_rowop_kernel_beyond_the_static_shared_memory(card):
    """D = 168: one env's two tiles (56 KB) exceed the 48 KB a block gets
    without asking, so the launch takes the opt-in limit, one env a block."""
    n = 168
    gateset = [("CX", (i, i + 1)) for i in range(n - 1)]
    core = MatrixEnvCore(n, gateset, "linear", bitpack=False, device="cuda")
    assert core.D == 168
    g = torch.Generator(device=card).manual_seed(6)
    state = core.reset(37, 12, generator=g)
    a, ainv = state.a, state.ainv
    for _ in range(3):
        act = torch.randint(0, core.num_actions + 1, (37,), generator=g,
                            device=card)
        flip = torch.rand(37, generator=g, device=card) < 0.5
        got = rs.fused_step_apply(core, a, ainv, act, flip)
        want = rs.fused_step_apply_plain(core, a, ainv, act, flip)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        a, ainv = got[0], got[1]
    noop = torch.full((37,), core.noop_action, device=card)
    ident = core.reset(37, 0)
    assert rs.fused_step_apply(core, ident.a, ident.ainv, noop,
                               torch.zeros(37, dtype=torch.bool,
                                           device=card))[2].all()


def test_rowop_kernel_table_width_and_refusals(card):
    assert rs._lib().qgt_rowop_table_width() == len(rs.TABLE_NAMES)
    core = _dense_core("lf_5_line")
    state = core.reset(4, 2)
    act = torch.zeros(4, dtype=torch.int64, device=card)
    flip = torch.zeros(4, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="actions"):
        rs.fused_step_apply(core, state.a, state.ainv, act.int(), flip)
    with pytest.raises(ValueError, match="contiguous"):
        rs.fused_step_apply(core, state.a.transpose(1, 2), state.ainv, act,
                            flip)


def test_dense_step_on_the_card_equals_cpu(card):
    """The dense core's whole step on the card (torch ops + kernel B2)
    against the same step on the CPU."""
    core = _dense_core("clifford_3q_line")
    with open(os.path.join(MODELS, "clifford_3q_line.json")) as f:
        env = json.load(f)["env"]
    cpu = MatrixEnvCore(env["num_qubits"],
                        [(g[0], tuple(g[1])) for g in env["gateset"]],
                        "clifford", max_depth=env["max_depth"],
                        bitpack=False, device="cpu")
    gen = torch.Generator().manual_seed(5)
    scr = torch.randint(0, core.num_actions, (B, 6), generator=gen)
    sc, sg = cpu.reset(B, 6, scramble_override=scr), \
        core.reset(B, 6, scramble_override=scr)
    for _ in range(4):
        act = torch.randint(0, core.num_actions + 1, (B,), generator=gen)
        flip = torch.rand(B, generator=gen) < 0.5
        sc = cpu.step(sc, act, invert_override=flip)
        sg = core.step(sg, act.to(card), invert_override=flip.to(card))
        for name, x, y in zip(sc._fields, sc, sg):
            assert torch.equal(x, y.cpu()), name


def _b2_operands(batch, n, card, seed):
    """Seeded operands of kernel B2 (every gate type, no-ops included)."""
    return chip_smoke.b2_inputs(
        batch, n, torch.Generator(device=card).manual_seed(seed))


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("n", [5, 12, 27])
@pytest.mark.parametrize("batch", [
    32768,   # whole tiles only: every tile moves by bulk copy
    1000,    # a ragged last tile
    1001,    # not a multiple of 4
    3,       # below one tile
])
def test_metrics_kernel_tiles_and_edges(card, batch, n, track):
    """Kernel B2's bulk-copy tiles, its ragged last tile and its path for
    operands off a 16-byte mark: bit-identical to the plain version."""
    w = (0.01, 0.02, 0.005, 0.001)
    ops = _b2_operands(batch, n, card, seed=batch + n)
    before = mk.metrics_update.launches
    for operands in (ops, tuple(chip_smoke.unaligned(t) for t in ops)):
        got = mk.metrics_update(*operands, w, track)
        want = mk.metrics_update_plain(*operands, w, track)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert mk.metrics_update.launches == before + 2


def test_metrics_kernel_wide_rows_take_the_narrow_tile(card):
    """n = 300: a ring of 64-env tiles would not fit a block's shared
    memory, so the launch takes the 32-env tile (and the opt-in limit)."""
    w = (0.01, 0.02, 0.005, 0.001)
    ops = _b2_operands(777, 300, card, seed=9)
    got = mk.metrics_update(*ops, w, True)
    want = mk.metrics_update_plain(*ops, w, True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("track", [False, True])
def test_pauli_step_through_the_kernel_equals_plain_metrics(card, track):
    """The Pauli-network step with kernel B2 against the same step with the
    plain metrics update: same start, actions and automorphism draws."""
    core = _core("pauli_heavy_hex_27q")
    core.track_layers = track
    g = torch.Generator(device=card).manual_seed(8)
    got = want = core.reset(B, 32, generator=g)
    before = mk.metrics_update.launches
    for _ in range(5):
        act = torch.randint(0, core.num_actions + 1, (B,), generator=g,
                            device=card)
        perm = torch.randint(0, core.num_perms, (B,), generator=g,
                             device=card)
        got = core.step(got, act, perm_idx=perm)
        want = core.step(want, act, perm_idx=perm,
                         metrics=mk.metrics_update_plain)
        _equal(got, want)
    torch.cuda.synchronize()
    assert mk.metrics_update.launches == before + 5


def test_pauli_step_on_the_card_equals_cpu(card):
    """The whole Pauli step and `dense` on the card against the CPU, from
    one injected reset with the same actions and automorphism draws."""
    with open(os.path.join(MODELS, "pauli_12_line.json")) as f:
        cfg = json.load(f)["env"]
    cpu = SYNTH_ENVS["PauliNetworkEnv"].from_json(cfg, device="cpu").core
    core = _core("pauli_12_line")
    gen = torch.Generator().manual_seed(10)
    n, RT = cpu.num_qubits, cpu.RT
    scr = torch.randint(0, cpu.n_scramble, (B, 6), generator=gen)
    x = (torch.rand((B, RT, n), generator=gen) < 0.15).to(torch.uint8)
    z = (torch.rand((B, RT, n), generator=gen) < 0.15).to(torch.uint8)
    valid = (torch.rand((B, RT), generator=gen) < 0.6) & ((x | z).sum(-1) > 0)
    rot = (x.numpy(), z.numpy(), ((x & z).sum(-1) % 4).to(torch.int8).numpy(),
           valid.numpy())
    perm = torch.randint(0, cpu.num_perms, (B,), generator=gen)
    sc = cpu.reset(B, 4, scramble_override=scr, rotations_override=rot,
                   perm_idx=perm)
    sg = core.reset(B, 4, scramble_override=scr, rotations_override=rot,
                    perm_idx=perm)
    for _ in range(6):
        for name, a, b in zip(sc._fields, sc, sg):
            assert torch.equal(a, b.cpu()), name
        assert torch.equal(cpu.dense(sc), core.dense(sg).cpu())
        act = torch.randint(0, cpu.num_actions + 1, (B,), generator=gen)
        perm = torch.randint(0, cpu.num_perms, (B,), generator=gen)
        sc = cpu.step(sc, act, perm_idx=perm)
        sg = core.step(sg, act.to(card), perm_idx=perm.to(card))


# ------------------------------------------------------------- MCTS, AZ
def _az(name, device):
    from qiskit_gym_torch.rl import RLSynthesis

    return RLSynthesis.from_config_json(
        os.path.join(MODELS, name + ".json"),
        os.path.join(MODELS, name + ".pt"), device=device)


@pytest.mark.parametrize("name,kernel", [
    ("az_perm_grid_3x3", "fused_step"), ("az_pauli_18_line", "metrics")])
def test_mcts_search_on_the_card_against_the_cpu(card, name, kernel):
    """One search on the card and the same search on the CPU (plain
    versions) from one reset state with the same injected draws. Structure
    must hold on both; root priors agree to 1e-5; the env step of every
    simulation is one launch of the family's kernel. Visit counts may part
    on near-ties (cuBLAS and CPU logits differ in the last bits), so only a
    share of equal lanes is asked for."""
    from qiskit_gym_torch.rl import mcts_search

    lanes, sims, E = 24, 12, 2
    cpu, gpu = _az(name, "cpu"), _az(name, "cuda")
    gen = torch.Generator().manual_seed(4)
    core_c, core_g = cpu.env.core, gpu.env.core
    A = core_c.num_actions
    state_c = core_c.reset(lanes, 3, generator=gen)
    state_g = type(state_c)(*(x.to(card) for x in state_c))
    draws = dict(
        root_gamma=torch._standard_gamma(torch.full((lanes, A), 0.3),
                                         generator=gen),
        flips=torch.rand((sims, E, lanes), generator=gen) < 0.5,
        perms=(torch.randint(0, core_c.num_perms, (sims, E, lanes),
                             generator=gen)
               if hasattr(core_c, "translate_action") else None))
    counter = fs.fused_step if kernel == "fused_step" else mk.metrics_update
    before = counter.launches
    out = {}
    for key, rls, state in (("cpu", cpu, state_c), ("cuda", gpu, state_g)):
        visits, value, priors = mcts_search(
            rls.env.core, rls.algorithm.policy, state, sims, 1.41, 8,
            noise_eps=0.25, max_expand_depth=E, **draws)
        assert visits.device.type == key
        live = ~rls.env.core.is_final(state)
        assert (visits[live].sum(-1) == sims).all()
        assert float((visits * ~rls.env.core.masks(state))[live].sum()) == 0
        assert torch.isfinite(value).all()
        out[key] = (visits.cpu(), value.cpu(), priors.cpu())
    torch.cuda.synchronize()
    # one env step per simulation and per rollout step, on the card only
    assert counter.launches == before + sims * E
    assert torch.allclose(out["cpu"][2], out["cuda"][2], atol=1e-5)
    same = (out["cpu"][0] == out["cuda"][0]).all(-1).float().mean()
    assert float(same) >= 0.75, float(same)


def test_mcts_synth_on_the_card(card):
    from qiskit_gym_torch.quantum import (linear_from_circuit,
                                          permutation_pattern)

    rls = _az("az_perm_grid_3x3", "cuda")
    pattern = [1, 0, 2, 3, 4, 5, 8, 7, 6]
    before = fs.fused_step.launches
    out = rls.synth(pattern, num_searches=8, num_mcts_searches=16)
    assert out is not None
    assert permutation_pattern(linear_from_circuit(out)).tolist() == pattern
    # 16 simulations and the played step, per move
    moves, rest = divmod(fs.fused_step.launches - before, 17)
    assert rest == 0 and 2 <= moves <= rls.env.core.max_depth


def test_fit_demos_on_the_card_equals_cpu(card):
    """BC from the shipped az_pauli_18_line weights on a seeded corpus, with
    the same injected permutation: the card's weights equal the CPU's within
    1e-4, and the fitted policy still serves through B2."""
    import numpy as np

    from qiskit_gym_torch.rl import fit_demos, generate_demos

    cpu, gpu = _az("az_pauli_18_line", "cpu"), _az("az_pauli_18_line", "cuda")
    spec = cpu.env.spec
    spec.rng = np.random.default_rng(6)
    demos = generate_demos(spec, [2, 4], 20)
    N = demos["action"].shape[0]
    gen = torch.Generator().manual_seed(6)
    perm = torch.stack([torch.randperm(N, generator=gen) for _ in range(2)])
    for rls in (cpu, gpu):
        aux = fit_demos(rls.algorithm, demos, epochs=2, num_minibatches=4,
                        perm=perm)
        assert np.isfinite(aux["loss"])
    for k, v in gpu.params.items():
        assert float((v.cpu() - cpu.params[k]).abs().max()) <= 1e-4, k
    before = mk.metrics_update.launches
    gpu.synth(chip_smoke.bc_targets(gpu.env, 1, np.random.default_rng(1))[0],
              num_searches=16)
    assert mk.metrics_update.launches - before == gpu.env.core.max_depth


def test_graft_on_the_card(card):
    """The 137-action dense Pauli artifact grafted into a fresh 303-action
    policy on the card: the shared logits and the value equal the source's
    within 1e-5."""
    from qiskit_gym_torch.models import graft_action_head

    src = _az("az_pauli_heavy_hex_27q_dense", "cuda")
    dst = chip_smoke.load_artifact("az_pauli_heavy_hex_27q_full",
                                   weights=False)
    src_gs, dst_gs = src.env.gateset, dst.env.gateset
    grafted = graft_action_head(dst.params, src.params, src_gs, dst_gs)
    assert all(v.device.type == "cuda" for v in grafted.values())
    dst.algorithm.policy.module.load_state_dict(grafted)
    core = dst.env.core
    obs = core.dense(core.reset(64, 6, generator=torch.Generator(
        device="cuda").manual_seed(2)))
    cols = [dst_gs.index(gate) for gate in src_gs]
    with torch.no_grad():
        s_logits, s_value = src.algorithm.policy(obs)
        d_logits, d_value = dst.algorithm.policy(obs)
    assert float((d_logits[:, cols] - s_logits).abs().max()) <= 1e-5
    assert float((d_value - s_value).abs().max()) <= 1e-5
