"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card with `nvcc` (a CUDA kernel has no CPU mode) and
skip elsewhere. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

They import torch and the port only (and `chip_smoke.py`'s input makers).
Every comparison is bit for bit."""

import functools
import json
import os

import pytest
import torch

import chip_smoke
from qiskit_gym_torch.envs import SYNTH_ENVS
from qiskit_gym_torch.envs.coupling_maps import eagle_127q
from qiskit_gym_torch.ops import fused_step as fs
from qiskit_gym_torch.ops import metrics_kernel as mk
from qiskit_gym_torch.ops import pauli_observe as po
from qiskit_gym_torch.ops import pauli_step as ps
from qiskit_gym_torch.ops import rowop_step as rs
from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore, unpack_rows
from qiskit_gym_torch.ops.pauli import PauliEnvCore

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
    for W in (1, 2, 3, 8, 28):
        assert lib.qgt_op_table_width(W) == fs.table_columns(W)["F"]


_GYMS = {"clifford": "CliffordEnv", "linear": "LinearFunctionEnv",
         "permutation": "PermutationEnv"}


def _line_core(kind, n, **kw):
    """The core of the gym on an n-qubit line, on the card; kind "eagle" is
    the Clifford gym on IBM's 127-qubit Eagle map instead, the tables of
    the `clifford127.train` benchmark cell."""
    if kind == "eagle":
        return SYNTH_ENVS["CliffordEnv"].from_coupling_map(
            eagle_127q(), device="cuda", **kw).core
    line = [(i, i + 1) for i in range(n - 1)]
    return SYNTH_ENVS[_GYMS[kind]].from_coupling_map(
        line, device="cuda", **kw).core


def _wide_batch(kind, n):
    """Envs a wide test steps: the Eagle cell's 2048 lanes, 37 past 100
    qubits, else the ragged B."""
    return 2048 if kind == "eagle" else 37 if n > 100 else B


# (kind, qubits): W = 3 (dim 66 and 65), W = 3 with whole words (dim 96),
# W = 8 (127 qubits) and W = 28 (433 qubits); then W = 4 (dim 128), 5
# (130), 9 (258), 16 (512), 17 (514), 32 (1024), 33 (1026) and 35 (a
# permutation on 1100 rows). Between them they take the wide kernels'
# 16-byte accesses (W * dim a multiple of 4) and 4-byte ones (dim 66, 65,
# 130, 258, 514), at 256 threads a block and at 512 (W * dim >= 16384),
# with rows that end inside an access (dim 866, 258, ...); last the Eagle
# map's tables (W = 8) at 2048 envs
WIDE = [("clifford", 33), ("clifford", 48), ("linear", 65),
        ("permutation", 65), ("clifford", 127), ("clifford", 433),
        ("clifford", 64), ("clifford", 65), ("clifford", 129),
        ("clifford", 256), ("clifford", 257), ("clifford", 512),
        ("clifford", 513), ("permutation", 1100), ("eagle", 127)]


@pytest.mark.parametrize("kind,n", WIDE)
@pytest.mark.parametrize("track,inv", [(False, True), (True, True),
                                       (True, False)])
def test_wide_fused_step_kernel_equals_plain(card, kind, n, track, inv):
    """Kernel B1 for W >= 3 (one block per env) against its plain version,
    every field bit for bit, no-op actions and flips included."""
    core = _line_core(kind, n, add_inverts=inv)
    assert core.W >= 3
    core.track_layers = track
    batch = _wide_batch(kind, n)
    g = torch.Generator(device=card).manual_seed(n)
    state = core.reset(batch, 6, generator=g)
    before = fs.fused_step.launches
    before_wide = fs.fused_step.wide_launches
    for _ in range(5):
        act = torch.randint(0, core.num_actions + 1, (batch,), generator=g,
                            device=card)
        flip = ((torch.rand(batch, generator=g, device=card) < 0.5)
                if inv else None)
        got = fs.fused_step(core, state, act, flip)
        _equal(got, fs.fused_step_plain(core, state, act, flip))
        state = got
    torch.cuda.synchronize()
    assert fs.fused_step.launches == before + 5
    assert fs.fused_step.wide_launches == before_wide + 5


@pytest.mark.parametrize("kind,n", WIDE)
@pytest.mark.parametrize("inv", [True, False])
def test_wide_apply_kernel_equals_plain(card, kind, n, inv):
    core = _line_core(kind, n, add_inverts=inv)
    g = torch.Generator(device=card).manual_seed(n + 1)
    batch = _wide_batch(kind, n)
    state = core.reset(batch, 6, generator=g)
    act = torch.randint(0, core.num_actions + 1, (batch,), generator=g,
                        device=card)
    before = fs.apply_gates.launches
    got = fs.apply_gates(core, state.a, state.ainv, act)
    want = fs.apply_plain(core.op_tab[act], state.a, state.ainv, core.W,
                          core.dim, inv)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert fs.apply_gates.launches == before + 1


def test_wide_solved_flag_fires_on_the_identity(card):
    """Stepping a 127-qubit Clifford target's inverse actions reaches the
    identity: success and reward fire at the last step only."""
    core = _line_core("clifford", 127)
    g = torch.Generator(device=card).manual_seed(8)
    acts = torch.randint(0, core.num_actions, (4, 12), generator=g,
                         device=card)
    state = core.reset(4, 12, scramble_override=acts)
    off = torch.zeros(4, dtype=torch.bool, device=card)
    for t in range(11, -1, -1):  # every gate is an involution
        state = core.step(state, acts[:, t].contiguous(), invert_override=off)
        assert bool(state.success.all()) == (t == 0)
    assert torch.equal(state.a, core.ident_pk.expand(4, -1))


@pytest.mark.parametrize("kind,n", [("clifford", 33), ("clifford", 433),
                                    ("permutation", 1100)])
def test_wide_kernels_at_one_env(card, kind, n):
    """B = 1: one env, one block."""
    core = _line_core(kind, n)
    core.track_layers = True
    g = torch.Generator(device=card).manual_seed(n + 2)
    state = core.reset(1, 6, generator=g)
    for _ in range(4):
        act = torch.randint(0, core.num_actions + 1, (1,), generator=g,
                            device=card)
        flip = torch.rand(1, generator=g, device=card) < 0.5
        got = fs.fused_step(core, state, act, flip)
        _equal(got, fs.fused_step_plain(core, state, act, flip))
        ka, ki = fs.apply_gates(core, state.a, state.ainv, act)
        pa, pi = fs.apply_plain(core.op_tab[act], state.a, state.ainv,
                                core.W, core.dim, True)
        assert torch.equal(ka, pa) and torch.equal(ki, pi)
        state = got


@pytest.mark.parametrize("n", [127, 433])
@pytest.mark.parametrize("every", [True, False])
def test_wide_step_with_every_env_flipped_or_none(card, n, every):
    core = _line_core("clifford", n)
    g = torch.Generator(device=card).manual_seed(n + every)
    state = core.reset(37, 6, generator=g)
    flip = torch.full((37,), every, dtype=torch.bool, device=card)
    for _ in range(3):
        act = torch.randint(0, core.num_actions + 1, (37,), generator=g,
                            device=card)
        got = fs.fused_step(core, state, act, flip)
        _equal(got, fs.fused_step_plain(core, state, act, flip))
        assert torch.equal(got.inverted, state.inverted ^ flip)
        state = got


@pytest.mark.parametrize("n", [127, 433])
def test_wide_kernels_on_tensors_off_a_16_byte_mark(card, n):
    """State tensors that start 4 bytes past a 16-byte mark take the wide
    kernels' 4-byte accesses; the results are those of the plain version."""
    core = _line_core("clifford", n)
    g = torch.Generator(device=card).manual_seed(n + 4)
    state = core.reset(9, 6, generator=g)
    state = state._replace(a=chip_smoke.unaligned(state.a),
                           ainv=chip_smoke.unaligned(state.ainv))
    act = torch.randint(0, core.num_actions + 1, (9,), generator=g,
                        device=card)
    flip = torch.rand(9, generator=g, device=card) < 0.5
    got = fs.fused_step(core, state, act, flip)
    _equal(got, fs.fused_step_plain(core, state, act, flip))
    ka, ki = fs.apply_gates(core, state.a, state.ainv, act)
    pa, pi = fs.apply_plain(core.op_tab[act], state.a, state.ainv, core.W,
                            core.dim, True)
    assert torch.equal(ka, pa) and torch.equal(ki, pi)


def _near_identity(core, spots):
    """Packed states at the identity, env e with bit 0 of word w of column
    d flipped for its spot (d, w) in `spots`, the last env untouched."""
    a = core.ident_pk.expand(len(spots) + 1, -1).clone()
    for e, (d, w) in enumerate(spots):
        a[e, w * core.dim + d] ^= 1
    return a


@pytest.mark.parametrize("kind,n", [("clifford", 33), ("clifford", 127),
                                    ("clifford", 433), ("clifford", 512),
                                    ("permutation", 1100)])
def test_wide_solved_flag_sees_every_word(card, kind, n):
    """A state equal to the identity but for one word is not solved,
    wherever that word lies: one env per spot, a spot every 64 columns
    (in rows that vary, so in words that different threads and rounds of
    the wide kernel's stream load) and one in the last word of the last
    column. The same states fixed are solved."""
    core = _line_core(kind, n)
    dim, W = core.dim, core.W
    spots = [(d, (d // 32 + 1) % W) for d in range(0, dim, 64)]
    spots.append((dim - 1, W - 1))
    B = len(spots) + 1
    state = core.reset(B, 2)
    noop = torch.full((B,), core.noop_action, dtype=torch.int64,
                      device=card)
    off = torch.zeros(B, dtype=torch.bool, device=card)
    broken = state._replace(a=_near_identity(core, spots))
    got = fs.fused_step(core, broken, noop, off)
    _equal(got, fs.fused_step_plain(core, broken, noop, off))
    assert got.success.tolist() == [False] * len(spots) + [True]
    fixed = state._replace(a=core.ident_pk.expand(B, -1).clone())
    got = fs.fused_step(core, fixed, noop, off)
    _equal(got, fs.fused_step_plain(core, fixed, noop, off))
    assert bool(got.success.all()) and bool((got.reward == 1.0).all())


@pytest.mark.parametrize("n", [127, 433])
def test_wide_kernels_replayed_in_a_cuda_graph(card, n):
    """The step and apply kernels captured once in a CUDA graph and
    replayed three times on new inputs copied into the captured ones, each
    replay equal to the plain version. Env 0 is solved in replays 0 and 2
    and one word off in replay 1, so a flag or count carried from one
    replay to the next would show."""
    core = _line_core("clifford", n)
    core.track_layers = True
    batch = 64
    g = torch.Generator(device=card).manual_seed(n + 3)
    ident = core.ident_pk

    def inputs(solved):
        st = core.reset(batch, 6, generator=g)
        act = torch.randint(0, core.num_actions + 1, (batch,), generator=g,
                            device=card)
        flip = torch.rand(batch, generator=g, device=card) < 0.5
        a = st.a.clone()
        a[0] = ident
        if not solved:
            a[0, -1] ^= 1
        act[0], flip[0] = core.noop_action, False
        return st._replace(a=a), act, flip

    st0, act0, flip0 = inputs(True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fs.fused_step(core, st0, act0, flip0)
        fs.apply_gates(core, st0.a, st0.ainv, act0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fs.fused_step(core, st0, act0, flip0)
        oa, oi = fs.apply_gates(core, st0.a, st0.ainv, act0)
    for r in range(3):
        st, act, flip = inputs(r != 1)
        for field in st._fields:
            getattr(st0, field).copy_(getattr(st, field))
        act0.copy_(act)
        flip0.copy_(flip)
        graph.replay()
        torch.cuda.synchronize()
        _equal(out, fs.fused_step_plain(core, st, act, flip))
        assert bool(out.success[0]) == (r != 1)
        pa, pi = fs.apply_plain(core.op_tab[act], st.a, st.ainv, core.W,
                                core.dim, True)
        assert torch.equal(oa, pa) and torch.equal(oi, pi)


def test_wide_step_raises_on_a_shape_it_does_not_take(card):
    """No fallback: a core whose W does not fit its dim raises before any
    launch, and the library refuses Dr > 32 W itself."""
    core = _line_core("clifford", 33)
    state = core.reset(4, 2)
    act = torch.zeros(4, dtype=torch.int64, device=card)
    flip = torch.zeros(4, dtype=torch.bool, device=card)
    before = fs.fused_step.launches
    core.dim = 97  # 97 rows do not fit W = 3 words
    with pytest.raises(ValueError, match="do not fit"):
        fs.fused_step(core, state, act, flip)
    assert fs.fused_step.launches == before
    p = fs.cuda_lib.ptr
    err = fs._lib().qgt_apply_gates(p(act), p(state.a), p(state.ainv),
                                    p(core.op_tab), p(state.a),
                                    p(state.ainv), 4, 3, 97, 1, None)
    assert err != 0


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


@pytest.mark.parametrize("n,batch,flips", [
    (172, 5, "random"),    # D = 344: the first D past 227 KB of tiles
    (176, 3, "all"),       # D = 352
    (176, 4, "none"),
    (433, 3, "random"),    # D = 872: the 433-qubit line
    (433, 2, "all"),
])
def test_rowop_stream_kernel_equals_plain(card, n, batch, flips):
    """Kernel B3's streaming path (2 D^2 bytes past a block's shared
    memory) against its plain version and the dense apply_gates, on dense
    Clifford line cores, ragged batches, every env flipped or none, no-op
    action included; the identity is seen as solved."""
    core = chip_smoke.dense_line_core(n)
    assert rs._lib().qgt_rowop_streams(core.D) == 1
    g = torch.Generator(device=card).manual_seed(n + batch)
    state = core.reset(batch, 10, generator=g)
    a, ainv = state.a, state.ainv
    before = (rs.fused_step_apply.launches,
              rs.fused_step_apply.large_launches)
    for t in range(4):
        act = torch.randint(0, core.num_actions + 1, (batch,), generator=g,
                            device=card)
        act[t % batch] = core.noop_action
        flip = {"all": torch.ones(batch, dtype=torch.bool, device=card),
                "none": torch.zeros(batch, dtype=torch.bool, device=card),
                "random": torch.rand(batch, generator=g, device=card) < 0.5,
                }[flips]
        got = rs.fused_step_apply(core, a, ainv, act, flip)
        want = rs.fused_step_apply_plain(core, a, ainv, act, flip)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y), t
        na, ni = core.apply_gates(a, ainv, act)
        f3 = flip[:, None, None]
        assert torch.equal(got[0], torch.where(f3, ni, na))
        assert torch.equal(got[1], torch.where(f3, na, ni))
        a, ainv = got[0], got[1]
    torch.cuda.synchronize()
    assert rs.fused_step_apply.launches == before[0] + 4
    assert rs.fused_step_apply.large_launches == before[1] + 4
    ident = core.reset(batch, 0)
    noop = torch.full((batch,), core.noop_action, device=card)
    for flip in (torch.zeros(batch, dtype=torch.bool, device=card),
                 torch.ones(batch, dtype=torch.bool, device=card)):
        assert rs.fused_step_apply(core, ident.a, ident.ainv, noop,
                                   flip)[2].all()


def test_rowop_stream_kernel_takes_over_exactly_past_the_limit(card):
    """D = 336 is the last D whose two tiles fit (225.8 KB); 344 streams."""
    lib = rs._lib()
    assert [lib.qgt_rowop_streams(D) for D in (8, 56, 336, 344, 872)] == \
        [0, 0, 0, 1, 1]


@pytest.mark.parametrize("n", [6148, 6152])   # D = 12296, 12304
def test_rowop_stream_kernel_past_its_static_stage(card, n):
    """The streaming kernel stages 4 D bytes: past 48 KB (D > 12288) its
    launch opts in to more shared memory. A dense Clifford core with gates
    on both ends of the state, both terms enabled, one env flipped."""
    from qiskit_gym_torch.envs.synthesis import ONE_Q_GATES, TWO_Q_GATES

    qs = [0, 1, n // 2, n - 2]
    gateset = ([(g, (q,)) for g in ONE_Q_GATES for q in qs + [n - 1]]
               + [(g, p) for g in TWO_Q_GATES for q in qs
                  for p in ((q, q + 1), (q + 1, q))])
    core = MatrixEnvCore(n, gateset, "clifford", bitpack=False, device=card)
    assert core.D > 12288 and rs._lib().qgt_rowop_streams(core.D) == 1
    g = torch.Generator(device=card).manual_seed(n)
    state = core.reset(2, 6, generator=g)
    a, ainv = state.a, state.ainv
    flip = torch.tensor([True, False], device=card)
    before = rs.fused_step_apply.large_launches
    for t in range(3):
        act = torch.randint(0, core.num_actions + 1, (2,), generator=g,
                            device=card)
        got = rs.fused_step_apply(core, a, ainv, act, flip)
        want = rs.fused_step_apply_plain(core, a, ainv, act, flip)
        for x, y in zip(got, want):
            assert torch.equal(x, y), t
        a, ainv = got[0], got[1]
    torch.cuda.synchronize()
    assert rs.fused_step_apply.large_launches == before + 3


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
@pytest.mark.parametrize("n,batch", [(127, 8192), (433, 1024), (433, 77)])
def test_metrics_kernel_at_127_and_433_qubits(card, n, batch, track):
    """Kernel B2 at the widths of the large Clifford lines (rows of 508 and
    1732 bytes; n = 433 takes the 32-env tile), operands aligned and not."""
    w = (0.01, 0.02, 0.005, 0.001)
    ops = _b2_operands(batch, n, card, seed=n)
    for operands in (ops, tuple(chip_smoke.unaligned(t) for t in ops)):
        got = mk.metrics_update(*operands, w, track)
        want = mk.metrics_update_plain(*operands, w, track)
        torch.cuda.synchronize()
        assert all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(got, want))


@pytest.mark.parametrize("track", [False, True])
def test_pauli_step_through_the_kernel_equals_plain_metrics(card, track):
    """The Pauli-network step with kernel B2 and the transition kernel
    against the same step with the plain metrics update and the plain
    transition: same start, actions and automorphism draws."""
    core = _core("pauli_heavy_hex_27q")
    core.track_layers = track
    g = torch.Generator(device=card).manual_seed(8)
    got = want = core.reset(B, 32, generator=g)
    before = (mk.metrics_update.launches, ps.pauli_step.launches)
    for _ in range(5):
        act = torch.randint(0, core.num_actions + 1, (B,), generator=g,
                            device=card)
        perm = torch.randint(0, core.num_perms, (B,), generator=g,
                             device=card)
        got = core.step(got, act, perm_idx=perm)
        want = core.step(want, act, perm_idx=perm,
                         metrics=mk.metrics_update_plain,
                         transition=ps.pauli_step_plain)
        _equal(got, want)
    torch.cuda.synchronize()
    assert (mk.metrics_update.launches, ps.pauli_step.launches) == (
        before[0] + 5, before[1] + 5)


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
    before = ps.pauli_step.launches
    for _ in range(6):
        for name, a, b in zip(sc._fields, sc, sg):
            assert torch.equal(a, b.cpu()), name
        assert torch.equal(cpu.dense(sc), core.dense(sg).cpu())
        act = torch.randint(0, cpu.num_actions + 1, (B,), generator=gen)
        perm = torch.randint(0, cpu.num_perms, (B,), generator=gen)
        sc = cpu.step(sc, act, perm_idx=perm)
        sg = core.step(sg, act.to(card), perm_idx=perm.to(card))
    assert ps.pauli_step.launches == before + 6


# ----------------------------------------------------- Pauli transition
def _hold_pauli_step(core, state, steps=8):
    """`steps` steps through the transition kernel, each against the plain
    transition from the same state. Lane i of step t takes action
    (i + t B) mod (A + 1) under automorphism ((i + t B) div (A + 1)) mod P,
    so every action, the no-op included, meets every automorphism once
    steps * B >= P (A + 1). Returns the rotations retired."""
    dev, A1 = state.tab.device, core.num_actions + 1
    before = ps.pauli_step.launches
    retired = 0
    for t in range(steps):
        k = torch.arange(state.batch, device=dev) + t * state.batch
        act = k % A1
        perm = ((k // A1) % core.num_perms).to(torch.int32)
        got = core.step(state, act, perm_idx=perm)
        want = core.step(state, act, perm_idx=perm,
                         transition=ps.pauli_step_plain)
        _equal(got, want)
        retired += int(state.active.sum() - got.active.sum())
        state = got
    torch.cuda.synchronize()
    assert ps.pauli_step.launches == before + steps
    assert steps * state.batch >= core.num_perms * A1
    return retired


def _labels(core, rng):
    """Up to R rotation labels a lane, of weight 1 to 3 on neighbouring
    qubits."""
    n = core.num_qubits
    out = []
    for _ in range(B):
        labels = []
        for _ in range(int(rng.integers(0, core.R + 1))):
            q = int(rng.integers(0, n - 2))
            chars = ["I"] * n
            for j in range(int(rng.integers(1, 4))):
                chars[n - 1 - (q + j)] = "XYZ"[int(rng.integers(0, 3))]
            labels.append("".join(chars))
        out.append(labels)
    return out


@pytest.mark.parametrize("start", ["reset_1", "reset_8", "reset_64",
                                   "set_state"])
def test_pauli_step_kernel_on_the_27q_core(card, start):
    """The 27q heavy-hex artifact's core (W2 = 2, Wn = 1, RT = 7) at the
    ragged B from reset at difficulties 1, 8 and 64 and from `set_state`
    (no initial sweep, so weight-1 rotations wait for a CNOT): every
    action and both automorphisms, bit for bit with the plain
    transition."""
    import numpy as np

    core = _core("pauli_heavy_hex_27q")
    assert core.num_perms == 2 and (core.W2, core.Wn) == (2, 1)
    g = torch.Generator(device=card).manual_seed(40)
    if start == "set_state":
        rng = np.random.default_rng(41)
        tabs = unpack_rows(core.reset(B, 8, generator=g).tab, core.W2,
                           core.D2, core.dim)[:, :, :core.dim]
        state = core.set_state(tabs.cpu().numpy(), _labels(core, rng))
    else:
        state = core.reset(B, int(start.split("_")[1]), generator=g)
    retired = _hold_pauli_step(core, state)
    # pauli_diff_scale is 16: rotations from difficulty 16 on
    if start in ("reset_64", "set_state"):
        assert retired > 0


@functools.lru_cache(maxsize=None)
def _line_pauli_core(n, max_rotations):
    gs = [(name, (q,)) for name in ("H", "S", "Sdg", "SX", "SXdg")
          for q in range(n)]
    gs += [(name, pair) for name in ("CX", "CZ", "SWAP")
           for q in range(n - 1) for pair in ((q, q + 1), (q + 1, q))]
    return PauliEnvCore(n, gs, max_rotations=max_rotations, device="cuda")


def _line_rotations(core, rng):
    """Rotations of weight 1 or 2 on neighbouring qubits of the line, in
    80 % of the slots: (x, z, phase, valid) for `reset`."""
    import numpy as np

    n, RT = core.num_qubits, core.RT
    q = rng.integers(0, n - 1, (B, RT))
    b, r = np.meshgrid(np.arange(B), np.arange(RT), indexing="ij")
    x = np.zeros((B, RT, n), np.uint8)
    z = np.zeros((B, RT, n), np.uint8)
    axis = rng.integers(0, 3, (B, RT))
    x[b, r, q], z[b, r, q] = axis != 2, axis != 0
    two = rng.random((B, RT)) < 0.7
    axis = rng.integers(0, 3, (B, RT))
    x[b, r, q + 1], z[b, r, q + 1] = two & (axis != 2), two & (axis != 0)
    valid = rng.random((B, RT)) < 0.8
    return x, z, ((x & z).sum(-1) % 4).astype(np.int8), valid


@pytest.mark.parametrize("n,max_rotations", [
    (33, 1), (33, 12), (33, 40), (127, 1), (127, 12)])
def test_pauli_step_kernel_on_line_cores(card, n, max_rotations):
    """Line-coupled cores past one word: n = 33 (W2 = 3, Wn = 2) and 127
    (W2 = 8, Wn = 4), with 3, 14 and 42 rotation slots (42: a lane holds
    two rotations), every action and both automorphisms, bit for bit with
    the plain transition."""
    import numpy as np

    core = _line_pauli_core(n, max_rotations)
    assert core.Wn > 1 and core.W2 > 2 and core.num_perms == 2
    g = torch.Generator(device=card).manual_seed(n + max_rotations)
    rng = np.random.default_rng(n + max_rotations)
    state = core.reset(B, 8, generator=g,
                       rotations_override=_line_rotations(core, rng))
    steps = -(-2 * (core.num_actions + 1) // B)
    assert _hold_pauli_step(core, state, steps) > 0


def test_pauli_step_kernel_replayed_in_a_cuda_graph(card):
    """The whole Pauli step (translation, B2, the transition kernel)
    captured once in a CUDA graph and replayed on new inputs copied into
    the captured ones, each replay equal to the plain step."""
    core = _core("pauli_heavy_hex_27q")
    g = torch.Generator(device=card).manual_seed(44)

    def inputs(difficulty):
        st = core.reset(B, difficulty, generator=g)
        act = torch.randint(0, core.num_actions + 1, (B,), generator=g,
                            device=card)
        perm = torch.randint(0, core.num_perms, (B,), generator=g,
                             device=card).to(torch.int32)
        return st, act, perm

    st0, act0, perm0 = inputs(32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        core.step(st0, act0, perm_idx=perm0)
    torch.cuda.current_stream().wait_stream(side)
    before = ps.pauli_step.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = core.step(st0, act0, perm_idx=perm0)
    assert ps.pauli_step.launches == before + 1
    for difficulty in (8, 64, 16):
        st, act, perm = inputs(difficulty)
        for field in st._fields:
            getattr(st0, field).copy_(getattr(st, field))
        act0.copy_(act)
        perm0.copy_(perm)
        graph.replay()
        torch.cuda.synchronize()
        _equal(out, core.step(st, act, perm_idx=perm,
                              metrics=mk.metrics_update_plain,
                              transition=ps.pauli_step_plain))


@pytest.mark.parametrize("fault", ["rphase_int32", "anti_uint8",
                                   "rx_strided", "rotations_past_64"])
def test_pauli_step_raises_on_what_it_does_not_take(card, fault):
    """No fallback: an operand of another type, a strided one, or a core
    past the kernel's 64 rotations raises before any launch."""
    core = _core("pauli_heavy_hex_27q")
    if fault == "rotations_past_64":
        core = _line_pauli_core(5, 70)
    g = torch.Generator(device=card).manual_seed(45)
    state = core.reset(B, 8, generator=g)
    if fault == "rphase_int32":
        state = state._replace(rphase=state.rphase.to(torch.int32))
    elif fault == "anti_uint8":
        state = state._replace(anti=state.anti.to(torch.uint8))
    elif fault == "rx_strided":
        state = state._replace(rx=torch.cat([state.rx, state.rx], 2)[..., ::2])
    act = torch.zeros(B, dtype=torch.int64, device=card)
    before = ps.pauli_step.launches
    with pytest.raises(ValueError, match="pauli_step"):
        core.step(state, act)
    assert ps.pauli_step.launches == before


# ---------------------------------------------------- Pauli observation
@functools.lru_cache(maxsize=None)
def _observe_core(name):
    """The 27q heavy-hex artifact's core (two automorphisms), its gateset
    with none (a one-row perm table), and IBM's 127q Eagle map with every
    1q gate and CX both ways on each coupler (W2 = 8, Wn = 4)."""
    if name == "eagle_127q":
        gs = [(g, (q,)) for g in ("H", "S", "Sdg", "SX", "SXdg")
              for q in range(127)]
        gs += [("CX", e) for a, b in eagle_127q() for e in ((a, b), (b, a))]
        return PauliEnvCore(127, gs, device="cuda")
    with open(os.path.join(MODELS, "pauli_heavy_hex_27q.json")) as f:
        env = json.load(f)["env"]
    return PauliEnvCore(
        27, [(g[0], tuple(g[1])) for g in env["gateset"]],
        max_rotations=env["max_rotations"], max_depth=env["max_depth"],
        pauli_diff_scale=env["pauli_diff_scale"],
        add_perms=name == "heavy_hex_27q", device="cuda")


def _observe_states(core, batch, seed):
    """Reset at difficulty 64, three random steps (both automorphisms
    drawn), then the last state with its active set replaced by random
    subsets of every size from 0 to RT (lane b: b mod (RT + 1) slots)."""
    dev = core.device
    g = torch.Generator(device=dev).manual_seed(seed)
    st = core.reset(batch, 64, generator=g)
    yield st
    for _ in range(3):
        act = torch.randint(0, core.num_actions + 1, (batch,), generator=g,
                            device=dev)
        st = core.step(st, act, generator=g)
        yield st
    order = torch.rand((batch, core.RT), generator=g, device=dev).argsort(1)
    count = torch.arange(batch, device=dev) % (core.RT + 1)
    yield st._replace(active=order < count[:, None])


def _plain_observe(core, st, chunk=2048):
    """The plain observation, lanes a chunk at a time (its int64 unpacking
    of the 127q tableau takes 0.5 MB a lane)."""
    return torch.cat([
        po.pauli_observe_plain(core, type(st)(*(f[a:a + chunk] for f in st)))
        for a in range(0, st.batch, chunk)])


@pytest.mark.parametrize("batch", [1, 7, 32768])
@pytest.mark.parametrize("name", ["heavy_hex_27q", "heavy_hex_27q_trivial",
                                  "eagle_127q"])
def test_pauli_observe_kernel_equals_plain(card, name, batch):
    """The observation kernel against its plain version byte for byte, on
    reachable states and on every size of the active set."""
    core = _observe_core(name)
    assert (core.num_perms, core.W2, core.Wn) == {
        "heavy_hex_27q": (2, 2, 1), "heavy_hex_27q_trivial": (1, 2, 1),
        "eagle_127q": (2, 8, 4)}[name]
    drawn, counts = set(), set()
    before = po.pauli_observe.launches
    for t, st in enumerate(_observe_states(core, batch, batch + 3)):
        got = po.pauli_observe(core, st)
        want = _plain_observe(core, st)
        assert got.dtype == want.dtype and torch.equal(got, want), t
        drawn |= set(st.perm_idx.unique().tolist())
        counts |= set(st.active.sum(1).unique().tolist())
    torch.cuda.synchronize()
    assert po.pauli_observe.launches == before + 5
    if batch == 32768:
        assert drawn == set(range(core.num_perms))
        assert counts == set(range(core.RT + 1))


@pytest.mark.parametrize("fault", ["tab_int64", "active_uint8", "rx_strided",
                                   "rotations_past_64"])
def test_pauli_observe_raises_on_what_it_does_not_take(card, fault):
    """No fallback: an operand of another type, a strided one, or a core
    past the kernel's 64 rotation slots raises before any launch."""
    core = _observe_core("heavy_hex_27q")
    if fault == "rotations_past_64":
        core = _line_pauli_core(5, 70)
    g = torch.Generator(device=card).manual_seed(46)
    st = core.reset(B, 8, generator=g)
    if fault == "tab_int64":
        st = st._replace(tab=st.tab.to(torch.int64))
    elif fault == "active_uint8":
        st = st._replace(active=st.active.to(torch.uint8))
    elif fault == "rx_strided":
        st = st._replace(rx=torch.cat([st.rx, st.rx], 2)[..., ::2])
    before = po.pauli_observe.launches
    with pytest.raises(ValueError, match="pauli_observe"):
        core.dense(st)
    assert po.pauli_observe.launches == before


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
