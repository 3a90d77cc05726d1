"""The port's bitpacked matrix envs past 64 rows (W >= 3 words a column)
against the JAX package, on the CPU.

Cores on lines: Clifford at 33 qubits (dim 66, W = 3) and 48 (dim 96, three
whole words), linear function and permutation at 65 (W = 3), and Clifford at
127 qubits (dim 254, W = 8: the `--scale` sweep's 127-qubit line, where
the card's tests hold the wide kernels against this plain version). The
433-qubit line (W = 28) is held on the card only,
kernel against plain version: its JAX core took 35.5 s to build on a
CPU, too long for these tests. Inputs are made
with numpy seeds and injected on both sides (`scramble_override`,
`invert_override`, actions as arrays); every state field, the reward and the
success flag must be bit-identical to the JAX XLA step (packed uint32 words
are compared by their int32 view). The op table's Slm words are held against
the packed lane masks, and the W <= 2 tables against the 64-bit layout they
had before wide tables existed. One case runs the JAX package's Pallas
kernel in interpret mode at W = 3, one a 40-qubit Clifford `policy_solve`
with carried-over weights and injected noise, one a 40-qubit Pauli walk."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qiskit_gym_tpu.rl.rollout as jax_rollout
import qiskit_gym_tpu.rl.solve as jax_solve
import qiskit_gym_torch.rl.solve as torch_solve
from qiskit_gym_tpu.envs import CliffordGym as JaxCliffordGym
from qiskit_gym_tpu.models.policies import make_policy as jax_make_policy
from qiskit_gym_tpu.ops.matrix_env import MatrixEnvCore as JaxCore
from qiskit_gym_tpu.ops.pallas_fused import fused_step as jax_fused_step
from qiskit_gym_tpu.quantum import Circuit as JaxCircuit
from qiskit_gym_torch.envs import CliffordGym
from qiskit_gym_torch.models import make_policy, params_from_jax
from qiskit_gym_torch.ops import fused_step as fs
from qiskit_gym_torch.ops.matrix_env import (MatrixEnvCore, pack_term_tables,
                                             unpack_rows)
from qiskit_gym_torch.quantum import Circuit
from qiskit_gym_torch.rl.rollout import collect

from test_torch_pauli_env import both_reset, line_gateset, walk
from test_torch_pauli_env import cores as pauli_cores
from test_torch_pauli_env import CASES as PAULI_CASES

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
ONE_Q = ("H", "S", "Sdg", "SX", "SXdg")
TWO_Q = ("CX", "CZ", "SWAP")
FAMILY = {"clifford": ONE_Q + TWO_Q, "linear": ("CX", "SWAP"),
          "permutation": ("SWAP",)}
# (kind, qubits) -> dim, W
CORES = {("clifford", 33): (66, 3), ("clifford", 48): (96, 3),
         ("linear", 65): (65, 3), ("permutation", 65): (65, 3),
         ("clifford", 127): (254, 8)}


def line_gates(kind, n):
    """The gateset `from_coupling_map` makes on an n-qubit line."""
    line = [(i, i + 1) for i in range(n - 1)]
    gs = []
    for name in FAMILY[kind]:
        gs += ([(name, e) for e in line] if name in TWO_Q
               else [(name, (q,)) for q in range(n)])
    return gs


def both_cores(kind, n, track=False, add_inverts=True):
    gs = line_gates(kind, n)
    jc = JaxCore(n, gs, kind, add_inverts=add_inverts)
    tc = MatrixEnvCore(n, gs, kind, add_inverts=add_inverts, device="cpu")
    jc.track_layers = tc.track_layers = track
    return jc, tc


def assert_same(js, ts, where):
    assert js._fields == ts._fields
    for field in js._fields:
        j = np.asarray(getattr(js, field))
        t = getattr(ts, field).numpy()
        if j.dtype == np.uint32:
            j = j.view(np.int32)
        assert j.dtype == t.dtype, (field, where)
        assert j.shape == t.shape, (field, where)
        assert np.array_equal(j, t), (field, where)


def scrambled(jc, tc, B, rng, K=8):
    scr = rng.integers(0, jc.num_actions + 1, (B, K))
    js = jc.reset(jax.random.key(0), B, K,
                  scramble_override=jnp.asarray(scr, jnp.int32))
    ts = tc.reset(B, K, scramble_override=torch.as_tensor(scr))
    return js, ts


@pytest.mark.parametrize("kind,n", list(CORES))
def test_wide_cores_build_with_the_packed_default(kind, n):
    _, tc = both_cores(kind, n)
    dim, W = CORES[(kind, n)]
    assert tc.bitpack and (tc.dim, tc.W, tc.L) == (dim, W, W * dim)
    assert tc.op_tab.shape == (tc.num_actions + 1,
                               fs.table_columns(W)["F"])


@pytest.mark.parametrize("kind,n", list(CORES))
@pytest.mark.parametrize("track,add_inverts", [
    (False, True), (True, True), (False, False), (True, False)])
def test_step_bit_identical_to_jax(kind, n, track, add_inverts):
    """set_state from scrambled matrices, then 6 steps with numpy-made
    actions (a no-op on one lane each step) and flips."""
    jc, tc = both_cores(kind, n, track, add_inverts)
    B = 8
    rng = np.random.default_rng(n + 2 * track + add_inverts)
    _, ts0 = scrambled(jc, tc, B, rng)
    dense = unpack_rows(ts0.a, tc.W, tc.dim, tc.dim).numpy()
    js, ts = jc.set_state(dense), tc.set_state(dense)
    assert_same(js, ts, "set_state")
    jstep = jax.jit(jc.step)
    for t in range(6):
        act = rng.integers(0, jc.num_actions + 1, B)
        act[t % B] = jc.noop_action
        flip = rng.random(B) < 0.5
        js = jstep(js, jnp.asarray(act, jnp.int32), jax.random.key(t),
                   invert_override=jnp.asarray(flip) if add_inverts
                   else None)
        ts = tc.step(ts, torch.as_tensor(act),
                     invert_override=torch.as_tensor(flip) if add_inverts
                     else None)
        assert_same(js, ts, t)


@pytest.mark.parametrize("kind,n", list(CORES))
def test_reset_apply_and_dense_match_jax(kind, n):
    jc, tc = both_cores(kind, n)
    rng = np.random.default_rng(n)
    js, ts = scrambled(jc, tc, 6, rng, K=12)
    assert_same(js, ts, "reset")
    np.testing.assert_array_equal(np.asarray(jc.dense(js)),
                                  tc.dense(ts).numpy())
    act = rng.integers(0, jc.num_actions + 1, 6)
    ja, ji = jc.apply_gates(js.a, js.ainv, jnp.asarray(act, jnp.int32))
    ta, ti = tc.apply_gates(ts.a, ts.ainv, torch.as_tensor(act))
    np.testing.assert_array_equal(np.asarray(ja).view(np.int32), ta.numpy())
    np.testing.assert_array_equal(np.asarray(ji).view(np.int32), ti.numpy())


def _slm_from_words(tab, W, Dr):
    """Slm lanes [A1, K, Dr] (0/1) decoded from an op table's words."""
    c = fs.table_columns(W)
    words = tab[:, c["slm"]:c["F"]].view(np.uint32).reshape(
        len(tab), fs.K, fs.slm_words(W))
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(len(tab), fs.K, -1)[:, :, :Dr]


@pytest.mark.parametrize("kind,n,W", [("linear", 27, 1), ("clifford", 27, 2),
                                      ("clifford", 33, 3),
                                      ("clifford", 64, 4)])
def test_op_table_slm_words_equal_the_packed_lanes(kind, n, W):
    """The table's Slm words against the JAX core's Slm lane masks."""
    jc, tc = both_cores(kind, n)
    assert tc.W == W
    np.testing.assert_array_equal(
        _slm_from_words(tc.op_tab.numpy(), W, tc.dim),
        np.asarray(jc.Slm) != 0)


def _table_with_64_bit_slm(U32, S32, Ulm, Slm, mtype, q1, q2):
    """The op table as it was built when Slm was one 64-bit mask (W <= 2)."""
    A1, K, W = U32.shape
    F = 3 + 2 * K * W + 2 * K + 2 * K
    tab = np.zeros((A1, F), np.uint32)
    tab[:, 0], tab[:, 1], tab[:, 2] = mtype, q1, q2
    tab[:, 3:3 + K * W] = U32.reshape(A1, K * W)
    tab[:, 3 + K * W:3 + 2 * K * W] = S32.reshape(A1, K * W)
    ucol, slm = 3 + 2 * K * W, 3 + 2 * K * W + 2 * K
    for a in range(A1):
        for k in range(K):
            cols = np.flatnonzero(Ulm[a, k])
            for s in range(2):
                tab[a, ucol + 2 * k + s] = (np.uint32(cols[s]) if s < len(cols)
                                            else np.uint32(0xFFFFFFFF))
            mask = 0
            for d in np.flatnonzero(Slm[a, k]):
                mask |= 1 << int(d)
            tab[a, slm + 2 * k] = mask & 0xFFFFFFFF
            tab[a, slm + 2 * k + 1] = mask >> 32
    return tab.view(np.int32)


@pytest.mark.parametrize("name", ["clifford_heavy_hex_27q",
                                  "perm_heavy_hex_27q", "lf_5_line",
                                  "clifford_3q_line"])
def test_narrow_op_tables_are_unchanged(name):
    with open(os.path.join(MODELS, name + ".json")) as f:
        full = json.load(f)
    env = full["env"]
    kind = {"CliffordEnv": "clifford", "PermutationEnv": "permutation",
            "LinearFunctionEnv": "linear"}[full["env_cls"].split(".")[-1]]
    gs = [(g[0], tuple(g[1])) for g in env["gateset"]]
    tc = MatrixEnvCore(env["num_qubits"], gs, kind, device="cpu")
    assert tc.W <= 2
    from qiskit_gym_torch.ops.matrix_env import gate_rank2_terms

    Us, Ss = zip(*[gate_rank2_terms(g, tc.num_qubits, kind, tc.dim)
                   for g in gs])
    packed = pack_term_tables(list(Us) + [np.zeros((tc.dim, 2), np.int8)],
                              list(Ss) + [np.zeros((2, tc.dim), np.int8)],
                              tc.dim)
    want = _table_with_64_bit_slm(*packed, tc.mtype, tc.mq1, tc.mq2)
    np.testing.assert_array_equal(tc.op_tab.numpy(), want)


def test_step_matches_the_pallas_kernel_at_w3():
    """The JAX package's Pallas kernel (interpret mode, tracked layers, as
    its own tests run it) against the port's step on a 33-qubit Clifford
    line."""
    jc, tc = both_cores("clifford", 33, track=True)
    B = 16
    rng = np.random.default_rng(21)
    js, ts = scrambled(jc, tc, B, rng)
    for t in range(3):
        act = rng.integers(0, jc.num_actions + 1, B)
        flip = rng.random(B) < 0.5
        js = jax_fused_step(jc, js, jnp.asarray(act, jnp.int32),
                            jnp.asarray(flip), block_b=8, interpret=True)
        ts = tc.step(ts, torch.as_tensor(act),
                     invert_override=torch.as_tensor(flip))
        assert_same(js, ts, t)


def test_policy_solve_40q_clifford_trace_matches_jax(monkeypatch):
    """A 40-qubit Clifford line (dim 80, W = 3): JAX BasicPolicy weights
    carried over by `params_from_jax`, Gumbel noise and flips injected on
    both sides; the rollout trace, the final state and the solution are the
    JAX package's."""
    n, T, lanes = 40, 12, 8
    line = [(i, i + 1) for i in range(n - 1)]
    jenv = JaxCliffordGym.from_coupling_map(line, max_depth=T)
    tenv = CliffordGym.from_coupling_map(line, max_depth=T, device="cpu")
    A = tenv.num_actions()
    cfg = {"embedding_size": 64, "common_layers": [32]}
    jpol = jax_make_policy("BasicPolicy", jenv.obs_shape(), A, cfg)
    params = jax.tree.map(np.asarray, jpol.init(jax.random.key(5)))
    tpol = make_policy("BasicPolicy", tenv.obs_shape(), A, cfg)
    tpol.module.load_state_dict(params_from_jax(params), strict=True)

    rng = np.random.default_rng(40)
    gumbel = rng.gumbel(size=(T, lanes, A)).astype(np.float32)
    flips = rng.random((T, lanes)) < 0.5
    gates = [tenv.gateset[int(a)] for a in rng.integers(0, A, 2)]
    enc = tenv.get_state(Circuit.from_gate_list(gates, num_qubits=n))
    assert enc == jenv.get_state(JaxCircuit.from_gate_list(gates,
                                                           num_qubits=n))

    got = {}
    monkeypatch.setattr(
        jax_rollout, "_pregen_randomness",
        lambda core, key, T_, B_, det: (jnp.asarray(gumbel),
                                        jnp.asarray(flips),
                                        jax.random.split(key, T_)))
    jax_best = jax_solve.best_lane

    def keep_jax(final, traj):
        got["jax"] = (final, traj)
        return jax_best(final, traj)

    monkeypatch.setattr(jax_solve, "best_lane", keep_jax)
    jsol = jax_solve.policy_solve(jenv, jpol, params, enc,
                                  num_searches=lanes,
                                  key=jax.random.key(0))

    def keep_torch(*args, **kw):
        out = collect(*args, gumbel=torch.as_tensor(gumbel),
                      flips=torch.as_tensor(flips), **kw)
        got["torch"] = out
        return out

    monkeypatch.setattr(torch_solve, "collect", keep_torch)
    tsol = torch_solve.policy_solve(tenv, tpol, enc, num_searches=lanes)

    (jfinal, jtraj), (tfinal, ttraj) = got["jax"], got["torch"]
    for field in ("action", "actual", "valid", "done", "inverted", "reward",
                  "success"):
        t = getattr(ttraj, field).numpy()
        np.testing.assert_array_equal(
            t, np.asarray(getattr(jtraj, field)).astype(t.dtype),
            err_msg=field)
    np.testing.assert_allclose(ttraj.logp.numpy(), np.asarray(jtraj.logp),
                               atol=1e-5, rtol=1e-5)
    assert_same(jfinal, tfinal, "final")
    assert tsol == jsol


def test_pauli_40q_walk_matches_jax(monkeypatch):
    """The Pauli-network env at 40 qubits (its tableau is W = 3 words):
    reset with injected scrambles and rotations, then 8 seeded steps."""
    monkeypatch.setitem(PAULI_CASES, "line40", dict(
        num_qubits=40, gateset=line_gateset(40), max_rotations=4,
        pauli_diff_scale=4))
    jc, tc = pauli_cores("line40")
    assert tc.W2 >= 3
    rng = np.random.default_rng(40)
    js, ts = both_reset(jc, tc, rng, 4)
    walk(jc, tc, js, ts, rng, 8, use_override=False)
