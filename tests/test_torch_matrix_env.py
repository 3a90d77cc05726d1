"""The port's bitpacked matrix env (plain PyTorch versions of kernels B1 and
B2) against the JAX package's XLA step, bit for bit, on the CPU.

Inputs are made with numpy seeds and injected on both sides through
`scramble_override` and `invert_override`. Packed words are compared by
their int32 view (the port holds uint32 bit patterns in int32 tensors)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.ops.matrix_env import MatrixEnvCore as JaxCore
from qiskit_gym_torch.ops import fused_step as fs
from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore, unpack_rows
from qiskit_gym_torch.ops.metrics_kernel import metrics_update_plain
from qiskit_gym_torch.ops.permutation import PermutationEnvCore

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
KINDS = {"CliffordEnv": "clifford", "PermutationEnv": "permutation",
         "LinearFunctionEnv": "linear"}
CORES = ["clifford_heavy_hex_27q", "perm_heavy_hex_27q", "lf_5_line"]


def _artifact_env(name):
    with open(os.path.join(MODELS, name + ".json")) as f:
        full = json.load(f)
    env = full["env"]
    gateset = [(g[0], tuple(g[1])) for g in env["gateset"]]
    return (env["num_qubits"], gateset,
            KINDS[full["env_cls"].split(".")[-1]], env["max_depth"])


def _cores(name, track, add_inverts=True):
    n, gs, kind, max_depth = _artifact_env(name)
    jc = JaxCore(n, gs, kind, max_depth=max_depth, add_inverts=add_inverts)
    tc = MatrixEnvCore(n, gs, kind, max_depth=max_depth,
                       add_inverts=add_inverts, device="cpu")
    jc.track_layers = track
    tc.track_layers = track
    return jc, tc


def _assert_same(js, ts, where):
    assert js._fields == ts._fields
    for field in js._fields:
        j = np.asarray(getattr(js, field))
        t = getattr(ts, field).numpy()
        if j.dtype == np.uint32:
            j = j.view(np.int32)
        assert j.dtype == t.dtype, (field, where)
        assert j.shape == t.shape, (field, where)
        assert np.array_equal(j, t), (field, where)


def _scrambled(jc, tc, B, rng, K=6):
    scr = rng.integers(0, jc.num_actions + 1, (B, K))
    js = jc.reset(jax.random.key(0), B, K,
                  scramble_override=jnp.asarray(scr, jnp.int32))
    ts = tc.reset(B, K, scramble_override=torch.as_tensor(scr))
    return js, ts


STEP_CASES = ([(c, t, True) for c in CORES for t in (False, True)]
              + [("clifford_heavy_hex_27q", False, False),
                 ("perm_heavy_hex_27q", True, False)])


@pytest.mark.parametrize("name,track,add_inverts", STEP_CASES)
def test_step_bit_identical_to_jax(name, track, add_inverts):
    """set_state, then 6 steps with numpy-made actions (no-op included)
    and flips: all 12 state fields identical, reward exact."""
    jc, tc = _cores(name, track, add_inverts)
    B = 12
    rng = np.random.default_rng(3)
    # set_state from scrambled dense matrices (the solve path's entry)
    _, ts0 = _scrambled(jc, tc, B, rng)
    dense = unpack_rows(ts0.a, tc.W, tc.dim, tc.dim).numpy()
    js = jc.set_state(dense)
    ts = tc.set_state(dense)
    _assert_same(js, ts, "set_state")
    for t in range(6):
        act = rng.integers(0, jc.num_actions + 1, B)
        act[t % B] = jc.noop_action
        flip = rng.random(B) < 0.5
        js = jc.step(js, jnp.asarray(act, jnp.int32), jax.random.key(t),
                     invert_override=jnp.asarray(flip) if add_inverts
                     else None)
        ts = tc.step(ts, torch.as_tensor(act),
                     invert_override=torch.as_tensor(flip) if add_inverts
                     else None)
        _assert_same(js, ts, t)


@pytest.mark.parametrize("name", CORES)
def test_reset_scramble_override_matches_jax(name):
    jc, tc = _cores(name, False)
    js, ts = _scrambled(jc, tc, 16, np.random.default_rng(4), K=9)
    _assert_same(js, ts, "reset")


@pytest.mark.parametrize("name", CORES)
def test_dense_matches_jax(name):
    jc, tc = _cores(name, False)
    js, ts = _scrambled(jc, tc, 8, np.random.default_rng(5))
    np.testing.assert_array_equal(np.asarray(jc.dense(js)),
                                  tc.dense(ts).numpy())
    np.testing.assert_array_equal(np.asarray(jc.masks(js)),
                                  tc.masks(ts).numpy())
    np.testing.assert_array_equal(np.asarray(jc.is_final(js)),
                                  tc.is_final(ts).numpy())


@pytest.mark.parametrize("difficulty", [5, "per_lane"])
def test_random_reset_keeps_inverse(difficulty):
    """a . ainv = I over GF(2) after a random scramble (int and per-lane
    difficulty), and the depth budget follows the difficulty."""
    _, tc = _cores("clifford_heavy_hex_27q", False)
    g = torch.Generator().manual_seed(0)
    B = 6
    d = (torch.arange(B, dtype=torch.int32) + 1 if difficulty == "per_lane"
         else difficulty)
    st = tc.reset(B, d, generator=g)
    a = tc.dense(st).long()
    ainv = unpack_rows(st.ainv, tc.W, tc.dim, tc.dim).long()
    eye = torch.eye(tc.dim, dtype=torch.long).expand(B, -1, -1)
    assert torch.equal((a @ ainv) % 2, eye)
    want = torch.clamp(2 * torch.as_tensor(d), max=tc.max_depth)
    assert torch.equal(st.depth, torch.broadcast_to(want, (B,)).int())


@pytest.mark.parametrize("name,track", [(c, t) for c in CORES[:2]
                                        for t in (False, True)])
def test_metrics_plain_matches_jax(name, track):
    """Plain kernel-B2 function against `_metrics_update_terms`."""
    jc, tc = _cores(name, True)
    B = 16
    rng = np.random.default_rng(6)
    js, ts = _scrambled(jc, tc, B, rng)
    for t in range(4):  # non-trivial layer fields
        act = rng.integers(0, jc.num_actions + 1, B)
        flip = rng.random(B) < 0.5
        js = jc.step(js, jnp.asarray(act, jnp.int32), jax.random.key(t),
                     invert_override=jnp.asarray(flip))
        ts = tc.step(ts, torch.as_tensor(act),
                     invert_override=torch.as_tensor(flip))
    jc.track_layers = track
    act = rng.integers(0, jc.num_actions + 1, B)
    mtype, q1, q2 = jc.mtype[act], jc.mq1[act], jc.mq2[act]
    noop = jnp.asarray(act == jc.noop_action)
    want, pen = jc._metrics_update_terms(js, mtype, q1, q2, noop)
    scal = torch.stack([ts.max_g, ts.max_c, ts.n_cnots, ts.n_gates,
                        torch.as_tensor(np.asarray(mtype), dtype=torch.int32),
                        torch.as_tensor(np.asarray(q1), dtype=torch.int32),
                        torch.as_tensor(np.asarray(q2), dtype=torch.int32),
                        torch.as_tensor(act == jc.noop_action,
                                        dtype=torch.int32)], dim=1)
    lg, lc, out, got_pen = metrics_update_plain(
        ts.last_g, ts.last_c, scal, tc.weights_static, track)
    np.testing.assert_array_equal(np.asarray(want.last_g), lg.numpy())
    np.testing.assert_array_equal(np.asarray(want.last_c), lc.numpy())
    for col, field in enumerate(("max_g", "max_c", "n_cnots", "n_gates")):
        np.testing.assert_array_equal(np.asarray(getattr(want, field)),
                                      out[:, col].numpy())
    np.testing.assert_array_equal(np.asarray(pen), got_pen.numpy())


@pytest.mark.parametrize("track", [False, True])
def test_metrics_kernel_route_equals_fused_route(track):
    """use_metrics_kernel (B2 + apply) gives the same step as the fused
    B1 route."""
    jc, tc = _cores("clifford_heavy_hex_27q", track)
    rng = np.random.default_rng(8)
    _, ts = _scrambled(jc, tc, 10, rng)
    act = torch.as_tensor(rng.integers(0, tc.num_actions + 1, 10))
    flip = torch.as_tensor(rng.random(10) < 0.5)
    want = tc.step(ts, act, invert_override=flip)
    tc.use_metrics_kernel = True
    got = tc.step(ts, act, invert_override=flip)
    for field, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), field


def test_apply_gates_plain_matches_jax():
    jc, tc = _cores("clifford_heavy_hex_27q", False)
    rng = np.random.default_rng(9)
    js, ts = _scrambled(jc, tc, 8, rng)
    act = rng.integers(0, jc.num_actions + 1, 8)
    ja, ji = jc.apply_gates(js.a, js.ainv, jnp.asarray(act, jnp.int32))
    ta, ti = fs.apply_gates(tc, ts.a, ts.ainv, torch.as_tensor(act))
    np.testing.assert_array_equal(np.asarray(ja).view(np.int32), ta.numpy())
    np.testing.assert_array_equal(np.asarray(ji).view(np.int32), ti.numpy())


def test_permutation_core_set_state_and_perm_vector():
    n, gs, _, _ = _artifact_env("perm_grid_3x3")
    core = PermutationEnvCore(n, gs, device="cpu")
    perms = np.stack([np.random.default_rng(i).permutation(n)
                      for i in range(3)])
    st = core.set_state(perms)
    np.testing.assert_array_equal(core.perm_vector(st).numpy(), perms)
    assert st.success.tolist() == [bool((p == np.arange(n)).all())
                                   for p in perms]


def test_entry_points_need_cuda_or_cpu():
    n, gs, kind, _ = _artifact_env("lf_5_line")
    if torch.cuda.is_available():
        MatrixEnvCore(n, gs, kind)  # the default device is the card
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MatrixEnvCore(n, gs, kind)
    dense = MatrixEnvCore(n, gs, kind, bitpack=False, device="cpu")
    assert not dense.bitpack and dense.device.type == "cpu"


def test_op_table_width_and_noop_row():
    _, tc = _cores("clifford_heavy_hex_27q", False)
    cols = fs.table_columns(tc.W)
    assert tc.op_tab.shape == (tc.num_actions + 1, cols["F"])
    noop = tc.op_tab[tc.noop_action]
    assert noop[cols["U"]:cols["ucol"]].abs().sum() == 0
    assert (noop[cols["ucol"]:cols["slm"]] == -1).all()
