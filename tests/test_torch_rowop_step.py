"""Kernel B3's plain PyTorch version (`fused_step_apply_plain`) on the CPU:
against the JAX package's Pallas kernel in interpret mode and against the
dense `apply_gates` + swap + solved of both packages, bit for bit.

The kernel applies term 2 to the result of term 1, the dense `apply_gates`
reads both source rows from the original matrix; the gate tables make the
two agree, and these tests hold that for the three families."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.ops.matrix_env import MatrixEnvCore as JaxCore
from qiskit_gym_tpu.ops.pallas_step import build_rowop_tables as jax_tables
from qiskit_gym_tpu.ops.pallas_step import fused_step_apply as jax_apply
from qiskit_gym_torch.ops.matrix_env import MatrixEnvCore
from qiskit_gym_torch.ops.rowop_step import (TABLE_NAMES, build_rowop_tables,
                                             fused_step_apply,
                                             fused_step_apply_plain,
                                             rowop_table)

GATESETS = {
    "clifford": lambda n, edges: (
        [(g, (q,)) for g in ("H", "S", "Sdg", "SX", "SXdg")
         for q in range(n)]
        + [(g, e) for g in ("CX", "CZ", "SWAP") for e in edges]),
    "linear": lambda n, edges: [(g, e) for g in ("CX", "SWAP")
                                for e in edges],
    "permutation": lambda n, edges: [("SWAP", e) for e in edges],
}
SHAPES = [("clifford", 4), ("linear", 4), ("permutation", 4),
          ("clifford", 5), ("linear", 5)]   # D = 8, 8, 8, 16, 8 (dim 5 pads)


def _cores(kind, n):
    edges = [(i, i + 1) for i in range(n - 1)]
    gs = GATESETS[kind](n, edges)
    jc = JaxCore(n, gs, kind, bitpack=False)
    tc = MatrixEnvCore(n, gs, kind, bitpack=False, device="cpu")
    return jc, tc


@pytest.mark.parametrize("kind,n", SHAPES)
def test_rowop_tables_match_jax(kind, n):
    jc, tc = _cores(kind, n)
    want = jax_tables(jc)
    got = build_rowop_tables(tc)
    assert len(got) == len(TABLE_NAMES) == len(want)
    for name, g, w in zip(TABLE_NAMES, got, want):
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    tab = rowop_table(tc)
    assert tab.shape == (tc.num_actions + 1, 10) and tab.dtype == torch.int32
    # the trailing no-op action: both terms off, every index "no row"
    assert tab[-1].tolist() == [tc.D] * 4 + [0] + [tc.D] * 4 + [0]


@pytest.mark.parametrize("kind,n", SHAPES)
def test_plain_matches_jax_kernel_in_interpret_mode(kind, n):
    jc, tc = _cores(kind, n)
    B = 32
    rng = np.random.default_rng(3)
    scr = rng.integers(0, jc.num_actions, (B, 6))
    js = jc.reset(jax.random.key(0), B, 6,
                  scramble_override=jnp.asarray(scr, jnp.int32))
    ja, ji = js.a, js.ainv
    ta, ti = (torch.from_numpy(np.asarray(ja).copy()),
              torch.from_numpy(np.asarray(ji).copy()))
    for t in range(4):
        actions = rng.integers(0, jc.num_actions, B)
        flips = rng.random(B) < 0.5
        ja, ji, jsucc = jax_apply(jc, ja, ji, jnp.asarray(actions, jnp.int32),
                                  jnp.asarray(flips), block_b=8,
                                  interpret=True)
        ta, ti, tsucc = fused_step_apply(tc, ta, ti, torch.as_tensor(actions),
                                         torch.as_tensor(flips))
        assert ta.dtype == torch.int8 and tsucc.dtype == torch.bool
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy(), err_msg=t)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy(), err_msg=t)
        np.testing.assert_array_equal(np.asarray(jsucc), tsucc.numpy())


@pytest.mark.parametrize("kind,n", SHAPES)
def test_plain_matches_dense_apply_gates(kind, n):
    """Against the dense core's own apply_gates + swap + solved, no-op
    action and a ragged batch included."""
    _, tc = _cores(kind, n)
    B = 13
    rng = np.random.default_rng(4)
    st = tc.reset(B, 5, generator=torch.Generator().manual_seed(2))
    a, ainv = st.a, st.ainv
    for t in range(5):
        actions = torch.as_tensor(rng.integers(0, tc.num_actions + 1, B))
        actions[t] = tc.noop_action
        flips = torch.as_tensor(rng.random(B) < 0.5)
        na, ni = tc.apply_gates(a, ainv, actions)
        f3 = flips[:, None, None]
        want_a = torch.where(f3, ni, na)
        want_i = torch.where(f3, na, ni)
        want_s = (want_a == tc.ident[None]).flatten(1).all(1)
        got_a, got_i, got_s = fused_step_apply_plain(tc, a, ainv, actions,
                                                     flips)
        assert torch.equal(got_a, want_a), t
        assert torch.equal(got_i, want_i), t
        assert torch.equal(got_s, want_s), t
        a, ainv = got_a, got_i


def test_solved_flag_sees_the_identity():
    _, tc = _cores("linear", 5)
    st = tc.reset(6, 0)                      # identity, dim 5 padded to 8
    noop = torch.full((6,), tc.noop_action)
    _, _, succ = fused_step_apply(tc, st.a, st.ainv, noop,
                                  torch.zeros(6, dtype=torch.bool))
    assert succ.all()
    _, _, succ = fused_step_apply(tc, st.a, st.ainv, torch.zeros(6).long(),
                                  torch.zeros(6, dtype=torch.bool))
    assert not succ.any()


def test_wrapper_refuses_a_bitpacked_core():
    tc = MatrixEnvCore(4, GATESETS["linear"](4, [(0, 1)]), "linear",
                       device="cpu")
    st = tc.reset(2, 1, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="bitpack=False"):
        fused_step_apply(tc, st.a, st.ainv, torch.zeros(2).long(),
                         torch.zeros(2, dtype=torch.bool))


def test_plain_matches_jax_dense_step_past_the_shared_memory_limit():
    """The 172-qubit Clifford line (D = 344, the first D whose two int8
    tiles exceed a block's 227 KB, where the card takes the streaming
    kernel): the port's dense step through `fused_step_apply` equals the
    JAX package's dense `step` bit for bit over injected actions (no-op
    included) and flips."""
    import chip_smoke

    n, B = 172, 4
    tc = chip_smoke.dense_line_core(n, "cpu")
    jc = JaxCore(n, tc.gateset, "clifford", bitpack=False)
    assert tc.D == jc.D == 344 and 2 * tc.D ** 2 > 227 * 1024
    rng = np.random.default_rng(9)
    scr = rng.integers(0, jc.num_actions, (B, 12))
    js = jc.reset(jax.random.key(0), B, 12,
                  scramble_override=jnp.asarray(scr, jnp.int32))
    ta, ti = (torch.from_numpy(np.asarray(js.a).copy()),
              torch.from_numpy(np.asarray(js.ainv).copy()))
    for t in range(4):
        actions = rng.integers(0, jc.num_actions + 1, B)
        actions[t] = jc.num_actions                       # the no-op
        flips = rng.random(B) < 0.5
        js = jc.step(js, jnp.asarray(actions, jnp.int32), jax.random.key(t),
                     invert_override=jnp.asarray(flips))
        ta, ti, tsucc = fused_step_apply(tc, ta, ti, torch.as_tensor(actions),
                                         torch.as_tensor(flips))
        np.testing.assert_array_equal(np.asarray(js.a), ta.numpy(),
                                      err_msg=t)
        np.testing.assert_array_equal(np.asarray(js.ainv), ti.numpy(),
                                      err_msg=t)
        np.testing.assert_array_equal(np.asarray(js.success), tsucc.numpy())
