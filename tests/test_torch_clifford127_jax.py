"""The port's Clifford env on IBM's 127-qubit Eagle map against the JAX
package's, on the CPU.

Both packages' `CliffordGym.from_coupling_map` build the env from the same
`eagle_127q()` edges: at the sub-maps of qubits 0-32 (the first two rows
and their bridges, dim 66) and 0-36 (the training test's sub-map, dim 74),
both W = 3 words a column, and at the whole map (dim 254, W = 8). The
gateset, the widths and the symmetry copies must be equal; the core's
reset, dense observation, apply and steps bit for bit, as
`test_torch_wide_matrix.py` holds them on lines (inputs made with numpy
seeds and injected on both sides).

The JAX package searches the coupling graph's automorphisms by plain
backtracking: 0.2 s at 33 qubits, a minute at 37, no end at 127. So at 33
qubits it searches them itself, and at 37 and 127 its spec is given the
automorphisms written out here (the identity; at 127 also q -> 126 - q,
which `test_torch_clifford127.py` holds the port's search to) and builds
its symmetry copies from them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.envs import CliffordGym as JaxCliffordGym
from qiskit_gym_tpu.spec import symmetry as jax_symmetry
from qiskit_gym_torch.envs import CliffordGym
from qiskit_gym_torch.envs.coupling_maps import eagle_127q
from qiskit_gym_torch.ops.matrix_env import unpack_rows

from test_torch_wide_matrix import assert_same, scrambled

BASIS = ("H", "S", "Sdg", "SX", "SXdg", "CX", "CZ", "SWAP")
# qubits of the sub-map -> (words a column of the packed state, the map's
# automorphisms given to the JAX spec, or None where it searches them)
MAPS = {33: (3, None),
        37: (3, [list(range(37))]),
        127: (8, [list(range(127)), list(range(126, -1, -1))])}


@pytest.fixture(scope="module", params=list(MAPS), ids=lambda n: f"{n}q")
def gyms(request):
    n = request.param
    edges = [e for e in eagle_127q() if max(e) < n]
    autos = MAPS[n][1]
    with pytest.MonkeyPatch.context() as mp:
        if autos is not None:
            mp.setattr(jax_symmetry, "coupling_automorphisms",
                       lambda num_qubits, gateset: autos)
        jg = JaxCliffordGym.from_coupling_map(edges, basis_gates=BASIS)
    return (n, edges, jg,
            CliffordGym.from_coupling_map(edges, basis_gates=BASIS,
                                          device="cpu"))


def test_the_same_env(gyms):
    n, edges, jg, tg = gyms
    assert [(g, tuple(q)) for g, q in tg.gateset] == [
        (g, tuple(q)) for g, q in jg.gateset]
    assert tg.obs_shape() == jg.obs_shape() == [2 * n, 2 * n]
    assert tg.num_actions() == jg.num_actions() == 5 * n + 3 * len(edges)
    assert tg.twists() == jg.twists()
    assert len(tg.twists()[0]) == 1
    assert tg.core.W == MAPS[n][0]
    assert tg.core.track_layers == jg.core.track_layers


def test_reset_dense_and_apply_match_jax(gyms):
    n, _, jg, tg = gyms
    jc, tc = jg.core, tg.core
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


def test_steps_bit_identical_to_jax(gyms):
    """set_state from scrambled matrices, then 6 steps with numpy-made
    actions (a no-op on one lane each step) and flips."""
    n, _, jg, tg = gyms
    jc, tc = jg.core, tg.core
    B = 8
    rng = np.random.default_rng(n + 1)
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
                   invert_override=jnp.asarray(flip))
        ts = tc.step(ts, torch.as_tensor(act),
                     invert_override=torch.as_tensor(flip))
        assert_same(js, ts, t)
