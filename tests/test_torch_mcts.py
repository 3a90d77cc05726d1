"""The port's batched MCTS (`rl/mcts.py`) against the JAX package, on the CPU.

Small sizes: 4 qubits on a line (permutation and Clifford cores, with the
inversion coin-flips) and the Pauli-network core on a 3-qubit line (two
automorphisms), B = 12 lanes, 12 or 16 simulations, a seeded random policy.
The JAX side draws from its own key: the same splits are repeated here
(`jax_search_draws`) and handed to the port as `root_gamma`/`flips`/`perms`.

What must hold: visit counts identical on every lane (they are integers; a
silent tolerance would hide a tree that parted ways), the argmax of the root
priors identical, root value and priors within 1e-5 (float32 matmuls and
softmax of two libraries)."""

import jax
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.envs import CliffordGym as JaxCliffordGym
from qiskit_gym_tpu.envs import PermutationGym as JaxPermutationGym
from qiskit_gym_tpu.envs.synthesis import PauliGym as JaxPauliGym
from qiskit_gym_tpu.models.policies import make_policy as jax_make_policy
from qiskit_gym_tpu.rl.mcts import mcts_search as jax_mcts_search
from qiskit_gym_torch.envs import CliffordGym, PauliGym, PermutationGym
from qiskit_gym_torch.models import make_policy, params_from_jax
from qiskit_gym_torch.ops.matrix_env import state_from_arrays
from qiskit_gym_torch.rl import mcts_search
from qiskit_gym_torch.rl.mcts import (Tree, _gather_node, _scatter_node,
                                      _tile_node_axis)

LINE_4 = [(0, 1), (1, 2), (2, 3)]
LINE_3 = [(0, 1), (1, 0), (1, 2), (2, 1)]
POLICY_CFG = dict(embedding_size=32, common_layers=[16])
ALPHA = 0.3
TOL = dict(atol=1e-5, rtol=1e-5)


def gym_pair(kind, **kw):
    """The JAX gym and the port's gym (on the CPU) of one small env."""
    if kind == "pauli":
        kw = dict(dict(max_depth=24, max_rotations=3), **kw)
        return (JaxPauliGym.from_coupling_map(LINE_3, **kw),
                PauliGym.from_coupling_map(LINE_3, device="cpu", **kw))
    jcls, tcls = {"permutation": (JaxPermutationGym, PermutationGym),
                  "clifford": (JaxCliffordGym, CliffordGym)}[kind]
    kw = dict(dict(max_depth=16), **kw)
    return (jcls.from_coupling_map(LINE_4, **kw),
            tcls.from_coupling_map(LINE_4, device="cpu", **kw))


def policy_pair(jenv, seed=3):
    """One set of seeded random weights in a JAX policy and in the port's:
    (jax bundle, its params, the port's bundle in eval mode)."""
    shape, A = tuple(jenv.obs_shape()), jenv.num_actions()
    jpol = jax_make_policy("BasicPolicy", shape, A, POLICY_CFG)
    tpol = make_policy("BasicPolicy", shape, A, POLICY_CFG)
    params = jax.tree.map(np.asarray, jpol.init(jax.random.key(seed)))
    tpol.module.load_state_dict(params_from_jax(params))
    return jpol, params, tpol.eval()


def as_port(state, tcore):
    """A JAX env state as the port's state of `tcore`'s kind, on the CPU."""
    fields = {f: np.asarray(getattr(state, f)) for f in state._fields}
    cls = type(tcore._fresh(1))
    return state_from_arrays(fields, device="cpu", cls=cls)


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def jax_step_draw(jcore, key, B):
    """What `core.step(state, action, key)` of the JAX package draws from
    `key`: the inversion coin-flip of a matrix core, the next automorphism
    of the Pauli core. Returns (flip, perm), one of them None."""
    if hasattr(jcore, "translate_action"):
        k_perm, _ = jax.random.split(key)
        return None, np.asarray(
            jax.random.randint(k_perm, (B,), 0, jcore.num_perms))
    return np.asarray(jax.random.bernoulli(key, 0.5, (B,))), None


def jax_search_draws(jcore, key, num_sims, E, B):
    """The draws `mcts_search(..., key, ...)` of the JAX package makes, by
    the same splits: root gammas [B, A] and, per simulation and rollout
    step, the draw of the env step (flips bool or perms int32 [S, E, B])."""
    key, noise_key = jax.random.split(key)
    gamma = np.asarray(jax.random.gamma(noise_key, ALPHA,
                                        (B, jcore.num_actions)))
    sim_keys = jax.random.split(key, num_sims)
    flips = np.zeros((num_sims, E, B), bool)
    perms = np.zeros((num_sims, E, B), np.int32)
    for s in range(num_sims):
        for d in range(E):
            k = sim_keys[s] if d == 0 else jax.random.fold_in(sim_keys[s], d)
            f, p = jax_step_draw(jcore, k, B)
            if p is None:
                flips[s, d] = f
            else:
                perms[s, d] = p
    with_perms = hasattr(jcore, "translate_action")
    return gamma, flips, (perms if with_perms else None)


def search_draw_kwargs(jcore, key, num_sims, E, B):
    gamma, flips, perms = jax_search_draws(jcore, key, num_sims, E, B)
    return dict(root_gamma=t(gamma), flips=t(flips),
                perms=None if perms is None else t(perms))


CASES = [
    ("permutation", 0.0, 1), ("permutation", 0.25, 3),
    ("clifford", 0.25, 1), ("clifford", 0.0, 3),
    ("pauli", 0.0, 1), ("pauli", 0.25, 3),
]


@pytest.mark.parametrize("kind,noise_eps,expand", CASES)
def test_search_matches_jax_on_every_lane(kind, noise_eps, expand):
    jenv, tenv = gym_pair(kind)
    jpol, params, tpol = policy_pair(jenv)
    B, S, depth = 12, 16 if kind != "pauli" else 12, 8
    jstate = jenv.core.reset(jax.random.key(1), B, 3)
    key = jax.random.key(7)
    jv, jroot, jpri = jax.jit(lambda s, k: jax_mcts_search(
        jenv.core, jpol.apply, params, s, k, num_sims=S, c_puct=1.41,
        max_depth=depth, dirichlet_alpha=ALPHA, noise_eps=noise_eps,
        max_expand_depth=expand))(jstate, key)
    tv, troot, tpri = mcts_search(
        tenv.core, tpol, as_port(jstate, tenv.core), S, 1.41, depth,
        dirichlet_alpha=ALPHA, noise_eps=noise_eps, max_expand_depth=expand,
        **search_draw_kwargs(jenv.core, key, S, expand, B))
    jv = np.asarray(jv)
    # integers: identical or wrong
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert (jv.sum(-1) == S).all()
    np.testing.assert_array_equal(tpri.argmax(-1).numpy(),
                                  np.asarray(jpri).argmax(-1))
    np.testing.assert_allclose(troot.numpy(), np.asarray(jroot), **TOL)
    np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), **TOL)


def test_search_without_inverts_matches_jax():
    """`add_inverts=False`: no draw at all reaches the env step."""
    jenv, tenv = gym_pair("permutation", add_inverts=False)
    jpol, params, tpol = policy_pair(jenv, seed=5)
    B, S = 8, 24
    jstate = jenv.core.reset(jax.random.key(2), B, 4)
    jv, jroot, _ = jax.jit(lambda s, k: jax_mcts_search(
        jenv.core, jpol.apply, params, s, k, num_sims=S, c_puct=1.41,
        max_depth=8))(jstate, jax.random.key(0))
    tv, troot, _ = mcts_search(tenv.core, tpol, as_port(jstate, tenv.core),
                               S, 1.41, 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(troot.numpy(), np.asarray(jroot), **TOL)


def _one_swap_away(tenv):
    # patterns one SWAP(0,1) (action 0) away from the identity, and two away
    return tenv.core.set_state(np.stack([
        tenv.encoded_to_dense(tenv.get_state(p))
        for p in ([1, 0, 2, 3], [1, 0, 3, 2])]))


def test_search_prefers_the_solving_action():
    """From a state one swap from solved, the visits concentrate on that
    swap even with an untrained policy, and the root value is positive."""
    _, tenv = gym_pair("permutation", add_inverts=False)
    tpol = make_policy("BasicPolicy", tuple(tenv.obs_shape()),
                       tenv.num_actions(), POLICY_CFG).eval()
    g = torch.Generator().manual_seed(0)
    tpol.module.reset_parameters(g)
    visits, value, priors = mcts_search(tenv.core, tpol, _one_swap_away(tenv),
                                        64, 1.41, 8, generator=g)
    assert int(visits[0].argmax()) == 0, visits[0]
    assert float(value[0]) > 0.3
    assert (visits.sum(-1) == 64).all()
    np.testing.assert_allclose(priors.sum(-1).numpy(), 1.0, atol=1e-6)


def test_search_from_a_solved_root_attaches_nothing():
    _, tenv = gym_pair("clifford")
    tpol = make_policy("BasicPolicy", tuple(tenv.obs_shape()),
                       tenv.num_actions(), POLICY_CFG).eval()
    g = torch.Generator().manual_seed(1)
    state = tenv.core.reset(4, 0, generator=g)      # identity: solved
    assert bool(state.success.all())
    visits, value, _ = mcts_search(tenv.core, tpol, state, 6, 1.41, 4,
                                   generator=g)
    assert (visits.sum(-1) == 6).all()
    # every simulation stops at the terminal root: nothing backed up
    assert (value == 0).all()


@pytest.mark.parametrize("kind", ["clifford", "pauli"])
def test_search_draws_from_the_generator_are_reproducible(kind):
    _, tenv = gym_pair(kind)
    tpol = make_policy("BasicPolicy", tuple(tenv.obs_shape()),
                       tenv.num_actions(), POLICY_CFG).eval()
    tpol.module.reset_parameters(torch.Generator().manual_seed(2))
    state = tenv.core.reset(6, 3, generator=torch.Generator().manual_seed(3))

    def run(seed):
        return mcts_search(tenv.core, tpol, state, 10, 1.41, 8,
                           noise_eps=0.25, max_expand_depth=2,
                           generator=torch.Generator().manual_seed(seed))

    a, b, c = run(4), run(4), run(5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[2], c[2])       # other root noise
    live = ~tenv.core.is_final(state)
    masks = tenv.core.masks(state)
    assert (a[0][live].sum(-1) == 10).all()
    assert float((a[0] * ~masks)[live].sum()) == 0.0   # none on a masked one


def test_node_pool_gather_and_scatter():
    _, tenv = gym_pair("pauli")
    core = tenv.core
    g = torch.Generator().manual_seed(6)
    root = core.reset(3, 2, generator=g)
    other = core.reset(3, 3, generator=g)
    pool = _tile_node_axis(root, 4)
    _scatter_node(pool, 2, other)
    tree = Tree(pool, torch.zeros(3, 4, dtype=torch.bool),
                torch.zeros(3, 4, 5, core.num_actions))
    base = torch.arange(3) * 4
    slots = torch.tensor([0, 2, 2])
    got = _gather_node(tree.states, base + slots)
    for f, x, r, o in zip(root._fields, got, root, other):
        assert x.dtype == r.dtype and x.shape == r.shape, f
        assert torch.equal(x[0], r[0]) and torch.equal(x[1:], o[1:]), f
