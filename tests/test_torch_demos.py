"""The port's demonstration bootstrap (`rl/demos.py`) against the JAX package,
on the CPU.

The planning half is numpy on the spec twins: from the same seeded
`env.rng` both packages must record the same corpus byte for byte (every
draw of the scramble replica, the rotations and the augmentation
automorphisms in the same order). `fit_demos` is held against the JAX
package's with the JAX permutation injected: params within 1e-5 abs / 1e-4
rel, losses within 1e-5 (float32 matmuls summed in another order). Sizes
are those of the JAX package's `tests/test_demos.py`."""

import jax
import numpy as np
import pytest
import torch

import qiskit_gym_tpu.rl.demos as jax_demos
from qiskit_gym_tpu.envs import CliffordGym as JaxCliffordGym
from qiskit_gym_tpu.envs import PauliGym as JaxPauliGym
from qiskit_gym_tpu.envs import PermutationGym as JaxPermutationGym
from qiskit_gym_tpu.rl import AlphaZeroConfig as JaxAZConfig
from qiskit_gym_tpu.rl import BasicPolicyConfig as JaxPolicyConfig
from qiskit_gym_tpu.rl import RLSynthesis as JaxRLSynthesis
from qiskit_gym_torch.envs import CliffordGym, PauliGym, PermutationGym
from qiskit_gym_torch.models import params_from_jax
from qiskit_gym_torch.rl import (AlphaZeroConfig, BasicPolicyConfig,
                                 RLSynthesis, fit_demos, generate_demos,
                                 plan_episode)
from qiskit_gym_torch.rl.demos import (generate_demos_matrix,
                                       plan_episode_matrix, prepare_demos,
                                       shortest_path_tables, unpack_rows)

LINE_5 = [(i, i + 1) for i in range(4)]
HEAVY_HEX_27 = [
    (0, 1), (1, 2), (1, 4), (2, 3), (3, 5), (4, 7), (5, 8), (6, 7), (7, 10),
    (8, 9), (8, 11), (10, 12), (11, 14), (12, 13), (12, 15), (13, 14),
    (14, 16), (15, 18), (16, 19), (17, 18), (18, 21), (19, 20), (19, 22),
    (21, 23), (22, 25), (23, 24), (24, 25), (25, 26),
]
GRID_2x3 = [(0, 1), (1, 2), (0, 3), (1, 4), (2, 5), (3, 4), (4, 5)]
LINE_KW = dict(basis_gates=("H", "S", "Sdg", "CX"), max_rotations=4,
               pauli_diff_scale=4, depth_slope=4)
FULL_27_KW = dict(max_rotations=5, pauli_diff_scale=4, depth_slope=4,
                  pauli_layer_reward=0.05)


def _both(edges):
    return list(edges) + [(b, a) for a, b in edges]


def _spec_pair(gym_cls_pair, edges, **kw):
    jax_cls, port_cls = gym_cls_pair
    return (jax_cls.from_coupling_map(_both(edges), **kw).spec,
            port_cls.from_coupling_map(_both(edges), device="cpu",
                                       **kw).spec)


PAULI = (JaxPauliGym, PauliGym)


@pytest.fixture(scope="module")
def line_pair():
    return _spec_pair(PAULI, LINE_5, **LINE_KW)


@pytest.fixture(scope="module")
def full_27_pair():
    return _spec_pair(PAULI, HEAVY_HEX_27, **FULL_27_KW)


def _assert_corpora_equal(want, got):
    assert set(got) == set(want)
    for k in want:
        w, g = want[k], got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert g == w, k


# ------------------------------------------------------------- numpy half
@pytest.mark.parametrize("edges,n", [(LINE_5, 5), (HEAVY_HEX_27, 27)],
                         ids=["line5", "heavy_hex_27"])
def test_shortest_path_tables_match_jax(edges, n):
    want = jax_demos.shortest_path_tables(n, edges)
    got = shortest_path_tables(n, edges)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("which", ["line5", "full27"])
@pytest.mark.parametrize("difficulty", [2, 3, 4])
def test_plan_episode_matches_jax(line_pair, full_27_pair, which,
                                  difficulty):
    jenv, tenv = line_pair if which == "line5" else full_27_pair
    jenv.rng = np.random.default_rng(difficulty)
    tenv.rng = np.random.default_rng(difficulty)
    for _ in range(4):
        want = jax_demos.plan_episode(jenv, difficulty)
        got = plan_episode(tenv, difficulty)
        assert got == want
        assert np.array_equal(tenv.network.data, jenv.network.data)
        for a in got or []:
            tenv.step(a)
        assert got is None or tenv.success


@pytest.mark.parametrize("augment", [True, False])
def test_generate_demos_matches_jax(line_pair, augment):
    jenv, tenv = line_pair
    jenv.rng = np.random.default_rng(3)
    tenv.rng = np.random.default_rng(3)
    want = jax_demos.generate_demos(jenv, [2, 5], 8, augment=augment)
    got = generate_demos(tenv, [2, 5], 8, augment=augment)
    _assert_corpora_equal(want, got)
    assert got["episodes"] == 16


@pytest.mark.parametrize("kind", ["permutation", "clifford"])
def test_generate_demos_matrix_matches_jax(kind):
    if kind == "permutation":
        jenv, tenv = _spec_pair((JaxPermutationGym, PermutationGym),
                                GRID_2x3)
    else:
        jenv, tenv = _spec_pair((JaxCliffordGym, CliffordGym), LINE_5[:2],
                                basis_gates=("H", "S", "CX"))
    jenv.rng = np.random.default_rng(1)
    tenv.rng = np.random.default_rng(1)
    assert (plan_episode_matrix(tenv, 6)
            == jax_demos.plan_episode_matrix(jenv, 6))
    want = jax_demos.generate_demos_matrix(jenv, [2, 6], 10)
    got = generate_demos_matrix(tenv, [2, 6], 10)
    _assert_corpora_equal(want, got)
    assert got["episodes"] == 20


def test_unpack_rows_inverts_packbits():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (5, 37)).astype(np.uint8)
    packed = torch.from_numpy(np.packbits(bits, axis=1))
    assert np.array_equal(unpack_rows(packed, 37).numpy(), bits)


# -------------------------------------------------------------- BC fitting
def _rls_pair(embedding=32, layers=(16,), seed=0, lr=1e-3):
    """A JAX and a port AZ on the 5q Pauli line, with the JAX weights."""
    cfg = dict(num_episodes=8, num_mcts_searches=4, lr=lr)
    pol = dict(embedding_size=embedding, common_layers=list(layers))
    jrls = JaxRLSynthesis(
        JaxPauliGym.from_coupling_map(_both(LINE_5), **LINE_KW),
        JaxAZConfig(**cfg), JaxPolicyConfig(**pol), seed=seed)
    trls = RLSynthesis(
        PauliGym.from_coupling_map(_both(LINE_5), device="cpu", **LINE_KW),
        AlphaZeroConfig(**cfg), BasicPolicyConfig(**pol), seed=seed)
    trls.algorithm.policy.module.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jrls.algorithm.params)))
    return jrls, trls


def _assert_params_close(jalgo, talgo):
    want = params_from_jax(jax.tree.map(np.asarray, jalgo.params))
    for name, p in talgo.policy.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("epochs,minibatches", [(1, 4), (2, 3)])
def test_fit_demos_matches_jax_with_its_permutation(epochs, minibatches):
    jrls, trls = _rls_pair()
    spec = trls.env.spec
    spec.rng = np.random.default_rng(7)
    demos = generate_demos(spec, [2, 4], 10)
    N = demos["action"].shape[0]
    key = jax.random.key(5)
    ekeys = jax.random.split(key, epochs)
    perm = np.stack([np.asarray(jax.random.permutation(k, N))
                     for k in ekeys])
    # two calls: the second starts from a carried (non-fresh) Adam state
    for _ in range(2):
        jaux = jax_demos.fit_demos(jrls.algorithm, demos, epochs=epochs,
                                   num_minibatches=minibatches, key=key)
        taux = fit_demos(trls.algorithm, demos, epochs=epochs,
                         num_minibatches=minibatches,
                         perm=torch.from_numpy(perm))
        assert set(taux) == set(jaux)
        for k in ("loss", "pg_loss", "v_loss"):
            assert abs(taux[k] - jaux[k]) <= 1e-5, (k, taux[k], jaux[k])
        assert taux["demo_steps"] == jaux["demo_steps"] == N
        _assert_params_close(jrls.algorithm, trls.algorithm)


def test_prepare_demos_packs_on_the_device_once():
    _, trls = _rls_pair()
    spec = trls.env.spec
    spec.rng = np.random.default_rng(2)
    demos = generate_demos(spec, [2], 6)
    prep = prepare_demos(trls.algorithm, demos)
    assert prep["obs_packed"].dtype == torch.uint8
    assert prep["action"].dtype == torch.int64
    assert prep["ret"].dtype == torch.float32
    assert np.array_equal(prep["obs_packed"].numpy(), demos["obs_packed"])
    out = fit_demos(trls.algorithm, prep, epochs=1, num_minibatches=2)
    assert np.isfinite(out["loss"])


def test_fit_demos_takes_a_swapped_optimizer():
    """A zero-lr Adam swapped in between calls must leave the weights
    bit-identical: the step goes through the optimizer of the call."""
    _, trls = _rls_pair()
    algo = trls.algorithm
    spec = trls.env.spec
    spec.rng = np.random.default_rng(7)
    demos = generate_demos(spec, [2], 10)
    before = {k: v.clone() for k, v in algo.params.items()}
    fit_demos(algo, demos, epochs=1, num_minibatches=4)
    moved = {k: v.clone() for k, v in algo.params.items()}
    assert any(not torch.equal(before[k], moved[k]) for k in before)
    algo.optimizer = torch.optim.Adam(algo.policy.parameters(), lr=0.0)
    fit_demos(algo, demos, epochs=1, num_minibatches=4)
    assert all(torch.equal(moved[k], v) for k, v in algo.params.items())


def test_bc_lifts_argmax_eval_on_scrambled_frontier():
    """The port's counterpart of the JAX package's BC-uplift test, at its
    sizes: cloning planner demos must lift the argmax eval on env-scrambled
    episodes at a frontier difficulty the fresh policy cannot solve."""
    trls = RLSynthesis(
        PauliGym.from_coupling_map(_both(LINE_5), device="cpu", **LINE_KW),
        AlphaZeroConfig(num_episodes=8, num_mcts_searches=4, lr=1e-3),
        BasicPolicyConfig(embedding_size=128, common_layers=[64]), seed=5)
    algo = trls.algorithm
    trls.env.spec.rng = np.random.default_rng(42)
    demos = generate_demos(trls.env.spec, list(range(2, 9)), 60)
    frontier = 6
    ev = algo.config.evals["ppo_deterministic"]  # the gate the test reads

    def argmax_eval():
        algo.policy.eval()
        return algo._eval(algo._horizon(frontier), ev, frontier)

    eval0 = argmax_eval()
    prepared = prepare_demos(algo, demos)
    for _ in range(12):
        fit_demos(algo, prepared, epochs=2, num_minibatches=16)
    eval1 = argmax_eval()
    assert eval1 >= max(eval0 + 0.25, 0.3), (eval0, eval1)


def test_fit_demos_clones_the_labels():
    """The port's counterpart of the JAX package's label-cloning test, from
    the same initial weights (the JAX package's seed-0 init)."""
    _, trls = _rls_pair(embedding=64, layers=(32,))
    algo = trls.algorithm
    trls.env.spec.rng = np.random.default_rng(11)
    demos = generate_demos(trls.env.spec, [2, 4], 40)
    obs = torch.from_numpy(
        np.unpackbits(demos["obs_packed"], axis=1)[:, :demos["obs_bits"]])
    obs = obs.reshape((-1,) + tuple(algo.core.obs_shape))
    labels = torch.from_numpy(demos["action"]).long()

    def accuracy():
        with torch.no_grad():
            logits, _ = algo.policy(obs)
        return float((logits.argmax(-1) == labels).float().mean())

    acc0 = accuracy()
    prepared = prepare_demos(algo, demos)
    losses = []
    for _ in range(6):
        m = fit_demos(algo, prepared, epochs=2, num_minibatches=8)
        losses.append(m["loss"])
    acc1 = accuracy()
    assert m["demo_steps"] == demos["action"].shape[0]
    assert losses[-1] < losses[0]
    assert acc1 > max(5 * acc0, 0.15), (acc0, acc1)
