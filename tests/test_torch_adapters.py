"""The port's Gymnasium adapters (`envs/adapters.py`) against the JAX
package's, on the CPU.

The single-env adapter wraps the numpy spec env, whose draws come from a
numpy generator: the same seed gives the same episode in both packages. The
vector adapter steps the batched core; the JAX one draws each step's
coin-flip (or automorphism) and the reset of finished lanes from its key:
the same splits are repeated here and injected into the port's `step`.
Everything compared is integer or a reward made of exact terms: equal, no
tolerance."""

import jax
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.envs import adapters as jax_adapters
from qiskit_gym_torch.envs import (GymnasiumEnv, VectorGymnasiumEnv,
                                   gym_adapter, vector_gym_adapter)

from test_torch_mcts import as_port, gym_pair, jax_step_draw


@pytest.mark.parametrize("kind", ["permutation", "clifford", "pauli"])
def test_single_env_episode_matches_jax(kind):
    jgym, tgym = gym_pair(kind)
    jenv, tenv = jax_adapters.gym_adapter(jgym), gym_adapter(tgym)
    assert isinstance(tenv, GymnasiumEnv)
    assert tenv.observation_space == jenv.observation_space
    assert tenv.action_space == jenv.action_space
    jenv.difficulty = tenv.difficulty = 3
    assert tenv.difficulty == jenv.difficulty == 3
    rng = np.random.default_rng(0)
    for seed in (1, 2):
        jobs, _ = jenv.reset(seed=seed)
        tobs, info = tenv.reset(seed=seed)
        assert info == {} and tobs.dtype == np.int8
        np.testing.assert_array_equal(tobs, jobs)
        for _ in range(12):
            action = int(rng.integers(tenv.action_space.n))
            want = jenv.step(action)
            got = tenv.step(action)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
            if got[2]:
                with pytest.raises(AssertionError, match="final state"):
                    tenv.step(action)
                break
    # attribute forwarding to the spec env, and the gym's JSON
    assert tenv.num_actions() == jenv.num_actions()
    assert tenv.to_json() == jenv.to_json()


@pytest.mark.parametrize("kind", ["clifford", "pauli"])
def test_vector_env_trace_with_injected_draws_matches_jax(kind):
    jgym, tgym = gym_pair(kind)
    B, difficulty = 12, 2
    jenv = jax_adapters.vector_gym_adapter(jgym, num_envs=B,
                                           difficulty=difficulty, seed=3)
    tenv = vector_gym_adapter(tgym, num_envs=B, difficulty=difficulty,
                              seed=3)
    assert isinstance(tenv, VectorGymnasiumEnv)
    assert tenv.observation_space == jenv.observation_space
    assert tenv.single_action_space == jenv.single_action_space
    jobs, _ = jenv.reset()
    tobs, _ = tenv.reset(state=as_port(jenv._state, tgym.core))
    assert tobs.dtype == np.int8 and isinstance(tobs, np.ndarray)
    np.testing.assert_array_equal(tobs, jobs)
    rng = np.random.default_rng(1)
    finished = 0
    for _ in range(8):
        np.testing.assert_array_equal(tenv.masks(), jenv.masks())
        actions = rng.integers(0, tgym.num_actions(), B)
        # the JAX adapter's own splits for this step
        _, sub = jax.random.split(jenv._key)
        k_step, k_reset = jax.random.split(sub)
        flips, perms = jax_step_draw(jgym.core, k_step, B)
        fresh = as_port(jgym.core.reset(k_reset, B, difficulty), tgym.core)
        want = jenv.step(actions)
        got = tenv.step(actions, flips=flips, perms=perms, fresh=fresh)
        for g, w in zip(got[:4], want[:4]):
            assert isinstance(g, np.ndarray) and g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)
        assert set(got[4]) == set(want[4])
        for k in want[4]:
            np.testing.assert_array_equal(got[4][k], want[4][k])
        finished += int((got[2] | got[3]).sum())
    assert finished > 0   # lanes ended and were reset within the step


def test_vector_env_draws_its_own_noise_and_resets_finished_lanes():
    _, tgym = gym_pair("permutation")
    tgym.difficulty = 2
    env = VectorGymnasiumEnv(tgym, num_envs=16, seed=5)
    assert env.difficulty == 2          # inherited from the gym
    with pytest.raises(AssertionError, match="reset"):
        env.step(np.zeros(16, np.int64))
    a, _ = env.reset(seed=7)
    b, _ = env.reset(seed=7)
    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    ended = 0
    for _ in range(10):
        obs, reward, terminated, truncated, infos = env.step(
            rng.integers(0, tgym.num_actions(), 16))
        done = terminated | truncated
        assert obs.shape == (16,) + tuple(tgym.obs_shape())
        assert reward.dtype == np.float32 and not (terminated
                                                   & truncated).any()
        if done.any():
            np.testing.assert_array_equal(infos["_final_observation"], done)
            # a finished lane shows its fresh reset, not its closing state
            assert infos["final_observation"].shape == obs.shape
            ended += int(done.sum())
        else:
            assert infos == {}
    assert ended > 0
    # the state lives on the gym's device; the arrays are on the host
    assert env._state.depth.device == tgym.core.device


def test_vector_env_default_device_is_cuda():
    from qiskit_gym_torch.envs import PermutationGym

    line = [(0, 1), (1, 2)]
    if torch.cuda.is_available():
        env = vector_gym_adapter(PermutationGym.from_coupling_map(line), 4)
        assert env.core.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vector_gym_adapter(PermutationGym.from_coupling_map(line), 4)
