"""Gymnasium adapters: a single-env view for interactive use and a
vectorized view over the batched core on the device.

Port of the JAX package's `envs/adapters.py`. `GymnasiumEnv` wraps a gym's
numpy spec env in the standard Gymnasium interface (MultiBinary observation
/ Discrete action, 5-tuple step), including the assert on stepping a final
env and attribute forwarding; where gymnasium is not installed it still
offers `action_space` and `observation_space`, as small host stand-ins for
`Discrete` and `MultiBinary`, so that the tour notebook's cells run there
too. `VectorGymnasiumEnv` steps `num_envs` environments of the gym's core
at once on the core's device (the gym was built for CUDA unless
`device="cpu"` was passed to it) and hands numpy arrays back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qiskit_gym_torch.ops.lanes import (draw_step_noise, env_step,
                                        select_lanes)

try:
    import gymnasium as gym
    from gymnasium import spaces

    _GYM_BASE = gym.Env
except Exception:  # pragma: no cover - gymnasium is optional
    gym = None
    spaces = None
    _GYM_BASE = object


class _HostSpace:
    """What the single-env view needs of a gymnasium space where gymnasium
    is not installed: `n`, `shape`, `seed`, `sample` (the draws gymnasium
    makes from the same seed) and the repr."""

    def __init__(self, n, shape):
        self.n, self.shape = n, shape
        self._rng = np.random.default_rng()

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)
        return [seed]

    def __repr__(self):
        return f"{type(self).__name__.lstrip('_')}({self.n})"


class _Discrete(_HostSpace):
    def __init__(self, n: int):
        super().__init__(int(n), ())

    def sample(self):
        return np.int64(self._rng.integers(self.n))


class _MultiBinary(_HostSpace):
    def __init__(self, shape):
        super().__init__(shape, tuple(shape))

    def sample(self):
        return self._rng.integers(0, 2, self.shape, dtype=np.int8)


class GymnasiumEnv(_GYM_BASE):
    """Gymnasium view over a synthesis gym (or a bare spec env)."""

    metadata = {"render_modes": ["human"], "render_fps": 4}

    def __init__(self, env):
        # `env` is a BaseSynthesisEnv (has .spec) or a spec env directly
        self._synth_env = env
        self._spec_env = getattr(env, "spec", env)
        self._obs_shape = tuple(self._spec_env.obs_shape())
        if spaces is not None:
            self.observation_space = spaces.MultiBinary(self._obs_shape)
            self.action_space = spaces.Discrete(self._spec_env.num_actions())
        else:
            self.observation_space = _MultiBinary(self._obs_shape)
            self.action_space = _Discrete(self._spec_env.num_actions())

    def _full_obs(self) -> np.ndarray:
        full = np.zeros(int(np.prod(self._obs_shape)), dtype=np.int8)
        full[self._spec_env.observe()] = 1
        return full.reshape(self._obs_shape)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            if gym is not None:
                super().reset(seed=seed)
            # reproducibility must not depend on gymnasium being importable
            self._spec_env.rng = np.random.default_rng(seed)
        self._spec_env.reset()
        return self._full_obs(), {}

    def step(self, action):
        assert not bool(self._spec_env.is_final()), (
            "Action provided when env is in final state."
        )
        self._spec_env.step(int(action))
        return (
            self._full_obs(),
            float(self._spec_env.reward()),
            bool(self._spec_env.is_final()),
            False,
            {},
        )

    def render(self):
        print(self._spec_env.get_state()
              if hasattr(self._spec_env, "get_state") else self._full_obs())

    def close(self):
        pass

    @property
    def difficulty(self):
        return self._spec_env.get_difficulty()

    @difficulty.setter
    def difficulty(self, value):
        target = self._synth_env
        if hasattr(target, "difficulty"):
            target.difficulty = value
        else:
            self._spec_env.set_difficulty(value)

    def __getattr__(self, name):
        return getattr(self._spec_env, name)

    def to_json(self):
        if hasattr(self._synth_env, "to_json"):
            return self._synth_env.to_json()
        return {}


def gym_adapter(env) -> GymnasiumEnv:
    """Wrap a synthesis gym (or spec env) as a Gymnasium env."""
    return GymnasiumEnv(env)


class VectorGymnasiumEnv:
    """Vectorized Gymnasium view over the batched core on the device.

    Unlike `GymnasiumEnv` (one host-side numpy spec env per instance), this
    exposes the core the training stack runs on: `num_envs` environments
    live on the core's device and step in one batched env step. The API
    follows `gymnasium.vector` conventions with same-step autoreset: when an
    episode ends (terminated = solved, truncated = depth budget exhausted)
    the lane is reset within the same `step()` call and the fresh
    observation is returned, while the closing observation is available as
    `infos["final_observation"]`. Observations, rewards and flags come back
    as numpy arrays on the host, whatever the device.
    """

    def __init__(self, env, num_envs: int = 256,
                 difficulty: Optional[int] = None, seed: int = 0):
        self._synth_env = env
        self.core = env.core
        self.num_envs = int(num_envs)
        # inherit the wrapped env's curriculum difficulty unless overridden
        # (matching the single-env adapter; a silent default of 1 would run
        # vector evaluation on a trivially easy distribution)
        if difficulty is None:
            difficulty = int(getattr(env, "difficulty", 1))
        self.difficulty = int(difficulty)
        self._generator = torch.Generator(device=self.core.device)
        self._generator.manual_seed(int(seed))
        self._state = None
        self._obs_shape = tuple(int(d) for d in self.core.obs_shape)
        if spaces is not None:
            self.single_observation_space = spaces.MultiBinary(self._obs_shape)
            self.single_action_space = spaces.Discrete(self.core.num_actions)
            # batched views for gymnasium.vector drop-in compatibility
            self.observation_space = spaces.MultiBinary(
                (self.num_envs,) + self._obs_shape)
            self.action_space = spaces.MultiDiscrete(
                [self.core.num_actions] * self.num_envs)

    def _obs(self, state) -> np.ndarray:
        return self.core.dense(state).to(torch.int8).cpu().numpy()

    def _reset_state(self):
        return self.core.reset(self.num_envs, self.difficulty,
                               generator=self._generator)

    def reset(self, *, seed=None, options=None, state=None):
        """Reset every lane. `state` injects the reset state."""
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state = self._reset_state() if state is None else state
        return self._obs(self._state), {}

    @torch.no_grad()
    def step(self, actions, *, flips=None, perms=None, fresh=None):
        """Step every lane with `actions` [num_envs]. `flips`/`perms`
        [num_envs] inject the step's draw (the inversion coin-flip of a
        matrix core, the next automorphism of the Pauli core) and `fresh`
        the reset state that finished lanes take."""
        assert self._state is not None, "call reset() before step()"
        core, dev = self.core, self.core.device
        actions = torch.as_tensor(np.asarray(actions), dtype=torch.int64,
                                  device=dev)
        f_draw, p_draw = draw_step_noise(core, self._generator,
                                         (self.num_envs,))
        flips = f_draw if flips is None else torch.as_tensor(flips,
                                                             device=dev)
        if p_draw is not None and perms is not None:
            p_draw = torch.as_tensor(perms, device=dev)
        stepped = env_step(core, self._state, actions, flips, p_draw)
        terminated = stepped.success
        truncated = (stepped.depth == 0) & ~terminated
        done = terminated | truncated
        if fresh is None:
            fresh = self._reset_state()
        self._state = select_lanes(done, fresh, stepped)
        infos = {}
        done = done.cpu().numpy()
        if done.any():
            infos["final_observation"] = self._obs(stepped)
            infos["_final_observation"] = done
        return (self._obs(self._state), stepped.reward.cpu().numpy(),
                terminated.cpu().numpy(), truncated.cpu().numpy(), infos)

    def masks(self) -> np.ndarray:
        """bool [num_envs, A] action masks for the current state."""
        assert self._state is not None, "call reset() before masks()"
        return self.core.masks(self._state).cpu().numpy()

    def close(self):
        pass


def vector_gym_adapter(env, num_envs: int = 256, **kw) -> VectorGymnasiumEnv:
    """Wrap a synthesis gym as a batched vector env on the gym's device."""
    return VectorGymnasiumEnv(env, num_envs=num_envs, **kw)
