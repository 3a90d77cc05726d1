"""PPO: the algorithm object that holds env, policy, weights and config.

Port of the solve half of the JAX package's `rl/ppo.py`. `solve` runs the
policy path (`rl/solve.py:policy_solve`). Training (`learn`, GAE, the
optimizer, curriculum and evals) is not ported yet (ROADMAP A5), nor is
MCTS solving (ROADMAP A7).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from qiskit_gym_torch.models.policies import PolicyBundle

from .configs import PPOConfig
from .solve import policy_solve


class PPO:
    def __init__(self, env, policy: PolicyBundle, config: PPOConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0):
        self.env = env                      # user-facing gym (has .core)
        self.core = env.core
        self.device = self.core.device
        self.config = config
        self.seed = int(seed)
        if params is not None:
            policy.module.load_state_dict(params, strict=True)
        else:  # drawn on the CPU, so every device starts from the same net
            g = torch.Generator()
            g.manual_seed(self.seed + 1)
            policy.module.to("cpu").reset_parameters(g)
        self.policy = policy.to(self.device).eval()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The policy net's state dict (reference `.pt` key names)."""
        return self.policy.module.state_dict()

    def learn(self, num_iterations: int = int(1e10)) -> None:
        raise NotImplementedError(
            "PPO training is not ported yet (ROADMAP A5: PPO.learn, gae, "
            "collect_packed)")

    def solve(
        self,
        state,
        deterministic: bool = False,
        num_searches: int = 100,
        num_mcts_searches: int = 0,
        C: float = 2 ** 0.5,
        max_expand_depth: int = 1,
    ):
        """Policy-guided search from an encoded target state; returns the
        best solution's action list, or None."""
        if num_mcts_searches > 0:
            raise NotImplementedError(
                "MCTS solving (num_mcts_searches > 0) is not ported yet "
                "(ROADMAP A7)")
        return policy_solve(self.env, self.policy, state,
                            deterministic=deterministic,
                            num_searches=num_searches,
                            generator=self.generator)
