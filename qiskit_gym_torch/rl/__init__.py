"""Rollout collection and GAE, PPO training, solve, and the synthesis front
end."""

from .configs import (
    EvalConfig,
    PPOConfig,
    AlphaZeroConfig,
    BasicPolicyConfig,
    Conv1dPolicyConfig,
    ALGORITHMS,
    POLICIES,
)
from .ppo import PPO
from .synthesis import RLSynthesis, gate_list_to_circuit

__all__ = [
    "EvalConfig",
    "PPOConfig",
    "AlphaZeroConfig",
    "BasicPolicyConfig",
    "Conv1dPolicyConfig",
    "ALGORITHMS",
    "POLICIES",
    "PPO",
    "RLSynthesis",
    "gate_list_to_circuit",
]
