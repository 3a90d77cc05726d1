"""Rollout collection and GAE, PPO and AlphaZero training, batched MCTS,
solve, and the synthesis front end."""

from .configs import (
    EvalConfig,
    PPOConfig,
    AlphaZeroConfig,
    BasicPolicyConfig,
    Conv1dPolicyConfig,
    ALGORITHMS,
    POLICIES,
)
from .az import AZ, collect_mcts, collect_mcts_packed, mcts_solve
from .mcts import mcts_search
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
    "AZ",
    "mcts_search",
    "mcts_solve",
    "collect_mcts",
    "collect_mcts_packed",
    "RLSynthesis",
    "gate_list_to_circuit",
]
