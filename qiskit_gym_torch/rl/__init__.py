"""Rollout collection and GAE, PPO and AlphaZero training, batched MCTS,
solve, demonstrations and behavior cloning, and the synthesis front end."""

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
from .demos import fit_demos, generate_demos, plan_episode

__all__ = [
    "fit_demos",
    "generate_demos",
    "plan_episode",
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
