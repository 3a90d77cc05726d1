"""Batched policy-guided solve: N independent rollouts from one target state,
best successful solution wins.

Port of the JAX package's `rl/solve.py`: set_state -> num_searches parallel
episodes on the device -> pick the best success, "best" being fewest 2q
gates, then fewest gates, then shortest, ranked by the env's own metric
counters. The winning lane's trace becomes a solution through the gym's
solution_from_trace hook.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .rollout import collect, solve_temperatures


def best_lane(final_state, traj) -> Optional[int]:
    success = final_state.success.cpu().numpy()
    if not success.any():
        return None
    n_cnots = final_state.n_cnots.cpu().numpy()
    n_gates = final_state.n_gates.cpu().numpy()
    lengths = traj.valid.sum(dim=0).cpu().numpy()
    candidates = np.flatnonzero(success)
    return int(sorted(
        candidates, key=lambda s: (n_cnots[s], n_gates[s], lengths[s])
    )[0])


def policy_solve(
    env,
    policy,
    state_encoded,
    deterministic: bool = False,
    num_searches: int = 100,
    generator: Optional[torch.Generator] = None,
) -> Optional[List[int]]:
    """Best-of-`num_searches` policy rollouts of `core.max_depth` steps from
    the encoded target; the winning lane's action list, or None."""
    core = env.core
    state = env.make_solve_state(state_encoded, num_searches)
    if generator is None:
        generator = torch.Generator(device=core.device)
        generator.manual_seed(int(np.random.randint(0, 2**31 - 1)))
    # temperature-ladder portfolio: lane 0 greedy, half ramp, half classic
    # temperature-1.0 sampling; best_lane keeps the best success
    lane_temp = (None if deterministic
                 else solve_temperatures(num_searches, core.device))
    final_state, traj = collect(core, policy, state, core.max_depth,
                                deterministic=deterministic,
                                lane_temp=lane_temp, generator=generator)
    best = best_lane(final_state, traj)
    if best is None:
        return None
    valid = traj.valid[:, best].cpu().numpy()
    actions = traj.actual[:, best].cpu().numpy()[valid]
    inverted = traj.inverted[:, best].cpu().numpy()[valid]
    return env.solution_from_trace(state_encoded, actions.tolist(),
                                   inverted.tolist())
