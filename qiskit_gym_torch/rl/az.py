"""AlphaZero: batched MCTS self-play + policy/value fitting, on the env's
device.

Port of the JAX package's `rl/az.py`. Per decision, `num_mcts_searches`
simulations run through the batched array-MCTS (rl/mcts.py); the played
action is sampled from the root visit counts during collection and argmax'd
for deterministic eval/solve. Training targets are the normalized root
visits (policy) and the undiscounted reward-to-go (value), fitted with
CE + MSE for num_epochs. The evals, the curriculum, logging, checkpoints and
`solve` are `Algorithm`'s (rl/algorithm.py), shared with PPO.

The JAX `lax.scan` over moves is a Python loop; every draw of a collector
is made up front from one `torch.Generator` on the device, or injected (the
tests hand both packages the same noise): per move the search's draws
(`root_gamma` [T, B, A], `sim_flips`/`sim_perms` [T, num_sims,
max_expand_depth, B]), the Gumbel noise behind the sampled action (`gumbel`
[T, B, A]) and the draw of the played env step (`flips`/`perms` [T, B]).
With `mesh=` every draw is made (or injected) for the global lanes and each
process keeps its block, as in rl/rollout.py.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .algorithm import Algorithm
from .mcts import mcts_search
from qiskit_gym_torch.ops.lanes import (draw_step_noise, env_step,
                                        select_lanes)
from qiskit_gym_torch.parallel.mesh import (dp_size, gather_env_state,
                                            gather_lanes, psum,
                                            shard_env_state, shard_lanes)

from .rollout import (draw_gumbel, make_packed_pool, packed_refill,
                      sample_difficulties, solve_temperatures)
from .solve import best_lane, round_up_lanes

Tensor = torch.Tensor

# the tree-depth cap of a search: every extra level is a sequential pass of
# the descent in every simulation
SEARCH_DEPTH_CAP = 32


class AZTrajectory(NamedTuple):
    obs: Tensor          # [T, B, *obs_shape] uint8
    visit_probs: Tensor  # [T, B, A]
    action: Tensor       # [T, B] policy-frame action that was played
    actual: Tensor       # [T, B] env-frame action (after symmetry
    #                      un-permutation; == action for the matrix envs)
    inverted: Tensor     # [T, B] env inversion flag when acting
    reward: Tensor       # [T, B]
    valid: Tensor        # [T, B]
    done: Tensor         # [T, B] bool: episode ended at/after this step
    success: Tensor      # [B]


def trajectory_from_arrays(fields, device=None) -> AZTrajectory:
    """An `AZTrajectory` from numpy arrays keyed by field name, as
    `np.asarray` of each leaf of a JAX `AZTrajectory` gives them."""
    return AZTrajectory(**{
        f: torch.from_numpy(np.array(fields[f])).to(device=device)
        for f in AZTrajectory._fields})


class _Draws(NamedTuple):
    """The draws of a T-move MCTS rollout, one row per move."""
    root_gamma: Optional[Tensor]   # [T, B, A]; None without root noise
    sim_flips: Tensor              # bool [T, S, E, B]
    sim_perms: Optional[Tensor]    # int32 [T, S, E, B]; Pauli core only
    gumbel: Tensor                 # [T, B, A]
    flips: Tensor                  # bool [T, B]
    perms: Optional[Tensor]        # int32 [T, B]; Pauli core only


def _draws(core, generator, T: int, B: int, num_sims: int, E: int,
           noise_eps: float, dirichlet_alpha: float, deterministic: bool,
           root_gamma, sim_flips, sim_perms, gumbel, flips, perms,
           mesh=None) -> _Draws:
    """The injected draws, and from `generator` what was not injected, for
    B global lanes; with a mesh, this process's block of them."""
    dev = core.device
    A = core.num_actions
    with_perms = hasattr(core, "translate_action")
    if noise_eps > 0.0 and root_gamma is None:
        root_gamma = torch._standard_gamma(
            torch.full((T, B, A), float(dirichlet_alpha), device=dev),
            generator=generator)
    if sim_flips is None or (with_perms and sim_perms is None):
        f, p = draw_step_noise(core, generator, (T, num_sims, E, B))
        sim_flips = f if sim_flips is None else sim_flips
        sim_perms = p if sim_perms is None else sim_perms
    if gumbel is None:
        gumbel = draw_gumbel(core, generator, (T, B, A), deterministic)
    if flips is None or (with_perms and perms is None):
        f, p = draw_step_noise(core, generator, (T, B))
        flips = f if flips is None else flips
        perms = p if perms is None else perms

    def on_dev(x, axis, dtype=None):
        if x is None:
            return None
        x = shard_lanes(mesh, x, axis)
        return x.to(device=dev, dtype=dtype)

    return _Draws(on_dev(root_gamma, 1), on_dev(sim_flips, 3, torch.bool),
                  on_dev(sim_perms, 3, torch.int32), on_dev(gumbel, 1),
                  on_dev(flips, 1, torch.bool), on_dev(perms, 1, torch.int32))


def _mcts_act(core, policy, env_state, draws: _Draws, t: int, moves,
              num_sims, c_puct, deterministic, temperature, temperature_drop,
              noise_eps, dirichlet_alpha, max_expand_depth, search_depth,
              lane_temp=None):
    """Shared per-move prologue of the MCTS collectors and the solve:
    observe -> batched MCTS -> visit-count action selection -> env step,
    with row `t` of `draws`. `moves` (an int, or int [B]) is the number of
    moves played in the lane's episode, which gates `temperature_drop`.
    Returns what an AZTrajectory row needs plus the raw stepped state."""
    obs = core.dense(env_state)
    row = [None if d is None else d[t] for d in draws]
    root_gamma, sim_flips, sim_perms, g, flip, perm = row
    visits, _, _ = mcts_search(
        core, policy, env_state, num_sims=num_sims, c_puct=c_puct,
        max_depth=search_depth, dirichlet_alpha=dirichlet_alpha,
        noise_eps=noise_eps, max_expand_depth=max_expand_depth,
        root_gamma=root_gamma, flips=sim_flips, perms=sim_perms)
    probs = visits / torch.clamp(visits.sum(-1, keepdim=True), min=1e-8)
    greedy = torch.argmax(visits, dim=-1)
    if deterministic:
        action = greedy
    elif lane_temp is not None:
        # per-lane temperature portfolio (rl/rollout.solve_temperatures):
        # argmax(log v + t*g) samples softmax(log v / t); t == 0 is argmax
        logits = torch.log(torch.clamp(visits, min=1e-8))
        action = torch.argmax(logits + lane_temp[:, None] * g, dim=-1)
    else:
        logits = torch.log(torch.clamp(visits, min=1e-8)) / temperature
        action = torch.argmax(logits + g, dim=-1)
        if temperature_drop > 0:
            dropped = moves >= temperature_drop
            action = (torch.where(dropped, greedy, action)
                      if isinstance(dropped, Tensor)
                      else greedy if dropped else action)

    live = ~core.is_final(env_state)
    # env-frame action: the Pauli env observes under a random automorphism
    # and un-permutes incoming actions through it; the executed gate is
    # translate_action(action)
    actual = (action if perm is None
              else core.translate_action(env_state, action))
    stepped = env_step(core, env_state, action, flip, perm, actual)
    return obs, probs, action, actual, live, env_state.inverted, stepped


class _Rows:
    """The [T, B] buffers of an AZTrajectory, written one move at a time."""

    def __init__(self, core, T: int, B: int, dev):
        def rows(dtype, shape=()):
            return torch.empty((T, B) + tuple(shape), dtype=dtype, device=dev)

        self.obs = rows(torch.uint8, core.obs_shape)
        self.visit_probs = rows(torch.float32, (core.num_actions,))
        self.action = rows(torch.int64)
        self.actual = rows(torch.int64)
        self.inverted = rows(torch.bool)
        self.reward = rows(torch.float32)
        self.valid = rows(torch.bool)
        self.done = rows(torch.bool)

    def write(self, t, obs, visit_probs, action, actual, inverted, reward,
              valid, done):
        for buf, x in zip(self._buffers(), (obs, visit_probs, action, actual,
                                            inverted, reward, valid, done)):
            buf[t] = x

    def _buffers(self):
        return (self.obs, self.visit_probs, self.action, self.actual,
                self.inverted, self.reward, self.valid, self.done)

    def trajectory(self, success: Tensor) -> AZTrajectory:
        return AZTrajectory(*self._buffers(), success=success)


def _search_depth(T: int, search_depth: Optional[int]) -> int:
    return min(T, SEARCH_DEPTH_CAP) if search_depth is None else search_depth


@torch.no_grad()
def collect_mcts(core, policy, state, T: int, num_sims: int, c_puct: float,
                 deterministic: bool = False, temperature: float = 1.0,
                 temperature_drop: int = 0, noise_eps: float = 0.0,
                 dirichlet_alpha: float = 0.3, max_expand_depth: int = 1,
                 search_depth: Optional[int] = None,
                 lane_temp: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 root_gamma=None, sim_flips=None, sim_perms=None,
                 gumbel=None, flips=None, perms=None, mesh=None):
    """T moves from `state`, each chosen by a `num_sims`-simulation search;
    lanes that finish are frozen. Returns (final_state, AZTrajectory).

    `noise_eps`/`dirichlet_alpha` add AlphaZero root exploration noise per
    move; `temperature_drop > 0` switches from visit-sampling to argmax
    after that many moves; both are self-play-only knobs (leave the defaults
    for eval). `lane_temp` [B] gives each lane its own visit-sampling
    temperature (0 = argmax), the solve portfolio. `search_depth` overrides
    the tree-depth cap min(T, 32). With `mesh`, `state` and `lane_temp` are
    this process's block of the lanes and the draws those of all lanes."""
    B = state.depth.shape[0]
    dev = state.depth.device
    draws = _draws(core, generator, T, B * dp_size(mesh), num_sims,
                   max_expand_depth, noise_eps, dirichlet_alpha,
                   deterministic, root_gamma, sim_flips, sim_perms, gumbel,
                   flips, perms, mesh)
    depth = _search_depth(T, search_depth)
    rows = _Rows(core, T, B, dev)
    for t in range(T):
        obs, probs, action, actual, live, inverted, stepped = _mcts_act(
            core, policy, state, draws, t, t, num_sims, c_puct,
            deterministic, temperature, temperature_drop, noise_eps,
            dirichlet_alpha, max_expand_depth, depth, lane_temp)
        state = select_lanes(live, stepped, state)
        rows.write(t, obs, probs, action, actual, inverted,
                   torch.where(live, state.reward, 0.0), live,
                   core.is_final(state))
    return state, rows.trajectory(state.success)


@torch.no_grad()
def collect_mcts_packed(core, policy, T: int, B: int, difficulty,
                        num_sims: int, c_puct: float, pool_slots: int = 8,
                        deterministic: bool = False,
                        temperature: float = 1.0, temperature_drop: int = 0,
                        noise_eps: float = 0.0, dirichlet_alpha: float = 0.3,
                        max_expand_depth: int = 1, diff_replay: int = 0,
                        generator: Optional[torch.Generator] = None,
                        root_gamma=None, sim_flips=None, sim_perms=None,
                        gumbel=None, flips=None, perms=None,
                        slots: Optional[Tensor] = None,
                        rots: Optional[Tensor] = None, pool=None,
                        offsets: Optional[Tensor] = None, mesh=None):
    """Episode-packed MCTS self-play: lanes that finish are refilled at once
    from a pool of pregenerated reset batches, so every move runs a useful
    search (the aligned collect_mcts freezes finished lanes for the rest of
    the horizon, and each wasted step there costs a whole search). Pool
    slots and rotations are drawn as in rollout.collect_packed; `slots`,
    `rots` [T], `pool` and `offsets` inject them. `temperature_drop` counts
    the moves of a lane's own episode (the counter is reset on refill), not
    the loop index. Returns (final_state, AZTrajectory, stats) with the
    episode counters and last_value for bootstrapping the value targets.
    CAVEAT: the returned traj.success describes whichever pooled episode
    occupies each lane at the horizon; use the stats counters for success
    rates under packing. With `mesh`, B is the global lane count and what
    comes back is this process's block."""
    dev = core.device
    if pool is None:
        pool, state = make_packed_pool(core, B, pool_slots, difficulty,
                                       diff_replay=diff_replay,
                                       generator=generator, offsets=offsets,
                                       mesh=mesh)
    else:
        pool = shard_env_state(mesh, pool, batch_axis=1)
        state = type(pool)(*(x[0] for x in pool))
    draws = _draws(core, generator, T, B, num_sims, max_expand_depth,
                   noise_eps, dirichlet_alpha, deterministic, root_gamma,
                   sim_flips, sim_perms, gumbel, flips, perms, mesh)
    if slots is None:
        slots = torch.randint(0, pool_slots, (T,), generator=generator,
                              device=dev)
    if rots is None:
        rots = torch.randint(0, B, (T,), generator=generator, device=dev)
    slots, rots = slots.tolist(), rots.tolist()

    B = state.depth.shape[0]  # this process's lanes
    depth = _search_depth(T, None)
    rows = _Rows(core, T, B, dev)
    n_done = torch.zeros(B, dtype=torch.int32, device=dev)
    n_succ = torch.zeros(B, dtype=torch.int32, device=dev)
    moves = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(T):
        obs, probs, action, actual, live, inverted, stepped = _mcts_act(
            core, policy, state, draws, t, moves, num_sims, c_puct,
            deterministic, temperature, temperature_drop, noise_eps,
            dirichlet_alpha, max_expand_depth, depth)
        done = live & core.is_final(stepped)
        n_done += done.to(torch.int32)
        n_succ += (done & stepped.success).to(torch.int32)
        refresh = done | ~live
        state = packed_refill(pool, stepped, refresh, slots[t], rots[t],
                              mesh)
        moves = torch.where(refresh, 0, moves + 1)
        rows.write(t, obs, probs, action, actual, inverted,
                   torch.where(live, stepped.reward, 0.0), live, done)
    _, last_value = policy(core.dense(state))
    stats = {
        "episodes_completed": n_done,
        "episodes_succeeded": n_succ,
        "last_value": last_value,
    }
    return state, rows.trajectory(state.success), stats


def reward_to_go(traj: AZTrajectory,
                 last_value: Optional[Tensor] = None) -> Tensor:
    """Undiscounted reward-to-go [T, B], the value target: aware of episode
    boundaries (packed rollouts interleave episodes in a lane), zero on
    invalid rows, and bootstrapped with the critic's `last_value` where the
    packed collector truncates an episode at the horizon."""
    g = (torch.zeros_like(traj.reward[0]) if last_value is None
         else last_value)
    nonterm = 1.0 - traj.done.to(torch.float32)
    returns = torch.empty_like(traj.reward)
    for t in reversed(range(traj.reward.shape[0])):
        g = torch.where(traj.valid[t], traj.reward[t] + g * nonterm[t], 0.0)
        returns[t] = g
    return returns


class AZ(Algorithm):
    def _ce_mse(self, logits, value, visit_probs, valid, returns):
        """Cross-entropy to the visit distribution + squared error to the
        returns over any batch shape, masked by `valid`."""
        valid = valid.to(torch.float32)
        count = self._count(valid)
        logp = torch.log_softmax(logits, dim=-1)
        pol_loss = -((visit_probs * logp).sum(-1) * valid).sum() / count
        v_loss = (((value - returns) ** 2) * valid).sum() / count
        loss = pol_loss + v_loss
        return loss, {"loss": loss, "pg_loss": pol_loss, "v_loss": v_loss}

    def _loss(self, traj: AZTrajectory, returns):
        """CE + MSE over a whole [T, B] trajectory."""
        T, B = traj.reward.shape
        obs = traj.obs.reshape((T * B,) + traj.obs.shape[2:])
        logits, value = self.policy(obs)
        return self._ce_mse(logits.reshape(T, B, -1), value.reshape(T, B),
                            traj.visit_probs, traj.valid, returns)

    def _loss_flat(self, batch: Dict[str, Tensor]):
        """The same loss over a flat minibatch dict (obs, visit_probs,
        valid, ret), for the num_minibatches > 1 path."""
        logits, value = self.policy(batch["obs"])
        return self._ce_mse(logits, value, batch["visit_probs"],
                            batch["valid"], batch["ret"])

    def train_step(self, T: int, B: int, difficulty: int
                   ) -> Dict[str, float]:
        """T x B moves of MCTS self-play at `difficulty`, then num_epochs of
        fitting. Returns the losses of the last epoch and the collection
        statistics."""
        cfg = self.config
        mesh = self.mesh
        self.policy.eval()
        search = dict(
            num_sims=cfg.num_mcts_searches, c_puct=cfg.C,
            temperature=cfg.temperature,
            temperature_drop=cfg.temperature_drop,
            noise_eps=cfg.root_noise_eps,
            dirichlet_alpha=cfg.dirichlet_alpha,
            max_expand_depth=cfg.max_expand_depth, generator=self.generator,
            mesh=mesh)
        if cfg.episode_packing:
            final_state, traj, stats = collect_mcts_packed(
                self.core, self.policy, T, B, difficulty,
                pool_slots=cfg.pack_pool_slots, diff_replay=cfg.diff_replay,
                **search)
            returns = reward_to_go(traj, stats["last_value"])
        else:
            d_lanes = sample_difficulties(B, difficulty, cfg.diff_replay,
                                          generator=self.generator,
                                          device=self.device)
            state = self.core.reset(B, d_lanes, generator=self.generator)
            state = shard_env_state(mesh, state)
            final_state, traj = collect_mcts(self.core, self.policy, state,
                                             T, **search)
            stats = None
            returns = reward_to_go(traj)

        N = traj.action.numel()  # this process's T x B rows
        flat = {
            "obs": traj.obs.reshape((N,) + traj.obs.shape[2:]),
            "visit_probs": traj.visit_probs.reshape(N, -1),
            "valid": traj.valid.reshape(N),
            "ret": returns.reshape(N),
        }
        metrics = dict(self._fit(flat, B, self._loss, traj, returns))
        if stats is not None:
            completed = psum(mesh, stats["episodes_completed"].sum())
            metrics["success_rate"] = (
                psum(mesh, stats["episodes_succeeded"].sum())
                / torch.clamp(completed, min=1))
            metrics["episodes_completed"] = completed
        else:
            metrics["success_rate"] = psum(
                mesh, final_state.success.float().sum()) / B
        metrics["steps_collected"] = psum(mesh, traj.valid.sum())
        return {k: float(v) for k, v in metrics.items()}


@torch.no_grad()
def mcts_solve(env, policy, state_encoded, num_searches: int,
               num_mcts_searches: int, C: float, deterministic: bool = False,
               generator: Optional[torch.Generator] = None,
               max_expand_depth: int = 1, mesh=None) -> Optional[List[int]]:
    """Batched solve by tree search: `num_searches` lanes from the encoded
    target, every move of every lane chosen by a `num_mcts_searches`-
    simulation search, up to `core.max_depth` moves, stopping as soon as
    every lane is final.

    Shares the env hooks with rl/solve.policy_solve: the target is tiled
    through env.make_solve_state and the winning lane's ENV-FRAME actions
    (what the env executed after symmetry un-permutation) go through
    env.solution_from_trace (inversion bookkeeping for the matrix envs;
    packed rotation events through a spec replay for Pauli). Lanes play a
    temperature ladder (rl/rollout.solve_temperatures: lane 0 argmax of the
    visits, half a ramp, half classic sampling) and best_lane keeps the best
    success. Only the played actions, their valid flags and the inversion
    flags come to the host. With `mesh` the lanes (rounded up to a multiple
    of 'dp', rl/solve.round_up_lanes) are split over the processes, and
    every process returns the same solution."""
    core = env.core
    num_searches = round_up_lanes(num_searches, mesh)
    state = env.make_solve_state(state_encoded, num_searches)
    B = state.depth.shape[0]  # all lanes
    if generator is None:
        generator = torch.Generator(device=core.device)
        generator.manual_seed(int(np.random.randint(0, 2**31 - 1)))
    T = core.max_depth
    lane_temp = (None if deterministic
                 else solve_temperatures(num_searches, core.device))
    state = shard_env_state(mesh, state)
    if lane_temp is not None:
        lane_temp = shard_lanes(mesh, lane_temp)
    trace = []
    for _ in range(T):
        draws = _draws(core, generator, 1, B, num_mcts_searches,
                       max_expand_depth, 0.0, 0.3, deterministic,
                       None, None, None, None, None, None, mesh)
        _, _, _, actual, live, inverted, stepped = _mcts_act(
            core, policy, state, draws, 0, 0, num_mcts_searches, C,
            deterministic, 1.0, 0, 0.0, 0.3, max_expand_depth,
            _search_depth(T, None), lane_temp)
        state = select_lanes(live, stepped, state)
        trace.append(torch.stack([actual, live.to(torch.int64),
                                  inverted.to(torch.int64)]))
        if int(psum(mesh, (~core.is_final(state)).sum())) == 0:
            break
    trace = torch.stack(trace, dim=1)
    trace = gather_lanes(mesh, trace, axis=2)
    state = gather_env_state(mesh, state)
    actual, valid, inverted = trace.cpu().unbind(0)
    valid = valid.bool()
    best = best_lane(state, SimpleNamespace(valid=valid))
    if best is None:
        return None
    keep = valid[:, best]
    return env.solution_from_trace(
        state_encoded, actual[:, best][keep].tolist(),
        inverted[:, best][keep].bool().tolist())
