"""Batched rollout collection on the env's device, and GAE.

Port of the JAX package's `rl/rollout.py`. The aligned collector `collect`
starts every lane from an already-reset (or set) state and runs T
observe -> policy -> masked Gumbel-max sample -> env step steps; lanes that
finish are frozen (their rows are marked invalid). The episode-packed
collector `collect_packed` refills finished lanes from a pool of
pregenerated resets, so every step does useful work. The JAX `lax.scan`
becomes a Python loop over T with the batch written out; there is no host
round-trip inside the loop.

All randomness is drawn up front from one `torch.Generator` on the device
(the JAX package draws from threefry keys; the two give different numbers
from the same seed, so the tests hand both sides the same noise through the
`gumbel`/`flips`/`perms`/`slots`/`rots`/`pool`/`offsets` arguments).

A core with `translate_action` (the Pauli-network env) observes under a
random coupling-map automorphism: the collectors translate the policy-frame
action to the env frame once, record it as `Trajectory.actual`, and hand it
to `step` with the pregenerated automorphism draw for the next observation.

With `mesh=` (a DeviceMesh of parallel/mesh.py) each process steps its own
contiguous block of the lanes: it draws (or is handed) the global noise and
keeps its block, the packed pool holds its block of every slot, and a
refill gathers the chosen slot over 'dp' before the lane rotation, so the
union of the processes' lanes is the single-process rollout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from qiskit_gym_torch.ops.lanes import (draw_step_noise, env_step,
                                        select_lanes)
from qiskit_gym_torch.parallel.mesh import (dp_size, gather_env_state,
                                            shard_env_state, shard_lanes)
from qiskit_gym_torch.utils.profiling import span, spanned


class Trajectory(NamedTuple):
    obs: torch.Tensor       # [T, B, *obs_shape] uint8
    action: torch.Tensor    # [T, B] int64 (policy action space)
    actual: torch.Tensor    # [T, B] int64 env-frame action (== action for
    #                         the matrix envs)
    logp: torch.Tensor      # [T, B]
    value: torch.Tensor     # [T, B]
    reward: torch.Tensor    # [T, B]
    valid: torch.Tensor     # [T, B] bool: lane was live when this step ran
    done: torch.Tensor      # [T, B] bool: episode ended at/after this step
    inverted: torch.Tensor  # [T, B] bool: env inversion flag when acting
    success: torch.Tensor   # [B]  episode success per lane


def solve_temperatures(num_searches: int,
                       device=None) -> Optional[torch.Tensor]:
    """Best-of-N portfolio temperature ladder for the solve path.

    Lane 0 runs greedy (temperature 0 == argmax), the first half ramps
    linearly up to 1.0, and the rest sample at temperature 1.0. Sampling at
    temperature t is Gumbel-max with scaled noise: argmax(logits + t*g)
    draws from softmax(logits / t). Returns None for num_searches < 2."""
    if num_searches < 2:
        return None
    ramp = torch.arange(num_searches, dtype=torch.float32, device=device)
    return torch.clamp(ramp / max(num_searches // 2, 1), max=1.0)


def _gumbel(shape, device, generator: Optional[torch.Generator]
            ) -> torch.Tensor:
    """Standard Gumbel noise of `shape` on `device`: -log(E) for E ~ Exp(1)
    drawn from `generator`."""
    e = torch.empty(shape, device=device).exponential_(generator=generator)
    return -torch.log(e)


def draw_gumbel(core, generator: Optional[torch.Generator], shape,
                deterministic: bool = False) -> torch.Tensor:
    """Standard Gumbel noise of `shape` on the core's device (zeros if
    deterministic)."""
    if deterministic:
        return torch.zeros(shape, device=core.device)
    return _gumbel(shape, core.device, generator)


def sample_action(logits: torch.Tensor, masks: torch.Tensor,
                  deterministic: bool,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Masked categorical sample / argmax over [B, A] logits; masks bool
    [B, A]. The argmax keeps the first maximum (a row with every action
    masked gives 0); a sample is the Gumbel-max of the masked logits with
    `draw_gumbel`'s noise from `generator`, as the collectors draw."""
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(masks, logits, neg)
    if deterministic:
        return torch.argmax(masked, dim=-1)
    return torch.argmax(
        masked + _gumbel(masked.shape, logits.device, generator), dim=-1)


def _pregen_randomness(core, generator: Optional[torch.Generator], T: int,
                       B: int, deterministic: bool):
    """Bulk draws for a T-step rollout on the core's device: Gumbel noise
    [T, B, A] (zeros if deterministic) and the per-step draws of
    `draw_step_noise`, [T, B]."""
    return (draw_gumbel(core, generator, (T, B, core.num_actions),
                        deterministic),
            *draw_step_noise(core, generator, (T, B)))


def _sample_and_step(core, policy, state, g_t, flip_t, perm_t):
    """Shared per-step prologue of both collectors: observe -> policy ->
    Gumbel-max masked sample -> env step. Returns what a Trajectory row
    needs plus the raw stepped state."""
    with span("observe"):
        obs = core.dense(state)   # uint8 until the policy reads it
    with span("policy"):
        logits, value = policy(obs)
    masks = core.masks(state)
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(masks, logits, neg)
    action = torch.argmax(masked + g_t, dim=-1)
    logp_all = torch.log_softmax(masked, dim=-1)
    logp = logp_all.gather(1, action[:, None])[:, 0]

    live = ~core.is_final(state)
    inverted = state.inverted
    with span("env.step"):
        actual = (action if perm_t is None
                  else core.translate_action(state, action))
        stepped = env_step(core, state, action, flip_t, perm_t, actual)
    return obs, action, actual, logp, value, live, inverted, stepped


class _Rows:
    """The [T, B] buffers of a Trajectory, written one step at a time."""

    def __init__(self, core, T: int, B: int, dev):
        def rows(dtype, shape=()):
            return torch.empty((T, B) + tuple(shape), dtype=dtype, device=dev)

        self.obs = rows(torch.uint8, core.obs_shape)
        self.action = rows(torch.int64)
        # env-frame actions: a buffer of their own only where they can differ
        self.actual = (rows(torch.int64)
                       if hasattr(core, "translate_action") else self.action)
        self.logp = rows(torch.float32)
        self.value = rows(torch.float32)
        self.reward = rows(torch.float32)
        self.valid = rows(torch.bool)
        self.done = rows(torch.bool)
        self.inverted = rows(torch.bool)

    def write(self, t, obs, action, actual, logp, value, reward, valid, done,
              inverted):
        self.obs[t] = obs
        self.action[t] = action
        if self.actual is not self.action:
            self.actual[t] = actual
        self.logp[t] = logp
        self.value[t] = value
        self.reward[t] = reward
        self.valid[t] = valid
        self.done[t] = done
        self.inverted[t] = inverted

    def trajectory(self, success: torch.Tensor) -> Trajectory:
        return Trajectory(
            obs=self.obs, action=self.action, actual=self.actual,
            logp=self.logp, value=self.value, reward=self.reward,
            valid=self.valid, done=self.done, inverted=self.inverted,
            success=success)


def _noise(core, generator, T: int, B: int, deterministic: bool, gumbel,
           flips, perms, dev, mesh=None):
    """The injected `gumbel`/`flips`/`perms`, or draws from `generator`, for
    B global lanes; with a mesh, this process's block of them. `perms`
    comes back as a list of T rows (of None for a core without
    automorphisms)."""
    need_perms = perms is None and hasattr(core, "translate_action")
    if gumbel is None or flips is None or need_perms:
        g_draw, f_draw, p_draw = _pregen_randomness(core, generator, T, B,
                                                    deterministic)
        gumbel = g_draw if gumbel is None else gumbel
        flips = f_draw if flips is None else flips
        perms = p_draw if perms is None else perms
    gumbel = shard_lanes(mesh, gumbel, 1)
    flips = shard_lanes(mesh, flips, 1)
    perms = None if perms is None else shard_lanes(mesh, perms, 1)
    perms = ([None] * T if perms is None
             else list(perms.to(device=dev, dtype=torch.int32)))
    return gumbel.to(dev), flips.to(device=dev, dtype=torch.bool), perms


@spanned("collect")
def collect(core, policy, state, T: int, deterministic: bool = False,
            lane_temp: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            gumbel: Optional[torch.Tensor] = None,
            flips: Optional[torch.Tensor] = None,
            perms: Optional[torch.Tensor] = None, mesh=None):
    """Roll out T steps from `state`. Returns (final_state, Trajectory).

    `policy(obs) -> (logits, value)`. `lane_temp` [B] sets a per-lane
    sampling temperature (0 = argmax; see solve_temperatures), ignored when
    deterministic. `gumbel` [T, B, A], `flips` [T, B] and `perms` [T, B]
    (automorphism draws, Pauli core only) inject the noise; otherwise it is
    drawn from `generator`. With `mesh`, `state` and `lane_temp` are this
    process's block of the lanes and the noise is that of all lanes."""
    B = state.depth.shape[0]
    dev = state.depth.device
    gumbel, flips, perms = _noise(core, generator, T, B * dp_size(mesh),
                                  deterministic, gumbel, flips, perms, dev,
                                  mesh)
    if lane_temp is not None and not deterministic:
        gumbel = gumbel * lane_temp.to(dev)[None, :, None]
    rows = _Rows(core, T, B, dev)
    with torch.no_grad():
        for t in range(T):
            with span("rollout.step"):
                obs, action, actual, logp, value, live, inverted, \
                    stepped = _sample_and_step(core, policy, state, gumbel[t],
                                               flips[t], perms[t])
                state = select_lanes(live, stepped, state)
                rows.write(t, obs, action, actual, logp, value,
                           torch.where(live, state.reward, 0.0), live,
                           core.is_final(state), inverted)
    return state, rows.trajectory(state.success)


def sample_difficulties(count: int, difficulty, diff_replay: int,
                        generator: Optional[torch.Generator] = None,
                        offsets: Optional[torch.Tensor] = None,
                        device=None):
    """Per-lane curriculum-replay difficulties.

    With diff_replay == 0 the difficulty passes through untouched (every
    lane collects at the frontier). Otherwise the even lanes stay at the
    frontier and the odd ones draw uniformly from
    [max(1, difficulty - diff_replay), difficulty], which keeps dense
    learning signal in every batch while the frontier half keeps probing.
    The split is interleaved so that any contiguous sub-batch (each slot of
    the packed pool) keeps the same ratio. `offsets` (int [count], in
    [0, diff_replay]) injects the draw. Returns int32 [count]."""
    if diff_replay <= 0:
        return difficulty
    if offsets is None:
        offsets = torch.randint(0, int(diff_replay) + 1, (count,),
                                generator=generator, device=device)
    dev = offsets.device
    d = torch.as_tensor(difficulty, dtype=torch.int32, device=dev)
    lo = torch.clamp(d - int(diff_replay), min=1)
    mix = torch.maximum(d - offsets.to(torch.int32), lo)
    keep = (torch.arange(count, device=dev) % 2) == 0
    return torch.where(keep, d, mix)


def make_packed_pool(core, B: int, pool_slots: int, difficulty,
                     diff_replay: int = 0,
                     generator: Optional[torch.Generator] = None,
                     offsets: Optional[torch.Tensor] = None,
                     scramble_override: Optional[torch.Tensor] = None,
                     mesh=None):
    """Pregenerate `pool_slots` reset batches for packed collection: a
    state whose fields are [slots, B, ...], plus the slot-0 batch as the
    initial live state. `offsets` and `scramble_override` inject the
    difficulty-replay and scramble draws. With `mesh`, both hold this
    process's block of the B lanes (the pool split on axis 1)."""
    difficulty = sample_difficulties(B * pool_slots, difficulty, diff_replay,
                                     generator=generator, offsets=offsets,
                                     device=core.device)
    pool = core.reset(B * pool_slots, difficulty, generator=generator,
                      scramble_override=scramble_override)
    pool = type(pool)(*(x.reshape((pool_slots, B) + x.shape[1:])
                        for x in pool))
    pool = shard_env_state(mesh, pool, batch_axis=1)
    return pool, type(pool)(*(x[0] for x in pool))


def packed_refill(pool, stepped, refresh: torch.Tensor, slot_t: int,
                  rot_t: int, mesh=None):
    """Refill the `refresh` lanes of `stepped` from pool slot `slot_t` with
    its lanes rotated by `rot_t` (both Python ints; see collect_packed for
    why both draws must be random). With `mesh` the rotation runs over the
    global lanes: the slot is gathered over 'dp' first."""
    slot = type(stepped)(*(p[slot_t] for p in pool))
    slot = gather_env_state(mesh, slot)
    fresh = type(stepped)(*(torch.roll(x, rot_t, dims=0) for x in slot))
    fresh = shard_env_state(mesh, fresh)
    return select_lanes(refresh, fresh, stepped)


@spanned("collect_packed")
def collect_packed(core, policy, T: int, B: int,
                   difficulty: Union[int, torch.Tensor], pool_slots: int = 8,
                   deterministic: bool = False, diff_replay: int = 0,
                   generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None,
                   flips: Optional[torch.Tensor] = None,
                   perms: Optional[torch.Tensor] = None,
                   slots: Optional[torch.Tensor] = None,
                   rots: Optional[torch.Tensor] = None,
                   pool=None, offsets: Optional[torch.Tensor] = None,
                   mesh=None):
    """Episode-packed rollout: lanes that finish are refilled at once with a
    fresh reset, so every step does useful work (the aligned `collect`
    freezes finished lanes).

    Fresh states come from a pool of `pool_slots` pregenerated reset batches
    (resetting inside the loop would re-run the scramble every step). Each
    step draws a RANDOM pool slot and a RANDOM lane rotation, so a refilled
    lane can receive any of the pool_slots * B pregenerated scrambles; a
    fixed slot schedule would hand every failed episode (which always lasts
    exactly the depth budget) the same scramble over and over whenever the
    budget divides the schedule period.

    `gumbel` [T, B, A], `flips` [T, B], `perms` [T, B], `slots` [T], `rots`
    [T], `pool` (as make_packed_pool returns it) and `offsets` inject the
    draws; what is absent is drawn from `generator`. `slots` and `rots` go to the host once,
    before the loop.

    CAVEAT: the returned traj.success describes whichever pooled episode
    occupies each lane at the horizon; use the stats counters for success
    rates under packing.

    Returns (final_state, Trajectory, stats): stats holds the
    episodes_completed / episodes_succeeded int32 [B] counters and
    last_value [B] for bootstrapping GAE at the horizon (packing truncates
    mid-episode there, unlike the aligned collector where the horizon is the
    depth budget).

    With `mesh`, B is the global lane count (as are the injected draws and
    `pool`) and everything returned holds this process's block."""
    dev = core.device
    if pool is None:
        pool, state = make_packed_pool(core, B, pool_slots, difficulty,
                                       diff_replay=diff_replay,
                                       generator=generator, offsets=offsets,
                                       mesh=mesh)
    else:
        pool = shard_env_state(mesh, pool, batch_axis=1)
        state = type(pool)(*(x[0] for x in pool))
    gumbel, flips, perms = _noise(core, generator, T, B, deterministic,
                                  gumbel, flips, perms, dev, mesh)
    if slots is None:
        slots = torch.randint(0, pool_slots, (T,), generator=generator,
                              device=dev)
    if rots is None:
        rots = torch.randint(0, B, (T,), generator=generator, device=dev)
    slots, rots = slots.tolist(), rots.tolist()

    B = state.depth.shape[0]  # this process's lanes
    rows = _Rows(core, T, B, dev)
    n_done = torch.zeros(B, dtype=torch.int32, device=dev)
    n_succ = torch.zeros(B, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for t in range(T):
            with span("rollout.step"):
                obs, action, actual, logp, value, live, inverted, \
                    stepped = _sample_and_step(core, policy, state, gumbel[t],
                                               flips[t], perms[t])
                done = live & core.is_final(stepped)
                n_done += done.to(torch.int32)
                n_succ += (done & stepped.success).to(torch.int32)
                # refill finished lanes (and any dead lane, such as a fresh
                # reset that is solved already) from a random pool slot with
                # a random lane rotation
                state = packed_refill(pool, stepped, done | ~live, slots[t],
                                      rots[t], mesh)
                rows.write(t, obs, action, actual, logp, value,
                           torch.where(live, stepped.reward, 0.0), live,
                           done, inverted)
        _, last_value = policy(core.dense(state))
    stats = {
        "episodes_completed": n_done,
        "episodes_succeeded": n_succ,
        "last_value": last_value,
    }
    return state, rows.trajectory(state.success), stats


def gae(traj: Trajectory, gamma: float, lam: float,
        last_value: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over the batch: (advantages,
    returns), both [T, B].

    Episodes are finite-horizon (the depth budget is part of the MDP), so
    the value after a `done` step bootstraps to 0. The horizon end also
    bootstraps to 0 for the aligned collector (horizon == depth budget);
    packed collection truncates mid-episode and passes `last_value`. After an
    invalid row the carried value and advantage are 0."""
    T = traj.reward.shape[0]
    adv_next = torch.zeros_like(traj.value[0])
    v_next = adv_next if last_value is None else last_value
    advs = torch.empty_like(traj.value)
    for t in reversed(range(T)):
        valid = traj.valid[t]
        nonterm = (~traj.done[t]).to(torch.float32)
        delta = traj.reward[t] + gamma * v_next * nonterm - traj.value[t]
        adv = delta + gamma * lam * nonterm * adv_next
        adv_next = torch.where(valid, adv, 0.0)
        v_next = torch.where(valid, traj.value[t], 0.0)
        advs[t] = adv_next
    returns = advs + torch.where(traj.valid, traj.value, 0.0)
    return advs, returns
