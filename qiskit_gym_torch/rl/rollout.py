"""Batched rollout collection on the env's device.

Port of the aligned collector of the JAX package's `rl/rollout.py`: every lane
starts from an already-reset (or set) state and the batch runs T
observe -> policy -> masked Gumbel-max sample -> env step steps. The JAX
`lax.scan` becomes a Python loop over T with the batch written out; there
is no host round-trip inside the loop. Lanes that finish are frozen (their
rows are marked invalid).

All randomness is drawn up front by `_pregen_randomness` from one
`torch.Generator` on the device (the JAX package draws from threefry keys;
the two give different numbers from the same seed, so the tests hand both
sides the same numpy-made noise through the `gumbel`/`flips` arguments).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


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


def _pregen_randomness(core, generator: Optional[torch.Generator], T: int,
                       B: int, deterministic: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bulk draws for a T-step rollout on the core's device: Gumbel noise
    [T, B, A] (zeros if deterministic) and inversion flips bool [T, B]
    (all False without add_inverts)."""
    dev = core.device
    A = core.num_actions
    if deterministic:
        gumbel = torch.zeros((T, B, A), device=dev)
    else:
        # -log(E) for E ~ Exp(1) is a standard Gumbel draw
        e = torch.empty((T, B, A), device=dev).exponential_(
            generator=generator)
        gumbel = -torch.log(e)
    if core.add_inverts:
        flips = torch.rand((T, B), generator=generator, device=dev) < 0.5
    else:
        flips = torch.zeros((T, B), dtype=torch.bool, device=dev)
    return gumbel, flips


def collect(core, policy, state, T: int, deterministic: bool = False,
            lane_temp: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            gumbel: Optional[torch.Tensor] = None,
            flips: Optional[torch.Tensor] = None):
    """Roll out T steps from `state`. Returns (final_state, Trajectory).

    `policy(obs) -> (logits, value)`. `lane_temp` [B] sets a per-lane
    sampling temperature (0 = argmax; see solve_temperatures), ignored when
    deterministic. `gumbel` [T, B, A] and `flips` [T, B] inject the noise;
    otherwise it is drawn from `generator`."""
    B = state.depth.shape[0]
    dev = state.a.device
    if gumbel is None or flips is None:
        g_draw, f_draw = _pregen_randomness(core, generator, T, B,
                                            deterministic)
        gumbel = g_draw if gumbel is None else gumbel
        flips = f_draw if flips is None else flips
    gumbel = gumbel.to(dev)
    flips = flips.to(device=dev, dtype=torch.bool)
    if lane_temp is not None and not deterministic:
        gumbel = gumbel * lane_temp.to(dev)[None, :, None]

    def rows(dtype, shape=()):
        return torch.empty((T, B) + tuple(shape), dtype=dtype, device=dev)

    obs_t = rows(torch.uint8, core.obs_shape)
    action_t = rows(torch.int64)
    logp_t = rows(torch.float32)
    value_t = rows(torch.float32)
    reward_t = rows(torch.float32)
    valid_t = rows(torch.bool)
    done_t = rows(torch.bool)
    inverted_t = rows(torch.bool)

    with torch.no_grad():
        for t in range(T):
            obs = core.dense(state)
            logits, value = policy(obs)
            masks = core.masks(state)
            neg = torch.finfo(logits.dtype).min
            masked = torch.where(masks, logits, neg)
            action = torch.argmax(masked + gumbel[t], dim=-1)
            logp_all = torch.log_softmax(masked, dim=-1)
            logp = logp_all.gather(1, action[:, None])[:, 0]

            live = ~core.is_final(state)
            inverted = state.inverted
            stepped = core.step(state, action,
                                invert_override=flips[t]
                                if core.add_inverts else None)
            state = type(state)(*(
                torch.where(live.reshape((B,) + (1,) * (new.ndim - 1)),
                            new, old)
                for new, old in zip(stepped, state)))

            obs_t[t] = obs
            action_t[t] = action
            logp_t[t] = logp
            value_t[t] = value
            reward_t[t] = torch.where(live, state.reward, 0.0)
            valid_t[t] = live
            done_t[t] = core.is_final(state)
            inverted_t[t] = inverted

    traj = Trajectory(
        obs=obs_t, action=action_t, actual=action_t, logp=logp_t,
        value=value_t, reward=reward_t, valid=valid_t, done=done_t,
        inverted=inverted_t, success=state.success,
    )
    return state, traj
