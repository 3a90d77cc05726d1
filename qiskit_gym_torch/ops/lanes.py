"""What every caller that steps a core lane by lane shares (the collectors,
the tree search, the vector adapter): the env step with its injected draw,
the draws themselves, and the per-lane choice between two states."""

from __future__ import annotations

from typing import Optional

import torch

from qiskit_gym_torch.utils.profiling import counter


def env_step(core, state, action: torch.Tensor,
             flip: Optional[torch.Tensor], perm: Optional[torch.Tensor],
             actual: Optional[torch.Tensor] = None):
    """`core.step` with the injected draws: the inversion coin-flip `flip`
    (which a Pauli core ignores) and, for a core with `translate_action`,
    the next automorphism `perm`; `actual`, if given, is the already
    translated env-frame action (which a matrix core ignores). Counts the
    lanes it steps in `env_step.lane_steps`."""
    perm_kw = {} if perm is None else {"perm_idx": perm}
    env_step.lane_steps += action.shape[0]
    return core.step(state, action, invert_override=flip,
                     actual_override=actual, **perm_kw)


env_step.lane_steps = 0
counter("env_step.lane_steps", lambda: env_step.lane_steps)


def draw_step_noise(core, generator: Optional[torch.Generator], shape):
    """(flips, perms) of `shape` for env steps of `core`: fair coin-flips
    (all False without add_inverts) and, for a core with automorphisms,
    uniform `perm_idx` draws (else None)."""
    dev = core.device
    if core.add_inverts:
        flips = torch.rand(shape, generator=generator, device=dev) < 0.5
    else:
        flips = torch.zeros(shape, dtype=torch.bool, device=dev)
    perms = None
    if hasattr(core, "translate_action"):
        perms = torch.randint(0, core.num_perms, shape, generator=generator,
                              device=dev).to(torch.int32)
    return flips, perms


def select_lanes(mask: torch.Tensor, new, old):
    """Per lane: the fields of `new` where `mask`, else those of `old`."""
    B = mask.shape[0]
    return type(old)(*(
        torch.where(mask.reshape((B,) + (1,) * (n.ndim - 1)), n, o)
        for n, o in zip(new, old)))
