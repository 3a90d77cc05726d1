"""27q heavy-hex Pauli, FULL 8-gate gateset (303 actions): rotation onset.

Direct MCTS seed amplification (the dense-gateset recipe) does NOT carry
over to the full gateset: warm-starting from the pre-onset scale-16 PPO
artifact seeds 0.0% at the onset (measured with the JAX package, 50+ AZ
iterations) where the dense 137-action run seeded 7% — the tree cannot
stumble onto the rotation-sweep CX chain among 303 uninformed priors.

What does transfer is the POLICY itself: the dense gateset
(H/S/Sdg x 27 + CX x 56, basis of the full one) is a strict subset of the
full 303-action gateset, and the observation encoding is gateset-
independent. So the dense AZ artifact — which already crossed the onset
and sweeps rotations at difficulty 8 — is grafted into a 303-action head:

- embeddings / common trunk / value head: copied verbatim;
- action head: each dense action's logit column is copied to its index in
  the full gateset; the 166 new actions (SX/SXdg/CZ/SWAP) get zero
  kernel columns and a floor bias (min of the transferred biases), i.e.
  small-but-alive priors the self-play tree can still explore.

Then 96-sim AlphaZero self-play (lr 3e-4, 4 epochs) continues the
curriculum on the full env. Target: difficulty >= pauli_diff_scale + 4 = 8
(rotation budget 2) with >= 0.85 eval, full gateset.

Usage: python -m qiskit_gym_torch.examples.train_pauli_27q_full_az
       [minutes] [num_sims] [--out DIR]
       (defaults 100 / 96, runs/torch/az_pauli_27q_full; a later
       invocation resumes the run directory's train_state.pt — use a
       higher num_sims to push amplification at the difficulty frontier)
"""

from __future__ import annotations

import os

from qiskit_gym_torch.envs import PauliGym
from qiskit_gym_torch.models import graft_action_head
from qiskit_gym_torch.rl import (AlphaZeroConfig, BasicPolicyConfig,
                                 RLSynthesis)
from qiskit_gym_torch.utils.serialization import load_params

from ._common import (HEAVY_HEX_27, artifact, both_directions,
                      curriculum_loop, find_train_state, newest, out_dir,
                      parser, read_config, run_path, shipped)

STEM = "az_pauli_heavy_hex_27q_full"
DONOR = "az_pauli_heavy_hex_27q_dense"
RUN = "az_pauli_27q_full"


def graft(rls: RLSynthesis) -> None:
    """The dense AZ artifact's policy grafted into `rls`'s 303-action
    head."""
    dense_cfg = read_config(DONOR)
    dense_gs = [(g[0], tuple(g[1])) for g in dense_cfg["env"]["gateset"]]
    dense_params = load_params(shipped(DONOR, ".pt"))
    rls.algorithm.params = graft_action_head(
        rls.algorithm.params, dense_params, dense_gs, rls.env.gateset)
    print("grafted dense artifact into 303-action head", flush=True)


def build(num_sims: int = 96, out=None, device=None) -> RLSynthesis:
    env = PauliGym.from_coupling_map(both_directions(HEAVY_HEX_27),
                                     max_rotations=5,
                                     pauli_diff_scale=4, depth_slope=4,
                                     pauli_layer_reward=0.05, device=device)
    # temperature_drop 12 (not 8): difficulty-8 episodes (2 rotations + 8
    # scrambles) need ~11-13 moves, and the rotation sweeps land late —
    # argmaxing from move 8 starves exactly the tail the frontier needs to
    # explore
    # diff_replay=4: measured at the difficulty-8 plateau that search depth
    # is NOT the binding constraint (argmax solve 0.09 @ 96 sims vs only
    # 0.19 @ 512 sims — priors-bound), so keep cheap 96-sim iterations and
    # fix the batch composition instead: half the lanes replay difficulties
    # d-4..d (the mastered onset regime), keeping dense positive signal
    # while the frontier half probes.
    # episode packing: with replay on, the shorter replayed episodes would
    # freeze their lanes for up to half the horizon under aligned
    # collection; packing refills them so every MCTS decision is useful.
    cfg = AlphaZeroConfig(num_episodes=512, num_mcts_searches=num_sims,
                          num_epochs=4, lr=3e-4,
                          root_noise_eps=0.25, temperature_drop=12,
                          diff_replay=4, episode_packing=True,
                          pack_pool_slots=4)
    rls = RLSynthesis(env, cfg, BasicPolicyConfig())
    algo = rls.algorithm
    snap = find_train_state(run_path(out, RUN))
    if snap is not None:                    # resume the exact run state
        algo.restore_training_state(snap)
        print(f"resumed iter {algo.iteration} difficulty {env.difficulty} "
              f"(sims={num_sims})", flush=True)
    elif os.path.exists(newest(out, STEM)):
        # no run state, but a best snapshot exists: warm-start from it
        # rather than re-grafting from the dense artifact — the snapshot
        # already carries the difficulty-8 onset crossing. Seed the
        # best-snapshot defense with the warm start itself so a
        # plateaued/collapsed run can never overwrite the artifact with
        # something worse than what it started from.
        algo.params = load_params(newest(out, STEM))
        algo.best_params = algo.params
        algo.best_difficulty = 8
        env.difficulty = 8
        print("warm-started from shipped best snapshot @ difficulty 8",
              flush=True)
    else:
        graft(rls)
    return rls


def run(rls: RLSynthesis, minutes: float = 100.0, out=None) -> int:
    out = out_dir(out, RUN)
    # fresh run: start at the onset (the grafted policy solves it already);
    # resumed runs carry the snapshot's curriculum difficulty (> 1)
    start = max(int(getattr(rls.env, "difficulty", 1)), 4)
    difficulty = curriculum_loop(rls, minutes, start, 2, out,
                                 artifact(out, STEM))
    print(f"stopped at difficulty {difficulty}")
    return difficulty


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("minutes", nargs="?", type=float, default=100.0)
    p.add_argument("num_sims", nargs="?", type=int, default=96)
    args = p.parse_args(argv)
    run(build(args.num_sims, args.out), args.minutes, args.out)


if __name__ == "__main__":
    main()
