"""Resume an interrupted training run exactly where it stopped.

Rebuilds the RLSynthesis stack from a saved artifact config, then restores
the full training state (params, optimizer state, generator, iteration
counter, curriculum difficulty) from the run directory's `train_state.pt`
(written every `checkpoint_freq` iterations), or from a JAX package run's
`train_state.msgpack`.

Usage:
  python -m qiskit_gym_torch.examples.resume_training CONFIG.json RUN_DIR \
      [minutes] [--fixed-horizon] [--out DIR]

Training continues in RUN_DIR. The artifact (`<stem>.json` and `.pt`, stem
from CONFIG.json) is re-saved into --out (default RUN_DIR) every outer loop,
so this script is itself interruption-proof; CONFIG.json is only read.
"""

from __future__ import annotations

import os

from qiskit_gym_torch.rl import RLSynthesis

from ._common import artifact, curriculum_loop, find_train_state, parser


def build(cfg_path: str, run_dir: str, fixed_horizon: bool = False,
          device=None) -> RLSynthesis:
    """The stack of `cfg_path` with the training state of `run_dir`."""
    rls = RLSynthesis.from_config_json(cfg_path, device=device)
    if fixed_horizon:
        rls.algorithm.fixed_horizon = True
    state_path = find_train_state(run_dir)
    if state_path is None:
        raise FileNotFoundError(f"no train_state.pt or train_state.msgpack "
                                f"in {run_dir}")
    rls.algorithm.restore_training_state(state_path)
    print(f"resumed at iteration {rls.algorithm.iteration}, "
          f"difficulty {int(rls.env.difficulty)}", flush=True)
    return rls


def run(rls: RLSynthesis, run_dir: str, minutes: float = 30.0,
        out=None, stem: str = "resumed"):
    out = out or run_dir
    os.makedirs(out, exist_ok=True)
    difficulty = curriculum_loop(rls, minutes, int(rls.env.difficulty), 5,
                                 run_dir, artifact(out, stem))
    print(f"stopped at iteration {rls.algorithm.iteration}, "
          f"difficulty {difficulty}")


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("config")
    p.add_argument("run_dir")
    p.add_argument("minutes", nargs="?", type=float, default=30.0)
    p.add_argument("--fixed-horizon", action="store_true")
    args = p.parse_args(argv)
    rls = build(args.config, args.run_dir, args.fixed_horizon)
    stem = os.path.basename(args.config)
    stem = stem[:-5] if stem.endswith(".json") else stem
    run(rls, args.run_dir, args.minutes, args.out, stem)


if __name__ == "__main__":
    main()
