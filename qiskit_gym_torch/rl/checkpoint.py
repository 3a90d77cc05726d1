"""Full training-state checkpointing (resume-capable).

Port of the JAX package's `rl/checkpoint.py`. The weights-only `.pt`
checkpoints restart an interrupted run's optimizer, random stream and
curriculum from scratch; a training snapshot also carries the Adam state,
the generator state, the iteration count and the curriculum difficulty, so
`learn()` continues where it stopped. One file written with `torch.save`
(`train_state.pt`), swapped in atomically.

The algorithm object gives `params`, `optimizer`, `generator`, `iteration`,
`env.difficulty`, `best_difficulty` and `best_params`. A snapshot restores
onto the kind of device it was taken on (a CUDA generator's state does not
load into a CPU generator).
"""

from __future__ import annotations

import os
import tempfile

import torch


def _cpu(state_dict):
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def save_training_state(algo, path: str) -> None:
    payload = {
        "params": _cpu(algo.params),
        "opt": algo.optimizer.state_dict(),
        "generator": algo.generator.get_state(),
        "iteration": int(algo.iteration),
        "difficulty": int(getattr(algo.env, "difficulty", 1)),
        "best_difficulty": int(getattr(algo, "best_difficulty", 0)),
    }
    if getattr(algo, "best_params", None) is not None:
        payload["best_params"] = _cpu(algo.best_params)
    # atomic swap: a kill mid-write (the very case this snapshot exists for)
    # must not truncate the only copy
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".tmp")
    # mkstemp creates 0600; restore the umask-derived permissions so that
    # other users and tools can read the snapshot after the swap
    umask = os.umask(0)
    os.umask(umask)
    os.fchmod(fd, 0o666 & ~umask)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_training_state(algo, path: str) -> None:
    """Restore in place. The algorithm must be constructed with the same
    policy and config first; the optimizer state moves to the device of the
    weights it belongs to."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    algo.policy.module.load_state_dict(payload["params"], strict=True)
    algo.optimizer.load_state_dict(payload["opt"])
    algo.generator.set_state(payload["generator"])
    algo.iteration = int(payload["iteration"])
    algo.env.difficulty = int(payload["difficulty"])
    algo.best_difficulty = int(payload.get("best_difficulty", 0))
    if "best_params" in payload:
        algo.best_params = {k: v.to(algo.device)
                            for k, v in payload["best_params"].items()}
