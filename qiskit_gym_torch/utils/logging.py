"""Training-metrics logging.

The port's copy of the JAX package's `utils/logging.py` (plain Python, no
framework). `JsonlLogger` has the scalar-writer surface the algorithms use
(`add_scalar(tag, value, step)`) and appends one JSON object per step to
`<run_path>/metrics.jsonl`. It stands in when the `tensorboard` package is
absent, and combines with a TensorBoard `SummaryWriter` through
`MultiWriter`.
"""

from __future__ import annotations

import json
import os
from typing import Optional


class JsonlLogger:
    """Buffers scalars per step and appends one JSON line per flushed step:
    {"step": N, "<tag>": value, ...}. Lines are flushed when a scalar for a
    NEWER step arrives, and on close()."""

    def __init__(self, run_path: str, filename: str = "metrics.jsonl"):
        os.makedirs(run_path, exist_ok=True)
        self.path = os.path.join(run_path, filename)
        self._step: Optional[int] = None
        self._row: dict = {}
        self._fh = open(self.path, "a", buffering=1)

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._step is not None and step != self._step:
            self._flush()
        self._step = step
        self._row[tag] = float(value)

    def _flush(self) -> None:
        if self._step is not None and self._row:
            self._fh.write(
                json.dumps({"step": self._step, **self._row}) + "\n"
            )
        self._row = {}

    def flush(self) -> None:
        """Write the buffered step now (e.g. at the end of learn())."""
        self._flush()
        self._step = None
        self._fh.flush()

    def add_note(self, note: str, step: int) -> None:
        """Append a human-readable marker line ({"step": N, "note": ...}) —
        used for end-of-learn state so a run directory is self-describing
        (e.g. 'collapsed; ship the best snapshot @ difficulty N')."""
        self._flush()
        self._fh.write(json.dumps({"step": int(step), "note": note}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._flush()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_learn_end_note(writer, step: int, difficulty: int,
                         best_difficulty: int, last_metrics: dict,
                         has_best_snapshot: bool,
                         run_path: Optional[str] = None) -> None:
    """Terminal run-state marker so a run directory is self-describing.

    A training run that walked into a zero-success regime ends with live
    weights destroyed by the entropy bonus (docs/TRAINING.md 'entropy-collapse
    wall') while the proven snapshot is fine; without a marker, the final
    metrics rows read as a failed run.

    Training scripts call learn() in small chunks inside a while loop, so
    when `run_path` is given the marker OVERWRITES one run_summary.json
    (always the current end state) instead of appending a note per learn()
    call to metrics.jsonl; the jsonl note is the fallback for writer-only
    callers."""
    note = (f"learn() ended at difficulty {difficulty}; proven "
            f"best_difficulty={best_difficulty}")
    collapsed = (last_metrics.get("success_rate", 1.0) == 0.0
                 and has_best_snapshot)
    if collapsed:
        note += ("; final iteration had zero collection success "
                 "(entropy-collapse wall, docs/TRAINING.md): ship the "
                 f"best=True snapshot @ difficulty {best_difficulty}, "
                 "not the live params")
    if run_path is not None:
        os.makedirs(run_path, exist_ok=True)
        with open(os.path.join(run_path, "run_summary.json"), "w") as f:
            json.dump({"step": int(step), "difficulty": int(difficulty),
                       "best_difficulty": int(best_difficulty),
                       "collapsed_at_end": bool(collapsed),
                       "note": note}, f, indent=1)
        return
    if writer is None or not hasattr(writer, "add_note"):
        return
    writer.add_note(note, step)


class MultiWriter:
    """Fan-out add_scalar to several writers (e.g. TensorBoard + JSONL)."""

    def __init__(self, *writers):
        self.writers = [w for w in writers if w is not None]

    def add_scalar(self, tag: str, value, step: int) -> None:
        for w in self.writers:
            w.add_scalar(tag, value, step)

    def add_note(self, note: str, step: int) -> None:
        for w in self.writers:
            if hasattr(w, "add_note"):
                w.add_note(note, step)

    def flush(self) -> None:
        for w in self.writers:
            if hasattr(w, "flush"):
                w.flush()

    def close(self) -> None:
        for w in self.writers:
            if hasattr(w, "close"):
                w.close()
