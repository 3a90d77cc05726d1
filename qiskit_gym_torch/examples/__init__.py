"""The user programs of the JAX package's `examples/`, ported file for file.

`intro` is the tour, `resume_training` continues an interrupted run, and
the other modules are the training recipes that wrote the shipped artifacts
in `examples/models/` (each artifact's `trained_with` field names its
recipe). Each module runs as `python -m qiskit_gym_torch.examples.<name>`
with the JAX script's positional arguments plus `--out DIR`, and offers
`build(..., device=None)`, the `RLSynthesis` stack as the recipe configures
it, and `run(rls, ...)`, the recipe's loop. Everything runs on the CUDA card
unless `device="cpu"` is passed. The recipes read the shipped artifacts
and write their own artifact, `metrics.jsonl`, checkpoints and evidence
rows under `--out` (default `runs/torch/<run name>/`), never into
`examples/`.
"""
