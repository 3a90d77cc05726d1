"""The measuring, quality and artifact tools: what measures the port's
throughput and the shipped artifacts' solve quality, what drives it, and
what made the artifacts, as programs of the port.

Each module is named after its counterpart in the JAX package's tree and
runs as `python -m qiskit_gym_torch.tools.<name>`, on the CUDA card unless
`--device cpu` is given:

- `vs_reference`: the head-to-head against a reference's shipped weights
  (`bench_vs_reference.py`);
- `optimal_bc`: exact BFS distance tables and behavior cloning on optimal
  demonstrations (`scripts/optimal_bc.py`);
- `bench_quality`: the solve-quality tables (`bench_quality.py`);
- `bench_baseline5`: BASELINE config #5, 27q permutation AlphaZero with
  1000-simulation MCTS (`bench_baseline5.py`);
- `finetune_brevity`, `finetune_pauli_ppo`, `graft_pauli_ppo`: the
  artifact finetunes and the graft (`scripts/`).
- `bench`: env steps a second of the four 27q heavy-hex families, with
  `--mesh` and `--scale` (`bench.py`); `bench_fused`: kernel B1 against
  the plain step (`scripts/bench_fused.py`);
- `entry`: one fused policy and env step, and the sharded PPO dry run
  (`__graft_entry__.py`);
- `probe_depth_cap`, `probe_sims_vs_priors`: the MCTS evidence probes
  (`scripts/`).

They read the shipped artifacts under `examples/models/` and never write
there: an artifact they make, their evidence rows and their tables go to
the run directory or file given by `--out` (the bench and the entry points
print only).
"""
