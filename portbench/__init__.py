"""The benchmark of the PyTorch and CUDA port, `qiskit_gym_torch`.

`python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once; see README.md.
"""
