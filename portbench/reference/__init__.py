"""The frozen plain reference the benchmark judges the program by: circuit
verifiers on signed tableaus, the artifacts' float32 policy with its
symmetry copies, the matrix env's transition, the env's circuit metrics and
rewards, and PPO. It imports numpy and torch only: nothing of the program,
of JAX or of the JAX package."""
