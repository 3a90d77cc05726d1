"""qiskit-gym-torch: RL-driven quantum circuit synthesis on PyTorch and CUDA.

The PyTorch port of the JAX package (qiskit-gym-tpu), which stays beside it as the
reference. It imports torch and numpy, never jax, and nothing of the JAX
package (it keeps its own copies of the numpy-only modules).

Subpackages
-----------
quantum   standalone quantum-info layer (circuit IR, Clifford tableau with
          phases, Pauli algebra, GF(2) linear functions, statevector oracle).
spec      numpy single-env specification of the matrix env families.
ops       batched env cores (bitpacked or dense) on torch tensors and the
          hand-written CUDA kernels they launch (csrc/).
envs      user-facing gyms (PermutationGym, LinearFunctionGym, CliffordGym,
          PauliGym) and their Gymnasium adapters.
models    policy networks (BasicPolicy, Conv1dPolicy) as nn.Modules, `.pt`
          interop.
rl        rollout collection, PPO and AlphaZero training, batched MCTS,
          best-of-N and MCTS solve, RLSynthesis.
utils     device selection, checkpoint serialization, metrics logging.

Entry points take `device=None`, meaning CUDA; they raise when CUDA is
absent unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

from qiskit_gym_torch.envs import (  # noqa: E402,F401
    CliffordGym,
    LinearFunctionGym,
    PauliGym,
    PermutationGym,
    SYNTH_ENVS,
    gym_adapter,
)
from qiskit_gym_torch.rl import (  # noqa: E402,F401
    ALGORITHMS,
    AZ,
    POLICIES,
    PPO,
    AlphaZeroConfig,
    BasicPolicyConfig,
    Conv1dPolicyConfig,
    EvalConfig,
    PPOConfig,
    RLSynthesis,
    collect_mcts,
    collect_mcts_packed,
    mcts_search,
    mcts_solve,
)
