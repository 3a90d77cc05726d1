"""RLSynthesis — the user-facing orchestrator.

Port of the JAX package's `rl/synthesis.py`: construct from (env, rl_config,
model_config[, model_path]), `.learn()`, `.synth()`, `.save()`,
`.from_config_json()`.
The JSON schema is the reference's (examples/models/*.json); class-path
strings resolve by their last segment, so the JSONs the JAX package and the
reference ship (`<package>.envs.synthesis.CliffordEnv`, ...) load
unchanged, with their `.pt` weights. Everything runs on `device` (None
means CUDA). `learn(tb_path=...)` writes `metrics.jsonl`, the periodic
`checkpoint_<n>.pt` weights and the resumable `train_state.pt` there. The
algorithm is PPO or AlphaZero (`algorithm_cls: ...PPO` / `...AZ`); `synth`
with `num_mcts_searches > 0` runs a batched MCTS per move with either.
`mesh=` (parallel.make_mesh) spreads the lanes of training, evals and
solves over the processes of a torch.distributed group, one card each.
"""

from __future__ import annotations

import json
from typing import Optional, Union

from qiskit_gym_torch.envs.synthesis import SYNTH_ENVS, BaseSynthesisEnv
from qiskit_gym_torch.models import make_policy
from qiskit_gym_torch.parallel.distributed import is_primary
from qiskit_gym_torch.quantum import Circuit
from qiskit_gym_torch.utils.device import DeviceLike
from qiskit_gym_torch.utils.logging import JsonlLogger, MultiWriter
from qiskit_gym_torch.utils.profiling import span, spanned
from qiskit_gym_torch.utils.serialization import load_params, save_params

from .configs import ALGORITHMS, POLICIES, AlphaZeroConfig, PPOConfig


def _algorithm_class(path: str):
    name = path.split(".")[-1]
    if name == "PPO":
        from .ppo import PPO

        return PPO
    if name == "AZ":
        from .az import AZ

        return AZ
    raise ValueError(f"Unknown algorithm class {path!r}")


class RLSynthesis:
    def __init__(
        self,
        env: BaseSynthesisEnv,
        rl_config: Union[AlphaZeroConfig, PPOConfig],
        model_config,
        model_path: Optional[str] = None,
        seed: int = 0,
        mesh=None,
    ):
        self.env = env
        self.env_config = env.to_json()
        self.rl_config = rl_config
        self.model_config = model_config
        self.seed = seed
        self.mesh = mesh  # optional DeviceMesh, forwarded to the algorithm
        # free-form provenance note of the paired weights (round-trips
        # through save()/from_config_json)
        self.trained_with: Optional[str] = None
        self.algorithm = self._init_algorithm(model_path)

    def _init_algorithm(self, model_path: Optional[str]):
        algorithm_cls = _algorithm_class(self.rl_config.algorithm_cls)
        obs_perms, act_perms = self.env.twists()
        policy = make_policy(
            self.model_config.policy_cls,
            self.env.obs_shape(),
            self.env.num_actions(),
            self.model_config.to_json(),
            obs_perms=obs_perms,
            act_perms=act_perms,
        )
        params = load_params(model_path) if model_path else None
        return algorithm_cls(self.env, policy, self.rl_config, params=params,
                             seed=self.seed, mesh=self.mesh)

    # -------------------------------------------------------------- persist
    @classmethod
    def from_config_json(cls, config_path: str,
                         model_path: Optional[str] = None,
                         device: DeviceLike = None, mesh=None):
        with open(config_path) as f:
            full = json.load(f)

        env_cls = full["env_cls"].split(".")[-1]
        if env_cls not in SYNTH_ENVS:
            raise ValueError(
                f"Synth env class {full['env_cls']} not supported; "
                f"expected one of {list(SYNTH_ENVS)}"
            )
        algo_cls = full["algorithm_cls"].split(".")[-1]
        if algo_cls not in ALGORITHMS:
            raise ValueError(
                f"Algorithm class {full['algorithm_cls']} not supported; "
                f"expected one of {list(ALGORITHMS)}"
            )
        env = SYNTH_ENVS[env_cls].from_json(full["env"], device=device)
        rl_config = ALGORITHMS[algo_cls].from_json(full["algorithm"])
        rl_config = rl_config.with_updates(algorithm_cls=full["algorithm_cls"])

        pol_cls = full["policy_cls"].split(".")[-1]
        if pol_cls not in POLICIES:
            raise ValueError(
                f"Policy class {full['policy_cls']} not supported; "
                f"expected one of {list(POLICIES)}"
            )
        model_config = POLICIES[pol_cls].from_json(full["policy"])
        model_config = model_config.with_updates(policy_cls=full["policy_cls"])

        rls = cls(env, rl_config, model_config, model_path, mesh=mesh)
        rls.trained_with = full.get("trained_with")
        return rls

    def to_json(self) -> dict:
        out = {
            "env_cls": f"qiskit_gym_torch.envs.synthesis.{self.env.cls_name}",
            "env": self.env_config,
            "policy_cls": self.model_config.policy_cls,
            "policy": self.model_config.to_json(),
            "algorithm_cls": self.rl_config.algorithm_cls,
            "algorithm": self.rl_config.to_json(),
        }
        if self.trained_with:
            out["trained_with"] = self.trained_with
        return out

    def save(self, config_path: str, model_path: Optional[str] = None,
             best: bool = False):
        """Persist the JSON config and, given a `.pt` path, the weights.
        `best=True` saves the snapshot taken at the last curriculum advance
        instead of the live weights (the safe choice for periodic artifact
        saves, since a zero-success regime can degrade the live policy at
        every difficulty); before the first advance it saves the live
        weights."""
        with open(config_path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        if model_path is not None:
            params = self.algorithm.params
            if best and getattr(self.algorithm, "best_params",
                                None) is not None:
                params = self.algorithm.best_params
            save_params(params, model_path)

    # ----------------------------------------------------------------- use
    @spanned("synth")
    def synth(
        self,
        input,
        deterministic: bool = False,
        num_searches: int = 100,
        num_mcts_searches: int = 0,
        C: float = 2 ** 0.5,
        max_expand_depth: int = 1,
    ) -> Optional[Circuit]:
        with span("synth.encode"):
            state = self.env.get_state(input)
        actions = self.algorithm.solve(
            state, deterministic, num_searches, num_mcts_searches, C,
            max_expand_depth,
        )
        if actions is not None:
            with span("synth.circuit"):
                return self.env.build_circuit_from_solution(actions, input)
        return None

    def learn(self, initial_difficulty: int = 1,
              num_iterations: int = int(1e10), tb_path: Optional[str] = None):
        """Train from `initial_difficulty` for `num_iterations`. With
        `tb_path`, metrics go to `<tb_path>/metrics.jsonl` (and to
        TensorBoard where the `tensorboard` package is installed) and the
        checkpoints to the same directory; under a mesh only the primary
        process writes there."""
        if tb_path is not None:
            if hasattr(self.algorithm.tb_writer, "close"):
                self.algorithm.tb_writer.close()  # repeated learn() calls
            self.algorithm.run_path = tb_path
        if tb_path is not None and is_primary():  # one writer per run
            writers = [JsonlLogger(tb_path)]
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass  # without tensorboard there is still metrics.jsonl
            else:
                writers.append(SummaryWriter(tb_path))
            self.algorithm.tb_writer = MultiWriter(*writers)
        self.env.difficulty = initial_difficulty
        try:
            self.algorithm.learn(num_iterations)
        except KeyboardInterrupt:
            return
        finally:
            # the JSONL writer buffers the newest step until a newer one
            # arrives: flush so that the last iteration's row is on disk
            if hasattr(self.algorithm.tb_writer, "flush"):
                self.algorithm.tb_writer.flush()

    @property
    def params(self):
        return self.algorithm.params


def gate_list_to_circuit(gate_list, num_qubits: Optional[int] = None) -> Circuit:
    return Circuit.from_gate_list(gate_list, num_qubits)
