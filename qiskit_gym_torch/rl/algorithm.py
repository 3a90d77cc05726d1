"""What PPO and AlphaZero share: the policy net on the env's device, Adam, a
seeded generator, the evals, the success-gated difficulty curriculum with its
snapshot, logging, checkpoints and solve.

In the JAX package `rl/ppo.py` and `rl/az.py` each carry their own copy of
this loop; here a subclass gives `train_step(T, B, difficulty)` and its
loss. Collection and evals run with the net in `eval()` mode under
`torch.no_grad()`, the update in `train()` mode.

With `mesh=` (parallel/mesh.py) each process collects its block of the B
lanes, every loss divides its local masked sums by the global valid count,
and the gradients are summed over 'dp' before the Adam step, so every
process takes the single-process step on the union of the lanes; evals and
solves gather what they rank. Only the primary process writes checkpoints.
"""

from __future__ import annotations

import math
import os
import time
import warnings
from typing import Dict, Optional

import torch

from qiskit_gym_torch.models.policies import PolicyBundle
from qiskit_gym_torch.models.torch_io import save_torch_checkpoint
from qiskit_gym_torch.parallel.distributed import is_primary
from qiskit_gym_torch.parallel.mesh import (all_reduce_grads, dp_coords,
                                            dp_size, full_tensor,
                                            gather_lanes, load_into, psum,
                                            shard_env_state, shard_params)
from qiskit_gym_torch.utils.logging import write_learn_end_note
from qiskit_gym_torch.utils.profiling import note, spanned

from .checkpoint import restore_training_state, save_training_state
from .configs import EvalConfig
from .rollout import collect
from .solve import policy_solve

TRAIN_STATE_FILE = "train_state.pt"


def eval_episodes(E: int, S: int, mesh) -> int:
    """The episode count of an eval of E episodes x S searches: with a mesh
    the E*S lanes must split over 'dp', so E is rounded up to the smallest
    count that makes E*S a multiple of dp (which keeps the success-rate
    estimate unbiased)."""
    dp = dp_size(mesh)
    k = dp // math.gcd(S, dp)
    return -(-E // k) * k


class Algorithm:
    # When True, rollouts always use the max_depth horizon (episodes still
    # end at their depth budget through the env's done flags; the extra
    # steps are frozen lanes). Semantics are unchanged.
    fixed_horizon: bool = False

    def __init__(self, env, policy: PolicyBundle, config,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, mesh=None):
        self.env = env                      # user-facing gym (has .core)
        self.core = env.core
        self.device = self.core.device
        cap = getattr(self.core, "scramble_cap", None)
        if cap is not None and getattr(config, "diff_max", 0) > cap:
            warnings.warn(
                f"diff_max={config.diff_max} exceeds the per-lane reset's "
                f"scramble cap ({cap}): per-lane difficulties above the cap "
                f"scramble identically to {cap} while depth budgets keep "
                "growing", stacklevel=2)
        self.config = config
        self.seed = int(seed)
        if params is not None:
            policy.module.load_state_dict(params, strict=True)
        else:  # drawn on the CPU, so every device starts from the same net
            g = torch.Generator()
            g.manual_seed(self.seed + 1)
            policy.module.to("cpu").reset_parameters(g)
        self.policy = policy.to(self.device).eval()
        self.mesh = mesh  # optional DeviceMesh (dp[, mp])
        shard_params(mesh, self.policy.module)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.optimizer = torch.optim.Adam(self.policy.parameters(),
                                          lr=config.lr)
        self.run_path: Optional[str] = None
        self.tb_writer = None
        self.iteration = 0
        # snapshot taken each time the curriculum gate passes (see learn());
        # None until the first advance
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        self.best_difficulty = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """A copy of the policy net's state dict (reference `.pt` key
        names), whole tensors also where mp > 1 shards them (then a
        collective that every process calls). A copy, as the JAX package's
        immutable params are: the net's own tensors change in place as it
        trains, so `best = algo.params` keeps a snapshot."""
        return {k: full_tensor(v).detach().clone()
                for k, v in self.policy.module.state_dict().items()}

    @params.setter
    def params(self, value: Dict[str, torch.Tensor]) -> None:
        """Load whole tensors (e.g. `load_params(path)` or a snapshot) into
        the net, wherever it lives and however mp shards it."""
        load_into(self.policy.module, value)

    # ------------------------------------------------------------ internals
    def _horizon(self, difficulty: int) -> int:
        if self.fixed_horizon:
            return self.core.max_depth
        return max(min(self.core.depth_slope * difficulty,
                       self.core.max_depth), 1)

    def _count(self, valid: torch.Tensor) -> torch.Tensor:
        """The number of valid rows over every process (at least 1), the
        denominator of each masked mean of the losses."""
        return torch.clamp(psum(self.mesh, valid.sum()), min=1.0)

    @spanned("update")
    def _update(self, loss_fn, *args) -> Dict[str, torch.Tensor]:
        """One Adam step on `loss_fn(*args)`; its aux dict, detached. With
        a mesh the gradients are summed over 'dp' first, and the aux holds
        this process's share of each global mean (`psum` completes it)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(*args)
        loss.backward()
        all_reduce_grads(self.mesh, self.policy.parameters())
        self.optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    def _local_rows(self, idx: torch.Tensor, B: int):
        """Minibatches of global flat indices t * B + b ([nmb, mb]) -> for
        each, the positions of this process's lanes among its local flat
        rows (one host read for all of them)."""
        if dp_size(self.mesh) == 1:
            return list(idx)
        rank, size = dp_coords(self.mesh)
        Bl = B // size
        t, b = idx // B, idx % B - rank * Bl
        mine = (b >= 0) & (b < Bl)
        return list((t * Bl + b)[mine].split(mine.sum(1).tolist()))

    @spanned("fit")
    def _fit(self, flat: Dict[str, torch.Tensor], B: int, whole_batch_loss,
             *args) -> Dict[str, torch.Tensor]:
        """num_epochs of updates: one whole-batch step of
        `whole_batch_loss(*args)` per epoch, or with num_minibatches > 1 a
        shuffle of the flat [T*B] transitions `flat` into that many
        `_loss_flat` steps (B is the global lane count; with a mesh each
        process holds the rows of its lanes and steps on its share of every
        minibatch). Returns the aux of the last epoch (averaged over its
        minibatches; under a mesh summed over 'dp' into the global value)."""
        cfg = self.config
        self.policy.train()
        if cfg.num_minibatches > 1:
            N = flat["valid"].shape[0] * dp_size(self.mesh)
            # never let a "minibatch" become empty at tiny T*B
            nmb = min(cfg.num_minibatches, N)
            mb = N // nmb
            note(updates=cfg.num_epochs * nmb)
            for _ in range(cfg.num_epochs):
                perm = torch.randperm(N, generator=self.generator,
                                      device=self.device)
                idx = perm[: mb * nmb].reshape(nmb, mb)
                auxs = [self._update(self._loss_flat,
                                     {k: v[rows] for k, v in flat.items()})
                        for rows in self._local_rows(idx, B)]
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        else:
            note(updates=cfg.num_epochs)
            for _ in range(cfg.num_epochs):
                aux = self._update(whole_batch_loss, *args)
        self.policy.eval()
        return {k: psum(self.mesh, v) for k, v in aux.items()}

    def train_step(self, T: int, B: int, difficulty: int
                   ) -> Dict[str, float]:
        raise NotImplementedError

    def _eval(self, T: int, ev: EvalConfig, difficulty: int) -> float:
        """Success rate of `ev.num_episodes` fresh targets at `difficulty`,
        each tried on `ev.num_searches` lanes: policy rollouts, or with
        `ev.num_mcts_searches > 0` a batched MCTS per move."""
        S = ev.num_searches
        E = eval_episodes(ev.num_episodes, S, self.mesh)
        state = self.core.reset(E, difficulty, generator=self.generator)
        if S > 1:
            state = type(state)(*(x.repeat_interleave(S, dim=0)
                                  for x in state))
        state = shard_env_state(self.mesh, state)
        if ev.num_mcts_searches > 0:
            from .az import collect_mcts

            final_state, _ = collect_mcts(
                self.core, self.policy, state, T,
                num_sims=ev.num_mcts_searches, c_puct=ev.C,
                deterministic=ev.deterministic, generator=self.generator,
                mesh=self.mesh)
        else:
            final_state, _ = collect(self.core, self.policy, state, T,
                                     deterministic=ev.deterministic,
                                     generator=self.generator,
                                     mesh=self.mesh)
        success = final_state.success
        success = gather_lanes(self.mesh, success)
        success = success.reshape(E, S).any(dim=1)
        return float(success.float().mean())

    # ---------------------------------------------------------------- train
    def run_evals(self, difficulty: int) -> Dict[str, float]:
        T = self._horizon(difficulty)
        self.policy.eval()
        return {name: self._eval(T, ev, difficulty)
                for name, ev in self.config.evals.items()}

    def learn(self, num_iterations: int = int(1e10)) -> None:
        cfg = self.config
        B = cfg.num_episodes
        difficulty = int(getattr(self.env, "difficulty", 1))
        metrics: Dict[str, float] = {}
        for _ in range(num_iterations):
            it_start = time.time()
            metrics = self.train_step(self._horizon(difficulty), B,
                                      difficulty)
            evals = self.run_evals(difficulty)
            metrics.update({f"eval/{k}": v for k, v in evals.items()})
            metrics["difficulty"] = difficulty
            metrics["iter_seconds"] = time.time() - it_start

            # curriculum
            gate = evals.get(cfg.diff_metric)
            if gate is not None and gate >= cfg.diff_threshold:
                # the policy just proved itself at this difficulty: snapshot
                # it. A later zero-success regime lets the entropy bonus walk
                # the live weights to uniform within a few iterations, so
                # "weights at the last advance" is the safe artifact.
                self.best_params = self.params
                self.best_difficulty = difficulty
                difficulty = min(difficulty + 1, cfg.diff_max)
                self.env.difficulty = difficulty

            self.iteration += 1
            if (self.tb_writer is not None
                    and self.iteration % cfg.log_freq == 0):
                for k, v in metrics.items():
                    self.tb_writer.add_scalar(k, v, self.iteration)
            if (self.run_path is not None
                    and self.iteration % cfg.checkpoint_freq == 0):
                self._checkpoint()

        if is_primary():
            write_learn_end_note(self.tb_writer, self.iteration, difficulty,
                                 self.best_difficulty, metrics,
                                 self.best_params is not None,
                                 run_path=self.run_path)

    def _checkpoint(self):
        params = self.params  # on every process: a collective when mp > 1
        if is_primary():
            os.makedirs(self.run_path, exist_ok=True)
            save_torch_checkpoint(params, os.path.join(
                self.run_path, f"checkpoint_{self.iteration}.pt"))
        # resume-capable snapshot (optimizer state, generator, iteration,
        # curriculum difficulty) beside the weights-only checkpoints
        self.save_training_state(os.path.join(self.run_path,
                                              TRAIN_STATE_FILE))

    def save_training_state(self, path: str) -> None:
        save_training_state(self, path)

    def restore_training_state(self, path: str) -> None:
        restore_training_state(self, path)

    # ---------------------------------------------------------------- solve
    def solve(
        self,
        state,
        deterministic: bool = False,
        num_searches: int = 100,
        num_mcts_searches: int = 0,
        C: float = 2 ** 0.5,
        max_expand_depth: int = 1,
    ):
        """Search from an encoded target state with the policy; returns the
        best solution's action list, or None. `num_mcts_searches > 0` runs
        a batched MCTS of that many simulations per move."""
        if num_mcts_searches > 0:
            from .az import mcts_solve

            return mcts_solve(self.env, self.policy, state,
                              num_searches=num_searches,
                              num_mcts_searches=num_mcts_searches, C=C,
                              deterministic=deterministic,
                              max_expand_depth=max_expand_depth,
                              generator=self.generator, mesh=self.mesh)
        return policy_solve(self.env, self.policy, state,
                            deterministic=deterministic,
                            num_searches=num_searches,
                            generator=self.generator, mesh=self.mesh)
