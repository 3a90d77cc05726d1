"""PPO on the env's device: rollout -> GAE -> clipped update per iteration,
with eval presets and the success-gated difficulty curriculum.

Port of the JAX package's `rl/ppo.py`. Semantics follow the reference config
schema: GAE(lambda, gamma), clipped objective, value/entropy coefs, optional
advantage normalization, Adam; the curriculum advances the difficulty by 1
when evals[diff_metric] >= diff_threshold, up to diff_max. The rollout batch
is the whole num_episodes at once. The policy net is an `nn.Module` that
holds its own weights; its backward is plain autograd (the env is integer
GF(2) state, no gradient flows through a kernel). Collection and evals run
with the net in `eval()` mode under `torch.no_grad()`, the update in
`train()` mode. MCTS solving and evals are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, Optional

import torch

from qiskit_gym_torch.models.policies import PolicyBundle
from qiskit_gym_torch.models.torch_io import save_torch_checkpoint
from qiskit_gym_torch.utils.logging import write_learn_end_note

from .checkpoint import restore_training_state, save_training_state
from .configs import EvalConfig, PPOConfig
from .rollout import (Trajectory, collect, collect_packed, gae,
                      sample_difficulties)
from .solve import policy_solve

TRAIN_STATE_FILE = "train_state.pt"


class PPO:
    # When True, rollouts always use the max_depth horizon (episodes still
    # end at their depth budget through the env's done flags; the extra
    # steps are frozen lanes). Semantics are unchanged.
    fixed_horizon: bool = False

    def __init__(self, env, policy: PolicyBundle, config: PPOConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0):
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
        """The policy net's state dict (reference `.pt` key names)."""
        return self.policy.module.state_dict()

    # ------------------------------------------------------------ internals
    def _horizon(self, difficulty: int) -> int:
        if self.fixed_horizon:
            return self.core.max_depth
        return max(min(self.core.depth_slope * difficulty,
                       self.core.max_depth), 1)

    def _clipped_loss(self, logits, value, action, old_logp, valid, adv,
                      returns):
        """Clipped PPO loss over any batch shape, masked by `valid`."""
        cfg = self.config
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, action[..., None])[..., 0]
        valid = valid.to(torch.float32)
        count = torch.clamp(valid.sum(), min=1.0)
        if cfg.normalize_advantage:
            mean = (adv * valid).sum() / count
            var = (((adv - mean) ** 2) * valid).sum() / count
            adv = (adv - mean) * torch.rsqrt(var + 1e-8)
        ratio = torch.exp(logp - old_logp)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_ratio,
                              1.0 + cfg.clip_ratio)
        pg = -torch.minimum(ratio * adv, clipped * adv)
        pg_loss = (pg * valid).sum() / count
        v_loss = (((value - returns) ** 2) * valid).sum() / count
        ent = -(torch.exp(logp_all) * logp_all).sum(-1)
        ent_bonus = (ent * valid).sum() / count
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent_bonus
        return loss, {"loss": loss, "pg_loss": pg_loss, "v_loss": v_loss,
                      "entropy": ent_bonus}

    def _loss(self, traj: Trajectory, adv, returns):
        """Clipped PPO loss over a whole [T, B] trajectory."""
        T, B = traj.action.shape
        obs = traj.obs.reshape((T * B,) + traj.obs.shape[2:])
        logits, value = self.policy(obs)
        return self._clipped_loss(
            logits.reshape(T, B, -1), value.reshape(T, B), traj.action,
            traj.logp, traj.valid, adv, returns)

    def _loss_flat(self, batch: Dict[str, torch.Tensor]):
        """The same loss over a flat minibatch dict (obs, action, logp,
        valid, adv, ret), for the num_minibatches > 1 path."""
        logits, value = self.policy(batch["obs"])
        return self._clipped_loss(logits, value, batch["action"],
                                  batch["logp"], batch["valid"],
                                  batch["adv"], batch["ret"])

    def _update(self, loss_fn, *args) -> Dict[str, torch.Tensor]:
        """One Adam step on `loss_fn(*args)`; its aux dict, detached."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(*args)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    def train_step(self, T: int, B: int, difficulty: int
                   ) -> Dict[str, float]:
        """Collect T x B transitions at `difficulty`, then num_epochs of
        updates. Returns the metrics of the last epoch (averaged over its
        minibatches) and the collection statistics."""
        cfg = self.config
        self.policy.eval()
        if cfg.episode_packing:
            final_state, traj, stats = collect_packed(
                self.core, self.policy, T, B, difficulty,
                pool_slots=cfg.pack_pool_slots, diff_replay=cfg.diff_replay,
                generator=self.generator)
            adv, returns = gae(traj, cfg.gamma, cfg.gae_lambda,
                               last_value=stats["last_value"])
        else:
            d_lanes = sample_difficulties(B, difficulty, cfg.diff_replay,
                                          generator=self.generator,
                                          device=self.device)
            state = self.core.reset(B, d_lanes, generator=self.generator)
            final_state, traj = collect(self.core, self.policy, state, T,
                                        generator=self.generator)
            stats = None
            adv, returns = gae(traj, cfg.gamma, cfg.gae_lambda)

        self.policy.train()
        if cfg.num_minibatches > 1:
            N = T * B
            # never let a "minibatch" become empty at tiny T*B
            nmb = min(cfg.num_minibatches, N)
            mb = N // nmb
            flat = {
                "obs": traj.obs.reshape((N,) + traj.obs.shape[2:]),
                "action": traj.action.reshape(N),
                "logp": traj.logp.reshape(N),
                "valid": traj.valid.reshape(N),
                "adv": adv.reshape(N),
                "ret": returns.reshape(N),
            }
            for _ in range(cfg.num_epochs):
                perm = torch.randperm(N, generator=self.generator,
                                      device=self.device)
                idx = perm[: mb * nmb].reshape(nmb, mb)
                auxs = [self._update(self._loss_flat,
                                     {k: v[ib] for k, v in flat.items()})
                        for ib in idx]
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        else:
            for _ in range(cfg.num_epochs):
                aux = self._update(self._loss, traj, adv, returns)
        self.policy.eval()

        metrics = dict(aux)
        collected = (traj.reward * traj.valid).sum()
        if stats is not None:
            completed = stats["episodes_completed"].sum()
            done = torch.clamp(completed, min=1)
            metrics["success_rate"] = stats["episodes_succeeded"].sum() / done
            metrics["episodes_completed"] = completed
            # per-episode mean (a packed lane completes many episodes)
            metrics["mean_episode_reward"] = collected / done
        else:
            metrics["success_rate"] = final_state.success.float().mean()
            metrics["mean_episode_reward"] = collected / B
        metrics["steps_collected"] = traj.valid.sum()
        return {k: float(v) for k, v in metrics.items()}

    def _eval(self, T: int, ev: EvalConfig, difficulty: int) -> float:
        """Success rate of `ev.num_episodes` fresh targets at `difficulty`,
        each tried on `ev.num_searches` lanes."""
        if ev.num_mcts_searches > 0:
            raise NotImplementedError(
                "MCTS evals (num_mcts_searches > 0) are not ported yet "
                "(ROADMAP A7)")
        E, S = ev.num_episodes, ev.num_searches
        state = self.core.reset(E, difficulty, generator=self.generator)
        if S > 1:
            state = type(state)(*(x.repeat_interleave(S, dim=0)
                                  for x in state))
        final_state, _ = collect(self.core, self.policy, state, T,
                                 deterministic=ev.deterministic,
                                 generator=self.generator)
        success = final_state.success.reshape(E, S).any(dim=1)
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
                # "weights at the last advance" is the safe artifact. The
                # net's tensors are updated in place, hence the clone.
                self.best_params = {k: v.detach().clone()
                                    for k, v in self.params.items()}
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

        write_learn_end_note(self.tb_writer, self.iteration, difficulty,
                             self.best_difficulty, metrics,
                             self.best_params is not None,
                             run_path=self.run_path)

    def _checkpoint(self):
        os.makedirs(self.run_path, exist_ok=True)
        save_torch_checkpoint(
            self.params,
            os.path.join(self.run_path, f"checkpoint_{self.iteration}.pt"))
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
        """Policy-guided search from an encoded target state; returns the
        best solution's action list, or None."""
        if num_mcts_searches > 0:
            raise NotImplementedError(
                "MCTS solving (num_mcts_searches > 0) is not ported yet "
                "(ROADMAP A7)")
        return policy_solve(self.env, self.policy, state,
                            deterministic=deterministic,
                            num_searches=num_searches,
                            generator=self.generator)
