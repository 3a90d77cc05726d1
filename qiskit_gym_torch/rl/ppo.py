"""PPO on the env's device: rollout -> GAE -> clipped update per iteration.

Port of the JAX package's `rl/ppo.py`. Semantics follow the reference config
schema: GAE(lambda, gamma), clipped objective, value/entropy coefs, optional
advantage normalization, Adam. The rollout batch is the whole num_episodes
at once. The policy net is an `nn.Module` that holds its own weights; its
backward is plain autograd (the env is integer GF(2) state, no gradient
flows through a kernel). The evals, the curriculum, checkpoints and solve
are `Algorithm`'s (rl/algorithm.py), shared with AlphaZero.
"""

from __future__ import annotations

from typing import Dict

import torch

from .algorithm import Algorithm
from .rollout import (Trajectory, collect, collect_packed, gae,
                      sample_difficulties)


class PPO(Algorithm):
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

        N = T * B
        flat = {
            "obs": traj.obs.reshape((N,) + traj.obs.shape[2:]),
            "action": traj.action.reshape(N),
            "logp": traj.logp.reshape(N),
            "valid": traj.valid.reshape(N),
            "adv": adv.reshape(N),
            "ret": returns.reshape(N),
        }
        aux = self._fit(flat, self._loss, traj, adv, returns)

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
