"""Plain PPO: generalized advantage estimation, the clipped loss of the
artifacts' config schema, and Adam.

GAE over a finite-horizon batch: the value after a step that ended its
episode is 0, a packed batch bootstraps its last step from the value of the
state it stops in, and an invalid row carries nothing. The loss is the
clipped policy term, plus vf_coef times the squared value error, less
ent_coef times the entropy of the unmasked softmax, each a mean over the
valid rows. Adam is written out (betas 0.9 and 0.999, eps 1e-8, bias
corrected), as Kingma and Ba give it, from zero or from a given state.
Imports torch only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch


def gae(reward, value, valid, done, last_value, gamma: float, lam: float):
    """[T, L] float rows (valid and done bool) -> (advantages, returns)."""
    T = reward.shape[0]
    adv = torch.zeros_like(value)
    a_next = torch.zeros_like(value[0])
    v_next = last_value.clone()
    for t in range(T - 1, -1, -1):
        keep = 1.0 - done[t].float()
        delta = reward[t] + gamma * v_next * keep - value[t]
        a = delta + gamma * lam * keep * a_next
        a_next = torch.where(valid[t], a, torch.zeros_like(a))
        v_next = torch.where(valid[t], value[t], torch.zeros_like(a))
        adv[t] = a_next
    return adv, adv + torch.where(valid, value, torch.zeros_like(value))


def clipped_loss(logits, value, batch: Dict[str, torch.Tensor], cfg: dict):
    """The PPO loss of one minibatch, from the policy's outputs on its rows
    and the rows' action, old log-probability, valid, advantage, return."""
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, batch["action"][:, None])[:, 0]
    valid = batch["valid"].float()
    count = torch.clamp(valid.sum(), min=1.0)
    adv = batch["adv"]
    if cfg.get("normalize_advantage", False):
        mean = (adv * valid).sum() / count
        var = (((adv - mean) ** 2) * valid).sum() / count
        adv = (adv - mean) * torch.rsqrt(var + 1e-8)
    ratio = torch.exp(logp - batch["logp"])
    clip = cfg["clip_ratio"]
    clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    pg = -torch.minimum(ratio * adv, clipped * adv)
    pg_loss = (pg * valid).sum() / count
    v_loss = (((value - batch["ret"]) ** 2) * valid).sum() / count
    ent = -(torch.exp(logp_all) * logp_all).sum(-1)
    ent_bonus = (ent * valid).sum() / count
    return pg_loss + cfg["vf_coef"] * v_loss - cfg["ent_coef"] * ent_bonus


class Adam:
    BETAS = (0.9, 0.999)

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=BETAS, eps: float = 1e-8, state: Optional[Dict] = None):
        """`state` maps a leaf to its (first moment, second moment, steps
        taken), where the steps start from there; by default from zero."""
        self.lr, self.betas, self.eps = lr, betas, eps
        state = state or {}
        self.m = {k: state[k][0].clone() if k in state
                  else torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: state[k][1].clone() if k in state
                  else torch.zeros_like(v) for k, v in params.items()}
        self.t = {k: int(float(state[k][2])) if k in state else 0
                  for k in params}

    def step(self, params, grads) -> None:
        b1, b2 = self.betas
        for k, g in grads.items():
            self.t[k] += 1
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t[k])
            v_hat = self.v[k] / (1 - b2 ** self.t[k])
            params[k] -= self.lr * m_hat / (v_hat.sqrt() + self.eps)


def follow(params: Dict[str, torch.Tensor], batches: List[Dict],
           forward: Callable, cfg: dict, lr: float, dtype=torch.float32,
           adam: Optional[Dict] = None):
    """Adam steps of the clipped loss on `batches` from `params` (and the
    optimizer state `adam`, as `Adam` takes it), with
    `forward(obs, dtype, sd)` the policy: each step's loss, the first
    step's gradients, and the parameters after the last step. With dtype
    bfloat16 the forward and backward run in it and Adam in float32 (the
    mixed-precision control)."""
    params = {k: v.clone() for k, v in params.items()}
    opt = Adam(params, lr, state=adam)
    losses, first = [], None
    for batch in batches:
        leaves = {k: v.detach().to(dtype).requires_grad_(True)
                  for k, v in params.items()}
        logits, value = forward(batch["obs"], dtype, leaves)
        loss = clipped_loss(logits, value, batch, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = {k: g.float() for k, g in zip(leaves, grads)}
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        with torch.no_grad():
            opt.step(params, grads)
    return losses, first, params
