"""Policy/value networks as `nn.Module`s.

Port of the JAX package's `models/policies.py`. `BasicPolicy` is the
architecture of the reference checkpoints (flat obs -> Linear 'embeddings'
-> ReLU Linear stack 'common.i' -> heads 'action.i' / 'value.i'), with the
reference's state-dict names, so `examples/models/*.pt` load with a plain
`load_state_dict(strict=True)`.

`PolicyBundle` wraps a net with the coupling map's symmetry perms
("twists"): each (obs_perm, act_perm) pair relabels the flattened
observation before the net and un-relabels the action logits after, and the
results are averaged, which makes the policy exactly equivariant under the
automorphism group. `Conv1dPolicy` puts one Conv1d along an observation axis
in front of the same torso.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class BasicPolicy(nn.Module):
    def __init__(
        self,
        obs_size: int,
        num_actions: int,
        embedding_size: int = 512,
        common_layers: Sequence[int] = (256,),
        policy_layers: Sequence[int] = (),
        value_layers: Sequence[int] = (),
    ):
        super().__init__()
        self.embeddings = nn.Linear(obs_size, embedding_size)
        widths = [embedding_size, *common_layers]
        self.common = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))

        def head(hidden, out):
            ws = [widths[-1], *hidden, out]
            return nn.ModuleList(
                nn.Linear(i, o) for i, o in zip(ws[:-1], ws[1:]))

        self.action = head(policy_layers, num_actions)
        self.value = head(value_layers, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-draw every Linear and Conv1d as PyTorch's default init does
        (uniform in +-1/sqrt(fan_in) for weight and bias), from
        `generator`."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv1d)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    nn.init.uniform_(m.weight, -bound, bound,
                                     generator=generator)
                    nn.init.uniform_(m.bias, -bound, bound,
                                     generator=generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.torso(obs.reshape(obs.shape[0], -1))

    def torso(self, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, obs_size] features -> (logits [B, A], value [B])."""
        x = torch.relu(self.embeddings(flat))
        for layer in self.common:
            x = torch.relu(layer(x))
        p = x
        for layer in self.action[:-1]:
            p = torch.relu(layer(p))
        logits = self.action[-1](p)
        v = x
        for layer in self.value[:-1]:
            v = torch.relu(layer(v))
        value = self.value[-1](v)
        return logits, value[:, 0]


class Conv1dPolicy(BasicPolicy):
    """Conv1d frontend along obs axis `conv_dim`, then the MLP torso.

    As in the JAX package: one SAME-padded convolution along obs axis
    `conv_dim` (length L preserved) with the other axis as input channels
    and ceil(embedding_size / L) output channels, a ReLU, and the
    'embeddings' Linear from the flattened features to embedding_size.
    kernel_size = 3 is recorded in the 'conv.weight' checkpoint shape
    [out, in, k], which is also how the JAX package writes a flax conv
    kernel [k, in, out] into a `.pt`. The features are flattened position
    first, channel second, as flax's channels-last conv lays them out, so
    the 'embeddings' weight carries across unchanged."""

    def __init__(
        self,
        obs_shape: Sequence[int],
        num_actions: int,
        conv_dim: int = 1,
        embedding_size: int = 1260,
        common_layers: Sequence[int] = (256,),
        policy_layers: Sequence[int] = (),
        value_layers: Sequence[int] = (),
        kernel_size: int = 3,
    ):
        if conv_dim not in (0, 1) or len(obs_shape) != 2:
            raise ValueError("Conv1dPolicy needs a 2-D obs and conv_dim 0/1")
        length, channels = obs_shape[conv_dim], obs_shape[1 - conv_dim]
        features = max(1, -(-embedding_size // length))  # ceil divide
        super().__init__(length * features, num_actions, embedding_size,
                         common_layers, policy_layers, value_layers)
        self.conv_dim = conv_dim
        self.conv = nn.Conv1d(channels, features, kernel_size,
                              padding=kernel_size // 2)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # nn.Conv1d takes [B, channels, length]: obs as it is for conv_dim 1
        x = obs if self.conv_dim == 1 else obs.transpose(1, 2)
        x = torch.relu(self.conv(x))                    # [B, F, L]
        return self.torso(x.transpose(1, 2).reshape(x.shape[0], -1))


class PolicyBundle(nn.Module):
    """A policy net + its obs/action symmetry perms.

    forward(obs [B, *obs_shape]) -> (logits [B, A], value [B]); integer obs
    (the dense uint8 bits) are cast to float32 first."""

    def __init__(
        self,
        module: nn.Module,
        obs_shape: Sequence[int],
        num_actions: int,
        obs_perms: Optional[Sequence[Sequence[int]]] = None,
        act_perms: Optional[Sequence[Sequence[int]]] = None,
        symmetrize: bool = True,
    ):
        super().__init__()
        self.module = module
        self.obs_shape = tuple(int(s) for s in obs_shape)
        self.num_actions = int(num_actions)
        obs_perms = [list(p) for p in (obs_perms or [])]
        act_perms = [list(p) for p in (act_perms or [])]
        if len(obs_perms) != len(act_perms):
            raise ValueError("obs_perms and act_perms differ in length")
        self.num_perms = len(obs_perms)
        # relabeled_obs[:, p[i]] = obs[:, i]  <=>  relabeled = obs[:, inv_p]
        if symmetrize and self.num_perms > 1:
            inv_obs = np.stack([np.argsort(np.asarray(p)) for p in obs_perms])
            self.register_buffer("inv_obs", torch.from_numpy(inv_obs),
                                 persistent=False)                # [P, D]
            self.register_buffer(
                "act", torch.as_tensor(np.stack(act_perms), dtype=torch.int64),
                persistent=False)                                  # [P, A]
        else:
            self.inv_obs = None
            self.act = None

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if not obs.is_floating_point():
            obs = obs.to(torch.float32)
        if self.inv_obs is None:
            return self.module(obs)
        B = obs.shape[0]
        P = self.inv_obs.shape[0]
        flat = obs.reshape(B, -1)
        relabeled = flat[:, self.inv_obs]                  # [B, P, D]
        relabeled = relabeled.transpose(0, 1).reshape((P * B,)
                                                      + self.obs_shape)
        logits, value = self.module(relabeled)
        logits = logits.reshape(P, B, -1)
        # relabeled-frame action act_perm[a] is original-frame action a, so
        # the original-frame logit for a is logits[act_perm[a]]
        idx = self.act[:, None, :].expand(P, B, self.act.shape[1])
        logits = logits.gather(2, idx)
        return logits.mean(dim=0), value.reshape(P, B).mean(dim=0)


def make_policy(
    policy_cls: str,
    obs_shape,
    num_actions: int,
    model_config: dict,
    obs_perms=None,
    act_perms=None,
) -> PolicyBundle:
    """Instantiate from a config-style class path ('...BasicPolicy' or
    '...Conv1dPolicy')."""
    name = policy_cls.split(".")[-1]
    cfg = dict(model_config)
    cfg.pop("policy_cls", None)
    torso = dict(
        common_layers=tuple(cfg.pop("common_layers", (256,))),
        policy_layers=tuple(cfg.pop("policy_layers", ())),
        value_layers=tuple(cfg.pop("value_layers", ())),
    )
    if name == "BasicPolicy":
        module = BasicPolicy(
            obs_size=int(np.prod(obs_shape)), num_actions=num_actions,
            embedding_size=int(cfg.pop("embedding_size", 512)), **torso)
    elif name == "Conv1dPolicy":
        module = Conv1dPolicy(
            tuple(obs_shape), num_actions,
            conv_dim=int(cfg.pop("conv_dim", 1)),
            embedding_size=int(cfg.pop("embedding_size", 1260)), **torso)
    else:
        raise ValueError(f"Unknown policy class {policy_cls!r}")
    return PolicyBundle(module, tuple(obs_shape), num_actions, obs_perms,
                        act_perms)
