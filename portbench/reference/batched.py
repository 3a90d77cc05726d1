"""The matrix env's phase-less transition, batched on the card: what the
127-qubit configuration needs of the reference.

`policy.MatrixTransition` multiplies one numpy int64 2n x 2n matrix a step;
at 2n = 254 that is ~20 ms a product, and judging the sampled lanes of a
training call takes minutes. `BatchedTransition` makes the same judgement
with the same gate matrices (`tableau`, `emitted_gates`), as float32
products of a whole lane's steps at once, on `device` with TF32 off: every
entry of a product of 0/1 matrices is a count of at most 2n, exact in
float32, and is reduced mod 2 after. It covers the envs whose observation
is the whole state in a fixed frame (the Clifford env): a step's next
observation is the action's matrix times the one before, or, where the
state was inverted, its inverse. Imports numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from .policy import emitted_gates, strict_float32
from .tableau import tableau


class BatchedTransition:
    def __init__(self, n: int, gateset, family: str, device):
        if family != "clifford":
            raise ValueError("the batched transition covers the Clifford env "
                             "(its observation is the whole state)")
        strict_float32()
        mats = np.empty((len(gateset), 2 * n, 2 * n), np.float32)
        for i, (name, qs) in enumerate(gateset):
            x, z, _ = tableau(n, emitted_gates(family, name, qs))
            mats[i] = np.concatenate([x, z], axis=1).T
        self.device = device
        self.mats = torch.as_tensor(mats, device=device)
        self.eye = torch.eye(2 * n, device=device)

    def _stepped(self, before, action) -> torch.Tensor:
        """[k, dim, dim] observations and [k] actions -> the k products."""
        before = torch.as_tensor(np.asarray(before), device=self.device)
        action = torch.as_tensor(np.asarray(action, np.int64),
                                 device=self.device)
        return torch.remainder(self.mats[action] @ before.float(), 2)

    def solves(self, before: np.ndarray, action: int) -> bool:
        """Whether the step from `before` reaches the identity tableau."""
        nxt = self._stepped(before[None], [action])[0]
        return bool(torch.equal(nxt, self.eye))

    def errors(self, obs: np.ndarray, action: np.ndarray, valid: np.ndarray,
               done: np.ndarray, inverted: np.ndarray) -> int:
        """Steps of one lane ([T, dim, dim] obs, [T] rest) whose next
        observation disagrees with the step from the observation before:
        every valid step that did not end its episode."""
        ts = [t for t in range(obs.shape[0] - 1) if valid[t] and not done[t]]
        if not ts:
            return 0
        nxt = self._stepped(obs[ts], action[ts])
        after = torch.as_tensor(obs[[t + 1 for t in ts]],
                                device=self.device).float()
        flipped = torch.as_tensor(inverted[[t + 1 for t in ts]]
                                  != inverted[ts], device=self.device)
        # where the state was inverted, after times the step is the identity
        undone = torch.remainder(after @ nxt, 2)
        ok = torch.where(flipped,
                         (undone == self.eye).flatten(1).all(1),
                         (after == nxt).flatten(1).all(1))
        return int((~ok).sum())
