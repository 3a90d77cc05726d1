"""Back-to-back PPO iterations from fresh weights: `ppo_train`'s closed loop
of `algorithm.train_step(horizon, lanes, difficulty)` on a configuration
that ships no trained weights.

Traffic keys: those of `ppo_train`. The configuration's `artifact` names
its JSON only. Set-up draws the policy's initial weights in plain torch,
from the configuration's widths and a generator seeded with the run's
`--seed` (PyTorch's default Linear initialization, as the program's own
initializer draws it), writes them to a temporary `.pt` and runs
`ppo_train`'s set-up on it; the program and the reference load that file
each, and it goes with the run. Nothing the reference reads is made by the
program. The sampled lanes' transitions are
judged on the card (`reference/batched.py`), as a wide state's products
take minutes in numpy.

The traced calls' launches come back under the names the trace holds:
the wide kernels (`fused_step_wide_kernel`, `apply_wide_kernel`) for
states of W >= 3 words a column, counted by the wrappers' `.wide_launches`,
and the narrow ones for the rest. The record adds the FLOPs of the
first layer's forward a row and the bytes of one wide step, for
`mfu_exact.train` and `b1_wide_roofline.train`.
"""

from __future__ import annotations

import contextlib
import copy
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
from portbench.drivers import ppo_train
from portbench.metrics import costs
from portbench.reference.batched import BatchedTransition


def policy_layers(cfg: dict) -> list:
    """(name, inputs, outputs) of each Linear of the configuration's
    `BasicPolicy`, under its state dict's names, the observation's first."""
    torso = [int(np.prod(cfg["obs_shape"])), cfg["embedding_size"],
             *cfg["common_layers"]]
    names = ["embeddings"] + [f"common.{i}" for i in
                              range(len(cfg["common_layers"]))]
    layers = [(k, a, b) for k, a, b in zip(names, torso[:-1], torso[1:])]
    for head, hidden, out in (("action", cfg["policy_layers"],
                               cfg["num_actions"]),
                              ("value", cfg["value_layers"], 1)):
        widths = [torso[-1], *hidden, out]
        layers += [(f"{head}.{i}", a, b) for i, (a, b)
                   in enumerate(zip(widths[:-1], widths[1:]))]
    return layers


def write_initial_weights(cfg: dict, seed: int, path: str) -> None:
    """The configuration's policy net drawn from a CPU generator seeded
    with `seed`, layer after layer: each Linear's weight, then its bias,
    uniform in +-1/sqrt(inputs). Saved as a `.pt` state dict."""
    g = torch.Generator()
    g.manual_seed(seed)
    sd = {}
    for name, a, b in policy_layers(cfg):
        bound = a ** -0.5
        sd[f"{name}.weight"] = (2 * torch.rand(b, a, generator=g) - 1) * bound
        sd[f"{name}.bias"] = (2 * torch.rand(b, generator=g) - 1) * bound
    torch.save(sd, path)


def first_layer_flops(cfg: dict) -> int:
    """The first Linear's forward FLOPs of one row, times the symmetry
    copies: the input gradient an update row does not compute."""
    return cfg["policy_copies"] * costs.linear_flops(
        [int(np.prod(cfg["obs_shape"])), cfg["embedding_size"]])


def launch_names(step, apply, metrics) -> dict:
    """{kernel name in the trace: launches} from the counters' changes:
    (all, wide) launches of the step and of the apply, B2's launches. The
    wide ones run `*_wide_kernel`, the rest the narrow kernels."""
    return {"fused_step_kernel": step[0] - step[1],
            "fused_step_wide_kernel": step[1],
            "apply_kernel": apply[0] - apply[1],
            "apply_wide_kernel": apply[1],
            "metrics_kernel": metrics}


@contextlib.contextmanager
def _batched_transition(device):
    """`ppo_train`'s readings with the transition judged on `device`."""
    plain = ppo_train.MatrixTransition
    ppo_train.MatrixTransition = (
        lambda n, gateset, family: BatchedTransition(n, gateset, family,
                                                     device))
    try:
        yield
    finally:
        ppo_train.MatrixTransition = plain


class Run(ppo_train.Run):
    def __init__(self, ctx):
        self._weights = tempfile.TemporaryDirectory(prefix="portbench-")
        cell = copy.copy(ctx.cell)
        art = dict(cell.config["artifact"],
                   pt=os.path.join(self._weights.name, "initial.pt"))
        cell.config = dict(cell.config, artifact=art)
        write_initial_weights(cell.config, ctx.seed, art["pt"])
        super().__init__(SimpleNamespace(**dict(vars(ctx), cell=cell)))

    def traced(self, trace_sink: list) -> dict:
        from qiskit_gym_torch.ops import fused_step as fs
        from qiskit_gym_torch.ops import metrics_kernel as mk

        def read():
            return np.array([fs.fused_step.launches,
                             fs.fused_step.wide_launches,
                             fs.apply_gates.launches,
                             fs.apply_gates.wide_launches,
                             mk.metrics_update.launches])

        before = read()
        with harness.profiled(self.ctx.sync, trace_sink):
            for _ in range(int(self.tr["trace_calls"])):
                self.algo.train_step(self.T, self.B, self.difficulty)
        self.trace_calls = int(self.tr["trace_calls"])
        step, step_wide, apply, apply_wide, b2 = (
            int(x) for x in read() - before)
        return launch_names((step, step_wide), (apply, apply_wide), b2)

    def release(self) -> None:
        core = self.algo.core
        self.b1_wide_bytes = costs.b1_bytes(
            self.B, core.W, core.dim, core.num_qubits, core.track_layers,
            core.add_inverts)
        super().release()

    def _readings(self, *args) -> dict:
        with _batched_transition(self.ctx.device):
            return super()._readings(*args)

    def record(self) -> SimpleNamespace:
        rec = super().record()
        rec.first_layer_flops = first_layer_flops(self.cfg)
        rec.b1_wide_bytes = self.b1_wide_bytes
        return rec


def setup(ctx) -> Run:
    return Run(ctx)
