"""Closed-loop synthesis: one caller sends one target after another through
`RLSynthesis.synth(circuit, num_searches=lanes)` on a shipped artifact,
each call waiting for the one before.

Traffic keys: `depth` gates a target, `rotations` among them, `pool`
targets drawn from `pool_seed`, `num_searches` lanes a call, `quality_calls`
(the first calls, one pass over the pool, whose circuits the 2q mean
averages), `check_window` (the first calls, whose lane 0 the reference
reads step by step, and whose every lane's counters it recounts),
`check_calls` of them whose `check_lanes` other lanes it reads too,
`trace_calls` calls in the traced stretch. The window makes at least the
`check_window` calls.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness, targets
from portbench.metrics import costs
from portbench.reference import metrics as ref_metrics
from portbench.reference import tableau
from portbench.reference.policy import (MatrixTransition, Policy,
                                        load_artifact, strict_float32)

# Numbers compared exactly (limit 0).
EXACT = ("missing_captures", "start_errors", "transition_errors",
         "reward_errors", "counter_errors", "best_lane_errors")


def _circuit(gates, n):
    from qiskit_gym_torch.quantum import Circuit

    qc = Circuit(n)
    for name, qs, params in gates:
        qc.append(name, qs, params)
    return qc


def _gates(circuit):
    return [(g[0], tuple(g[1]), tuple(g[2])) for g in circuit]


class Run:
    def __init__(self, ctx):
        from qiskit_gym_torch.rl import solve
        from qiskit_gym_torch.rl.synthesis import RLSynthesis

        cell, tr = ctx.cell, dict(ctx.cell.traffic, **ctx.overrides)
        self.ctx, self.tr, self.cfg = ctx, tr, cell.config
        art = self.cfg["artifact"]
        self.json, self.pt = str(cell.path(art["json"])), str(
            cell.path(art["pt"]))
        self.rls = RLSynthesis.from_config_json(self.json, self.pt,
                                                device=ctx.device)
        self.rls.algorithm.generator.manual_seed(ctx.seed)
        core = self.rls.env.core
        if (list(core.obs_shape) != self.cfg["obs_shape"]
                or core.num_actions != self.cfg["num_actions"]):
            raise ValueError("the artifact does not have the configuration's "
                             "widths")
        self.n = core.num_qubits
        self.T = core.max_depth
        self.lanes = int(tr["num_searches"])
        self.art = load_artifact(self.json)
        self.gateset = [(g[0], tuple(g[1]))
                        for g in self.art["env"]["gateset"]]
        pool = targets.pool(self.gateset, self.n, tr)
        self.pool, warm = pool[:-1], pool[-1]
        self.seq = targets.order(ctx.seed, len(self.pool), 64)
        rng = np.random.default_rng(ctx.seed)
        self.check_window = int(tr["check_window"])
        self.sample = set(rng.choice(
            self.check_window, size=min(int(tr["check_calls"]),
                                        self.check_window),
            replace=False).tolist())
        others = rng.choice(np.arange(1, self.lanes),
                            size=min(int(tr["check_lanes"]), self.lanes - 1),
                            replace=False)
        self.check_lanes = torch.as_tensor([0, *others.tolist()],
                                           device=ctx.device)
        self.captured, self.capture = [], None
        inner = solve.collect

        def collect(core, *args, **kwargs):
            final, traj = inner(core, *args, **kwargs)
            if self.capture is not None:
                self.captured.append((self.capture,
                                      self._take(core, final, traj)))
                self.capture = None
            return final, traj

        solve.collect = collect
        self._undo = (solve, inner)
        if ctx.plant is not None:
            ctx.plant(self)
        self.rls.synth(_circuit(warm, self.n), num_searches=self.lanes)
        self.calls, self.outputs = [], []

    def _take(self, core, final, traj) -> dict:
        """What the reference reads of one call, copied on the card: the
        sampled lanes' rows and their observation after the last step, and
        every lane's actions, valid flags, success flag and counters."""
        lanes = (self.check_lanes if self.capture in self.sample
                 else self.check_lanes[:1])
        got = {k: getattr(traj, k)[:, lanes].clone() for k in
               ("obs", "action", "valid", "inverted", "logp", "reward")}
        last = type(final)(*(x[lanes] for x in final))
        got["last_obs"] = core.observe(last, traj.obs.dtype)
        got["last_inverted"] = last.inverted.clone()
        got["lanes"] = lanes.clone()
        got["all"] = {"action": traj.action.clone(),
                      "valid": traj.valid.clone(),
                      "success": final.success.clone(),
                      "n_cnots": final.n_cnots.clone(),
                      "n_gates": final.n_gates.clone()}
        return got

    # -------------------------------------------------------------- window
    def call(self, i: int):
        k = self.seq[i % len(self.seq)]
        self.capture = i if i < self.check_window else None
        t0 = time.perf_counter()
        out = self.rls.synth(_circuit(self.pool[k], self.n),
                             num_searches=self.lanes)
        t1 = time.perf_counter()
        return t0, t1, k, out

    def window(self, seconds: float, spans=None) -> None:
        from qiskit_gym_torch.rl import solve

        if spans is not None:
            spans.wrap(self.rls, "synth", "synth")
            spans.wrap(solve, "collect", "collect")
        self.start = time.perf_counter()
        i = 0
        while (i < self.check_window
               or time.perf_counter() - self.start < seconds):
            t0, t1, k, out = self.call(i)
            self.calls.append((t0, t1))
            self.outputs.append((k, out))
            i += 1
        self.ctx.sync()
        self.window_s = self.calls[-1][1] - self.start
        self.spans = ({k: list(v) for k, v in spans.times.items()}
                      if spans is not None else {})

    def traced(self, trace_sink: list) -> dict:
        """The traced stretch after the window: `trace_calls` more calls
        under the profiler. Returns the launch counters' deltas."""
        from qiskit_gym_torch.ops import fused_step as fs
        from qiskit_gym_torch.ops import metrics_kernel as mk

        counters = (fs.fused_step, fs.apply_gates, mk.metrics_update)
        before = [c.launches for c in counters]
        n0 = len(self.calls)
        with harness.profiled(self.ctx.sync, trace_sink):
            for j in range(int(self.tr["trace_calls"])):
                self.call(n0 + j)
        self.trace_calls = int(self.tr["trace_calls"])
        return {k: c.launches - b for k, c, b in
                zip(("fused_step_kernel", "apply_kernel", "metrics_kernel"),
                    counters, before)}

    def release(self) -> None:
        solve, inner = self._undo
        solve.collect = inner

        def host(x):
            return ({k: host(v) for k, v in x.items()} if isinstance(x, dict)
                    else x.cpu())

        self.captured = [(i, host(c)) for i, c in self.captured]
        del self.rls

    # --------------------------------------------------------------- check
    def check(self) -> list:
        """(name, value, limit) of every number compared; the run is correct
        where each value is at most its limit."""
        family = self.cfg["family"]
        verify = (tableau.verify_pauli if family == "pauli"
                  else tableau.verify_clifford)
        self.verified = []
        wrong = 0
        for k, out in self.outputs:
            ok = out is not None and verify(self.n, _gates(out), self.pool[k])
            wrong += out is not None and not ok
            self.verified.append(_gates(out) if ok else None)
        failed = sum(out is None for _, out in self.outputs)
        readings = self.compare(torch.float32)
        limits = self.cfg["limits"]["synth"]
        return ([("wrong_circuits", wrong, 0), ("failed_targets", failed, 0)]
                + [(k, readings[k], 0) for k in EXACT]
                + [("logp_gap", readings["logp_gap"], limits["logp_gap"])])

    def compare(self, dtype) -> dict:
        """The reference's readings of the captured calls: calls of the
        check window with nothing captured, or fewer lanes than sampled;
        the start state against the target and each step's transition;
        each step's reward from its action and the observations around it;
        every lane's 2q and gate counters from its actions, and the sampled
        lanes' success flags from their last observation; whether the
        returned circuit has the least 2q count among the lanes the program
        solved; and the largest gap between the log-probability the program
        recorded for a lane's action and the reference's. With `dtype`
        bfloat16 the reference computed in it stands in the program's
        place for the last."""
        strict_float32()
        dev = self.ctx.device
        policy = Policy(self.json, self.pt, dev)
        step = MatrixTransition(self.n, self.gateset, self.cfg["family"])
        costs = ref_metrics.action_costs(self.gateset)
        weights = ref_metrics.weights(self.art["env"])
        dim = 2 * self.n
        r = dict.fromkeys(EXACT, 0)
        r["logp_gap"] = 0.0
        got = {i for i, _ in self.captured}
        r["missing_captures"] = len(set(range(self.check_window)) - got) + sum(
            c["action"].shape[1] != (len(self.check_lanes) if i in self.sample
                                     else 1) for i, c in self.captured)
        for i, c in self.captured:
            k = self.seq[i % len(self.seq)]
            obs = torch.cat([c["obs"], c["last_obs"][None]]).numpy()
            act, valid = c["action"].numpy(), c["valid"].numpy()
            inverted = np.concatenate([c["inverted"].numpy(),
                                       c["last_inverted"].numpy()[None]])
            T, L = act.shape
            start = tableau.encoded_state(self.n, self.pool[k])
            pad = np.zeros(1, bool)
            for j in range(L):
                r["start_errors"] += not step.start_ok(obs[0, j, :, :dim],
                                                       start)
                r["transition_errors"] += step.errors(
                    obs[:, j, :, :dim], np.append(act[:, j], 0),
                    np.append(valid[:, j], pad), np.zeros(T + 1, bool),
                    inverted[:, j])
            left = ref_metrics.rotations_left(obs)
            ref = ref_metrics.step_rewards(
                ref_metrics.solved(obs[1:]), costs[0][act], costs[1][act],
                left[:-1] - left[1:], weights)
            reward = c["reward"].numpy()
            r["reward_errors"] += int(np.where(
                valid, np.abs(reward - ref) > ref_metrics.REWARD_ROUNDING,
                reward != 0).sum())

            a = c["all"]
            cnots, gates = ref_metrics.lane_counts(
                a["action"].numpy(), a["valid"].numpy(), costs)
            success = a["success"].numpy()
            r["counter_errors"] += int(
                ((cnots != a["n_cnots"].numpy())
                 | (gates != a["n_gates"].numpy())).sum()
                + (ref_metrics.solved(obs[-1])
                   != success[c["lanes"].numpy()]).sum())
            out = self.outputs[i][1] if i < len(self.outputs) else None
            if out is not None:
                r["best_lane_errors"] += bool(
                    not success.any() or ref_metrics.circuit_cnots(
                        _gates(out)) != cnots[success].min())

            rows = c["obs"][c["valid"]].to(dev)
            act_v = c["action"][c["valid"]].to(dev)[:, None]
            ref_logp = torch.log_softmax(policy(rows)[0], -1).gather(1, act_v)
            prog = (c["logp"][c["valid"]].to(dev)[:, None]
                    if dtype == torch.float32 else torch.log_softmax(
                        policy(rows, dtype)[0], -1).gather(1, act_v))
            if rows.shape[0]:
                r["logp_gap"] = max(r["logp_gap"],
                                    float((prog - ref_logp).abs().max()))
        return r

    # ------------------------------------------------------------- metrics
    def counts(self):
        failed = sum(v is None for v in self.verified)
        return len(self.outputs), failed

    def end_to_end(self) -> dict:
        q = int(self.tr["quality_calls"])
        twoq = [sum(1 for g in c if len(g[1]) == 2)
                for c in self.verified[:q] if c is not None]
        return {
            "synth_per_s": harness.whole_call_rate(self.calls, self.start),
            "synth_2q_mean": float(np.mean(twoq)) if twoq else None,
        }

    def record(self) -> SimpleNamespace:
        """What the per-layer readers read."""
        c = self.cfg
        return SimpleNamespace(
            spans=self.spans, window_s=self.window_s, calls=len(self.calls),
            lanes=self.lanes, steps_per_call=self.T,
            trace_calls=getattr(self, "trace_calls", 0),
            row_flops=costs.policy_flops(
                int(np.prod(c["obs_shape"])), c["embedding_size"],
                c["common_layers"], c["num_actions"], c["policy_layers"],
                c["value_layers"], c["policy_copies"]),
            b2_bytes=costs.b2_bytes(self.lanes, c["num_qubits"],
                                    c["track_layers"]))


def setup(ctx) -> Run:
    return Run(ctx)
