"""Back-to-back PPO iterations: `algorithm.train_step(horizon, lanes,
difficulty)` on a shipped artifact's PPO algorithm, from its weights, each
call after the one before. One call collects horizon x lanes env steps with
the config's own collector and runs its epochs x minibatches of Adam.

Traffic keys: `horizon`, `lanes`, `difficulty`, `check_lanes` (lanes of a
collection the reference reads), `follow_steps` (the Adam steps of a call
it follows), `trace_calls`.

Set-up makes one call, the first of the object that the window then drives.
The reference follows it and the window's last call: the rows each
collected (their transitions, rewards, log-probabilities and advantages, on
the sampled lanes) and its first Adam steps (each step's loss, the first
gradient, the change of the weights). The first call starts from the
shipped weights, which the reference loads itself; the last from the
program's own weights and Adam state, as they were when it began.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
from portbench.metrics import costs
from portbench.reference import metrics as ref_metrics
from portbench.reference import ppo as ref_ppo
from portbench.reference.policy import (MatrixTransition, Policy,
                                        load_artifact, strict_float32)

FIELDS = ("obs", "action", "valid", "done", "inverted", "reward", "value",
          "logp")
# Numbers compared exactly (limit 0), and those with a limit, for the first
# call and (prefixed `last_`) the window's last.
EXACT = ("missing_captures", "transition_errors", "reward_errors")
GAPS = ("logp_gap", "gae_gap", "loss_gap", "grad_gap", "update_gap")


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's."""
    norms = {k: _norm(v) for k, v in ref.items()}
    med = float(np.median(list(norms.values())))
    return max(abs(_norm(prog[k]) - norms[k]) / max(norms[k], med)
               for k in keep)


class Run:
    def __init__(self, ctx):
        from qiskit_gym_torch.rl import ppo
        from qiskit_gym_torch.rl.synthesis import RLSynthesis

        cell, tr = ctx.cell, dict(ctx.cell.traffic, **ctx.overrides)
        self.ctx, self.tr, self.cfg = ctx, tr, cell.config
        art = self.cfg["artifact"]
        self.json, self.pt = str(cell.path(art["json"])), str(
            cell.path(art["pt"]))
        self.art = load_artifact(self.json)
        rls = RLSynthesis.from_config_json(self.json, self.pt,
                                           device=ctx.device)
        self.algo = algo = rls.algorithm
        algo.generator.manual_seed(ctx.seed)
        core = rls.env.core
        if (list(core.obs_shape) != self.cfg["obs_shape"]
                or core.num_actions != self.cfg["num_actions"]):
            raise ValueError("the artifact does not have the configuration's "
                             "widths")
        self.n = core.num_qubits
        self.T, self.B = int(tr["horizon"]), int(tr["lanes"])
        self.difficulty = int(tr["difficulty"])
        rng = np.random.default_rng(ctx.seed)
        self.lanes = torch.as_tensor(
            np.sort(rng.choice(self.B, size=min(int(tr["check_lanes"]),
                                                self.B), replace=False)),
            device=ctx.device)
        self.follow = int(tr["follow_steps"])
        if self.cfg["family"] != "clifford":
            raise NotImplementedError("the reference's training rewards "
                                      "cover the matrix envs only")
        self.records, self.rec, self.recording = 0, None, True
        self._undo = self._hooks(ppo)
        if ctx.plant is not None:
            ctx.plant(self)
        algo.train_step(self.T, self.B, self.difficulty)
        self.first = self.rec
        self.calls = []

    def _hooks(self, ppo):
        """Wrap the collector, `_fit` and `_update`, so that each call
        records in `self.rec`, on the card, what the reference reads: the
        sampled lanes' rows, the weights and Adam state the update starts
        from, the advantages, and its first `follow_steps` Adam steps. They
        record until the window closes."""
        algo, lanes = self.algo, self.lanes
        collect, fit, update = ppo.collect_packed, algo._fit, algo._update
        names = dict(algo.policy.module.named_parameters())
        opt = algo.optimizer

        def adam_state():
            st = opt.state
            return {k: tuple(st[p][x].clone() for x in
                             ("exp_avg", "exp_avg_sq", "step"))
                    for k, p in names.items() if "exp_avg" in st.get(p, {})}

        def params():
            return {k: p.detach().clone() for k, p in names.items()}

        def collect_packed(*args, **kwargs):
            final, traj, stats = collect(*args, **kwargs)
            if not self.recording:
                return final, traj, stats
            self.records += 1
            self.rec = {"rows": {k: getattr(traj, k)[:, lanes].clone()
                                 for k in FIELDS},
                        "last_value": stats["last_value"][lanes].clone(),
                        "batches": [], "losses": []}
            return final, traj, stats

        def _fit(flat, B, *args):
            if not self.recording or self.rec is None or "start" in self.rec:
                return fit(flat, B, *args)
            for k in ("adv", "ret"):
                self.rec[k] = flat[k].reshape(-1, B)[:, lanes].clone()
            self.rec["start"], self.rec["adam0"] = params(), adam_state()
            return fit(flat, B, *args)

        def _update(loss_fn, batch):
            rec = self.rec
            aux = update(loss_fn, batch)
            if rec is None or "start" not in rec:
                return aux
            step = len(rec["losses"])
            if self.recording and step < self.follow:
                rec["batches"].append(batch)
                rec["losses"].append(aux["loss"].detach().clone())
                if step == 0:
                    rec["adam1"] = adam_state()
                if step == self.follow - 1:
                    rec["params"] = params()
            return aux

        ppo.collect_packed = collect_packed
        algo._fit, algo._update = _fit, _update
        return [(ppo, "collect_packed", collect),
                (algo, "_fit", fit), (algo, "_update", update)]

    def _unhook(self) -> None:
        for owner, attr, inner in self._undo:
            if owner is self.algo:
                delattr(owner, attr)
            else:
                setattr(owner, attr, inner)

    # -------------------------------------------------------------- window
    def window(self, seconds: float, spans=None) -> None:
        from qiskit_gym_torch.rl import ppo

        if spans is not None:
            spans.wrap(ppo, "collect_packed", "collect")
            spans.wrap(self.algo, "_fit", "update")
        self.start = time.perf_counter()
        while not self.calls or time.perf_counter() - self.start < seconds:
            t0 = time.perf_counter()
            self.algo.train_step(self.T, self.B, self.difficulty)
            self.calls.append((t0, time.perf_counter()))
        self.ctx.sync()
        self.window_s = self.calls[-1][1] - self.start
        self.spans = ({k: list(v) for k, v in spans.times.items()}
                      if spans is not None else {})
        self.last, self.recording = self.rec, False

    def traced(self, trace_sink: list) -> dict:
        from qiskit_gym_torch.ops import fused_step as fs
        from qiskit_gym_torch.ops import metrics_kernel as mk

        counters = (fs.fused_step, fs.apply_gates, mk.metrics_update)
        before = [c.launches for c in counters]
        with harness.profiled(self.ctx.sync, trace_sink):
            for _ in range(int(self.tr["trace_calls"])):
                self.algo.train_step(self.T, self.B, self.difficulty)
        self.trace_calls = int(self.tr["trace_calls"])
        return {k: c.launches - b for k, c, b in
                zip(("fused_step_kernel", "apply_kernel", "metrics_kernel"),
                    counters, before)}

    def release(self) -> None:
        self.epochs = self.algo.config.num_epochs
        self.minibatches = self.algo.config.num_minibatches
        self._unhook()
        for rec in (self.first, self.last):
            if rec is not None:
                rec["losses"] = [float(x) for x in rec["losses"]]
        del self.algo

    # --------------------------------------------------------------- check
    def check(self) -> list:
        r = self.compare(torch.float32)
        limits = self.cfg["limits"]["ppo_train"]
        return ([(k, r[k], 0) for k in EXACT]
                + [(p + k, r[p + k], limits[p + k]) for p in ("", "last_")
                   for k in GAPS])

    @staticmethod
    def _complete(rec) -> bool:
        return rec is not None and "params" in rec

    def missing(self) -> int:
        """Calls with no record, or with one short of what the reference
        follows: every call of set-up and window records one."""
        short = sum(not self._complete(r) for r in (self.first, self.last))
        return abs(1 + len(self.calls) - self.records) + short

    def compare(self, dtype, half_batch: bool = False) -> dict:
        """The readings of the first and the last call against the float32
        reference, the last's prefixed `last_`. With `dtype` bfloat16 the
        reference computed in it stands where the program's numbers stood
        (the control); `half_batch` does the same with every minibatch's
        mean taken over its first half (a fault)."""
        strict_float32()
        policy = Policy(self.json, self.pt, self.ctx.device)
        out = {"missing_captures": self.missing()}
        for prefix, rec in (("", self.first), ("last_", self.last)):
            if not self._complete(rec):
                # nothing to read: -1 marks it; missing_captures fails it
                r = dict(dict.fromkeys(GAPS, -1.0), transition_errors=0,
                         reward_errors=0)
            else:
                r = self._readings(policy, rec, rec is self.first, dtype,
                                   half_batch)
            for k in ("transition_errors", "reward_errors"):
                out[k] = out.get(k, 0) + r.pop(k)
            out.update({prefix + k: v for k, v in r.items()})
        return out

    def _readings(self, policy, rec, first: bool, dtype, half_batch) -> dict:
        dev = self.ctx.device
        train = self.art["algorithm"]["training"]
        collecting = self.art["algorithm"]["collecting"]
        lr = self.art["algorithm"]["optimizer"]["lr"]
        b1 = ref_ppo.Adam.BETAS[0]
        start = (policy.sd if first else
                 {k: v.to(dev) for k, v in rec["start"].items()})
        adam0 = {k: tuple(x.to(dev) for x in v)
                 for k, v in rec["adam0"].items()}
        rows = {k: v.to(dev) for k, v in rec["rows"].items()}
        T, L = rows["action"].shape
        obs = rows["obs"].reshape((T * L,) + rows["obs"].shape[2:])

        step = MatrixTransition(self.n, policy.gateset, self.cfg["family"])
        host = {k: v.cpu().numpy() for k, v in rec["rows"].items()}
        trans = sum(step.errors(*(host[k][:, j] for k in (
            "obs", "action", "valid", "done", "inverted")))
            for j in range(L))
        act, valid = host["action"], host["valid"]
        solved = np.array([[step.solves(host["obs"][t, j], act[t, j])
                            for j in range(L)] for t in range(T)])
        costs = ref_metrics.action_costs(policy.gateset)
        ref_reward = ref_metrics.step_rewards(
            solved, costs[0][act], costs[1][act], np.zeros_like(act),
            ref_metrics.weights(self.art["env"]))
        got = host["reward"]
        rewards = int(np.where(
            valid, np.abs(got - ref_reward) > ref_metrics.REWARD_ROUNDING,
            got != 0).sum() + (valid & solved & ~host["done"]).sum())

        with torch.no_grad():
            logits, value = policy(obs, sd=start)
        logits, value = logits.reshape(T, L, -1), value.reshape(T, L)
        ref_logp = torch.log_softmax(logits, -1).gather(
            2, rows["action"][..., None])[..., 0]
        reward = torch.as_tensor(ref_reward, device=dev)
        prog_logp, prog_adv = rows["logp"], rec["adv"].to(dev)
        if dtype != torch.float32:
            with torch.no_grad():
                lg, v = policy(obs, dtype, sd=start)
            prog_logp = torch.log_softmax(lg.reshape(T, L, -1), -1).gather(
                2, rows["action"][..., None])[..., 0]
            prog_adv, _ = ref_ppo.gae(
                reward, v.reshape(T, L), rows["valid"], rows["done"],
                rec["last_value"].to(dev), collecting["gamma"],
                collecting["lambda"])
        valid_t = rows["valid"]
        logp_gap = float((prog_logp - ref_logp).abs()[valid_t].max())
        ref_adv, _ = ref_ppo.gae(
            reward, value, valid_t, rows["done"], rec["last_value"].to(dev),
            collecting["gamma"], collecting["lambda"])
        gae_gap = float((prog_adv - ref_adv).abs()[valid_t].max()
                        / ref_adv.abs()[valid_t].max())

        batches = [{k: v.to(dev) for k, v in b.items()}
                   for b in rec["batches"]]
        losses, grad, params = ref_ppo.follow(start, batches, policy, train,
                                              lr, adam=adam0)
        p_losses = rec["losses"]
        p_params = {k: v.to(dev) for k, v in rec["params"].items()}
        p_grad = {k: torch.zeros_like(v) for k, v in start.items()}
        for k, (m1, _, _) in rec["adam1"].items():
            m0 = adam0[k][0].double() if k in adam0 else 0.0
            p_grad[k] = (m0 + (m1.to(dev).double() - m0) / (1 - b1)).float()
        if dtype != torch.float32 or half_batch:
            if half_batch:
                batches = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
                           for b in batches]
            p_losses, p_grad, p_params = ref_ppo.follow(
                start, batches, policy, train, lr, dtype, adam=adam0)
        gnorm = {k: _norm(v) for k, v in grad.items()}
        med = float(np.median(list(gnorm.values())))
        keep = [k for k, v in gnorm.items() if v >= 1e-3 * med]
        ref_change = {k: params[k] - start[k] for k in keep}
        prog_change = {k: p_params[k] - start[k] for k in keep}
        return {
            "transition_errors": trans,
            "reward_errors": rewards,
            "logp_gap": logp_gap,
            "gae_gap": gae_gap,
            "loss_gap": max(abs(a - b) for a, b in zip(p_losses, losses)),
            "grad_gap": leaf_gap({k: p_grad[k].to(dev) for k in keep},
                                 {k: grad[k] for k in keep}, keep),
            "update_gap": leaf_gap(prog_change, ref_change, keep),
            "left_out": sorted(set(grad) - set(keep)),
        }

    # ------------------------------------------------------------- metrics
    def counts(self):
        return len(self.calls), 0

    def end_to_end(self) -> dict:
        steps = len(self.calls) * self.T * self.B
        return {"train_env_steps_per_s":
                steps / (self.calls[-1][1] - self.start)}

    def record(self) -> SimpleNamespace:
        c = self.cfg
        rows = self.T * self.B
        mb = rows // self.minibatches
        return SimpleNamespace(
            spans=self.spans, window_s=self.window_s, calls=len(self.calls),
            trace_calls=getattr(self, "trace_calls", 0),
            collect_rows=rows + self.B,
            update_rows=self.epochs * self.minibatches * mb,
            row_flops=costs.policy_flops(
                int(np.prod(c["obs_shape"])), c["embedding_size"],
                c["common_layers"], c["num_actions"], c["policy_layers"],
                c["value_layers"], c["policy_copies"]))


def setup(ctx) -> Run:
    return Run(ctx)
