#!/usr/bin/env python3
"""One PPO iteration from a shipped artifact's weights, in either package.

    JAX_PLATFORMS=cpu python scripts/ppo_iteration_probe.py jax   [name] [difficulty] [seeds]
    python scripts/ppo_iteration_probe.py torch [name] [difficulty] [seeds]
    JAX_PLATFORMS=cpu python scripts/ppo_iteration_probe.py both  [name] [difficulty]
    JAX_PLATFORMS=cpu python scripts/ppo_iteration_probe.py stats [name] [difficulty] [seeds]
        [--arms jax,torch] [--reference rows.json] [--out rows.json]
        [--device cpu|cuda] [--first-seed 0]
    python scripts/ppo_iteration_probe.py merge rows.json ... [--blocks 24] [--out all.json]

Loads `examples/models/<name>.json` with its `.pt` weights (default
`clifford_heavy_hex_27q`), prints the config's evals at `difficulty` (default
1) before any update, runs one training iteration at that difficulty with the
JSON unchanged, and prints the collection success rate, the entropy of the
last epoch and the evals after it, once per seed (default 3). The torch side
runs on the CPU (`device="cpu"`); the rates it prints are success rates, not
times. It shows how far one iteration of the config's own update moves the
shipped policy against the curriculum gate (`diff_threshold`), in the JAX
package and in the port alike.

`both` collects one batch with the port, then runs the iteration's
minibatch updates in both packages on that batch with one set of numpy-made
permutations, and prints each epoch's last loss and entropy side by side and
the largest difference of any weight at the end: it separates a difference in
the update code from a difference in what was sampled.

`stats` runs `seeds` seeds (default 24) of each arm of `--arms` and prints,
for the gate metric after the iteration and the last epoch's entropy, each
arm's mean and SD, and against the first arm (or against the rows of
`--reference`, a file an earlier `--out` wrote) the Welch t and p and the
Mann-Whitney p; an arm that ran the seeds of the first arm is also compared
seed by seed. `--out` writes every row as JSON. The arms swap one piece of
the iteration between the packages (ARMS below lists them); an arm that
names `jax` needs the JAX package, the `torch` arm alone does not, and with
`--device cuda` it runs on the card. `merge` summarizes the rows of several
`--out` files as one run (seed ranges run apart with `--first-seed`), and
with `--blocks N` compares the arms within each run of N seeds.
"""

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def probe_jax(paths, difficulty, seed):
    import jax
    import jax.numpy as jnp
    from qiskit_gym_tpu.rl.synthesis import RLSynthesis

    algo = RLSynthesis.from_config_json(*paths).algorithm
    algo.key = jax.random.key(seed)
    before = algo.run_evals(difficulty)
    T, B = algo._horizon(difficulty), algo.config.num_episodes
    step = algo._make_train_step(T, B)
    algo.key, sub = jax.random.split(algo.key)
    algo.params, algo.opt_state, metrics = step(
        algo.params, algo.opt_state, sub, jnp.int32(difficulty))
    return before, {k: float(v) for k, v in metrics.items()}, \
        algo.run_evals(difficulty), algo.config


def probe_torch(paths, difficulty, seed, device="cpu"):
    from qiskit_gym_torch.rl import RLSynthesis

    algo = RLSynthesis.from_config_json(*paths, device=device).algorithm
    algo.generator.manual_seed(seed)
    before = algo.run_evals(difficulty)
    metrics = algo.train_step(algo._horizon(difficulty),
                              algo.config.num_episodes, difficulty)
    return before, metrics, algo.run_evals(difficulty), algo.config


def probe_both(paths, difficulty):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch
    from qiskit_gym_tpu.rl.synthesis import RLSynthesis as JaxRLSynthesis
    from qiskit_gym_torch.models import params_from_jax
    from qiskit_gym_torch.rl import RLSynthesis
    from qiskit_gym_torch.rl.rollout import collect_packed, gae

    ja = JaxRLSynthesis.from_config_json(*paths).algorithm
    ta = RLSynthesis.from_config_json(*paths, device="cpu").algorithm
    cfg = ta.config
    T, B = ta._horizon(difficulty), cfg.num_episodes
    _, traj, stats = collect_packed(ta.core, ta.policy, T, B, difficulty,
                                    pool_slots=cfg.pack_pool_slots,
                                    generator=ta.generator)
    adv, ret = gae(traj, cfg.gamma, cfg.gae_lambda,
                   last_value=stats["last_value"])
    N = T * B
    nmb = min(cfg.num_minibatches, N)
    mb = N // nmb
    flat = {"obs": traj.obs.reshape((N,) + traj.obs.shape[2:]),
            "action": traj.action.reshape(N), "logp": traj.logp.reshape(N),
            "valid": traj.valid.reshape(N), "adv": adv.reshape(N),
            "ret": ret.reshape(N)}
    jflat = {k: jnp.asarray(v.numpy(), jnp.int32 if k == "action" else None)
             for k, v in flat.items()}
    grad = jax.jit(jax.value_and_grad(ja._loss_flat, has_aux=True))
    jparams, jopt = ja.params, ja.opt_state
    rng = np.random.default_rng(0)
    ta.policy.train()
    for epoch in range(cfg.num_epochs):
        for ib in rng.permutation(N)[: mb * nmb].reshape(nmb, mb):
            (_, jaux), g = grad(jparams, {k: v[ib] for k, v in jflat.items()})
            updates, jopt = ja.tx.update(g, jopt, jparams)
            jparams = optax.apply_updates(jparams, updates)
            taux = ta._update(ta._loss_flat, {k: v[torch.as_tensor(ib)]
                                              for k, v in flat.items()})
        print(f"epoch {epoch}: jax loss {float(jaux['loss']):.4f} entropy "
              f"{float(jaux['entropy']):.4f} | torch loss "
              f"{float(taux['loss']):.4f} entropy "
              f"{float(taux['entropy']):.4f}", flush=True)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    worst = max(float((p.detach() - want[n]).abs().max())
                for n, p in ta.policy.module.named_parameters())
    print(f"largest weight difference after {cfg.num_epochs * nmb} updates: "
          f"{worst:.3g}")


# ------------------------------------------------------------------ stats
# Each arm runs one iteration for one seed and returns (before, metrics,
# after) as the probes above do. The pieces it swaps:
#   torch        the port's whole iteration (`PPO.train_step`), its evals
#   jax          the JAX package's whole iteration (its jitted train step)
#   jax-batch    the JAX package's `collect_packed` fills the batch that the
#                port's `train_step` updates on (GAE, `_fit`, evals: port)
#   torch-batch  the port's `collect_packed` + `gae` fill the batch of the
#                JAX package's epoch loop (its permutation keys, its evals)
#   numpy-perm   the port's iteration with numpy-made minibatch permutations
#   jax-noise:P  the port's iteration with the collection's draws P (any of
#                gumbel, flips, slots, rots, pool, joined by '+') drawn by
#                the JAX package from its own key split (with all five it
#                equals jax-batch row for row)
#   jax-draws    the port's train_step on every draw of the JAX train step
#                of the `jax` arm's seed, evaluated by the JAX package with
#                that arm's keys: a paired comparison of the arithmetic


def _jax_algo(paths):
    from qiskit_gym_tpu.rl.synthesis import RLSynthesis

    algo = RLSynthesis.from_config_json(*paths).algorithm
    return algo, algo.params


def _jax_reset(side, seed):
    import jax

    algo, p0 = side
    algo.params, algo.opt_state = p0, algo.tx.init(p0)
    algo.key = jax.random.key(seed)
    return algo


def _arm_jax(ctx, seed):
    import jax
    import jax.numpy as jnp

    algo = _jax_reset(ctx.jax(), seed)
    difficulty = ctx.difficulty
    before = algo.run_evals(difficulty)
    T, B = algo._horizon(difficulty), algo.config.num_episodes
    if (T, B) not in algo._train_cache:
        algo._train_cache[(T, B)] = algo._make_train_step(T, B)
    algo.key, sub = jax.random.split(algo.key)
    algo.params, algo.opt_state, metrics = algo._train_cache[(T, B)](
        algo.params, algo.opt_state, sub, jnp.int32(difficulty))
    return before, {k: float(v) for k, v in metrics.items()}, \
        algo.run_evals(difficulty)


def _arm_torch(ctx, seed):
    return probe_torch(ctx.paths, ctx.difficulty, seed, ctx.device)[:3]


def jax_iteration_draws(jppo, key, T, B, difficulty, device="cpu"):
    """What the JAX package's train step for `key` draws, as the port's
    `collect_packed` injection arguments (pool, gumbel, flips, slots,
    rots), and each epoch's permutation of the T * B rows (`fold_in(key,
    1)`, one key an epoch), as int64 tensors."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from qiskit_gym_tpu.rl.rollout import _pregen_randomness, make_packed_pool
    from qiskit_gym_torch.ops.matrix_env import state_from_arrays

    cfg = jppo.config
    _, k_roll = jax.random.split(key)
    k_pool, k_noise, k_slot, k_rot = jax.random.split(k_roll, 4)
    # a jax integer, as inside the jitted step: the reset draws the
    # scramble cap's actions and masks those past each lane's difficulty
    pool, _ = make_packed_pool(jppo.core, k_pool, B, cfg.pack_pool_slots,
                               jnp.int32(difficulty),
                               diff_replay=cfg.diff_replay)
    gumbel, flips, _ = _pregen_randomness(jppo.core, k_noise, T, B, False)

    def host(x):
        return torch.from_numpy(np.array(x))

    draws = {
        "pool": state_from_arrays({f: np.asarray(getattr(pool, f))
                                   for f in pool._fields}, device=device),
        "gumbel": host(gumbel), "flips": host(flips),
        "slots": host(jax.random.randint(k_slot, (T,), 0,
                                         cfg.pack_pool_slots)),
        "rots": host(jax.random.randint(k_rot, (T,), 0, B)),
    }
    epoch_keys = jax.random.split(jax.random.fold_in(key, 1), cfg.num_epochs)
    perms = [host(jax.random.permutation(k, T * B)).to(torch.int64)
             for k in epoch_keys]
    return draws, perms


def _noise_key(seed):
    """The key of the arms that draw from the JAX package apart from its
    own train step (jax-batch, jax-noise)."""
    import jax

    return jax.random.fold_in(jax.random.key(seed), 7)


@contextlib.contextmanager
def patched(collect=None, randperm=None):
    """`rl/ppo.py`'s `collect_packed` and `torch.randperm` (which `_fit`
    draws each epoch's permutation from) replaced inside the block."""
    import torch
    from qiskit_gym_torch.rl import ppo

    kept = ppo.collect_packed, torch.randperm
    if collect is not None:
        ppo.collect_packed = collect
    if randperm is not None:
        torch.randperm = randperm
    try:
        yield
    finally:
        ppo.collect_packed, torch.randperm = kept


def injected(draws):
    """`collect_packed` with `draws` injected."""
    from qiskit_gym_torch.rl.rollout import collect_packed

    return lambda *args, **kw: collect_packed(*args, **kw, **draws)


def _arm_jax_noise(pieces):
    def arm(ctx, seed):
        algo = ctx.jax()[0]
        draws, _ = jax_iteration_draws(
            algo, _noise_key(seed), algo._horizon(ctx.difficulty),
            algo.config.num_episodes, ctx.difficulty, ctx.device)
        with patched(collect=injected(
                {k: v for k, v in draws.items() if k in pieces})):
            return _arm_torch(ctx, seed)
    return arm


def _arm_jax_draws(ctx, seed):
    """Paired with the `jax` arm of the same seed: the port's `train_step`
    on every draw of the JAX train step (collection and permutations), its
    weights then evaluated by the JAX package with the `jax` arm's keys.
    What differs from that arm is the float arithmetic of the two
    implementations, and nothing that was sampled."""
    import jax
    import jax.numpy as jnp
    from qiskit_gym_torch.models import params_to_jax
    from qiskit_gym_torch.rl import RLSynthesis

    algo = _jax_reset(ctx.jax(), seed)
    difficulty = ctx.difficulty
    before = algo.run_evals(difficulty)
    T, B = algo._horizon(difficulty), algo.config.num_episodes
    algo.key, sub = jax.random.split(algo.key)
    draws, perms = jax_iteration_draws(algo, sub, T, B, difficulty,
                                       ctx.device)
    port = RLSynthesis.from_config_json(*ctx.paths,
                                        device=ctx.device).algorithm
    order = iter(perms)
    with patched(collect=injected(draws),
                  randperm=lambda n, generator=None, device=None: next(
                      order).to(device)):
        metrics = port.train_step(T, B, difficulty)
    algo.params = jax.tree.map(jnp.asarray, params_to_jax(
        port.policy.module.state_dict()))
    return before, metrics, algo.run_evals(difficulty)


def _arm_jax_batch(ctx, seed):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from qiskit_gym_tpu.rl.rollout import collect_packed as jax_collect
    from qiskit_gym_torch.rl.rollout import Trajectory

    algo = ctx.jax()[0]
    cfg = algo.config

    def collect(core, policy, T, B, difficulty, **kw):
        from qiskit_gym_torch.models import params_to_jax

        params = jax.tree.map(jnp.asarray,
                              params_to_jax(policy.module.state_dict()))
        # the collection key that jax_iteration_draws splits
        _, k_roll = jax.random.split(_noise_key(seed))
        _, traj, stats = jax_collect(
            algo.core, algo.policy.apply, params, k_roll, T, B,
            jnp.int32(difficulty), pool_slots=cfg.pack_pool_slots,
            diff_replay=cfg.diff_replay)

        def t(x, dtype=None):
            x = torch.from_numpy(np.array(x)).to(core.device)
            return x if dtype is None else x.to(dtype)

        traj = Trajectory(
            obs=t(traj.obs, torch.uint8), action=t(traj.action, torch.int64),
            actual=t(traj.actual, torch.int64), logp=t(traj.logp),
            value=t(traj.value), reward=t(traj.reward), valid=t(traj.valid),
            done=t(traj.done), inverted=t(traj.inverted),
            success=t(traj.success))
        return None, traj, {k: t(v) for k, v in stats.items()}

    with patched(collect=collect):
        return _arm_torch(ctx, seed)


def _arm_numpy_perm(ctx, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def randperm(n, generator=None, device=None, **_):
        return torch.from_numpy(rng.permutation(n)).to(device)

    with patched(randperm=randperm):
        return _arm_torch(ctx, seed)


def _arm_torch_batch(ctx, seed):
    """The port collects (its generator seeded with `seed`); the JAX
    package's epoch loop updates its own copy of the weights, with the
    permutation keys of its train step for key(seed), and evaluates."""
    import jax
    import jax.numpy as jnp
    import optax
    from qiskit_gym_torch.rl import RLSynthesis
    from qiskit_gym_torch.rl.rollout import collect_packed, gae

    ja = _jax_reset(ctx.jax(), seed)
    ta = RLSynthesis.from_config_json(*ctx.paths, device="cpu").algorithm
    ta.generator.manual_seed(seed)
    difficulty = ctx.difficulty
    before = ja.run_evals(difficulty)
    cfg = ta.config
    T, B = ta._horizon(difficulty), cfg.num_episodes
    _, traj, stats = collect_packed(ta.core, ta.policy, T, B, difficulty,
                                    pool_slots=cfg.pack_pool_slots,
                                    diff_replay=cfg.diff_replay,
                                    generator=ta.generator)
    adv, ret = gae(traj, cfg.gamma, cfg.gae_lambda,
                   last_value=stats["last_value"])
    N = T * B
    nmb = min(cfg.num_minibatches, N)
    mb = N // nmb
    flat = {"obs": traj.obs.reshape((N,) + traj.obs.shape[2:]),
            "action": traj.action.reshape(N), "logp": traj.logp.reshape(N),
            "valid": traj.valid.reshape(N), "adv": adv.reshape(N),
            "ret": ret.reshape(N)}
    jflat = {k: jnp.asarray(v.numpy(), jnp.int32 if k == "action" else None)
             for k, v in flat.items()}
    if ctx.grad is None:
        ctx.grad = jax.jit(jax.value_and_grad(ja._loss_flat, has_aux=True))
    ja.key, sub = jax.random.split(ja.key)
    params, opt = ja.params, ja.opt_state
    for ek in jax.random.split(jax.random.fold_in(sub, 1), cfg.num_epochs):
        idx = jax.random.permutation(ek, N)[: mb * nmb].reshape(nmb, mb)
        ents = []
        for ib in idx:
            (_, aux), g = ctx.grad(params, {k: v[ib] for k, v in jflat.items()})
            updates, opt = ja.tx.update(g, opt, params)
            params = optax.apply_updates(params, updates)
            ents.append(float(aux["entropy"]))
    ja.params, ja.opt_state = params, opt
    done = max(int(stats["episodes_completed"].sum()), 1)
    metrics = {"entropy": sum(ents) / len(ents),
               "success_rate": int(stats["episodes_succeeded"].sum()) / done}
    return before, metrics, ja.run_evals(difficulty)


ARMS = {"torch": _arm_torch, "jax": _arm_jax, "jax-batch": _arm_jax_batch,
        "torch-batch": _arm_torch_batch, "numpy-perm": _arm_numpy_perm,
        "jax-draws": _arm_jax_draws}


def arm_fn(name):
    if name.startswith("jax-noise:"):
        return _arm_jax_noise(set(name.split(":", 1)[1].split("+")))
    return ARMS[name]


class _Context:
    def __init__(self, paths, difficulty, device):
        self.paths, self.difficulty, self.device = paths, difficulty, device
        self._jax, self.grad = None, None

    def jax(self):
        if self._jax is None:
            self._jax = _jax_algo(self.paths)
        return self._jax


def summarize(values):
    import statistics

    return {"n": len(values), "mean": statistics.fmean(values),
            "sd": statistics.stdev(values) if len(values) > 1 else 0.0}


def compare(a, b):
    """Welch t and two-sided p, and the two-sided Mann-Whitney p, of the
    samples a against b."""
    from scipy import stats

    w = stats.ttest_ind(a, b, equal_var=False)
    u = stats.mannwhitneyu(a, b, alternative="two-sided")
    return {"welch_t": float(w.statistic), "welch_p": float(w.pvalue),
            "mannwhitney_p": float(u.pvalue)}


def report(rows, reference=None, blocks=0):
    """Prints (and returns) each arm's summary of `rows`: mean and SD of the
    gate eval after the iteration and of the entropy; against the first
    arm, or the first arm of the `reference` rows, Welch and Mann-Whitney;
    against an arm that ran the same seeds, the mean and SD of the paired
    differences and the count of equal values; with `blocks`, the same
    against the first arm within each run of `blocks` seeds."""
    import statistics

    arms = list(dict.fromkeys(r["arm"] for r in rows))
    groups = {arm: [r for r in rows if r["arm"] == arm] for arm in arms}
    base_name, base = arms[0], groups[arms[0]]
    if reference is not None:
        ref_arm = reference[0]["arm"]
        base_name = "reference " + ref_arm
        base = [r for r in reference if r["arm"] == ref_arm]
    by_seed = {r["seed"]: r for r in base}
    summary = {}
    for arm, rs in groups.items():
        summary[arm] = {}
        for key in ("after", "entropy"):
            s = summarize([r[key] for r in rs])
            line = (f"{arm}: {key} mean {s['mean']:.4f} sd {s['sd']:.4f} "
                    f"over {s['n']} seeds")
            if rs is not base and len(rs) > 1 and len(base) > 1:
                s.update(compare([r[key] for r in rs],
                                 [r[key] for r in base]))
                line += (f"; against {base_name}: Welch t {s['welch_t']:.2f}"
                         f" p {s['welch_p']:.3g}, Mann-Whitney p "
                         f"{s['mannwhitney_p']:.3g}")
                if len(rs) > 1 and all(r["seed"] in by_seed for r in rs):
                    d = [r[key] - by_seed[r["seed"]][key] for r in rs]
                    s["paired_mean"] = statistics.fmean(d)
                    s["paired_sd"] = statistics.stdev(d)
                    s["paired_equal"] = sum(abs(x) < 1e-4 for x in d)
                    line += (f"; paired by seed: difference mean "
                             f"{s['paired_mean']:.4f} sd {s['paired_sd']:.4f},"
                             f" {s['paired_equal']} of {len(d)} within 1e-4")
            summary[arm][key] = s
            print(line, flush=True)
    if blocks:
        for arm, rs in groups.items():
            if rs is base:
                continue
            for lo in range(0, max(r["seed"] for r in rs) + 1, blocks):
                a = [r["after"] for r in rs if lo <= r["seed"] < lo + blocks]
                b = [r["after"] for r in base
                     if lo <= r["seed"] < lo + blocks]
                if len(a) < 2 or len(b) < 2:
                    continue
                c = compare(a, b)
                print(f"seeds {lo}-{lo + blocks - 1}: after mean {arm} "
                      f"{statistics.fmean(a):.4f}, {base_name} "
                      f"{statistics.fmean(b):.4f}; Welch t "
                      f"{c['welch_t']:.2f} p {c['welch_p']:.3g}", flush=True)
    return summary


def write_rows(out, rows, summary, **meta):
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(dict(meta, rows=rows, summary=summary), f, indent=1)


def run_stats(paths, name, difficulty, seeds, arms, reference=None,
              out=None, device="cpu", first_seed=0):
    ctx = _Context(paths, difficulty, device)
    with open(paths[0]) as f:
        gate = json.load(f)["algorithm"]["learning"]["diff_metric"]
    rows = []
    for arm in arms:
        fn = arm_fn(arm)
        for seed in range(first_seed, first_seed + seeds):
            t0 = time.time()
            before, metrics, after = fn(ctx, seed)
            row = {"arm": arm, "seed": seed, "gate": gate,
                   "before": before[gate], "after": after[gate],
                   "entropy": metrics["entropy"],
                   "success_rate": metrics["success_rate"],
                   "seconds": time.time() - t0}
            rows.append(row)
            print(f"{arm} seed {seed}: {gate} before {row['before']:.4f} "
                  f"after {row['after']:.4f}, entropy after "
                  f"{row['entropy']:.4f}, collection success "
                  f"{row['success_rate']:.4f} ({row['seconds']:.1f} s)",
                  flush=True)
    if reference is not None:
        with open(reference) as f:
            reference = json.load(f)["rows"]
    summary = report(rows, reference)
    if out is not None:
        write_rows(out, rows, summary, name=name, difficulty=difficulty,
                   device=device, arms=arms)
    return summary


def run_merge(files, out=None, blocks=0):
    """The rows of several `--out` files of one artifact and difficulty
    (say, seed ranges run apart) summarized as one run."""
    rows, meta = [], {}
    for path in files:
        with open(path) as f:
            data = json.load(f)
        meta = {k: data[k] for k in ("name", "difficulty", "device")}
        rows += data["rows"]
    print(f"{meta['name']} difficulty {meta['difficulty']} on "
          f"{meta['device']}: {len(rows)} rows from {len(files)} files")
    summary = report(rows, blocks=blocks)
    if out is not None:
        write_rows(out, rows, summary,
                   arms=list(dict.fromkeys(r["arm"] for r in rows)), **meta)
    return summary


def _option(argv, flag, default=None):
    if flag in argv:
        i = argv.index(flag)
        value = argv[i + 1]
        del argv[i:i + 2]
        return value
    return default


def main(argv):
    argv = list(argv)
    arms = _option(argv, "--arms", "jax,torch").split(",")
    reference = _option(argv, "--reference")
    out = _option(argv, "--out")
    device = _option(argv, "--device", "cpu")
    first_seed = int(_option(argv, "--first-seed", "0"))
    blocks = int(_option(argv, "--blocks", "0"))
    if len(argv) > 1 and argv[1] == "merge":
        run_merge(argv[2:], out, blocks)
        return
    package = argv[1] if len(argv) > 1 else "torch"
    name = argv[2] if len(argv) > 2 else "clifford_heavy_hex_27q"
    difficulty = int(argv[3]) if len(argv) > 3 else 1
    seeds = int(argv[4]) if len(argv) > 4 else (24 if package == "stats"
                                                else 3)
    base = os.path.join(ROOT, "examples", "models", name)
    paths = (base + ".json", base + ".pt")
    if package == "both":
        probe_both(paths, difficulty)
        return
    if package == "stats":
        run_stats(paths, name, difficulty, seeds, arms, reference, out,
                  device, first_seed)
        return
    probe = {"jax": probe_jax, "torch": probe_torch}[package]
    for seed in range(seeds):
        before, metrics, after, cfg = probe(paths, difficulty, seed)
        gate = cfg.diff_metric
        print(f"{package} {name} difficulty {difficulty} seed {seed}: "
              f"{gate} before {before[gate]:.4f}, collection success "
              f"{metrics['success_rate']:.4f}, entropy after "
              f"{metrics['entropy']:.4f}, {gate} after {after[gate]:.4f} "
              f"(gate {cfg.diff_threshold})", flush=True)


if __name__ == "__main__":
    main(sys.argv)
