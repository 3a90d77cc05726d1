#!/usr/bin/env python3
"""One PPO iteration from a shipped artifact's weights, in either package.

    JAX_PLATFORMS=cpu python scripts/ppo_iteration_probe.py jax   [name] [difficulty] [seeds]
    python scripts/ppo_iteration_probe.py torch [name] [difficulty] [seeds]
    JAX_PLATFORMS=cpu python scripts/ppo_iteration_probe.py both  [name] [difficulty]

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
"""

import os
import sys

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


def probe_torch(paths, difficulty, seed):
    from qiskit_gym_torch.rl import RLSynthesis

    algo = RLSynthesis.from_config_json(*paths, device="cpu").algorithm
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


def main(argv):
    package = argv[1] if len(argv) > 1 else "torch"
    name = argv[2] if len(argv) > 2 else "clifford_heavy_hex_27q"
    difficulty = int(argv[3]) if len(argv) > 3 else 1
    seeds = int(argv[4]) if len(argv) > 4 else 3
    base = os.path.join(ROOT, "examples", "models", name)
    paths = (base + ".json", base + ".pt")
    if package == "both":
        probe_both(paths, difficulty)
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
