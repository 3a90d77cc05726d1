#!/usr/bin/env python
"""Solve rate of one quality-table eval row over several seeds, in the JAX
package or the port: how far one seed's row spreads, and, with --inject,
whether the port's lanes on the CPU and on the card follow the JAX
package's on the same targets and draws.

The lane run is the row's own (`bench_quality.eval_artifact`): E targets
reset at the difficulty, each on S lanes (sampled best-of-S policy
rollouts), or with --mcts N an argmax MCTS of N simulations a move; seed k
resets and rolls out from its own key (JAX) or generator (the port).

--inject FILE holds every side to the same inputs. The jax side writes to
FILE (.npz), for each seed, the lanes' initial env state (its own reset,
so the JAX tool's targets at its seed 1234 + difficulty), the collector's
draws in the port's keyword arguments and its lanes' success. The torch
side reads FILE, runs the port's collector from those states with those
draws on --device, and prints its rate beside the JAX side's and the
targets on which the two disagree.

Usage: [JAX_PLATFORMS=cpu] python probes/eval_seed_probe.py jax|torch
       <artifact> <difficulty> <episodes> <seed,seed,...>
       [--searches S] [--mcts N] [--device cpu|cuda] [--inject FILE]
(the JAX side runs where JAX runs; the port's default device is the CPU;
the JAX side of --inject needs the repository's tests directory)
"""
import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import numpy as np  # noqa: E402

DRAWS = ("root_gamma", "sim_flips", "sim_perms", "gumbel", "flips", "perms")


def jax_rates(name, diff, E, S, mcts, seeds, inject=None):
    """Yields (seed, solved [E]); with `inject` a dict that gathers each
    seed's initial states, draws and lanes for the port."""
    import jax
    import jax.numpy as jnp
    from qiskit_gym_tpu.rl import RLSynthesis
    from qiskit_gym_tpu.rl.az import collect_mcts
    from qiskit_gym_tpu.rl.rollout import collect

    rls = RLSynthesis.from_config_json(f"examples/models/{name}.json",
                                       f"examples/models/{name}.pt")
    core, algo = rls.algorithm.core, rls.algorithm
    T = min(core.depth_slope * diff, core.max_depth)
    if mcts:
        run = jax.jit(lambda s, k: collect_mcts(
            core, algo.policy.apply, algo.params, s, k, T, num_sims=mcts,
            c_puct=1.41, deterministic=True)[0].success)
    else:
        run = jax.jit(lambda s, k: collect(
            core, algo.policy.apply, algo.params, s, k, T)[0].success)
    for seed in seeds:
        k_reset, k_roll = jax.random.split(jax.random.key(seed))
        state = core.reset(k_reset, E, diff)
        state = jax.tree.map(lambda x: jnp.repeat(x, S, axis=0), state)
        lanes = np.asarray(run(state, k_roll))
        if inject is not None:
            for f in state._fields:
                inject[f"{seed}/state/{f}"] = np.asarray(getattr(state, f))
            inject[f"{seed}/success"] = lanes
            for k, v in _jax_draws(core, k_roll, T, mcts, E * S).items():
                if v is not None:
                    inject[f"{seed}/{k}"] = v
        yield seed, lanes.reshape(E, S).any(1)


def _jax_draws(core, key, T, mcts, B):
    """The draws the JAX collector makes from `key`, by the splits the
    port's tests replay (tests/test_torch_az.py, test_torch_tools.py)."""
    import torch
    from qiskit_gym_tpu.rl.rollout import _pregen_randomness

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    if mcts:
        from test_torch_az import jax_move_draws

        draws = jax_move_draws(core, key, T, mcts, 1, B)
    else:
        gumbel, flips, _ = _pregen_randomness(core, key, T, B, False)
        draws = {"gumbel": np.asarray(gumbel), "flips": np.asarray(flips)}
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in draws.items()}


def port_rates(name, diff, E, S, mcts, seeds, device, inject=None):
    import torch
    from qiskit_gym_torch.ops.matrix_env import state_from_arrays
    from qiskit_gym_torch.rl import collect_mcts
    from qiskit_gym_torch.rl.rollout import collect
    from qiskit_gym_torch.tools.bench_quality import C_PUCT, eval_lanes, load

    algo = load(name, device).algorithm
    core = algo.core
    T = min(core.depth_slope * diff, core.max_depth)
    for seed in seeds:
        g = torch.Generator(device=algo.device).manual_seed(seed)
        if inject is None:
            success, _ = eval_lanes(algo, diff, E, S, mcts, mcts > 0, g)
            yield seed, success.reshape(E, S).any(1)
            continue
        # eval_lanes' collector call, from the JAX side's initial states
        draws = {k: torch.from_numpy(inject[f"{seed}/{k}"]) for k in DRAWS
                 if f"{seed}/{k}" in inject}
        cls = type(core._fresh(1))
        state = state_from_arrays(
            {f: inject[f"{seed}/state/{f}"] for f in cls._fields},
            device=algo.device, cls=cls)
        if mcts:
            final, _ = collect_mcts(core, algo.policy, state, T,
                                    num_sims=mcts, c_puct=C_PUCT,
                                    deterministic=True, generator=g, **draws)
        else:
            final, _ = collect(core, algo.policy, state, T, generator=g,
                               **draws)
        yield seed, final.success.cpu().numpy().reshape(E, S).any(1)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("side", choices=["jax", "torch"])
    p.add_argument("artifact")
    p.add_argument("difficulty", type=int)
    p.add_argument("episodes", type=int)
    p.add_argument("seeds")
    p.add_argument("--searches", type=int, default=10)
    p.add_argument("--mcts", type=int, default=0)
    p.add_argument("--device", default="cpu")
    p.add_argument("--inject", default=None)
    a = p.parse_args()
    seeds = [int(x) for x in a.seeds.split(",")]
    S = 1 if a.mcts else a.searches
    inject = None
    if a.inject is not None:
        inject = {} if a.side == "jax" else dict(np.load(a.inject))
    rows = (jax_rates(a.artifact, a.difficulty, a.episodes, S, a.mcts, seeds,
                      inject)
            if a.side == "jax" else
            port_rates(a.artifact, a.difficulty, a.episodes, S, a.mcts,
                       seeds, a.device, inject))
    rates = []
    for seed, solved in rows:
        rates.append(float(solved.mean()))
        line = (f"{a.side} {a.artifact} d{a.difficulty} seed {seed}: "
                f"{rates[-1]:.4f} of {a.episodes}")
        if inject is not None and a.side == "torch":
            want = inject[f"{seed}/success"].reshape(a.episodes, S).any(1)
            line += (f" (JAX {want.mean():.4f}; targets that disagree: "
                     f"{np.flatnonzero(want != solved).tolist()})")
        print(line, flush=True)
    print(f"{a.side} {a.artifact} d{a.difficulty}: mean {np.mean(rates):.4f}"
          f" over {len(rates)} seeds, min {min(rates):.4f}, max "
          f"{max(rates):.4f}", flush=True)
    if inject is not None and a.side == "jax":
        np.savez_compressed(a.inject, **inject)


if __name__ == "__main__":
    main()
