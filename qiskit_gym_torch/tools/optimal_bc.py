"""Exact distance tables and optimal-demo BC for the head-to-head configs.

Port of the JAX package's `scripts/optimal_bc.py`. The three configs with
a reference artifact have fully enumerable phase-less state groups:
`perm_grid_3x3` is S_9 (9! = 362,880 states), `lf_5_line` generates
GL(5,2) (9,999,360), `clifford_3q_custom` a subgroup of Sp(6,2) (at most
1,451,520). Every generator is an involution in these representations
(CX/SWAP over GF(2); phase-less S^2 = SX^2 = H^2 = I), so one vectorized
BFS from the identity over packed-int states gives the exact
distance-to-identity table of the artifact's own gateset.

From that table the corpus samples uniformly over each distance shell and
records greedy-optimal trajectories (every step lowers the distance by
one, ties broken at random), and the shipped policy is behavior-cloned on
them with the AlphaZero loss (`rl/demos.fit_demos`) on the card. A burst's
weights are kept only when they score strictly better on the head-to-head
protocol (same-or-higher solve, lower mean 2q, seeds 777 + depth, disjoint
from the published table's).

The group code is host numpy, as in the JAX script. BFS transitions are
validated against the spec env on random replays before anything trains.

Usage: python -m qiskit_gym_torch.tools.optimal_bc <stem> [minutes]
       [--lr LR] [--epochs N] [--out DIR]
       [--device cuda|cpu]
stem in {perm_grid_3x3, lf_5_line, clifford_3q_custom}. Evidence rows go
to `<out>/evidence.jsonl`, an improved artifact to `<out>/<stem>.{json,pt}`
(default out: runs/torch/<stem>_optimal_bc).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

from qiskit_gym_torch.examples._common import (Evidence, artifact, out_dir,
                                               shipped)
from qiskit_gym_torch.rl import AlphaZeroConfig, RLSynthesis, fit_demos
from qiskit_gym_torch.rl.demos import prepare_demos

from .vs_reference import (_count_2q, _cliff_ck, _lf_ck, _perm_ck,
                           _random_target)

FAMILIES = {"perm_grid_3x3": "perm", "lf_5_line": "linear",
            "clifford_3q_custom": "clifford"}
CHECKERS = {
    "lf_5_line": (_lf_ck, [4, 8, 16]),
    "clifford_3q_custom": (_cliff_ck, [4, 8, 16]),
    "perm_grid_3x3": (_perm_ck, [4, 8, 16]),
}
SEED = 20260821                # the spec replay and the corpus draws

U64 = np.uint64


def _quiet(_msg):
    pass


def _row_ops(dim):
    """Packed-int row primitives: bit (dim*r + c) of the key = mat[r, c]."""
    mask = U64((1 << dim) - 1)

    def get_row(k, r):
        return (k >> U64(dim * r)) & mask

    def xor_row(k, src, dst):          # row dst ^= row src
        return k ^ (get_row(k, src) << U64(dim * dst))

    def swap_rows(k, r1, r2):
        x = get_row(k, r1) ^ get_row(k, r2)
        return k ^ (x << U64(dim * r1)) ^ (x << U64(dim * r2))

    return get_row, xor_row, swap_rows


def matrix_actions(gateset, num_qubits, kind):
    """One key->key callable per gateset action (the spec envs' row
    semantics: spec/linear_function.py, spec/clifford.py)."""
    n = num_qubits
    dim = 2 * n if kind == "clifford" else n
    _, xor_row, swap_rows = _row_ops(dim)
    fns = []
    for name, qs in gateset:
        if kind == "linear":
            if name == "CX":
                q1, q2 = qs
                fns.append(lambda k, a=q1, b=q2: xor_row(k, a, b))
            elif name == "SWAP":
                q1, q2 = qs
                fns.append(lambda k, a=q1, b=q2: swap_rows(k, a, b))
            else:                      # 1q gates are no-ops on GF(2) mats
                fns.append(lambda k: k)
        else:
            if name == "H":
                (q,) = qs
                fns.append(lambda k, a=q: swap_rows(k, a, n + a))
            elif name in ("S", "Sdg"):
                (q,) = qs
                fns.append(lambda k, a=q: xor_row(k, a, n + a))
            elif name in ("SX", "SXdg"):
                (q,) = qs
                fns.append(lambda k, a=q: xor_row(k, n + a, a))
            elif name == "CX":
                c, t = qs
                fns.append(lambda k, a=c, b=t:
                           xor_row(xor_row(k, a, b), n + b, n + a))
            elif name == "CZ":
                a_, b_ = qs
                fns.append(lambda k, a=a_, b=b_:
                           xor_row(xor_row(k, b, n + a), a, n + b))
            elif name == "SWAP":
                a_, b_ = qs
                fns.append(lambda k, a=a_, b=b_:
                           swap_rows(swap_rows(k, a, b), n + a, n + b))
            else:
                raise ValueError(name)
    return fns, dim


def perm_actions(gateset, n):
    """Packed base-n keys for permutation states (spec/permutation.py)."""
    pows = (n ** np.arange(n)).astype(np.uint64)

    def unpack(keys):
        out = np.empty((len(keys), n), np.int64)
        k = keys.astype(np.uint64).copy()
        for i in range(n):
            out[:, i] = (k % U64(n)).astype(np.int64)
            k //= U64(n)
        return out

    def pack(states):
        return (states.astype(np.uint64) * pows[None, :]).sum(axis=1)

    fns = []
    for name, (q1, q2) in gateset:
        if name != "SWAP":
            raise ValueError(f"a permutation gateset holds SWAPs, not {name}")

        def f(k, a=q1, b=q2):
            s = unpack(np.atleast_1d(k))
            s[:, [a, b]] = s[:, [b, a]]
            return pack(s)

        fns.append(f)
    return fns, unpack, pack


def bfs(fns, ident_key, log):
    """Vectorized BFS from the identity; returns (shells, sorted keys,
    parallel dist array). Valid because every generator is an involution
    (the Cayley graph is undirected), which the spec replay checks."""
    shells = [np.array([ident_key], np.uint64)]
    visited = shells[0].copy()
    while True:
        frontier = shells[-1]
        cands = np.unique(np.concatenate([f(frontier) for f in fns]))
        pos = np.searchsorted(visited, cands).clip(0, len(visited) - 1)
        new = cands[visited[pos] != cands]
        if not len(new):
            break
        shells.append(new)
        visited = np.union1d(visited, new)
        log(f"  shell {len(shells) - 1}: {len(new)} states "
            f"({len(visited)} total)")
    dist = np.empty(len(visited), np.uint8)
    for d, sh in enumerate(shells):
        dist[np.searchsorted(visited, sh)] = d
    return shells, visited, dist


def bfs_2q(fns, costs, ident_key, log=_quiet):
    """0/1-cost Dial BFS: 1q gates cost 0 2q gates, CX/SWAP cost 1 (as
    vs_reference._count_2q counts any 2q gate as one). Each cost level is
    closed under 0-cost edges before the next 1-cost expansion, so the
    first reach is the exact least 2q count. Returns (sorted keys,
    dist2q)."""
    zero = [f for f, c in zip(fns, costs) if c == 0]
    one = [f for f, c in zip(fns, costs) if c > 0]
    if any(c not in (0, 1) for c in costs):
        raise ValueError(f"costs must be 0 or 1, not {sorted(set(costs))}")

    def expand_new(frontier, visited, fns_):
        if not len(frontier) or not fns_:
            return np.array([], np.uint64), visited
        cand = np.unique(np.concatenate([f(frontier) for f in fns_]))
        pos = np.searchsorted(visited, cand).clip(0, len(visited) - 1)
        new = cand[visited[pos] != cand]
        return new, np.union1d(visited, new)

    def close_zero(level, visited):
        frontier = level
        while True:
            frontier, visited = expand_new(frontier, visited, zero)
            if not len(frontier):
                return level, visited
            level = np.concatenate([level, frontier])

    visited = np.array([ident_key], np.uint64)
    level, visited = close_zero(visited.copy(), visited)
    levels = [level]
    while True:
        seed, visited = expand_new(levels[-1], visited, one)
        if not len(seed):
            break
        level, visited = close_zero(seed, visited)
        levels.append(level)
        log(f"  2q-level {len(levels) - 1}: {len(level)} states "
            f"({len(visited)} total)")
    dist2q = np.empty(len(visited), np.uint8)
    for d, lvl in enumerate(levels):
        dist2q[np.searchsorted(visited, np.unique(lvl))] = d
    return visited, dist2q


def steps_under_min2q(keys_sorted, dist2q, fns, costs, ident_key):
    """The least ACTION count among least-2q paths to the identity, per
    state. Needed for a greedy descent that ends when 1q actions cost 0:
    processed level by level (a least-2q path from 2q-level L uses only
    level-L states through 0-cost edges, which involutions make
    undirected, plus exactly one 1-cost edge down to L-1), with Bellman
    relaxation inside each level."""
    zero = [f for f, c in zip(fns, costs) if c == 0]
    one = [f for f, c in zip(fns, costs) if c > 0]
    INF = np.int32(1 << 30)
    steps = np.full(len(keys_sorted), INF, np.int32)

    def idx(keys):
        return np.searchsorted(keys_sorted, keys)

    steps[idx(np.array([ident_key], np.uint64))] = 0
    for L in range(int(dist2q.max()) + 1):
        lvl_keys = keys_sorted[dist2q == L]
        li = idx(lvl_keys)
        if L > 0:
            for f in one:
                ni = idx(f(lvl_keys))
                cand = np.where(dist2q[ni] == L - 1, steps[ni] + 1, INF)
                steps[li] = np.minimum(steps[li], cand)
        frontier = lvl_keys[steps[li] < INF]
        while len(frontier) and zero:
            improved = []
            for f in zero:
                nk = f(frontier)
                ni = idx(nk)
                cand = steps[idx(frontier)] + 1
                better = (dist2q[ni] == L) & (cand < steps[ni])
                if better.any():
                    np.minimum.at(steps, ni[better], cand[better])
                    improved.append(nk[better])
            frontier = (np.unique(np.concatenate(improved)) if improved
                        else np.array([], np.uint64))
    if steps.max() >= INF:
        raise AssertionError("some state was never relaxed")
    return steps


class Family(NamedTuple):
    """A config's packed-int group: its actions, the identity's key, the
    2q cost of each action, and the maps between keys and the env's and
    the spec env's states."""
    kind: str
    fns: List[Callable]
    ident: np.uint64
    costs: List[int]
    encode: Callable          # env.get_state(target) -> key
    obs_bits: Callable        # keys [N] -> uint8 [N, obs bits]
    spec_state: Callable      # key [1] -> what spec.set_state takes
    key_of_spec: Callable     # spec env -> key


def family(stem, env) -> Family:
    n = env.config["num_qubits"]
    gateset = env.gateset
    kind = FAMILIES[stem]
    costs = [0 if len(g[1]) == 1 else 1 for g in gateset]
    if kind == "perm":
        fns, unpack, pack = perm_actions(gateset, n)

        def obs_bits(keys):
            s = unpack(keys)
            out = np.zeros((len(keys), n, n), np.uint8)
            out[np.arange(len(keys))[:, None], np.arange(n)[None, :], s] = 1
            return out.reshape(len(keys), -1)

        return Family(
            kind, fns, pack(np.arange(n, dtype=np.int64)[None])[0], costs,
            lambda state: pack(np.asarray(state, np.int64).reshape(1, n))[0],
            obs_bits, lambda key: unpack(key)[0].tolist(),
            lambda spec: pack(spec.get_state()[None])[0])
    fns, dim = matrix_actions(gateset, n, kind)
    ident = U64(0)
    for r in range(dim):
        ident |= U64(1) << U64(dim * r + r)
    shifts = np.arange(dim * dim, dtype=np.uint64)

    def encode(state):
        m = (np.asarray(state).reshape(-1) > 0).astype(np.uint64)
        return U64((m << shifts).sum())

    def obs_bits(keys):
        return ((keys[:, None] >> shifts[None, :]) & U64(1)).astype(np.uint8)

    return Family(kind, fns, ident, costs, encode, obs_bits,
                  lambda key: obs_bits(key)[0].tolist(),
                  lambda spec: encode(spec.get_state()))


def distance_tables(fam: Family, log=_quiet):
    """(sorted keys, least 2q count, least action count under it) of every
    reachable state: plain BFS when every action costs one 2q gate, Dial's
    0/1 BFS and the min-steps pass when 1q gates are free (Clifford), so
    that the greedy descent minimizes 2q gates first and actions second."""
    if all(c == 1 for c in fam.costs):
        _, keys_sorted, dist2q = bfs(fam.fns, fam.ident, log)
        return keys_sorted, dist2q, dist2q.astype(np.int32)
    keys_sorted, dist2q = bfs_2q(fam.fns, fam.costs, fam.ident, log)
    return keys_sorted, dist2q, steps_under_min2q(
        keys_sorted, dist2q, fam.fns, fam.costs, fam.ident)


def exact_min_2q_table(stem, env):
    """Exact least-2q lookup for env-encoded target states: plain BFS
    when every action costs one 2q gate, Dial's 0/1 BFS otherwise. A state
    outside the enumerated group raises ValueError."""
    fam = family(stem, env)
    if all(c == 1 for c in fam.costs):
        _, keys_sorted, dist = bfs(fam.fns, fam.ident, _quiet)
    else:
        keys_sorted, dist = bfs_2q(fam.fns, fam.costs, fam.ident)

    def min_2q(state):
        key = fam.encode(state)
        i = np.searchsorted(keys_sorted, key)
        if i == len(keys_sorted) or keys_sorted[i] != key:
            raise ValueError(f"{stem}: state key {int(key)} is not in the "
                             f"table of {len(keys_sorted)} reachable states")
        return int(dist[i])

    return min_2q


def validate_transitions(fam: Family, spec, shells, rng,
                         count: int = 60) -> None:
    """Raise unless the packed transition of a random action from a random
    state of a random shell equals the spec env's step, `count` times."""
    diameter = len(shells) - 1
    for _ in range(count):
        d = int(rng.integers(1, diameter + 1))
        while not len(shells[d]):
            d = int(rng.integers(1, diameter + 1))
        key = np.array([rng.choice(shells[d])], np.uint64)
        spec.set_state(fam.spec_state(key))
        a = int(rng.integers(len(fam.fns)))
        spec.step(a, invert=False)
        if fam.key_of_spec(spec) != fam.fns[a](key)[0]:
            raise AssertionError(f"packed transition mismatch at action {a}")


def optimal_corpus(stem, env, rng, log=_quiet,
                   per_shell: Optional[int] = None) -> Dict[str, object]:
    """The distance tables of `stem`'s group, the spec replay validation,
    and a corpus of optimal trajectories drawn uniformly over the distance
    shells (`per_shell` states a shell, by default as the JAX script
    sizes it), as `generate_demos` returns one. The corpus also carries
    `states`, `diameter` and `max_2q` of the group."""
    spec = env.spec
    w = spec.metrics_weights
    if w.n_layers != 0.0 or w.n_layers_cnots != 0.0:
        raise ValueError("the corpus's rewards assume the default "
                         "(layer-free) metrics weights")
    fam = family(stem, env)
    t0 = time.time()
    keys_sorted, dist2q, steps_arr = distance_tables(fam, log)
    # shells by least ACTION count: every lane started in shell m ends on
    # the identity after exactly m lex-optimal moves
    diameter = int(steps_arr.max())
    shells = [keys_sorted[steps_arr == m] for m in range(diameter + 1)]
    log({"phase": "bfs", "states": int(len(keys_sorted)),
         "diameter": diameter, "max_2q": int(dist2q.max()),
         "seconds": round(time.time() - t0, 1)})
    validate_transitions(fam, spec, shells, rng)
    log("spec replay validation OK")

    if per_shell is None:
        per_shell = max(400, min(4000, 120000 // max(diameter, 1)))
    gateset = env.gateset
    A = len(fam.fns)
    d_cnots = np.array([{"CX": 1, "SWAP": 3}.get(g[0], 0)
                        for g in gateset], np.float32)
    d_gates = np.array([3 if g[0] in ("SWAP", "CZ") else 1
                        for g in gateset], np.float32)
    pen = w.n_cnots * d_cnots + w.n_gates * d_gates
    carr = np.array(fam.costs, np.int32)[:, None]
    obs_rows, act_rows, ret_rows = [], [], []
    episodes = 0
    t0 = time.time()
    for d in range(1, diameter + 1):
        if not len(shells[d]):
            continue
        states = rng.choice(shells[d], size=min(per_shell, len(shells[d])),
                            replace=len(shells[d]) < per_shell
                            ).astype(np.uint64)
        N = len(states)
        ep_obs, ep_act = [], []
        for _ in range(d):
            neigh = np.stack([f(states) for f in fam.fns])       # [A, N]
            pos = np.searchsorted(keys_sorted, neigh.reshape(-1))
            nd2 = dist2q[pos].reshape(A, N).astype(np.int32)
            nst = steps_arr[pos].reshape(A, N)
            cpos = np.searchsorted(keys_sorted, states)
            cur2 = dist2q[cpos].astype(np.int32)
            curst = steps_arr[cpos]
            # lex-optimal moves: spend the action's 2q cost exactly, and
            # land on a state one optimal action closer
            valid = (carr + nd2 == cur2[None, :]) & \
                (nst == (curst - 1)[None, :])
            if not valid.any(axis=0).all():
                raise AssertionError("a state has no optimal move")
            act = (valid * (rng.random((A, N)) + 0.5)).argmax(axis=0)
            ep_obs.append(fam.obs_bits(states))
            ep_act.append(act)
            states = neigh[act, np.arange(N)]
        if not (states == fam.ident).all():
            raise AssertionError(f"shell {d} did not end on the identity")
        # returns-to-go: success reward 1.0 at the last step, penalties on
        # every step (default weights: cnot/gate counters only)
        rew = np.stack([-pen[a] for a in ep_act])               # [d, N]
        rew[-1] += 1.0
        ret = np.cumsum(rew[::-1], axis=0)[::-1]                # [d, N]
        for t in range(d):
            obs_rows.append(np.packbits(ep_obs[t], axis=1))
            act_rows.append(ep_act[t])
            ret_rows.append(ret[t])
        episodes += N
    demos = {
        "obs_packed": np.concatenate(obs_rows),
        "obs_bits": int(np.prod(spec.obs_shape())),
        "action": np.concatenate(act_rows).astype(np.int32),
        "ret": np.concatenate(ret_rows).astype(np.float32),
        "episodes": episodes,
        "attempts": episodes,
        "states": int(len(keys_sorted)),
        "diameter": diameter,
        "max_2q": int(dist2q.max()),
    }
    log({"phase": "corpus", "episodes": episodes,
         "steps": int(demos["action"].shape[0]), "per_shell": per_shell,
         "gen_seconds": round(time.time() - t0, 1)})
    return demos


def score(rls, depths, check, num_targets: int = 48):
    """(least solve rate over `depths`, mean over them of the mean 2q
    count) over 100 searches a target on the head-to-head protocol's own
    target distribution, seeds 777 + depth (disjoint from the published
    table's 4242 + depth); a depth with no verified solution counts as
    infinitely many 2q gates."""
    gateset = rls.env.gateset
    n = rls.env.config["num_qubits"]
    solves, twoqs = [], []
    for depth in depths:
        rng = np.random.default_rng(777 + depth)
        ok, cx = 0, []
        for _ in range(num_targets):
            target = _random_target(gateset, n, depth, rng)
            out = rls.synth(target, num_searches=100)
            if out is None or not check(out, target):
                continue
            ok += 1
            cx.append(_count_2q(out))
        solves.append(ok / num_targets)
        twoqs.append(float(np.mean(cx)) if cx else float("inf"))
    return min(solves), float(np.mean(twoqs))


def burst_loop(burst: Callable[[int], dict], measure: Callable[[], tuple],
               snapshot: Callable[[], dict], base: tuple, minutes: float,
               log) -> tuple:
    """Bursts until `minutes` are spent (at least one): `burst(i)` trains
    and returns its evidence fields, `measure()` scores the live weights
    as (solve, mean 2q), and a burst's weights (`snapshot()`) are kept
    only when strictly better than the best so far: solve at least as
    high and mean 2q lower. Returns ((solve, 2q), params) of the best."""
    best, best_params = base, snapshot()
    t0 = time.time()
    i = 0
    while time.time() - t0 < 60 * minutes:
        row = burst(i)
        s, q = measure()
        i += 1
        keep = s >= best[0] and q < best[1]
        if keep:
            best, best_params = (s, q), snapshot()
        log({"phase": "burst", "burst": i, **row, "solve": s,
             "mean_2q": round(q, 3), "kept": keep,
             "minutes": round((time.time() - t0) / 60, 1)})
    return best, best_params


def bc_stack(rls, lr: float, seed: int = 7):
    """An AlphaZero algorithm around the PPO artifact's env and weights:
    BC runs through the AlphaZero loss (one-hot demo visits,
    return-to-go values)."""
    bc = RLSynthesis(rls.env, AlphaZeroConfig(num_episodes=8,
                                              num_mcts_searches=4, lr=lr),
                     rls.model_config, seed=seed)
    bc.algorithm.params = rls.algorithm.params
    return bc.algorithm


def run(stem: str, minutes: float = 45.0, out=None, lr: float = 3e-4,
        fit_epochs: int = 2, num_targets: int = 48, device=None,
        per_shell: Optional[int] = None, num_minibatches: int = 64) -> dict:
    """The optimal-demo BC of `stem`'s shipped artifact: tables, corpus,
    baseline score, bursts of `fit_demos`, and the best weights written
    to `<out>/<stem>.{json,pt}` when they beat the shipped ones. Returns
    the final evidence row."""
    out = out_dir(out, f"{stem}_optimal_bc")
    log = Evidence(out, "evidence.jsonl")
    check, depths = CHECKERS[stem]
    rls = RLSynthesis.from_config_json(shipped(stem), shipped(stem, ".pt"),
                                       device=device)
    rng = np.random.default_rng(SEED)

    def say(msg):
        (log if isinstance(msg, dict) else print)(msg)

    demos = optimal_corpus(stem, rls.env, rng, say, per_shell)
    algo = bc_stack(rls, lr)
    demos = prepare_demos(algo, demos)

    def measure():
        return score(rls, depths, check, num_targets)

    base = measure()
    log({"phase": "baseline", "solve": base[0], "mean_2q": round(base[1], 3)})

    def burst(_):
        m = fit_demos(algo, demos, epochs=fit_epochs,
                      num_minibatches=num_minibatches)
        rls.algorithm.params = algo.params   # score through the PPO artifact
        return {"bc_loss": round(float(m["loss"]), 4)}

    best, best_params = burst_loop(burst, measure, lambda: algo.params,
                                   base, minutes, log)
    if best[1] < base[1] and best[0] >= base[0]:
        rls.algorithm.params = best_params
        rls.algorithm.best_params = best_params
        rls.trained_with = (
            f"{stem}: optimal-demo BC (qiskit_gym_torch.tools.optimal_bc: "
            f"exact BFS distance table over all {demos['states']} reachable "
            f"states, diameter {demos['diameter']}; cloned on uniformly "
            f"sampled optimal trajectories). Head-to-head protocol mean 2q "
            f"{base[1]:.2f} -> {best[1]:.2f} at solve {best[0]:.2f}. Prior "
            "provenance: " + (rls.trained_with or "none recorded"))
        rls.save(*artifact(out, stem), best=True)
        return log({"phase": "final", "shipped": True, "solve": best[0],
                    "mean_2q": round(best[1], 3)})
    return log({"phase": "final", "shipped": False,
                "note": "no snapshot beat the shipped weights"})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("stem", choices=sorted(FAMILIES))
    p.add_argument("minutes", nargs="?", type=float, default=45.0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.stem, args.minutes, args.out, args.lr, args.epochs,
        device=args.device)


if __name__ == "__main__":
    main()
