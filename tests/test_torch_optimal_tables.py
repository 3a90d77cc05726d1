"""The port's exact distance tables (`qiskit_gym_torch.tools.optimal_bc`)
against the JAX package's script (`scripts/optimal_bc.py`), on the CPU.

Both are host numpy over packed-int states, so every table must be equal
bit for bit: the sorted keys, the least 2q counts and the least action
counts under them, on the instances of `tests/test_optimal_tables.py` and
the whole `perm_grid_3x3` group (9! states). Then the optimal corpus: every
trajectory ends on the identity, every step lowers the exact distance by
one, and the returns-to-go are the script's formula."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import optimal_bc as jax_obc  # noqa: E402  (the JAX package's script)
from qiskit_gym_tpu.rl.synthesis import RLSynthesis as JaxRLSynthesis  # noqa
from qiskit_gym_tpu.spec.gates import parse_gateset  # noqa: E402
from qiskit_gym_torch.rl import RLSynthesis  # noqa: E402
from qiskit_gym_torch.tools import optimal_bc as obc  # noqa: E402

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
LF_GS = [("CX", (0, 1)), ("CX", (1, 0)), ("CX", (1, 2)), ("CX", (2, 1))]
CLIFF_GS = [("CX", (0, 1)), ("CX", (1, 0)), ("SWAP", (0, 1)),
            ("H", (0,)), ("S", (0,))]
PERM_GS = [("SWAP", (0, 1)), ("SWAP", (1, 2)), ("SWAP", (2, 3))]


def _load(stem):
    paths = (os.path.join(MODELS, stem + ".json"),
             os.path.join(MODELS, stem + ".pt"))
    return RLSynthesis.from_config_json(*paths, device="cpu"), \
        JaxRLSynthesis.from_config_json(*paths)


def _ident_key(dim):
    k = np.uint64(0)
    for r in range(dim):
        k |= np.uint64(1) << np.uint64(dim * r + r)
    return k


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_plain_bfs_equals_the_jax_script_on_gl32():
    gs = parse_gateset(LF_GS)
    fns, dim = obc.matrix_actions(gs, 3, "linear")
    jfns, _ = jax_obc.matrix_actions(gs, 3, "linear")
    got = obc.bfs(fns, _ident_key(dim), obc._quiet)
    want = jax_obc.bfs(jfns, _ident_key(dim), lambda m: None)
    _assert_same(got[0], want[0])                 # the shells
    _assert_same(got[1:], want[1:])               # keys, distances
    assert len(got[1]) == 168


def test_dial_bfs_and_steps_equal_the_jax_script_on_sp42():
    gs = parse_gateset(CLIFF_GS)
    costs = [0 if len(g[1]) == 1 else 1 for g in gs]
    fns, dim = obc.matrix_actions(gs, 2, "clifford")
    jfns, _ = jax_obc.matrix_actions(gs, 2, "clifford")
    ident = _ident_key(dim)
    keys, d2 = obc.bfs_2q(fns, costs, ident)
    jkeys, jd2 = jax_obc.bfs_2q(jfns, costs, ident)
    _assert_same((keys, d2), (jkeys, jd2))
    assert len(keys) == 720
    steps = obc.steps_under_min2q(keys, d2, fns, costs, ident)
    _assert_same((steps,), (jax_obc.steps_under_min2q(jkeys, jd2, jfns,
                                                       costs, ident),))


def test_perm_tables_equal_the_jax_script_on_s4():
    gs = parse_gateset(PERM_GS)
    fns, unpack, pack = obc.perm_actions(gs, 4)
    jfns, _, jpack = jax_obc.perm_actions(gs, 4)
    ident = pack(np.arange(4)[None])[0]
    assert ident == jpack(np.arange(4)[None])[0]
    got = obc.bfs(fns, ident, obc._quiet)
    want = jax_obc.bfs(jfns, ident, lambda m: None)
    _assert_same(got[1:], want[1:])
    assert int(got[2].max()) == 6
    assert np.array_equal(unpack(got[1]), jax_obc.perm_actions(gs, 4)[1](
        want[1]))


def test_whole_perm_grid_group_equals_the_jax_script():
    """S_9 on the 3x3 grid: 362,880 states, diameter 16 (the JAX script's
    evidence row), the same table and the same least-2q lookups."""
    trls, jrls = _load("perm_grid_3x3")
    fam = obc.family("perm_grid_3x3", trls.env)
    keys, d2, steps = obc.distance_tables(fam)
    jfns, jident, jencode, jcosts = jax_obc.build_family("perm_grid_3x3",
                                                         jrls.env)
    assert fam.ident == jident and fam.costs == jcosts
    _, jkeys, jd2 = jax_obc.bfs(jfns, jident, lambda m: None)
    _assert_same((keys, d2, steps), (jkeys, jd2, jd2.astype(np.int32)))
    assert len(keys) == 362880 and int(steps.max()) == 16
    # exact_min_2q_table on targets encoded by each package's own env
    min_2q = obc.exact_min_2q_table("perm_grid_3x3", trls.env)
    rng = np.random.default_rng(5)
    for key in rng.choice(keys, 16):
        state = obc.perm_actions(trls.env.gateset, 9)[1](np.array([key]))[0]
        assert min_2q(state) == int(jd2[np.searchsorted(jkeys, jencode(
            state))])


@pytest.mark.parametrize("stem,per_shell", [("perm_grid_3x3", 40),
                                            ("clifford_3q_custom", 6)])
def test_optimal_corpus_walks_shortest_paths(stem, per_shell):
    """Rebuild every trajectory of the corpus from its packed observations:
    each ends on the identity, each step lowers the least action count by
    one and spends exactly its 2q cost of the least 2q count, and the
    returns-to-go equal 1 less the penalties from that step on."""
    trls, jrls = _load(stem)
    env = trls.env
    demos = obc.optimal_corpus(stem, env, np.random.default_rng(3),
                               per_shell=per_shell)
    fam = obc.family(stem, env)
    jfns, jident, _, costs = jax_obc.build_family(stem, jrls.env)
    if all(c == 1 for c in costs):
        _, keys, d2 = jax_obc.bfs(jfns, jident, lambda m: None)
        steps = d2.astype(np.int32)
    else:
        keys, d2 = jax_obc.bfs_2q(jfns, costs, jident)
        steps = jax_obc.steps_under_min2q(keys, d2, jfns, costs, jident)
    assert demos["states"] == len(keys)
    assert demos["diameter"] == int(steps.max())
    assert (demos["states"], demos["diameter"]) == {
        "perm_grid_3x3": (362880, 16),
        "clifford_3q_custom": (1451520, 23)}[stem]

    bits = demos["obs_bits"]
    obs = np.unpackbits(demos["obs_packed"], axis=1)[:, :bits]
    n = env.config["num_qubits"]
    if fam.kind == "perm":
        perms = obs.reshape(-1, n, n).argmax(axis=2)
        row_keys = (perms.astype(np.uint64)
                    * (n ** np.arange(n)).astype(np.uint64)).sum(axis=1)
    else:
        row_keys = (obs.astype(np.uint64) << np.arange(
            bits, dtype=np.uint64)).sum(axis=1)
    w = env.spec.metrics_weights
    pen = np.array([w.n_cnots * {"CX": 1, "SWAP": 3}.get(g[0], 0)
                    + w.n_gates * (3 if g[0] in ("SWAP", "CZ") else 1)
                    for g in env.gateset], np.float32)
    act, ret = demos["action"], demos["ret"]
    row = 0
    for d in range(1, demos["diameter"] + 1):
        N = min(per_shell, int((steps == d).sum()))
        ks = row_keys[row:row + d * N].reshape(d, N)
        acts = act[row:row + d * N].reshape(d, N)
        rets = ret[row:row + d * N].reshape(d, N)
        idx = np.searchsorted(keys, ks)
        np.testing.assert_array_equal(steps[idx], (d - np.arange(d))[:, None]
                                      + np.zeros((1, N), int))
        for t in range(d):
            nxt = np.array([jfns[a](np.array([k], np.uint64))[0]
                            for a, k in zip(acts[t], ks[t])], np.uint64)
            want_next = ks[t + 1] if t + 1 < d else np.full(N, jident)
            np.testing.assert_array_equal(nxt, want_next)
            spent = np.asarray(costs)[acts[t]]
            np.testing.assert_array_equal(
                d2[idx[t]].astype(int) - spent,
                d2[np.searchsorted(keys, nxt)].astype(int))
        want_ret = 1.0 - np.cumsum(pen[acts][::-1], axis=0)[::-1]
        np.testing.assert_allclose(rets, want_ret, rtol=0, atol=1e-5)
        row += d * N
    assert row == len(act) and demos["episodes"] == demos["attempts"]
