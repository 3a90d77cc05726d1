"""The port's Pauli-network env core against the JAX package's, on the CPU.

Inputs are made with numpy seeds and injected on both sides: scramble-op
indices and rotations through `reset`'s hooks, labels through `set_state`,
actions as arrays, and the per-step automorphism draw (`perm_idx`) carried
across from the JAX state. Every state field, the reward and `dense` must be
bit-identical (packed uint32 words are compared by their int32 view). The
generator-driven `reset` is held to structure and distribution, since
`jax.random` and `torch.Generator` give different streams."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.ops.pauli import PauliEnvCore as JaxCore
from qiskit_gym_tpu.ops.pauli import PauliEnvState as JaxState
from qiskit_gym_torch.ops.matrix_env import state_from_arrays
from qiskit_gym_torch.ops.pauli import (PauliEnvCore, PauliEnvState,
                                        pack_bits_lastdim,
                                        unpack_bits_lastdim)
from qiskit_gym_torch.spec import PauliSpecEnv

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
ALL_GATES = ("H", "S", "Sdg", "SX", "SXdg", "CX", "CZ", "SWAP")


def line_gateset(n, names=ALL_GATES):
    gs = []
    for name in names:
        if name in ("CX", "CZ", "SWAP"):
            # both directions, so that the line's reversal is an automorphism
            gs += [(name, (q, q + 1)) for q in range(n - 1)]
            gs += [(name, (q + 1, q)) for q in range(n - 1)]
        else:
            gs += [(name, (q,)) for q in range(n)]
    return gs


def artifact_kwargs(name):
    with open(os.path.join(MODELS, name + ".json")) as f:
        env = json.load(f)["env"]
    kw = {k: env[k] for k in ("num_qubits", "depth_slope", "max_depth",
                              "max_rotations", "pauli_diff_scale",
                              "pauli_layer_reward", "metrics_weights")
          if k in env}
    kw["gateset"] = [(g[0], tuple(g[1])) for g in env["gateset"]]
    return kw


# name -> constructor kwargs; the last is the shipped 27q heavy-hex config
CASES = {
    "line3": dict(num_qubits=3, gateset=line_gateset(3), max_rotations=4,
                  pauli_diff_scale=4),
    "line4_cx_only": dict(num_qubits=4,
                          gateset=line_gateset(4, ("H", "S", "Sdg", "CX")),
                          max_rotations=3, final_pauli_layers=6,
                          pauli_diff_scale=2, pauli_layer_reward=0.05),
    "line5_tracked": dict(num_qubits=5, gateset=line_gateset(5),
                          max_rotations=4, pauli_diff_scale=4,
                          metrics_weights={"n_cnots": 0.01,
                                           "n_layers_cnots": 0.02,
                                           "n_layers": 0.005,
                                           "n_gates": 0.001}),
    "line3_no_perms": dict(num_qubits=3, gateset=line_gateset(3),
                           add_perms=False),
    "heavy_hex_27q": artifact_kwargs("pauli_heavy_hex_27q"),
}


def cores(case):
    kw = CASES[case]
    return JaxCore(**kw), PauliEnvCore(device="cpu", **kw)


def assert_same(js, ts, where):
    assert js._fields == ts._fields
    for field in js._fields:
        j = np.asarray(getattr(js, field))
        t = getattr(ts, field).numpy()
        if j.dtype == np.uint32:
            j = j.view(np.int32)
        assert j.dtype == t.dtype, (field, where, j.dtype, t.dtype)
        assert j.shape == t.shape, (field, where)
        assert np.array_equal(j, t), (field, where)


def random_labels(rng, n, count):
    out = []
    for _ in range(count):
        lab = "".join(rng.choice(list("IXYZ"), n))
        if set(lab) == {"I"}:
            lab = "X" + lab[1:]
        out.append(("-" if rng.random() < 0.3 else "") + lab)
    return out


def random_overrides(rng, core, B, K):
    """(scramble indices [B, K], rotations (x, z, phase, valid)) for reset."""
    n, RT = core.num_qubits, core.RT
    scr = rng.integers(0, core.n_scramble, (B, K))
    x = rng.integers(0, 2, (B, RT, n)).astype(np.uint8)
    z = rng.integers(0, 2, (B, RT, n)).astype(np.uint8)
    # sparse strings so that trivial (weight <= 1) rotations occur
    keep = rng.random((B, RT, n)) < 0.35
    x, z = x * keep, z * keep
    valid = (rng.random((B, RT)) < 0.7) & ((x | z).sum(-1) > 0)
    phase = ((x & z).sum(-1) % 4).astype(np.int8)
    return scr, (x, z, phase, valid)


def both_reset(jc, tc, rng, B, K=6, difficulty=5):
    scr, rot = random_overrides(rng, jc, B, K)
    perm = rng.integers(0, jc.num_perms, B).astype(np.int32)
    js = jc.reset(jax.random.key(0), B, difficulty,
                  scramble_override=jnp.asarray(scr, jnp.int32),
                  rotations_override=tuple(jnp.asarray(a) for a in rot))
    js = js._replace(perm_idx=jnp.asarray(perm))
    ts = tc.reset(B, difficulty, scramble_override=torch.as_tensor(scr),
                  rotations_override=rot, perm_idx=torch.as_tensor(perm))
    return js, ts


def walk(jc, tc, js, ts, rng, steps, use_override):
    """`steps` seeded steps (no-op included) on both sides, perm_idx carried
    across from the JAX state; every field and `dense` compared each step."""
    B = js.tab.shape[0]
    jstep = jax.jit(jc.step)
    for t in range(steps):
        act = rng.integers(0, jc.num_actions + 1, B)
        act[t % B] = jc.noop_action
        ja, ta = jnp.asarray(act, jnp.int32), torch.as_tensor(act)
        np.testing.assert_array_equal(
            np.asarray(jc.translate_action(js, ja)),
            tc.translate_action(ts, ta).numpy())
        if use_override:
            js = jstep(js, ja, jax.random.key(t),
                       actual_override=jc.translate_action(js, ja))
        else:
            js = jstep(js, ja, jax.random.key(t))
        perm = torch.as_tensor(np.array(js.perm_idx))
        ts = tc.step(ts, ta, perm_idx=perm,
                     actual_override=(tc.translate_action(ts, ta)
                                      if use_override else None))
        assert_same(js, ts, t)
        np.testing.assert_array_equal(np.asarray(jc.dense(js)),
                                      tc.dense(ts).numpy(), err_msg=str(t))
        np.testing.assert_array_equal(np.asarray(jc.is_final(js)),
                                      tc.is_final(ts).numpy())
        np.testing.assert_array_equal(np.asarray(jc.masks(js)),
                                      tc.masks(ts).numpy())
    return js, ts


@pytest.mark.parametrize("case", list(CASES))
def test_tables_equal(case):
    jc, tc = cores(case)
    for attr in ("R", "RT", "dim", "D2", "W2", "L2", "Wn", "max_prims",
                 "cleanup_slots", "num_perms", "qubit_perms", "noop_action",
                 "n_scramble", "n_scramble_cx", "all_dists", "track_layers",
                 "weights_static", "final_pauli_layers", "obs_shape",
                 "num_actions", "pauli_diff_scale", "valid_pairs"):
        assert getattr(jc, attr) == getattr(tc, attr), attr
    assert tc.num_perms == (1 if case == "line3_no_perms" else 2)
    A1 = jc.num_actions + 1
    tab = tc.op_tab.numpy()
    np.testing.assert_array_equal(tab[:, 0], np.asarray(jc.mtype))
    np.testing.assert_array_equal(tab[:, 1], np.asarray(jc.mq1))
    np.testing.assert_array_equal(tab[:, 2], np.asarray(jc.mq2))
    np.testing.assert_array_equal(tab[:, 3:6], np.asarray(jc.ptype))
    np.testing.assert_array_equal(tab[:, 6:9], np.asarray(jc.pq1))
    np.testing.assert_array_equal(tab[:, 9:12], np.asarray(jc.pq2))
    kw = tc.K2 * tc.W2
    np.testing.assert_array_equal(
        tab[:, 12:12 + kw], np.asarray(jc.U32).view(np.int32).reshape(A1, kw))
    np.testing.assert_array_equal(
        tab[:, 12 + kw:], np.asarray(jc.S32).view(np.int32).reshape(A1, kw))
    skw = tc.scK * tc.W2
    sc = tc.sc_tab.numpy()
    np.testing.assert_array_equal(
        sc[:, :skw],
        np.asarray(jc.scU32).view(np.int32).reshape(jc.n_scramble, skw))
    np.testing.assert_array_equal(
        sc[:, skw:],
        np.asarray(jc.scS32).view(np.int32).reshape(jc.n_scramble, skw))
    np.testing.assert_array_equal(tc.act_perms.numpy(),
                                  np.asarray(jc.act_perms))
    np.testing.assert_array_equal(tc.ident_pk.numpy(),
                                  np.asarray(jc.ident_pk).view(np.int32))
    for name in ("pair_tab", "pair_cnt", "dist_vals"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    # the automorphism as row indices is the JAX one-hot matrix's argmax
    pm = np.asarray(jc.perm_mats)[:, :jc.dim, :jc.dim]
    np.testing.assert_array_equal(tc.perm_rows.numpy(), pm.argmax(-1))


@pytest.mark.parametrize("case", list(CASES))
def test_reset_overrides_then_steps_bit_identical(case):
    """reset with scramble_override and rotations_override (the initial
    sweep included), then 32 seeded steps through translate_action."""
    jc, tc = cores(case)
    rng = np.random.default_rng(11)
    B = 6 if case == "heavy_hex_27q" else 16
    js, ts = both_reset(jc, tc, rng, B)
    assert_same(js, ts, "reset")
    np.testing.assert_array_equal(np.asarray(jc.dense(js)),
                                  tc.dense(ts).numpy())
    walk(jc, tc, js, ts, rng, 32, use_override=False)


@pytest.mark.parametrize("case", list(CASES))
def test_set_state_then_steps_bit_identical(case):
    """set_state from dense tableaus and rotation labels (more labels than
    R on one lane: only the first R are kept, no initial sweep), then 30
    seeded steps with the collectors' `actual_override`."""
    jc, tc = cores(case)
    rng = np.random.default_rng(12)
    B = 4 if case == "heavy_hex_27q" else 8
    _, ts0 = both_reset(jc, tc, rng, B)
    from qiskit_gym_torch.ops.matrix_env import unpack_rows
    tabs = unpack_rows(ts0.tab, tc.W2, tc.D2, tc.dim)[:, :, :tc.dim].numpy()
    labels = [random_labels(rng, jc.num_qubits, int(rng.integers(0, jc.R + 1)))
              for _ in range(B)]
    labels[0] = random_labels(rng, jc.num_qubits, jc.R + 2)
    labels[1] = ["Z" + "I" * (jc.num_qubits - 1)]      # trivial, stays active
    js, ts = jc.set_state(tabs, labels), tc.set_state(tabs, labels)
    assert_same(js, ts, "set_state")
    assert int(ts.active[0].sum()) == tc.R and bool(ts.active[1, 0])
    assert (ts.depth == tc.max_depth).all()
    walk(jc, tc, js, ts, rng, 30, use_override=True)


def test_state_from_arrays_carries_a_jax_state():
    jc, tc = cores("line3")
    js, ts = both_reset(jc, tc, np.random.default_rng(13), 8)
    fields = {f: np.asarray(getattr(js, f)) for f in JaxState._fields}
    carried = state_from_arrays(fields, device="cpu", cls=PauliEnvState)
    for f in PauliEnvState._fields:
        assert torch.equal(getattr(carried, f), getattr(ts, f)), f
    act = torch.as_tensor(np.random.default_rng(1).integers(0, 10, 8))
    perm = torch.zeros(8, dtype=torch.int32)
    a, b = tc.step(carried, act, perm_idx=perm), tc.step(ts, act,
                                                         perm_idx=perm)
    for f in PauliEnvState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_noop_action_survives_translation():
    """The no-op (== num_actions) must not be clamped to the last real gate
    by the act_perms gather."""
    _, tc = cores("line3")
    assert tc.num_perms > 1
    state = tc.reset(4, 3, generator=torch.Generator().manual_seed(0))
    state = state._replace(perm_idx=torch.ones(4, dtype=torch.int32))
    act = torch.tensor([tc.noop_action, 0, tc.num_actions - 1,
                        tc.noop_action])
    out = tc.translate_action(state, act)
    assert out[0] == tc.noop_action and out[3] == tc.noop_action
    assert out[1] == tc.act_perms[1, 0]
    stepped = tc.step(state, act, perm_idx=state.perm_idx)
    assert torch.equal(stepped.tab[0], state.tab[0])
    assert stepped.n_gates[0] == 0 and stepped.n_gates[1] == 1


def test_use_pallas_metrics_is_rejected():
    _, tc = cores("line3")
    assert tc.use_pallas_metrics is False
    tc.use_pallas_metrics = False
    with pytest.raises(ValueError):
        tc.use_pallas_metrics = True


def test_pack_unpack_bits_roundtrip():
    rng = np.random.default_rng(2)
    for n, W in ((5, 1), (32, 1), (40, 2)):
        bits = torch.as_tensor(rng.integers(0, 2, (3, 4, n)).astype(np.uint8))
        words = pack_bits_lastdim(bits, W)
        assert words.dtype == torch.int32 and words.shape == (3, 4, W)
        assert torch.equal(unpack_bits_lastdim(words, n), bits)


def test_step_draws_perm_idx_from_the_generator():
    _, tc = cores("line3")
    g = torch.Generator().manual_seed(5)
    state = tc.reset(256, 4, generator=g)
    seen = set(state.perm_idx.tolist())
    for _ in range(3):
        state = tc.step(state, torch.zeros(256, dtype=torch.int64),
                        generator=g)
        seen |= set(state.perm_idx.tolist())
    assert state.perm_idx.dtype == torch.int32
    assert seen == set(range(tc.num_perms))


def test_reset_difficulty_zero_is_identity():
    _, tc = cores("line3")
    state = tc.reset(8, 0, generator=torch.Generator().manual_seed(0))
    assert (state.tab == tc.ident_pk[None]).all()
    assert not state.active.any() and state.success.all()
    assert (state.depth == 0).all()


@pytest.mark.parametrize("case", ["line3", "line4_cx_only"])
def test_generated_reset_structure(case):
    """Generator-driven reset: every made rotation is a non-identity Pauli
    with phase = (#Y mod 4), the anti matrix matches the symplectic product,
    active rotations are non-trivial or blocked, the tableau is symplectic
    and invertible, and the depth follows the difficulty."""
    jc, tc = cores(case)
    B, difficulty = 128, 24
    state = tc.reset(B, difficulty, generator=torch.Generator().manual_seed(3))
    n = tc.num_qubits
    rx = unpack_bits_lastdim(state.rx, n).numpy().astype(int)
    rz = unpack_bits_lastdim(state.rz, n).numpy().astype(int)
    w = (rx | rz).sum(-1)
    made = w > 0
    assert made.any() and made.sum(-1).max() <= tc.final_pauli_layers
    # rotations are made in order: no made rotation after an empty slot
    assert (np.diff(made.astype(int), axis=1) <= 0).all()
    np.testing.assert_array_equal(state.rphase.numpy()[made],
                                  ((rx & rz).sum(-1) % 4)[made])
    sym = (np.einsum("bin,bjn->bij", rx, rz)
           + np.einsum("bin,bjn->bij", rz, rx)) % 2
    want = (sym == 1) & np.tril(np.ones((tc.RT, tc.RT), bool), -1)[None] \
        & made[:, :, None] & made[:, None, :]
    np.testing.assert_array_equal(state.anti.numpy(), want)
    active = state.active.numpy()
    assert not (active & ~made).any()
    blocked = (want & active[:, None, :]).any(-1)
    assert ((w > 1) | blocked)[active].all()
    assert (state.depth == min(tc.depth_slope * difficulty,
                               tc.max_depth)).all()
    # the same state steps identically in the JAX core
    fields = {f: getattr(state, f).numpy() for f in state._fields}
    for f in ("tab", "rx", "rz"):
        fields[f] = fields[f].view(np.uint32)
    js = JaxState(**{f: jnp.asarray(v) for f, v in fields.items()})
    walk(jc, tc, js, state, np.random.default_rng(4), 6, use_override=False)


def test_generated_rotation_distribution_matches_spec():
    """Rotations per episode, mean weight and axis shares of the port's
    generator against the numpy spec env's sequential generator (the same
    algorithm, uncapped) on 4 qubits."""
    kw = CASES["line4_cx_only"]
    _, tc = cores("line4_cx_only")
    B, pd = 4000, 6
    g = torch.Generator().manual_seed(7)
    rx, rz, _, valid = tc._generate_rotations(
        g, B, torch.full((B,), pd, dtype=torch.int32))
    x = unpack_bits_lastdim(rx, 4).numpy()
    z = unpack_bits_lastdim(rz, 4).numpy()
    valid = valid.numpy()
    spec = PauliSpecEnv(difficulty=1, depth_slope=2, max_depth=32,
                        rng=np.random.default_rng(8),
                        **{k: v for k, v in kw.items()})
    counts, weights, axes = [], [], {"X": 0, "Y": 0, "Z": 0}
    for _ in range(2000):
        labs = spec._generate_rotations(pd)
        counts.append(len(labs))
        for lab in labs:
            weights.append(sum(c != "I" for c in lab))
            for c in lab:
                if c != "I":
                    axes[c] += 1
    got_counts = valid.sum(-1)
    got_w = (x | z).sum(-1)[valid]
    assert abs(got_counts.mean() - np.mean(counts)) < 0.1
    assert abs(got_w.mean() - np.mean(weights)) < 0.1
    tot = sum(axes.values())
    share = {"X": (x & ~z & 1)[valid].sum(), "Y": (x & z)[valid].sum(),
             "Z": (~x & z & 1)[valid].sum()}
    got_tot = sum(share.values())
    for a in "XYZ":
        assert abs(share[a] / got_tot - axes[a] / tot) < 0.03, a


def test_scramble_distribution():
    """70 % CX / 15 % H / 15 % S: the op-class shares of the drawn scramble,
    read back from a one-op scramble of the identity."""
    _, tc = cores("line4_cx_only")
    B = 6000
    tab = tc._scramble_tableau(torch.Generator().manual_seed(9), B, 1)
    rows = tc.sc_tab.numpy()
    kinds = np.full(B, -1)
    for i in range(tc.n_scramble - 1):
        U32, S32 = tc._terms(tc.sc_tab[i:i + 1], tc.scK)
        from qiskit_gym_torch.ops.fused_step import packed_apply_left
        one = packed_apply_left(U32, S32, tc.ident_pk[None], tc.W2, tc.D2)
        hit = (tab == one).all(1).numpy()
        kind = 0 if i < tc.n_scramble_cx else (
            1 if i < tc.n_scramble_cx + tc.num_qubits else 2)
        kinds[hit] = kind
    assert rows.shape[0] == tc.n_scramble and (kinds >= 0).all()
    shares = [(kinds == k).mean() for k in range(3)]
    assert abs(shares[0] - 0.70) < 0.03
    assert abs(shares[1] - 0.15) < 0.02 and abs(shares[2] - 0.15) < 0.02


def test_per_lane_difficulty_reset():
    """A per-lane difficulty vector (curriculum replay): depth per lane, and
    lanes at difficulty 0 keep the identity tableau."""
    _, tc = cores("line3")
    d = torch.tensor([0, 1, 5, 40] * 4)
    state = tc.reset(16, d, generator=torch.Generator().manual_seed(2))
    want = torch.clamp(tc.depth_slope * d, max=tc.max_depth).to(torch.int32)
    assert torch.equal(state.depth, want)
    assert (state.tab[d == 0] == tc.ident_pk[None]).all()
    assert not state.active[d < tc.pauli_diff_scale].any()
