"""The port's `PauliGym`, its collectors and `RLSynthesis` on the Pauli
artifacts against the JAX package, on the CPU.

Encodings, the solve state, the replayed solution and the rebuilt circuit
must be equal for the same inputs. `collect` runs on both sides with the same
numpy-made Gumbel noise and the JAX side's own per-step automorphism draws
(recomputed from its step keys and injected into the port through `perms`):
observations, actions in both frames, rewards and the final state must be
identical, logp and value within 1e-5 (float32 matmuls summed in another
order, the tolerance `test_torch_policy.py` states). `synth` must return
circuits whose unitary equals the target's up to a global phase."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qiskit_gym_tpu.rl.rollout as jax_rollout
from qiskit_gym_tpu.envs.synthesis import PauliGym as JaxPauliGym
from qiskit_gym_tpu.quantum import Circuit as JaxCircuit
from qiskit_gym_tpu.quantum import Clifford as JaxClifford
from qiskit_gym_tpu.rl.synthesis import RLSynthesis as JaxRLSynthesis
from qiskit_gym_torch.envs import SYNTH_ENVS, PauliGym
from qiskit_gym_torch.envs.synthesis import (_just_clifford,
                                             _parse_pauli_circuit)
from qiskit_gym_torch.quantum import Circuit, Clifford
from qiskit_gym_torch.quantum.statevector import (allclose_up_to_global_phase,
                                                  circuit_unitary)
from qiskit_gym_torch.rl import RLSynthesis
from qiskit_gym_torch.rl.configs import (BasicPolicyConfig, EvalConfig,
                                         PPOConfig)
from qiskit_gym_torch.rl.rollout import (collect, collect_packed,
                                         solve_temperatures)

import chip_smoke

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
TOL = dict(atol=1e-5, rtol=1e-5)
LINE3 = [(0, 1), (1, 0), (1, 2), (2, 1)]


def _paths(name):
    return (os.path.join(MODELS, name + ".json"),
            os.path.join(MODELS, name + ".pt"))


def _gyms(**kw):
    kw = dict(dict(difficulty=1, max_depth=24, max_rotations=3), **kw)
    return (JaxPauliGym.from_coupling_map(LINE3, **kw),
            PauliGym.from_coupling_map(LINE3, device="cpu", **kw))


def _circuit(cls, gates, n):
    qc = cls(n)
    for name, qs, params in gates:
        qc.append(name, qs, params)
    return qc


def _random_gates(rng, gateset, n, depth, nrot):
    """A seeded Clifford + rotations target as (name, qubits, params)."""
    return chip_smoke.pauli_target_gates(gateset, n, rng, depth, nrot)


def _same_circuit(jqc, tqc):
    assert [(g[0], tuple(g[1]), tuple(g[2])) for g in jqc] == \
        [(g[0], tuple(g[1]), tuple(g[2])) for g in tqc]


def test_registered_and_json_round_trip():
    assert SYNTH_ENVS["PauliNetworkEnv"] is PauliGym
    jg, tg = _gyms()
    assert tg.obs_shape() == jg.obs_shape() == [6, 6 + 3]
    assert tg.num_actions() == jg.num_actions()
    assert tg.to_json() == jg.to_json()
    back = PauliGym.from_json(tg.to_json(), device="cpu")
    assert back.gateset == tg.gateset
    assert back.config["max_rotations"] == 3
    assert tg.twists() == ([], [])


def test_diff_scale_default_is_16_and_passes_through():
    _, tg = _gyms()
    assert tg.spec.pauli_diff_scale == 16 and tg.core.pauli_diff_scale == 16
    assert tg.pauli_diff_scale == 16 and tg.max_rotations == 3
    _, tg8 = _gyms(pauli_diff_scale=8)
    assert tg8.spec.pauli_diff_scale == 8 and tg8.core.pauli_diff_scale == 8
    assert PauliGym.from_json(tg8.to_json(),
                              device="cpu").core.pauli_diff_scale == 8


@pytest.mark.parametrize("seed", range(4))
def test_get_state_encodings_equal(seed):
    """Circuit input, Clifford + labels, and both tuple forms."""
    jg, tg = _gyms()
    rng = np.random.default_rng(seed)
    gates = _random_gates(rng, tg.gateset, 3, 6, 2)
    jqc, tqc = _circuit(JaxCircuit, gates, 3), _circuit(Circuit, gates, 3)
    enc = tg.get_state(tqc)
    assert enc == jg.get_state(jqc)
    cliff, rots, params = _parse_pauli_circuit(tqc)
    assert len(rots) == 2 and len(params) == 2
    jcl = JaxClifford(np.array(cliff.tableau))
    assert tg.get_state(cliff, rotations=rots, rotation_params=params) == \
        jg.get_state(jcl, rotations=rots, rotation_params=params)
    # tuple inputs take the tableau as it is: the adjoint gives the circuit's
    assert tg.get_state((cliff.adjoint(), rots, params)) == enc
    assert tg.get_state((cliff.adjoint(), rots)) == \
        jg.get_state((jcl.adjoint(), rots))
    assert tg._rotation_params == []
    tableau, labels = tg._parse_encoded(enc, 3)
    jt, jl = jg._parse_encoded(enc, 3)
    assert labels == jl == rots and np.array_equal(tableau, jt)


def test_get_state_rejects_what_it_cannot_rebuild():
    _, tg = _gyms()
    cl = Clifford.identity(3)
    with pytest.raises(ValueError, match="max_rotations"):
        tg.get_state(cl, rotations=["XII", "IXI", "IIX", "ZII"])
    with pytest.raises(ValueError, match="no X/Y/Z support"):
        tg.get_state(cl, rotations=["III"])
    with pytest.raises(ValueError, match="Unsupported input"):
        tg.get_state([1, 2, 3])


def test_make_solve_state_equal():
    jg, tg = _gyms()
    gates = _random_gates(np.random.default_rng(5), tg.gateset, 3, 6, 3)
    enc = tg.get_state(_circuit(Circuit, gates, 3))
    js, ts = jg.make_solve_state(enc, 5), tg.make_solve_state(enc, 5)
    assert ts.batch == 5
    for f in js._fields:
        j = np.asarray(getattr(js, f))
        j = j.view(np.int32) if j.dtype == np.uint32 else j
        t = getattr(ts, f).numpy()
        assert j.dtype == t.dtype and np.array_equal(j, t), f


@pytest.mark.parametrize("seed", range(4))
def test_solution_and_circuit_equal_for_the_same_trace(seed):
    """One random action trace: the replayed solution (gate indices with the
    rotation events) and the circuit rebuilt from it are equal, and the
    replay env is built once."""
    jg, tg = _gyms()
    rng = np.random.default_rng(100 + seed)
    gates = _random_gates(rng, tg.gateset, 3, 5, 2)
    jqc, tqc = _circuit(JaxCircuit, gates, 3), _circuit(Circuit, gates, 3)
    enc = tg.get_state(tqc)
    assert jg.get_state(jqc) == enc
    actions = rng.integers(0, tg.num_actions(), 24).tolist()
    jsol = jg.solution_from_trace(enc, actions, [False] * 24)
    tsol = tg.solution_from_trace(enc, actions, [False] * 24)
    assert jsol == tsol
    replay = tg._replay_env
    tg.solution_from_trace(enc, actions[:3], [False] * 3)
    assert tg._replay_env is replay
    _same_circuit(jg.build_circuit_from_solution(jsol, jqc),
                  tg.build_circuit_from_solution(tsol, tqc))


def test_rotation_memo_restores_labels_for_clifford_targets():
    jg, tg = _gyms()
    gates = _random_gates(np.random.default_rng(7), tg.gateset, 3, 4, 0)
    cl = Clifford(_circuit(Circuit, gates, 3))
    jcl = JaxClifford(np.array(cl.tableau))
    other = Clifford(_circuit(Circuit, gates[:2], 3))
    rots, params = ["XXI", "IZZ"], [0.4, 1.1]
    enc = tg.get_state(cl, rotations=rots, rotation_params=params)
    assert enc == jg.get_state(jcl, rotations=rots, rotation_params=params)
    tg.get_state(other, rotations=["YII"], rotation_params=[0.2])  # interleave
    actions = np.random.default_rng(8).integers(0, tg.num_actions(),
                                                24).tolist()
    tsol = tg.solution_from_trace(enc, actions, [False] * 24)
    jsol = jg.solution_from_trace(enc, actions, [False] * 24)
    assert tsol == jsol
    _same_circuit(jg.build_circuit_from_solution(jsol, jcl),
                  tg.build_circuit_from_solution(tsol, cl))
    # the same Clifford part with other rotations: ambiguous without kwargs
    tg.get_state(cl, rotations=["ZII"], rotation_params=[0.3])
    with pytest.raises(ValueError, match="disambiguate"):
        tg.build_circuit_from_solution(tsol, cl)
    tg.build_circuit_from_solution(tsol, cl, rotations=rots,
                                   rotation_params=params)


def test_just_clifford_drops_rotations():
    qc = Circuit(2).h(0).rz(0.3, 1).cx(0, 1).rx(0.2, 0)
    assert [g[0] for g in _just_clifford(qc)] == ["h", "cx"]


@pytest.mark.parametrize("name", ["pauli_5_line", "pauli_12_line"])
def test_collect_with_injected_noise_matches_jax(name, monkeypatch):
    T, B, K = 12, 6, 4
    jr = JaxRLSynthesis.from_config_json(*_paths(name))
    tr = RLSynthesis.from_config_json(*_paths(name), device="cpu")
    jcore, tcore = jr.env.core, tr.env.core
    assert tcore.num_perms == jcore.num_perms == 2
    A = jcore.num_actions
    rng = np.random.default_rng(21)
    gumbel = rng.gumbel(size=(T, B, A)).astype(np.float32)
    scramble = rng.integers(0, jcore.n_scramble, (B, K))
    n, RT = jcore.num_qubits, jcore.RT
    x = (rng.random((B, RT, n)) < 0.15).astype(np.uint8)
    z = (rng.random((B, RT, n)) < 0.15).astype(np.uint8)
    valid = (rng.random((B, RT)) < 0.6) & ((x | z).sum(-1) > 0)
    rot = (x, z, ((x & z).sum(-1) % 4).astype(np.int8), valid)
    perm0 = rng.integers(0, 2, B).astype(np.int32)

    key = jax.random.key(0)
    step_keys = jax.random.split(key, T)
    monkeypatch.setattr(
        jax_rollout, "_pregen_randomness",
        lambda core, key_, T_, B_, det: (jnp.asarray(gumbel),
                                         jnp.zeros((T, B), bool), step_keys))
    # the automorphism the JAX step draws from each step key
    perms = np.stack([np.asarray(jax.random.randint(
        jax.random.split(k)[0], (B,), 0, jcore.num_perms))
        for k in step_keys]).astype(np.int32)

    js = jcore.reset(key, B, 2, scramble_override=jnp.asarray(scramble,
                                                              jnp.int32),
                     rotations_override=tuple(jnp.asarray(a) for a in rot))
    js = js._replace(perm_idx=jnp.asarray(perm0))
    jfinal, jtraj = jax_rollout.collect(
        jcore, jr.algorithm.policy.apply, jr.algorithm.params, js, key, T,
        lane_temp=jax_rollout.solve_temperatures(B))

    ts = tcore.reset(B, 2, scramble_override=torch.as_tensor(scramble),
                     rotations_override=rot, perm_idx=torch.as_tensor(perm0))
    tfinal, ttraj = collect(tcore, tr.algorithm.policy, ts, T,
                            lane_temp=solve_temperatures(B),
                            gumbel=torch.as_tensor(gumbel),
                            perms=torch.as_tensor(perms))

    for field in ("obs", "action", "actual", "valid", "done", "inverted",
                  "reward", "success"):
        np.testing.assert_array_equal(
            getattr(ttraj, field).numpy(),
            np.asarray(getattr(jtraj, field)).astype(
                getattr(ttraj, field).numpy().dtype), err_msg=field)
    for field in ("logp", "value"):
        np.testing.assert_allclose(getattr(ttraj, field).numpy(),
                                   np.asarray(getattr(jtraj, field)), **TOL)
    for field in jfinal._fields:
        j = np.asarray(getattr(jfinal, field))
        j = j.view(np.int32) if j.dtype == np.uint32 else j
        np.testing.assert_array_equal(getattr(tfinal, field).numpy(), j,
                                      err_msg=field)
    # both frames were exercised: some action was translated; the episode
    # budget (depth_slope * 2) ran out inside T, so frozen lanes were too
    assert (ttraj.actual != ttraj.action).any()
    assert not ttraj.valid[-1].any()


def test_policy_logits_match_jax_on_pauli_observations():
    name = "pauli_5_line"
    jr = JaxRLSynthesis.from_config_json(*_paths(name))
    tr = RLSynthesis.from_config_json(*_paths(name), device="cpu")
    state = tr.env.core.reset(16, 20,
                              generator=torch.Generator().manual_seed(0))
    obs = tr.env.core.dense(state)
    assert obs.dtype == torch.uint8 and tuple(obs.shape[1:]) == (10, 14)
    with torch.no_grad():
        tl, tv = tr.algorithm.policy(obs)
    jl, jv = jr.algorithm.policy.apply(jr.algorithm.params,
                                       jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def _synth_targets(env, seed, count, depth, nrot):
    rng = np.random.default_rng(seed)
    n = env.config["num_qubits"]
    return [_circuit(Circuit, _random_gates(rng, env.gateset, n, depth, nrot),
                     n) for _ in range(count)]


def test_synth_pauli_5_line_returns_verified_circuits():
    rls = RLSynthesis.from_config_json(*_paths("pauli_5_line"), device="cpu")
    solved = 0
    for target in _synth_targets(rls.env, 0, 3, 6, 2):
        out = rls.synth(target, num_searches=32)
        if out is None:
            continue
        solved += 1
        assert allclose_up_to_global_phase(circuit_unitary(out),
                                           circuit_unitary(target))
        assert chip_smoke.pauli_circuits_equivalent(out, target)
        rots = [g for g in out if g[0] in ("rx", "ry", "rz")]
        assert len(rots) == 2
    assert solved >= 2


def test_synth_pauli_12_line_verified_by_statevector():
    """12 qubits: too wide for a unitary; one random statevector through
    both circuits, and the tableau + rotation-sequence check."""
    rls = RLSynthesis.from_config_json(*_paths("pauli_12_line"), device="cpu")
    solved = 0
    for target in _synth_targets(rls.env, 1, 2, 5, 1):
        out = rls.synth(target, num_searches=16)
        if out is None:
            continue
        solved += 1
        assert chip_smoke.statevectors_agree(out, target, seed=3)
        assert chip_smoke.pauli_circuits_equivalent(out, target)
    assert solved >= 1


def test_circuit_equivalence_check_rejects_wrong_circuits():
    """The tableau + rotation-sequence check used beyond statevector width
    agrees with the unitary on equal and on unequal circuits."""
    a = Circuit(3).h(0).cx(0, 1).rz(0.7, 1).s(2).ry(0.3, 2).cx(1, 2)
    same = Circuit(3).s(2).ry(0.3, 2).h(0).cx(0, 1).rz(0.7, 1).cx(1, 2)
    assert allclose_up_to_global_phase(circuit_unitary(a),
                                       circuit_unitary(same))
    assert chip_smoke.pauli_circuits_equivalent(a, same)
    assert chip_smoke.statevectors_agree(a, same, seed=0)
    for wrong in (
            Circuit(3).h(0).cx(0, 1).rz(-0.7, 1).s(2).ry(0.3, 2).cx(1, 2),
            Circuit(3).h(0).cx(0, 1).rz(0.7, 1).s(2).ry(0.3, 2).cx(2, 1),
            Circuit(3).h(0).cx(0, 1).rz(0.7, 0).s(2).ry(0.3, 2).cx(1, 2),
            Circuit(3).h(0).cx(0, 1).s(2).ry(0.3, 2).cx(1, 2)):
        assert not allclose_up_to_global_phase(circuit_unitary(a),
                                               circuit_unitary(wrong))
        assert not chip_smoke.pauli_circuits_equivalent(a, wrong)
        assert not chip_smoke.statevectors_agree(a, wrong, seed=0)
    # anticommuting rotations must keep their order
    b = Circuit(2).rz(0.4, 0).rx(0.9, 0)
    swapped = Circuit(2).rx(0.9, 0).rz(0.4, 0)
    assert not chip_smoke.pauli_circuits_equivalent(b, swapped)
    assert chip_smoke.pauli_circuits_equivalent(
        b, Circuit(2).x(0).rz(-0.4, 0).rx(0.9, 0).x(0))


def _tiny_rls(packing):
    _, gym = _gyms(max_depth=16)
    cfg = PPOConfig(num_episodes=16, num_epochs=2, episode_packing=packing,
                    evals={"ppo_deterministic": EvalConfig(num_episodes=8)})
    return RLSynthesis(gym, cfg, BasicPolicyConfig(embedding_size=32,
                                                   common_layers=[16]))


@pytest.mark.parametrize("packing", [False, True])
def test_pauli_ppo_learn_smoke(packing):
    """PauliGym trains end to end through the batched core (2 iterations at
    difficulty 16, where rotations appear)."""
    rls = _tiny_rls(packing)
    before = {k: v.clone() for k, v in rls.params.items()}
    rls.learn(initial_difficulty=16, num_iterations=2)
    assert rls.algorithm.iteration == 2
    assert any(not torch.equal(before[k], v) for k, v in rls.params.items())


def test_learn_on_the_shipped_pauli_5_line_config():
    """One iteration from the shipped weights with the JSON unchanged
    (2048 lanes, packing, 4 x 16 minibatches) at difficulty 2."""
    rls = RLSynthesis.from_config_json(*_paths("pauli_5_line"), device="cpu")
    assert rls.rl_config.episode_packing
    rls.learn(initial_difficulty=2, num_iterations=1)
    assert rls.algorithm.iteration == 1


def test_collect_packed_on_the_pauli_core_records_both_frames():
    rls = _tiny_rls(True)
    core = rls.env.core
    g = torch.Generator().manual_seed(4)
    final, traj, stats = collect_packed(core, rls.algorithm.policy, 12, 16,
                                        3, pool_slots=2, generator=g)
    assert traj.actual is not traj.action
    assert (traj.actual != traj.action).any()
    assert int(traj.actual.max()) < core.num_actions
    # the line's reversal maps 1q gate (name, q) to (name, 2 - q): an action
    # and its env-frame twin are equal or mirror images, never anything else
    twin = core.act_perms[1]
    assert ((traj.actual == traj.action)
            | (traj.actual == twin[traj.action])).all()
    assert traj.obs.shape == (12, 16, 6, 9)
    assert int(stats["episodes_completed"].sum()) > 0
    assert final.perm_idx.dtype == torch.int32
