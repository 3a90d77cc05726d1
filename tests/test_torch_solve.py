"""The port's solve path against the JAX package, on the CPU.

`collect` runs on both sides with the same numpy-made Gumbel noise and
inversion flips (the JAX side through a monkeypatched `_pregen_randomness`,
the port through its `gumbel`/`flips` arguments) and the shipped weights:
actions, validity, inversion flags, rewards and the final env state must be
identical, logp and value within 1e-5 (float32 matmuls summed in another
order). Then `RLSynthesis.synth` on the six shipped matrix artifacts must
return circuits that the port's own quantum layer verifies."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import qiskit_gym_tpu.rl.rollout as jax_rollout
from qiskit_gym_tpu.rl.synthesis import RLSynthesis as JaxRLSynthesis
from qiskit_gym_torch.quantum import (Circuit, Clifford, linear_from_circuit,
                                      permutation_pattern)
from qiskit_gym_torch.rl import RLSynthesis
from qiskit_gym_torch.rl.rollout import collect, solve_temperatures

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
ARTIFACTS = ["clifford_heavy_hex_27q", "perm_heavy_hex_27q", "perm_grid_3x3",
             "lf_5_line", "clifford_3q_line", "clifford_3q_custom"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _paths(name):
    return (os.path.join(MODELS, name + ".json"),
            os.path.join(MODELS, name + ".pt"))


def _load(name):
    return RLSynthesis.from_config_json(*_paths(name), device="cpu")


@pytest.mark.parametrize("name", ["lf_5_line", "clifford_3q_line"])
def test_collect_with_injected_noise_matches_jax(name, monkeypatch):
    T, B, K = 16, 8, 4
    jr = JaxRLSynthesis.from_config_json(*_paths(name))
    tr = _load(name)
    jcore, tcore = jr.env.core, tr.env.core
    A = jcore.num_actions
    rng = np.random.default_rng(11)
    gumbel = rng.gumbel(size=(T, B, A)).astype(np.float32)
    flips = rng.random((T, B)) < 0.5
    scramble = rng.integers(0, A, (B, K))

    monkeypatch.setattr(
        jax_rollout, "_pregen_randomness",
        lambda core, key, T_, B_, det: (jax.numpy.asarray(gumbel),
                                        jax.numpy.asarray(flips),
                                        jax.random.split(key, T_)))
    key = jax.random.key(0)
    js = jcore.reset(key, B, K, scramble_override=jax.numpy.asarray(
        scramble, jax.numpy.int32))
    jfinal, jtraj = jax_rollout.collect(
        jcore, jr.algorithm.policy.apply, jr.algorithm.params, js, key, T,
        lane_temp=jax_rollout.solve_temperatures(B))

    ts = tcore.reset(B, K, scramble_override=torch.as_tensor(scramble))
    tfinal, ttraj = collect(tcore, tr.algorithm.policy, ts, T,
                            lane_temp=solve_temperatures(B),
                            gumbel=torch.as_tensor(gumbel),
                            flips=torch.as_tensor(flips))

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
    # the episode budget ran out inside T: frozen lanes are exercised
    assert not ttraj.valid[-1].any()


def _target(env, rng, depth):
    gs = env.gateset
    acts = rng.integers(0, len(gs), depth)
    return Circuit.from_gate_list([gs[int(a)] for a in acts],
                                  num_qubits=env.config["num_qubits"])


def _implements(env, out, target):
    if env.cls_name == "PermutationEnv":
        return np.array_equal(permutation_pattern(linear_from_circuit(out)),
                              permutation_pattern(linear_from_circuit(target)))
    if env.cls_name == "LinearFunctionEnv":
        return np.array_equal(linear_from_circuit(out),
                              linear_from_circuit(target))
    # phase-exact: the whole tableau, sign column included
    return np.array_equal(Clifford(out).tableau, Clifford(target).tableau)


@pytest.mark.parametrize("name", ARTIFACTS)
def test_synth_shipped_artifact_verifies(name):
    rls = _load(name)
    rng = np.random.default_rng(2)
    for _ in range(2):
        target = _target(rls.env, rng, 3)
        out = rls.synth(target, num_searches=16)
        assert out is not None, name
        assert _implements(rls.env, out, target), name


def test_save_round_trip(tmp_path):
    rls = _load("clifford_3q_line")
    cfg, pt = str(tmp_path / "m.json"), str(tmp_path / "m.pt")
    rls.save(cfg, pt)
    back = RLSynthesis.from_config_json(cfg, pt, device="cpu")
    assert back.to_json() == rls.to_json()
    for k, v in rls.params.items():
        assert torch.equal(back.params[k], v), k


def test_learn_runs_on_a_shipped_artifact():
    """One PPO iteration from the shipped weights at the JSON's own width:
    the metrics are finite, the weights move, the eval gate passes and the
    curriculum advances."""
    rls = _load("perm_grid_3x3")
    before = {k: v.clone() for k, v in rls.params.items()}
    rls.learn(initial_difficulty=2, num_iterations=1)
    algo = rls.algorithm
    assert algo.iteration == 1
    assert any(not torch.equal(before[k], v) for k, v in rls.params.items())
    assert rls.env.difficulty == 3 and algo.best_difficulty == 2
    for k, v in algo.best_params.items():
        assert torch.equal(v, rls.params[k]), k


def test_unported_paths_raise_with_roadmap_item():
    """What used to raise as not ported now runs: MCTS solving from a PPO
    artifact, and loading an AlphaZero artifact."""
    rls = _load("perm_grid_3x3")
    pattern = [1, 0, 2, 3, 4, 5, 6, 7, 8]
    out = rls.synth(pattern, num_searches=4, num_mcts_searches=4)
    assert out is not None
    assert permutation_pattern(linear_from_circuit(out)).tolist() == pattern
    az = RLSynthesis.from_config_json(*_paths("az_perm_grid_3x3"),
                                      device="cpu")
    assert type(az.algorithm).__name__ == "AZ"


def test_entry_point_default_device_is_cuda():
    if torch.cuda.is_available():
        assert RLSynthesis.from_config_json(
            *_paths("lf_5_line")).env.core.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RLSynthesis.from_config_json(*_paths("lf_5_line"))


def test_shipped_json_class_paths_resolve():
    """The shipped JSONs name the JAX package's classes; they load by their
    last segment and keep their algorithm and policy paths on save."""
    with open(_paths("lf_5_line")[0]) as f:
        full = json.load(f)
    out = _load("lf_5_line").to_json()
    assert out["algorithm_cls"] == full["algorithm_cls"]
    assert out["policy_cls"] == full["policy_cls"]
    assert out["env_cls"].endswith(full["env_cls"].split(".")[-1])
