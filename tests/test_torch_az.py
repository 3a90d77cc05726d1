"""The port's AlphaZero path (`rl/az.py`) against the JAX package, on the CPU.

Small sizes (4-qubit lines, the 3-qubit Pauli line, `perm_grid_3x3`; B <= 16
lanes, 8 simulations). The JAX collectors draw from their own keys: the same
splits are repeated here and every draw is handed to the port (root gammas,
the draws of every env step inside the searches, the Gumbel noise behind the
sampled move, the draw of the played step, pool slots and rotations).
Tolerances: env-side values (actions in both frames, flags, rewards, the
final state) exact; `visit_probs` 1e-6 (ratios of equal integers); value
targets 1e-6; losses and gradients 1e-5 relative (float32 matmuls summed in
another order)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qiskit_gym_tpu.rl.az as jax_az
import qiskit_gym_tpu.rl.rollout as jax_rollout
from qiskit_gym_tpu.rl.configs import AlphaZeroConfig as JaxAZConfig
from qiskit_gym_torch.models import params_from_jax
from qiskit_gym_torch.quantum import (Circuit, linear_from_circuit,
                                      permutation_pattern)
from qiskit_gym_torch.quantum.statevector import (allclose_up_to_global_phase,
                                                  circuit_unitary)
from qiskit_gym_torch.rl import (AZ, AlphaZeroConfig, BasicPolicyConfig,
                                 EvalConfig, RLSynthesis, collect_mcts,
                                 collect_mcts_packed, mcts_solve)
from qiskit_gym_torch.rl import az as az_mod
from qiskit_gym_torch.rl.az import reward_to_go, trajectory_from_arrays
from qiskit_gym_torch.rl.rollout import solve_temperatures

from test_torch_mcts import (ALPHA, as_port, gym_pair, jax_search_draws,
                             jax_step_draw, policy_pair, t)

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
AZ_ARTIFACTS = ["az_perm_grid_3x3", "az_perm_heavy_hex_27q",
                "az_clifford_heavy_hex_27q", "az_pauli_18_line",
                "az_pauli_heavy_hex_27q", "az_pauli_heavy_hex_27q_dense",
                "az_pauli_heavy_hex_27q_full"]
EXACT = ("obs", "action", "actual", "valid", "done", "inverted", "reward",
         "success")


def _paths(name):
    return (os.path.join(MODELS, name + ".json"),
            os.path.join(MODELS, name + ".pt"))


def jax_move_draws(jcore, key, T, S, E, B):
    """The draws of a T-move JAX MCTS collector started with `key`, as the
    port's keyword arguments: per move the keys (k_sim, k_act, k_step) of
    `split(key, 3 * T).reshape(T, 3)` feed the search, the Gumbel noise and
    the played step."""
    A = jcore.num_actions
    keys = jax.random.split(key, 3 * T).reshape(T, 3)
    gam, sf, sp, gum, fl, pm = [], [], [], [], [], []
    for k_sim, k_act, k_step in keys:
        g, f, p = jax_search_draws(jcore, k_sim, S, E, B)
        gam.append(g)
        sf.append(f)
        sp.append(p)
        gum.append(np.asarray(jax.random.gumbel(k_act, (B, A))))
        f, p = jax_step_draw(jcore, k_step, B)
        fl.append(np.zeros(B, bool) if f is None else f)
        pm.append(p)
    with_perms = pm[0] is not None
    return dict(
        root_gamma=t(np.stack(gam)), sim_flips=t(np.stack(sf)),
        sim_perms=t(np.stack(sp)) if with_perms else None,
        gumbel=t(np.stack(gum)), flips=t(np.stack(fl)),
        perms=t(np.stack(pm)) if with_perms else None)


def assert_traj_matches(ttraj, jtraj):
    for field in EXACT:
        got = getattr(ttraj, field).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jtraj, field)).astype(got.dtype),
            err_msg=field)
    np.testing.assert_allclose(ttraj.visit_probs.numpy(),
                               np.asarray(jtraj.visit_probs), atol=1e-6,
                               rtol=1e-6)


def assert_state_equal(js, ts):
    for f in js._fields:
        j = np.asarray(getattr(js, f))
        j = j.view(np.int32) if j.dtype == np.uint32 else j
        np.testing.assert_array_equal(j, getattr(ts, f).numpy(), err_msg=f)


# ------------------------------------------------------------ collect_mcts
COLLECT_CASES = {
    "clifford-noise-drop": ("clifford", dict(noise_eps=0.25,
                                             temperature_drop=2)),
    "permutation-deterministic": ("permutation", dict(deterministic=True)),
    "pauli-lane-temp": ("pauli", dict(lane_temp=True, max_expand_depth=2)),
    "pauli-temperature": ("pauli", dict(temperature=0.7, noise_eps=0.25)),
}


@pytest.mark.parametrize("case", list(COLLECT_CASES))
def test_collect_mcts_with_injected_draws_matches_jax(case):
    kind, kw = COLLECT_CASES[case]
    kw = dict(kw)
    jenv, tenv = gym_pair(kind)
    jpol, params, tpol = policy_pair(jenv)
    T, B, S = 5, 8, 8     # one move more than the depth budget of 4
    E = kw.get("max_expand_depth", 1)
    lane_temp = None
    if kw.pop("lane_temp", False):
        lane_temp = np.asarray(solve_temperatures(B))
    jstate = jenv.core.reset(jax.random.key(1), B, 2)
    key = jax.random.key(11)
    jfinal, jtraj = jax.jit(lambda s, k: jax_az.collect_mcts(
        jenv.core, jpol.apply, params, s, k, T, num_sims=S, c_puct=1.41,
        dirichlet_alpha=ALPHA,
        lane_temp=None if lane_temp is None else jnp.asarray(lane_temp),
        **kw))(jstate, key)
    tfinal, ttraj = collect_mcts(
        tenv.core, tpol, as_port(jstate, tenv.core), T, num_sims=S,
        c_puct=1.41, dirichlet_alpha=ALPHA,
        lane_temp=None if lane_temp is None else t(lane_temp),
        **kw, **jax_move_draws(jenv.core, key, T, S, E, B))
    assert_traj_matches(ttraj, jtraj)
    assert_state_equal(jfinal, tfinal)
    assert ttraj.valid.any() and not ttraj.valid.all()  # lanes did finish
    if kind == "pauli":   # the two frames do differ under an automorphism
        assert (ttraj.action != ttraj.actual).any()
    if kw.get("temperature_drop"):
        late = ttraj.visit_probs[kw["temperature_drop"]:]
        assert torch.equal(ttraj.action[kw["temperature_drop"]:],
                           late.argmax(-1))


@pytest.mark.parametrize("kind,replay,drop", [("clifford", 0, 1),
                                              ("pauli", 2, 0)])
def test_collect_mcts_packed_with_injected_draws_matches_jax(kind, replay,
                                                             drop):
    jenv, tenv = gym_pair(kind)
    jcore = jenv.core
    jpol, params, tpol = policy_pair(jenv)
    T, B, S, slots, difficulty = 6, 8, 8, 3, 2
    key = jax.random.key(13)
    kw = dict(num_sims=S, c_puct=1.41, pool_slots=slots, noise_eps=0.25,
              dirichlet_alpha=ALPHA, temperature_drop=drop,
              diff_replay=replay)
    jfinal, jtraj, jstats = jax.jit(lambda k: jax_az.collect_mcts_packed(
        jcore, jpol.apply, params, k, T, B, difficulty, **kw))(key)
    # the JAX side's own key splits
    k_pool, k_roll, k_slot, k_rot = jax.random.split(key, 4)
    jpool, _ = jax_rollout.make_packed_pool(jcore, k_pool, B, slots,
                                            difficulty, diff_replay=replay)
    tfinal, ttraj, tstats = collect_mcts_packed(
        tenv.core, tpol, T, B, difficulty, pool=as_port(jpool, tenv.core),
        slots=t(jax.random.randint(k_slot, (T,), 0, slots)),
        rots=t(jax.random.randint(k_rot, (T,), 0, B)),
        **kw, **jax_move_draws(jcore, k_roll, T, S, 1, B))
    assert_traj_matches(ttraj, jtraj)
    assert_state_equal(jfinal, tfinal)
    for k in ("episodes_completed", "episodes_succeeded"):
        np.testing.assert_array_equal(tstats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)
    np.testing.assert_allclose(tstats["last_value"].numpy(),
                               np.asarray(jstats["last_value"]), atol=1e-5,
                               rtol=1e-5)
    # episodes ended inside the horizon, so lanes were refilled
    assert int(tstats["episodes_completed"].sum()) >= B // 2


def test_packed_temperature_drop_counts_moves_of_the_episode():
    """With temperature_drop = 1 every move after an episode's first is the
    argmax of its visits, and a refilled lane samples its first move again:
    the gate is the lane's own move counter, not the loop index."""
    _, tenv = gym_pair("permutation")
    tpol = policy_pair(gym_pair("permutation")[0])[2]
    T, B = 8, 16
    g = torch.Generator().manual_seed(3)
    _, traj, stats = collect_mcts_packed(
        tenv.core, tpol, T, B, 1, num_sims=6, c_puct=1.41, pool_slots=2,
        temperature_drop=1, generator=g)
    greedy = traj.visit_probs.argmax(-1)
    first = torch.ones(B, dtype=torch.bool)
    sampled_first_moves = 0
    for step in range(T):
        later = ~first & traj.valid[step]
        assert torch.equal(traj.action[step][later], greedy[step][later])
        sampled_first_moves += int((first & traj.valid[step]
                                    & (traj.action[step] != greedy[step])
                                    ).sum())
        first = traj.done[step] | ~traj.valid[step]
    assert int(stats["episodes_completed"].sum()) > B
    assert sampled_first_moves > 0    # first moves after a refill do sample


# ----------------------------------------------------------- value targets
def _np_traj(rng, T, B, obs_shape, A, packed):
    """A random AZ trajectory as numpy arrays: frozen tails (aligned), or
    episodes that end and restart inside a lane (packed)."""
    if packed:
        valid = rng.random((T, B)) < 0.9
        done = (rng.random((T, B)) < 0.3) & valid
    else:
        length = rng.integers(1, T + 1, B)
        valid = np.arange(T)[:, None] < length[None, :]
        done = np.arange(T)[:, None] >= (length - 1)[None, :]
    probs = rng.random((T, B, A)).astype(np.float32)
    return dict(
        obs=rng.integers(0, 2, (T, B) + tuple(obs_shape), dtype=np.uint8),
        visit_probs=probs / probs.sum(-1, keepdims=True),
        action=rng.integers(0, A, (T, B)), actual=rng.integers(0, A, (T, B)),
        inverted=rng.random((T, B)) < 0.5,
        reward=rng.standard_normal((T, B)).astype(np.float32) * valid,
        valid=valid, done=done, success=rng.random(B) < 0.5)


def _jax_reward_to_go(d, last_value):
    """The reverse scan of the JAX package's AZ train step."""
    def back(g, xs):
        r, done, valid = xs
        g = r + g * (1.0 - done)
        return jnp.where(valid, g, 0.0), jnp.where(valid, g, 0.0)

    g0 = (jnp.zeros(d["reward"].shape[1]) if last_value is None
          else jnp.asarray(last_value))
    _, returns = jax.lax.scan(
        back, g0, (jnp.asarray(d["reward"]),
                   jnp.asarray(d["done"], jnp.float32),
                   jnp.asarray(d["valid"])), reverse=True)
    return np.asarray(returns)


@pytest.mark.parametrize("packed", [False, True])
def test_reward_to_go_matches_the_jax_scan(packed):
    rng = np.random.default_rng(0)
    T, B = 10, 9
    d = _np_traj(rng, T, B, (4, 4), 5, packed)
    last = rng.standard_normal(B).astype(np.float32) if packed else None
    got = reward_to_go(trajectory_from_arrays(d),
                       None if last is None else t(last)).numpy()
    np.testing.assert_allclose(got, _jax_reward_to_go(d, last), atol=1e-6,
                               rtol=1e-6)
    assert (got[~d["valid"]] == 0).all()
    if not packed:  # a plain sum of what is still to come in the episode
        np.testing.assert_allclose(
            got[0], d["reward"].sum(0), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------ loss and gradient
def _az_pair(**cfg):
    """A JAX AZ and the port's AZ on the 4q-line Clifford gym with one set
    of random weights."""
    jenv, tenv = gym_pair("clifford")
    jpol, params, tpol = policy_pair(jenv)
    kw = dict(dict(num_episodes=8, num_mcts_searches=8, num_epochs=2), **cfg)
    jaz = jax_az.AZ(jenv, jpol, JaxAZConfig(**kw), params=params)
    taz = AZ(tenv, tpol, AlphaZeroConfig(**kw),
             params=params_from_jax(params))
    return jaz, taz


def _assert_grads_close(taz, jgrads):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in taz.policy.module.named_parameters():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_loss_value_and_gradient_match_jax():
    jaz, taz = _az_pair()
    rng = np.random.default_rng(1)
    T, B = 5, 7
    d = _np_traj(rng, T, B, (8, 8), jaz.core.num_actions, packed=True)
    ret = rng.standard_normal((T, B)).astype(np.float32)
    jtraj = jax_az.AZTrajectory(**{k: jnp.asarray(v) for k, v in d.items()})
    (_, jaux), jgrads = jax.value_and_grad(jaz._loss, has_aux=True)(
        jaz.params, jtraj, jnp.asarray(ret))
    tloss, taux = taz._loss(trajectory_from_arrays(d), t(ret))
    tloss.backward()
    assert set(taux) == set(jaux) == {"loss", "pg_loss", "v_loss"}
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_grads_close(taz, jgrads)


def test_loss_flat_value_and_gradient_match_jax():
    jaz, taz = _az_pair()
    rng = np.random.default_rng(2)
    N = 30
    d = _np_traj(rng, 1, N, (8, 8), jaz.core.num_actions, packed=True)
    batch = {"obs": d["obs"][0], "visit_probs": d["visit_probs"][0],
             "valid": d["valid"][0],
             "ret": rng.standard_normal(N).astype(np.float32)}
    (_, jaux), jgrads = jax.value_and_grad(jaz._loss_flat, has_aux=True)(
        jaz.params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, taux = taz._loss_flat({k: t(v) for k, v in batch.items()})
    tloss.backward()
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_grads_close(taz, jgrads)


@pytest.mark.parametrize("packing,minibatches", [(False, 1), (True, 3)])
def test_train_step_metrics_have_the_jax_keys(packing, minibatches):
    jaz, taz = _az_pair(episode_packing=packing, num_minibatches=minibatches,
                        pack_pool_slots=2, root_noise_eps=0.25,
                        temperature_drop=2, diff_replay=1)
    before = {k: v.clone() for k, v in taz.params.items()}
    metrics = taz.train_step(4, 8, 2)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics["steps_collected"] > 0
    assert any(not torch.equal(before[k], v) for k, v in taz.params.items())
    _, _, jmetrics = jaz._make_train_step(4, 8)(
        jaz.params, jaz.opt_state, jax.random.key(0), jnp.int32(2))
    assert set(metrics) == set(jmetrics)


# ------------------------------------------------------------------ solve
def test_mcts_solve_returns_a_verified_solution_and_stops_early(monkeypatch):
    _, tenv = gym_pair("permutation")
    tpol = policy_pair(gym_pair("permutation")[0])[2]
    searches = []
    real = az_mod.mcts_search

    def spy(*args, **kw):
        searches.append(kw["max_depth"])
        return real(*args, **kw)

    monkeypatch.setattr(az_mod, "mcts_search", spy)
    pattern = [1, 0, 3, 2]
    g = torch.Generator().manual_seed(0)
    actions = mcts_solve(tenv, tpol, tenv.get_state(pattern), num_searches=4,
                         num_mcts_searches=24, C=1.41, generator=g)
    assert actions is not None
    out = tenv.build_circuit_from_solution(actions, pattern)
    assert permutation_pattern(linear_from_circuit(out)).tolist() == pattern
    # every lane was final long before the 16-move budget, and every search
    # kept the full-horizon depth cap min(max_depth, 32)
    assert 2 <= len(searches) < tenv.core.max_depth
    assert set(searches) == {16}


def test_mcts_solve_pauli_records_env_frame_actions():
    """MCTS synth on the Pauli family, whose observations are permuted by a
    random automorphism: the circuit is rebuilt from the env-frame actions,
    so it implements the target whichever automorphisms fired."""
    _, tenv = gym_pair("pauli")
    assert tenv.core.num_perms == 2
    cfg = AlphaZeroConfig(
        num_episodes=8, num_mcts_searches=8, num_epochs=1,
        evals={"mcts_100": EvalConfig(num_episodes=4, num_mcts_searches=4)})
    rls = RLSynthesis(tenv, cfg, BasicPolicyConfig(embedding_size=32,
                                                   common_layers=[16]))
    target = Circuit(3).h(0).cx(0, 1).rz(0.7, 1)
    out = rls.synth(target, num_searches=32, num_mcts_searches=16)
    assert out is not None, "MCTS synth failed on a 1-rotation 3q target"
    assert allclose_up_to_global_phase(circuit_unitary(out),
                                       circuit_unitary(target))


# ------------------------------------------------------- artifacts, learn
@pytest.mark.parametrize("name", AZ_ARTIFACTS)
def test_az_artifacts_load_with_their_weights(name):
    rls = RLSynthesis.from_config_json(*_paths(name), device="cpu")
    assert isinstance(rls.algorithm, AZ)
    with open(_paths(name)[0]) as f:
        full = json.load(f)
    out = rls.to_json()["algorithm"]   # (the default evals are merged in)
    for section in ("collecting", "training", "learning", "optimizer"):
        assert out[section] == full["algorithm"][section], section
    assert full["algorithm"]["evals"].items() <= out["evals"].items()
    assert rls.rl_config.evals[rls.rl_config.diff_metric].num_mcts_searches > 0


def test_az_artifact_synth_with_mcts_and_with_the_policy():
    rls = RLSynthesis.from_config_json(*_paths("az_perm_grid_3x3"),
                                       device="cpu")
    # two swaps through the tree; one swap by the policy's priors alone
    for pattern, kw in (
            ([1, 0, 2, 3, 4, 5, 8, 7, 6], dict(num_mcts_searches=16,
                                               num_searches=8)),
            ([1, 0, 2, 3, 4, 5, 6, 7, 8], dict(num_searches=100))):
        out = rls.synth(pattern, **kw)
        assert out is not None, kw
        assert permutation_pattern(
            linear_from_circuit(out)).tolist() == pattern, kw


def _az_perm_grid(**updates):
    rls = RLSynthesis.from_config_json(_paths("az_perm_grid_3x3")[0],
                                       device="cpu")
    rls.rl_config = rls.rl_config.with_updates(**updates)
    rls.algorithm.config = rls.rl_config
    return rls


SMALL = dict(
    num_episodes=32, num_mcts_searches=16,
    evals={"mcts_100": EvalConfig(num_episodes=16, num_mcts_searches=16),
           "ppo_deterministic": EvalConfig(num_episodes=16)})


def test_learn_on_perm_grid_advances_the_difficulty(tmp_path):
    rls = _az_perm_grid(checkpoint_freq=2, **SMALL)
    before = {k: v.clone() for k, v in rls.params.items()}
    run = str(tmp_path / "run")
    rls.learn(initial_difficulty=1, num_iterations=4, tb_path=run)
    algo = rls.algorithm
    assert rls.env.difficulty > 1 and algo.best_difficulty >= 1
    assert algo.best_params is not None and algo.iteration == 4
    assert any(not torch.equal(before[k], v) for k, v in rls.params.items())
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert {"loss", "pg_loss", "v_loss", "success_rate", "steps_collected",
            "eval/mcts_100", "eval/ppo_deterministic"} <= set(rows[0])
    # the difficulty follows the gate, iteration by iteration
    passed = sum(r["eval/mcts_100"] >= rls.rl_config.diff_threshold
                 for r in rows)
    assert rls.env.difficulty == 1 + passed
    for name in ("checkpoint_2.pt", "checkpoint_4.pt", "train_state.pt"):
        assert os.path.exists(os.path.join(run, name)), name
    cfg, pt = str(tmp_path / "m.json"), str(tmp_path / "m.pt")
    rls.save(cfg, pt, best=True)
    back = RLSynthesis.from_config_json(cfg, pt, device="cpu")
    assert isinstance(back.algorithm, AZ)
    for k, v in algo.best_params.items():
        assert torch.equal(back.params[k], v), k


def test_training_state_round_trip_and_resume(tmp_path):
    a = _az_perm_grid(episode_packing=True, pack_pool_slots=2,
                      num_minibatches=2, **SMALL)
    a.learn(initial_difficulty=1, num_iterations=2)
    path = str(tmp_path / "train_state.pt")
    a.algorithm.save_training_state(path)
    b = _az_perm_grid(episode_packing=True, pack_pool_slots=2,
                      num_minibatches=2, **SMALL)
    b.algorithm.restore_training_state(path)
    x, y = a.algorithm, b.algorithm
    assert (y.iteration, b.env.difficulty, y.best_difficulty) == (
        x.iteration, a.env.difficulty, x.best_difficulty)
    assert torch.equal(x.generator.get_state(), y.generator.get_state())
    # both continue identically: optimizer, generator and curriculum resumed
    x.learn(1)
    y.learn(1)
    for k, v in x.params.items():
        assert torch.equal(y.params[k], v), k
    assert a.env.difficulty == b.env.difficulty


def test_az_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        rls = RLSynthesis.from_config_json(*_paths("az_perm_grid_3x3"))
        assert rls.algorithm.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RLSynthesis.from_config_json(*_paths("az_perm_grid_3x3"))
