"""The port's PPO training path against the JAX package, on the CPU.

Small sizes (4 qubits on a line, B <= 64, embedding 32). Inputs come from
numpy seeds; where the JAX side draws from its own keys (the packed
collector), the same draws are taken from the same key splits and injected
into the port. Tolerances: env-side values (actions, flags, rewards) exact;
`logp`/`value` 1e-5 and the loss and its gradient 1e-5 relative (float32
matmuls summed in another order); GAE and one Adam step 1e-6."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import qiskit_gym_tpu.rl.rollout as jax_rollout
from qiskit_gym_tpu.envs import LinearFunctionGym as JaxLinearGym
from qiskit_gym_tpu.models.policies import make_policy as jax_make_policy
from qiskit_gym_tpu.rl.configs import PPOConfig as JaxPPOConfig
from qiskit_gym_tpu.rl.ppo import PPO as JaxPPO
from qiskit_gym_torch.envs import LinearFunctionGym
from qiskit_gym_torch.models import (adam_state_from_optax, make_policy,
                                     params_from_jax)
from qiskit_gym_torch.ops.matrix_env import state_from_arrays
from qiskit_gym_torch.rl import PPO, EvalConfig, PPOConfig, RLSynthesis
from qiskit_gym_torch.rl.rollout import (Trajectory, collect_packed, gae,
                                         make_packed_pool, packed_refill,
                                         sample_difficulties)

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
LINE_4 = [(0, 1), (1, 2), (2, 3)]
POLICY_CFG = dict(embedding_size=32, common_layers=[16], policy_layers=[],
                  value_layers=[])
CFG = dict(num_episodes=16, num_epochs=2, vf_coef=0.8, ent_coef=0.01,
           clip_ratio=0.1, lr=3e-4)


def _pair(seed=3, **cfg):
    """A JAX PPO and the port's PPO on a 4q-line linear-function gym, with
    one set of random weights carried across."""
    jenv = JaxLinearGym.from_coupling_map(LINE_4, max_depth=16)
    tenv = LinearFunctionGym.from_coupling_map(LINE_4, max_depth=16,
                                               device="cpu")
    obs_shape, A = tuple(jenv.obs_shape()), jenv.num_actions()
    jpol = jax_make_policy("BasicPolicy", obs_shape, A, POLICY_CFG)
    tpol = make_policy("BasicPolicy", obs_shape, A, POLICY_CFG)
    params = jax.tree.map(np.asarray, jpol.init(jax.random.key(seed)))
    kw = dict(CFG, **cfg)
    jppo = JaxPPO(jenv, jpol, JaxPPOConfig(**kw), params=params)
    tppo = PPO(tenv, tpol, PPOConfig(**kw), params=params_from_jax(params))
    return jppo, tppo


def _np_traj(rng, T, B, obs_shape, A):
    """A random trajectory with frozen tails, as numpy arrays."""
    length = rng.integers(1, T + 1, B)
    valid = np.arange(T)[:, None] < length[None, :]
    done = np.arange(T)[:, None] >= (length - 1)[None, :]
    return dict(
        obs=rng.integers(0, 2, (T, B) + tuple(obs_shape), dtype=np.uint8),
        action=rng.integers(0, A, (T, B)),
        logp=-rng.random((T, B)).astype(np.float32) * 2 - 0.1,
        value=rng.standard_normal((T, B)).astype(np.float32),
        reward=(rng.standard_normal((T, B)).astype(np.float32) * valid),
        valid=valid, done=done,
        inverted=rng.random((T, B)) < 0.5,
        success=rng.random(B) < 0.5)


def _trajs(d):
    jt = jax_rollout.Trajectory(
        obs=jnp.asarray(d["obs"]), action=jnp.asarray(d["action"], jnp.int32),
        actual=jnp.asarray(d["action"], jnp.int32),
        logp=jnp.asarray(d["logp"]), value=jnp.asarray(d["value"]),
        reward=jnp.asarray(d["reward"]), valid=jnp.asarray(d["valid"]),
        done=jnp.asarray(d["done"]), inverted=jnp.asarray(d["inverted"]),
        success=jnp.asarray(d["success"]))
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    tt = Trajectory(actual=t["action"], **t)
    return jt, tt


# ------------------------------------------------------------------- GAE
@pytest.mark.parametrize("with_last_value", [False, True])
def test_gae_matches_jax(with_last_value):
    rng = np.random.default_rng(0)
    T, B = 12, 9
    d = _np_traj(rng, T, B, (4, 4), 6)
    # packed trajectories have valid rows after a done row too
    d["valid"][:, :3] = True
    d["done"][:, :3] = rng.random((T, 3)) < 0.3
    jt, tt = _trajs(d)
    last = rng.standard_normal(B).astype(np.float32)
    jadv, jret = jax_rollout.gae(
        jt, 0.995, 0.97,
        last_value=jnp.asarray(last) if with_last_value else None)
    tadv, tret = gae(tt, 0.995, 0.97,
                     last_value=torch.as_tensor(last) if with_last_value
                     else None)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-6,
                               rtol=1e-6)
    assert (tadv.numpy()[~d["valid"]] == 0).all()


# ------------------------------------------------ difficulties and refill
@pytest.mark.parametrize("difficulty,replay", [(7, 3), (2, 5), (4, 0)])
def test_sample_difficulties_with_injected_offsets(difficulty, replay):
    key = jax.random.key(5)
    count = 24
    want = jax_rollout.sample_difficulties(key, count, difficulty, replay)
    if replay == 0:
        assert sample_difficulties(count, difficulty, 0) == difficulty == want
        return
    off = np.asarray(jax.random.randint(key, (count,), 0, replay + 1))
    got = sample_difficulties(count, difficulty, replay,
                              offsets=torch.as_tensor(off))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = sample_difficulties(count, difficulty, replay,
                                generator=torch.Generator().manual_seed(1))
    assert (drawn[::2] == difficulty).all()
    assert (drawn >= max(1, difficulty - replay)).all()
    assert (drawn <= difficulty).all()


def _jax_pool(jppo, key, B, slots, difficulty, replay=0):
    pool, state0 = jax_rollout.make_packed_pool(
        jppo.core, key, B, slots, difficulty, diff_replay=replay)
    return pool, state0


def _as_port(state):
    return state_from_arrays({f: np.asarray(getattr(state, f))
                              for f in state._fields}, device="cpu")


def _assert_state_equal(js, ts, where=""):
    for f in js._fields:
        j = np.asarray(getattr(js, f))
        j = j.view(np.int32) if j.dtype == np.uint32 else j
        np.testing.assert_array_equal(j, getattr(ts, f).numpy(),
                                      err_msg=f"{f} {where}")


@pytest.mark.parametrize("slot,rot", [(0, 0), (2, 5), (3, 15)])
def test_packed_refill_matches_jax(slot, rot):
    jppo, _ = _pair()
    B, slots = 16, 4
    jpool, jstate = _jax_pool(jppo, jax.random.key(1), B, slots, 3)
    tpool, tstate = _as_port(jpool), _as_port(jstate)
    refresh = np.random.default_rng(slot).random(B) < 0.5
    want = jax_rollout.packed_refill(jpool, jstate, jnp.asarray(refresh),
                                     jnp.int32(slot), jnp.int32(rot))
    got = packed_refill(tpool, tstate, torch.as_tensor(refresh), slot, rot)
    _assert_state_equal(want, got, f"slot={slot} rot={rot}")


def test_make_packed_pool_shapes_and_per_lane_budget():
    _, tppo = _pair()
    B, slots = 8, 3
    g = torch.Generator().manual_seed(0)
    pool, state0 = make_packed_pool(tppo.core, B, slots, 5, diff_replay=2,
                                    generator=g)
    assert pool.a.shape[:2] == (slots, B) and state0.a.shape[0] == B
    assert torch.equal(state0.a, pool.a[0])
    # each lane's depth budget follows its own difficulty
    assert set(pool.depth.unique().tolist()) <= {6, 8, 10}
    assert (pool.depth[:, ::2] == 10).all()


# -------------------------------------------------------- collect_packed
@pytest.mark.parametrize("difficulty,replay", [(3, 0), (4, 2)])
def test_collect_packed_with_injected_draws_matches_jax(difficulty, replay):
    jppo, tppo = _pair()
    jcore = jppo.core
    T, B, slots = 14, 16, 4
    key = jax.random.key(9)
    # the JAX side's own key splits
    k_pool, k_roll, k_slot, k_rot = jax.random.split(key, 4)
    jpool, _ = _jax_pool(jppo, k_pool, B, slots, difficulty, replay)
    gumbel, flips, _ = jax_rollout._pregen_randomness(jcore, k_roll, T, B,
                                                      False)
    jslots = jax.random.randint(k_slot, (T,), 0, slots)
    jrots = jax.random.randint(k_rot, (T,), 0, B)

    jfinal, jtraj, jstats = jax_rollout.collect_packed(
        jcore, jppo.policy.apply, jppo.params, key, T, B, difficulty,
        pool_slots=slots, diff_replay=replay)
    tfinal, ttraj, tstats = collect_packed(
        tppo.core, tppo.policy, T, B, difficulty, pool_slots=slots,
        diff_replay=replay, pool=_as_port(jpool),
        gumbel=torch.as_tensor(np.asarray(gumbel)),
        flips=torch.as_tensor(np.asarray(flips)),
        slots=torch.as_tensor(np.asarray(jslots)),
        rots=torch.as_tensor(np.asarray(jrots)))

    for field in ("obs", "action", "actual", "valid", "done", "inverted",
                  "reward", "success"):
        got = getattr(ttraj, field).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jtraj, field)).astype(got.dtype),
            err_msg=field)
    for field in ("logp", "value"):
        np.testing.assert_allclose(getattr(ttraj, field).numpy(),
                                   np.asarray(getattr(jtraj, field)),
                                   atol=1e-5, rtol=1e-5)
    _assert_state_equal(jfinal, tfinal, "final")
    for k in ("episodes_completed", "episodes_succeeded"):
        np.testing.assert_array_equal(tstats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)
    np.testing.assert_allclose(tstats["last_value"].numpy(),
                               np.asarray(jstats["last_value"]), atol=1e-5,
                               rtol=1e-5)
    # episodes ended inside the horizon, so lanes were refilled
    assert int(tstats["episodes_completed"].sum()) >= B
    # (a lane refilled with an already-solved scramble idles one step)
    assert ttraj.valid.float().mean() > 0.9


# ------------------------------------------------------ loss and gradient
def _assert_grads_close(tppo, jgrads):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in tppo.policy.module.named_parameters():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("normalize", [False, True])
def test_loss_value_and_gradient_match_jax(normalize):
    jppo, tppo = _pair(normalize_advantage=normalize)
    rng = np.random.default_rng(1)
    T, B = 6, 10
    d = _np_traj(rng, T, B, (4, 4), jppo.core.num_actions)
    jt, tt = _trajs(d)
    adv = rng.standard_normal((T, B)).astype(np.float32)
    ret = rng.standard_normal((T, B)).astype(np.float32)
    (jloss, jaux), jgrads = jax.value_and_grad(jppo._loss, has_aux=True)(
        jppo.params, jt, jnp.asarray(adv), jnp.asarray(ret))
    tloss, taux = tppo._loss(tt, torch.as_tensor(adv), torch.as_tensor(ret))
    tloss.backward()
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_grads_close(tppo, jgrads)


@pytest.mark.parametrize("normalize", [False, True])
def test_loss_flat_value_and_gradient_match_jax(normalize):
    jppo, tppo = _pair(normalize_advantage=normalize)
    rng = np.random.default_rng(2)
    N = 40
    d = _np_traj(rng, 1, N, (4, 4), jppo.core.num_actions)
    batch = {"obs": d["obs"][0], "action": d["action"][0],
             "logp": d["logp"][0], "valid": rng.random(N) < 0.8,
             "adv": rng.standard_normal(N).astype(np.float32),
             "ret": rng.standard_normal(N).astype(np.float32)}
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "action" else None)
              for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(
        jppo._loss_flat, has_aux=True)(jppo.params, jbatch)
    tloss, taux = tppo._loss_flat({k: torch.as_tensor(v)
                                   for k, v in batch.items()})
    tloss.backward()
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_grads_close(tppo, jgrads)


# ------------------------------------------------------------------ Adam
def test_adam_steps_match_optax():
    """Two Adam steps: the first from a fresh state on both sides, the
    second with optax's state carried into torch.optim.Adam."""
    jppo, tppo = _pair()
    rng = np.random.default_rng(4)
    T, B = 5, 8
    jparams, jopt = jppo.params, jppo.opt_state
    for step in range(2):
        d = _np_traj(rng, T, B, (4, 4), jppo.core.num_actions)
        jt, tt = _trajs(d)
        adv = rng.standard_normal((T, B)).astype(np.float32)
        ret = rng.standard_normal((T, B)).astype(np.float32)
        if step == 1:  # start the port's optimizer from optax's state
            adam = jopt[0]
            tppo.policy.module.load_state_dict(
                params_from_jax(jax.tree.map(np.asarray, jparams)))
            adam_state_from_optax(
                tppo.optimizer, tppo.policy.module,
                jax.tree.map(np.asarray, adam.mu),
                jax.tree.map(np.asarray, adam.nu), int(adam.count))
        (_, _), grads = jax.value_and_grad(jppo._loss, has_aux=True)(
            jparams, jt, jnp.asarray(adv), jnp.asarray(ret))
        updates, jopt = jppo.tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tppo._update(tppo._loss, tt, torch.as_tensor(adv),
                     torch.as_tensor(ret))
        want = params_from_jax(jax.tree.map(np.asarray, jparams))
        for name, p in tppo.policy.module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{name} {step}")


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("packing,minibatches", [(False, 1), (True, 4),
                                                 (False, 1000)])
def test_train_step_metrics_have_the_jax_keys(packing, minibatches):
    cfg = dict(episode_packing=packing, num_minibatches=minibatches,
               pack_pool_slots=2, diff_replay=1 if packing else 0,
               evals={"ppo_deterministic": EvalConfig(num_episodes=4)})
    jppo, tppo = _pair(**cfg)
    before = {k: v.clone() for k, v in tppo.params.items()}
    metrics = tppo.train_step(4, 16, 2)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics["steps_collected"] > 0
    assert any(not torch.equal(before[k], v)
               for k, v in tppo.params.items())
    jstep = jppo._make_train_step(4, 16)
    _, _, jmetrics = jstep(jppo.params, jppo.opt_state, jax.random.key(0),
                           jnp.int32(2))
    assert set(metrics) == set(jmetrics)


def test_horizon_and_fixed_horizon():
    _, tppo = _pair()
    assert [tppo._horizon(d) for d in (0, 1, 5, 50)] == [1, 2, 10, 16]
    tppo.fixed_horizon = True
    assert tppo._horizon(1) == 16


def test_eval_repeats_lanes_and_mcts_evals_raise():
    """An eval repeats each target over num_searches lanes; an `mcts_*` eval
    (num_mcts_searches > 0) of a PPO config runs a search per move, and
    raises nothing."""
    _, tppo = _pair()
    rate = tppo._eval(4, EvalConfig(num_episodes=6, deterministic=False,
                                    num_searches=5), 2)
    assert 0.0 <= rate <= 1.0
    assert abs(rate * 6 - round(rate * 6)) < 1e-5   # a mean over 6 targets
    mcts = tppo._eval(4, EvalConfig(num_episodes=4, num_mcts_searches=16), 1)
    # one gate from solved: 16 simulations find it on every target
    assert mcts == 1.0


def test_ppo_config_with_an_mcts_eval_gates_the_curriculum():
    jppo, tppo = _pair(
        diff_metric="mcts_8", num_episodes=16,
        evals={"mcts_8": EvalConfig(num_episodes=4, num_mcts_searches=8),
               "ppo_deterministic": EvalConfig(num_episodes=4)})
    tppo.env.difficulty = 1
    tppo.learn(1)
    evals = tppo.run_evals(1)
    assert set(evals) == {"mcts_8", "ppo_deterministic"}
    assert tppo.env.difficulty == 2 and tppo.best_difficulty == 1
    # MCTS solving from a PPO algorithm object
    pattern_state = tppo.env.get_state(np.array(
        [[1, 1, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    actions = tppo.solve(pattern_state, num_searches=4, num_mcts_searches=8)
    assert actions is not None and len(actions) >= 1


# ------------------------------------------------------------------ learn
def _perm_grid(**updates):
    rls = RLSynthesis.from_config_json(
        os.path.join(MODELS, "perm_grid_3x3.json"), device="cpu")
    if updates:
        rls.rl_config = rls.rl_config.with_updates(**updates)
        rls.algorithm.config = rls.rl_config
    return rls


def test_learn_on_perm_grid_advances_the_difficulty(tmp_path):
    rls = _perm_grid(num_episodes=256, checkpoint_freq=2)
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
    assert rows[0]["difficulty"] == 1 and rows[0]["steps_collected"] > 0
    with open(os.path.join(run, "run_summary.json")) as f:
        assert json.load(f)["best_difficulty"] == algo.best_difficulty
    for name in ("checkpoint_2.pt", "checkpoint_4.pt", "train_state.pt"):
        assert os.path.exists(os.path.join(run, name)), name
    # save(best=True) writes the snapshot of the last advance
    cfg, pt = str(tmp_path / "m.json"), str(tmp_path / "m.pt")
    rls.save(cfg, pt, best=True)
    back = RLSynthesis.from_config_json(cfg, pt, device="cpu")
    for k, v in algo.best_params.items():
        assert torch.equal(back.params[k], v), k


def test_training_state_round_trip_and_resume(tmp_path):
    a = _perm_grid(num_episodes=64, num_epochs=2)
    a.learn(initial_difficulty=1, num_iterations=2)
    path = str(tmp_path / "train_state.pt")
    a.algorithm.save_training_state(path)
    assert os.listdir(tmp_path) == ["train_state.pt"]   # no temp file left

    b = _perm_grid(num_episodes=64, num_epochs=2)
    b.algorithm.restore_training_state(path)
    x, y = a.algorithm, b.algorithm
    assert (y.iteration, b.env.difficulty, y.best_difficulty) == (
        x.iteration, a.env.difficulty, x.best_difficulty)
    for k, v in x.params.items():
        assert torch.equal(y.params[k], v), k
    assert (x.best_params is None) == (y.best_params is None)
    if x.best_params is not None:
        for k, v in x.best_params.items():
            assert torch.equal(y.best_params[k], v), k
    assert torch.equal(x.generator.get_state(), y.generator.get_state())
    sx, sy = x.optimizer.state_dict(), y.optimizer.state_dict()
    assert sx["param_groups"] == sy["param_groups"]
    for i, st in sx["state"].items():
        for k, v in st.items():
            assert torch.equal(sy["state"][i][k], v), (i, k)
    # both continue identically: optimizer, generator and curriculum resumed
    a.algorithm.learn(1)
    b.algorithm.learn(1)
    for k, v in x.params.items():
        assert torch.equal(y.params[k], v), k
    assert a.env.difficulty == b.env.difficulty
