"""Data parallelism over env lanes (`parallel/`, the `mesh=` arguments) on
the CPU: 2 gloo processes, started once for the module with the spawn
context and joined through a FileStore under a tmp path (no TCP port, so
the suite can run under xdist). They run every scenario below in turn,
within a time limit of their own; each test holds one scenario's results
against the single process.

A DP `train_step` must give the single-process step's params within 1e-5
(aligned and packed collection: every process draws the global noise and
keeps its lanes, the losses divide by the global valid count, the gradients
are summed), DP collection must give the single-process lanes exactly, a
DP solve the same circuit, and with mp=2 the tensor-sharded forward and
gradient must equal the unsharded ones within 1e-5. The lane roundings
must equal the JAX package's."""

import os
import traceback

import numpy as np
import pytest
import torch

TIMEOUT_S = 240
WORLD = 2
LINE_3 = [(0, 1), (1, 2)]
POLICY = {"embedding_size": 32, "common_layers": [16], "policy_layers": [8]}


# ----------------------------------------------------------- spawn harness
def _entry(fn, rank, world, workdir, args):
    from qiskit_gym_torch import parallel

    torch.set_num_threads(1)
    try:
        store = torch.distributed.FileStore(os.path.join(workdir, "store"),
                                            world)
        parallel.initialize(store=store, num_processes=world,
                            process_id=rank, backend="gloo")
        out = fn(rank, *args)
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
        parallel.shutdown()
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(workdir, fn, *args, world=WORLD):
    """Run fn(rank, *args) in `world` gloo processes; their results, by
    rank. Fails on an error in any process or after TIMEOUT_S."""
    import time

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(workdir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errors = [open(workdir / f"err{r}.txt").read() for r in range(world)
              if (workdir / f"err{r}.txt").exists()]
    assert not errors, "\n".join(errors)
    assert not hung, f"{len(hung)} process(es) still running after " \
        f"{TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(workdir / f"out{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------- scenarios
def _ppo(mesh, packing):
    from qiskit_gym_torch.envs import CliffordGym
    from qiskit_gym_torch.rl import BasicPolicyConfig, EvalConfig, PPOConfig
    from qiskit_gym_torch.rl import RLSynthesis

    env = CliffordGym.from_coupling_map(
        LINE_3, basis_gates=("H", "S", "CX"), max_depth=8, device="cpu")
    cfg = PPOConfig(num_episodes=32, num_epochs=2, num_minibatches=4,
                    normalize_advantage=True, episode_packing=packing,
                    pack_pool_slots=4, lr=1e-3,
                    evals={"ppo_deterministic": EvalConfig(num_episodes=8)})
    return RLSynthesis(env, cfg, BasicPolicyConfig(**POLICY), seed=3,
                       mesh=mesh).algorithm


def _az(mesh, packing):
    from qiskit_gym_torch.envs import PermutationGym
    from qiskit_gym_torch.rl import AlphaZeroConfig, BasicPolicyConfig
    from qiskit_gym_torch.rl import EvalConfig, RLSynthesis

    env = PermutationGym.from_coupling_map(
        [(0, 1), (1, 2), (2, 3)], max_depth=8, device="cpu")
    cfg = AlphaZeroConfig(num_episodes=32, num_mcts_searches=4, num_epochs=2,
                          num_minibatches=4, episode_packing=packing,
                          pack_pool_slots=4, root_noise_eps=0.25, lr=1e-3,
                          evals={"ppo_deterministic": EvalConfig(
                              num_episodes=8),
                              "mcts": EvalConfig(num_episodes=4,
                                                 num_mcts_searches=4)},
                          diff_metric="mcts")
    return RLSynthesis(env, cfg, BasicPolicyConfig(**POLICY), seed=3,
                       mesh=mesh).algorithm


ALGOS = {"ppo": _ppo, "az": _az}


def _train_step(rank, packing, mp, kind="ppo"):
    from qiskit_gym_torch.parallel import make_mesh

    algo = ALGOS[kind](make_mesh(mp=mp), packing)
    metrics = algo.train_step(8, 32, 2)
    return {"params": algo.params, "metrics": metrics,
            "evals": algo.run_evals(2)}


def _learn(rank, run_dir):
    from qiskit_gym_torch.parallel import make_mesh

    algo = _ppo(make_mesh(), True)
    algo.config.checkpoint_freq = 1
    algo.run_path = run_dir
    algo.learn(2)
    return {"params": algo.params, "difficulty": algo.env.difficulty,
            "best": algo.best_difficulty}


def _collect(rank):
    from qiskit_gym_torch.parallel import (make_mesh, replicate,
                                           shard_env_state)
    from qiskit_gym_torch.quantum import Circuit
    from qiskit_gym_torch.rl.rollout import collect, collect_packed

    mesh = make_mesh()
    algo = _ppo(mesh, False)
    core, g = algo.core, algo.generator
    state = shard_env_state(mesh, core.reset(32, 3, generator=g))
    final, traj = collect(core, algo.policy, state, 6, generator=g,
                          mesh=mesh)
    pfinal, ptraj, stats = collect_packed(core, algo.policy, 6, 32, 2,
                                          pool_slots=4, generator=g,
                                          mesh=mesh)
    target = Circuit(3).h(0).cx(0, 1).s(1).cx(1, 2)
    out = algo.env.get_state(target)
    sol = algo.solve(out, num_searches=7)
    mine = {"x": torch.full((3,), float(rank)), "n": [torch.tensor(rank)]}
    return {"final": final, "traj": traj, "pfinal": pfinal, "ptraj": ptraj,
            "stats": stats, "solution": sol,
            "replicated": replicate(mesh, mine)}


def _demo_pair(mesh):
    from qiskit_gym_torch.envs import PauliGym
    from qiskit_gym_torch.rl import (AlphaZeroConfig, BasicPolicyConfig,
                                     RLSynthesis, generate_demos)

    line = [(0, 1), (1, 2), (2, 3), (1, 0), (2, 1), (3, 2)]
    rls = RLSynthesis(
        PauliGym.from_coupling_map(line, basis_gates=("H", "S", "CX"),
                                   max_rotations=2, device="cpu"),
        AlphaZeroConfig(num_episodes=8, num_mcts_searches=4, lr=1e-3),
        BasicPolicyConfig(**POLICY), seed=4, mesh=mesh)
    rls.env.spec.rng = np.random.default_rng(0)
    return rls.algorithm, generate_demos(rls.env.spec, [2, 3], 6)


def _fit_demos(rank):
    from qiskit_gym_torch.parallel import make_mesh
    from qiskit_gym_torch.rl import fit_demos

    algo, demos = _demo_pair(make_mesh())
    aux = fit_demos(algo, demos, epochs=2, num_minibatches=3)
    return {"params": algo.params, "aux": aux}


def _initialize_twice(rank):  # last: it leaves the group as it was
    from qiskit_gym_torch import parallel

    args = parallel.initialize._args
    parallel.initialize(*args[:4], store=args[4])  # same: a no-op
    try:
        parallel.initialize("tcp://localhost:1", 4, rank)
    except RuntimeError as exc:
        refused = str(exc)
    else:
        refused = ""
    return {"count": parallel.process_count(),
            "primary": parallel.is_primary(), "refused": refused}


def _net():
    from qiskit_gym_torch.models import make_policy

    pol = make_policy("BasicPolicy", (6, 6), 10, POLICY)
    pol.module.reset_parameters(torch.Generator().manual_seed(0))
    obs = (torch.rand((5, 6, 6), generator=torch.Generator().manual_seed(1))
           > 0.5).float()
    w = torch.randn(5, 10, generator=torch.Generator().manual_seed(2))
    return pol, obs, w


def _forward_backward(pol, obs, w):
    logits, value = pol(obs)
    ((logits * w).sum() + (value ** 2).sum()).backward()
    grads = {}
    for name, p in pol.module.named_parameters():
        g = p.grad
        grads[name] = (g.full_tensor() if hasattr(g, "full_tensor")
                       else g).detach().clone()
    return logits.detach(), value.detach(), grads


def _mp_forward(rank):
    from qiskit_gym_torch.parallel import make_mesh, shard_params

    mesh = make_mesh(mp=2)
    pol, obs, w = _net()
    shard_params(mesh, pol.module)
    sharded = [name for name, p in pol.module.named_parameters()
               if hasattr(p, "full_tensor")]
    return _forward_backward(pol, obs, w) + (sharded,)


TRAIN_STEPS = [("ppo", False, 1), ("ppo", True, 1), ("ppo", False, 2),
               ("az", False, 1), ("az", True, 1)]


def _run_all(rank, workdir):
    """Every scenario, by name, in one process group."""
    out = {("train_step",) + k: _train_step(rank, k[1], k[2], k[0])
           for k in TRAIN_STEPS}
    out["learn"] = _learn(rank, os.path.join(workdir, "run"))
    out["collect"] = _collect(rank)
    out["fit_demos"] = _fit_demos(rank)
    out["mp_forward"] = _mp_forward(rank)
    out["initialize"] = _initialize_twice(rank)
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The 2 processes' results of every scenario, by rank."""
    workdir = tmp_path_factory.mktemp("dp")
    return workdir, _spawn(workdir, _run_all, str(workdir))


# ----------------------------------------------------------------- tests
@pytest.mark.parametrize("kind,packing,mp", TRAIN_STEPS,
                         ids=["ppo-aligned", "ppo-packed", "ppo-aligned-mp2",
                              "az-aligned", "az-packed"])
def test_dp_train_step_matches_single_process(dp, kind, packing, mp):
    outs = [o[("train_step", kind, packing, mp)] for o in dp[1]]
    algo = ALGOS[kind](None, packing)
    metrics = algo.train_step(8, 32, 2)
    for out in outs:  # every process holds the same, single-process step
        for k, v in algo.params.items():
            np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
        for k in ("loss", "success_rate", "steps_collected"):
            assert abs(out["metrics"][k] - metrics[k]) <= 1e-5, k
    want = algo.run_evals(2)
    assert outs[0]["evals"] == outs[1]["evals"]
    for k, v in want.items():
        assert abs(outs[0]["evals"][k] - v) <= 1e-6, k


def test_dp_learn_checkpoints_once_and_matches(dp, tmp_path):
    """Two iterations of `learn` with a checkpoint after each: the primary
    process alone writes, the snapshot is the single process's, and so are
    the weights and the curriculum."""
    from qiskit_gym_torch.rl.checkpoint import restore_training_state

    run_dir = str(dp[0] / "run")
    outs = [o["learn"] for o in dp[1]]
    algo = _ppo(None, True)
    algo.config.checkpoint_freq = 1
    algo.run_path = str(tmp_path / "single")
    algo.learn(2)
    assert sorted(os.listdir(run_dir)) == sorted(os.listdir(algo.run_path))
    for out in outs:
        assert (out["difficulty"], out["best"]) == (
            algo.env.difficulty, algo.best_difficulty)
        for k, v in algo.params.items():
            np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
    other = _ppo(None, True)
    restore_training_state(other, os.path.join(run_dir, "train_state.pt"))
    assert other.iteration == 2
    for k, v in outs[0]["params"].items():
        assert torch.equal(other.params[k], v), k


def test_dp_collect_and_solve_match_single_process(dp):
    from qiskit_gym_torch.quantum import Circuit
    from qiskit_gym_torch.rl.rollout import collect, collect_packed

    outs = [o["collect"] for o in dp[1]]
    algo = _ppo(None, False)
    core, g = algo.core, algo.generator
    final, traj = collect(core, algo.policy, core.reset(32, 3, generator=g),
                          6, generator=g)
    pfinal, ptraj, stats = collect_packed(core, algo.policy, 6, 32, 2,
                                          pool_slots=4, generator=g)
    sol = algo.solve(algo.env.get_state(
        Circuit(3).h(0).cx(0, 1).s(1).cx(1, 2)), num_searches=8)

    def joined(key, axis):  # the lanes axis; [B] fields join on axis 0
        parts = zip(*(o[key] for o in outs))
        return [torch.cat(p, dim=min(axis, p[0].ndim - 1)) for p in parts]

    for got, want in ((joined("final", 0), final),
                      (joined("traj", 1), traj),
                      (joined("pfinal", 0), pfinal),
                      (joined("ptraj", 1), ptraj)):
        for name, gv, wv in zip(want._fields, got, want):
            if wv.dtype.is_floating_point:
                np.testing.assert_allclose(gv.numpy(), wv.numpy(),
                                           atol=1e-6, err_msg=name)
            else:
                assert torch.equal(gv, wv), name
    for k in ("episodes_completed", "episodes_succeeded"):
        assert torch.equal(torch.cat([o["stats"][k] for o in outs]),
                           stats[k]), k
    # 7 lanes round up to 8 over 2 processes: the single process's solve
    assert outs[0]["solution"] == outs[1]["solution"] == sol
    for out in outs:  # replicate: every process holds the first one's copy
        assert torch.equal(out["replicated"]["x"], torch.zeros(3))
        assert int(out["replicated"]["n"][0]) == 0


def test_dp_fit_demos_matches_single_process(dp):
    from qiskit_gym_torch.rl import fit_demos

    outs = [o["fit_demos"] for o in dp[1]]
    algo, demos = _demo_pair(None)
    aux = fit_demos(algo, demos, epochs=2, num_minibatches=3)
    for out in outs:
        for k, v in algo.params.items():
            np.testing.assert_allclose(out["params"][k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
        assert abs(out["aux"]["loss"] - aux["loss"]) <= 1e-5


def test_initialize_is_idempotent_and_refuses_a_conflict(dp):
    outs = [o["initialize"] for o in dp[1]]
    for rank, out in enumerate(outs):
        assert out["count"] == WORLD
        assert out["primary"] == (rank == 0)
        assert "already initialized" in out["refused"]


def test_initialize_lone_then_explicit(monkeypatch):
    """A lone process's no-op initialize() must not block a later explicit
    call; a different explicit call against a live group must raise."""
    import torch.distributed as dist

    from qiskit_gym_torch.parallel import distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.initialize, "_args", None, raising=False)
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert calls == []
    distributed.initialize("10.0.0.1:1234", 2, 0, backend="gloo")
    assert calls == [{"init_method": "tcp://10.0.0.1:1234", "store": None,
                      "world_size": 2, "rank": 0}]
    distributed.initialize("10.0.0.1:1234", 2, 0, backend="gloo")
    assert len(calls) == 1
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialized"):
        distributed.initialize("10.0.0.2:9999", 4, 1, backend="gloo")


def test_mp2_forward_and_gradient_match_unsharded(dp):
    outs = [o["mp_forward"] for o in dp[1]]
    pol, obs, w = _net()
    logits, value, grads = _forward_backward(pol, obs, w)
    for got_logits, got_value, got_grads, sharded in outs:
        assert set(sharded) == {"embeddings.weight", "embeddings.bias",
                                "common.0.weight", "common.0.bias",
                                "action.0.weight", "action.0.bias"}
        np.testing.assert_allclose(got_logits.numpy(), logits.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(got_value.numpy(), value.numpy(),
                                   atol=1e-5)
        for k, v in grads.items():
            np.testing.assert_allclose(got_grads[k].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=k)


class _FakeMesh:
    """The dp size of a mesh, as each package reads it."""

    mesh_dim_names = ("dp", "mp")

    def __init__(self, dp):
        self.shape = {"dp": dp, "mp": 1}  # a jax Mesh's
        self._dp = dp

    def size(self, dim):  # a DeviceMesh's
        return self.shape[self.mesh_dim_names[dim]]


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_lane_roundings_match_jax(dp):
    import inspect

    import jax

    from qiskit_gym_tpu.envs import CliffordGym as JaxCliffordGym
    from qiskit_gym_tpu.models import make_policy as jax_make_policy
    from qiskit_gym_tpu.rl import EvalConfig as JaxEvalConfig
    from qiskit_gym_tpu.rl import PPOConfig as JaxPPOConfig
    from qiskit_gym_tpu.rl.ppo import PPO as JaxPPO
    from qiskit_gym_tpu.rl.solve import round_up_lanes as jax_round_up
    from qiskit_gym_torch.rl.algorithm import eval_episodes
    from qiskit_gym_torch.rl.solve import round_up_lanes

    mesh = _FakeMesh(dp)
    for n in (1, 7, 8, 100, 101):
        assert round_up_lanes(n, mesh) == jax_round_up(n, mesh)
    env = JaxCliffordGym.from_coupling_map(LINE_3, max_depth=8)
    pol = jax_make_policy("BasicPolicy", env.obs_shape(), env.num_actions(),
                          POLICY)
    jppo = JaxPPO(env, pol, JaxPPOConfig(num_episodes=8))
    jppo.mesh = mesh
    for E, S in ((8, 1), (5, 1), (7, 3), (100, 6), (3, 8)):
        fn = jppo._make_eval(8, JaxEvalConfig(num_episodes=E,
                                              num_searches=S))
        want = inspect.getclosurevars(fn.__wrapped__).nonlocals["E"]
        assert eval_episodes(E, S, mesh) == want, (E, S)
    del jax
