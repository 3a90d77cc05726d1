"""One whole PPO iteration of the port against the JAX package's.

`PPO.train_step` with episode packing (the path of the shipped PPO configs:
`collect_packed`, GAE with the horizon's `last_value`, then the epochs of
minibatch updates) runs with every draw that the JAX package's jitted train
step makes for one key: the reset pool, the Gumbel noise and inversion
flips, the refill slots and rotations (its `collect_packed` key split), and
each epoch's permutation (`fold_in(key, 1)`, one key an epoch). The
collection counters must be equal, and for a random 4-qubit net the metrics
within 1e-5 relative and every updated weight within 2e-5 absolute.

The shipped 27q Clifford artifact at its published widths (64 lanes, 64
Adam steps) is held looser, by what Adam does to float noise: a weight
whose gradient is near zero moves by up to lr = 3e-4 a step in a direction
that the last bits of the gradient decide, so a few of its 1.5M weights end
up to 1.9e-3 apart (seeds 5 and 6 of this setup). There the metrics must
agree within 1e-4 relative, every weight within 5e-3, the updated nets'
logits on 512 fresh targets within 0.05, and their argmax (what the
deterministic eval plays) on at least 99 % of them.

The draws come from `scripts/ppo_iteration_probe.py`'s
`jax_iteration_draws`, which its `stats` mode's `jax-draws` arm feeds to the
port over many seeds; this test pins that composition at the CPU's float
tolerance.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.rl.synthesis import RLSynthesis as JaxRLSynthesis
from qiskit_gym_torch.models import params_from_jax
from qiskit_gym_torch.rl import RLSynthesis

from test_torch_ppo import _pair

ROOT = os.path.join(os.path.dirname(__file__), "..")
MODELS = os.path.join(ROOT, "examples", "models")
_spec = importlib.util.spec_from_file_location(
    "ppo_iteration_probe", os.path.join(ROOT, "scripts",
                                        "ppo_iteration_probe.py"))
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)
WEIGHT_ATOL = 2e-5
METRIC_RTOL = 1e-5


def run_both(jppo, tppo, T: int, B: int, difficulty: int, seed: int = 0):
    """The JAX train step for key(seed), and the port's train step on the
    same draws; returns both metrics and the JAX weights after."""
    key = jax.random.key(seed)
    draws, perms = probe.jax_iteration_draws(jppo, key, T, B, difficulty)
    order = iter(perms)
    with probe.patched(collect=probe.injected(draws),
                       randperm=lambda n, generator=None, device=None: next(
                           order)):
        tmetrics = tppo.train_step(T, B, difficulty)
    if tppo.config.num_minibatches > 1:
        assert next(order, None) is None, "an epoch's permutation was unused"
    jparams, _, jmetrics = jppo._make_train_step(T, B)(
        jppo.params, jppo.opt_state, key, jnp.int32(difficulty))
    return tmetrics, {k: float(v) for k, v in jmetrics.items()}, jparams


def assert_iteration_equal(tppo, tmetrics, jmetrics, jparams,
                           metric_rtol=METRIC_RTOL, weight_atol=WEIGHT_ATOL):
    """The metrics and the updated weights; returns the JAX weights as a
    state dict."""
    assert set(tmetrics) == set(jmetrics)
    for k in ("episodes_completed", "steps_collected"):
        assert tmetrics[k] == jmetrics[k], k
    for k, v in jmetrics.items():
        np.testing.assert_allclose(tmetrics[k], v, rtol=metric_rtol,
                                   atol=1e-6, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tppo.policy.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=weight_atol, err_msg=name)
    return want


@pytest.mark.parametrize("difficulty,replay,minibatches,seed", [
    (2, 0, 4, 0), (3, 1, 4, 1), (2, 0, 1, 2), (4, 2, 8, 3)])
def test_train_step_on_jax_draws_matches_jax(difficulty, replay, minibatches,
                                             seed):
    """A random net on the 4q-line linear-function gym (inversions on)."""
    jppo, tppo = _pair(seed=seed, episode_packing=True, pack_pool_slots=3,
                       diff_replay=replay, num_minibatches=minibatches,
                       num_epochs=3)
    T, B = 2 * difficulty, 16
    tmetrics, jmetrics, jparams = run_both(jppo, tppo, T, B, difficulty,
                                           seed)
    assert tmetrics["episodes_completed"] > 0
    assert_iteration_equal(tppo, tmetrics, jmetrics, jparams)


def test_clifford_27q_iteration_on_jax_draws_matches_jax():
    """The shipped 27q Clifford artifact with its JSON's update (4 epochs x
    16 minibatches, packing, 8 pool slots) at difficulty 1 on 64 lanes:
    the iteration in which the shipped policy loses its argmax on some
    single-gate targets."""
    base = os.path.join(MODELS, "clifford_heavy_hex_27q")
    paths = (base + ".json", base + ".pt")
    jppo = JaxRLSynthesis.from_config_json(*paths).algorithm
    tppo = RLSynthesis.from_config_json(*paths, device="cpu").algorithm
    cfg = tppo.config
    assert (cfg.episode_packing, cfg.num_epochs, cfg.num_minibatches) == (
        True, 4, 16)
    tmetrics, jmetrics, jparams = run_both(jppo, tppo, 2, 64, 1, seed=5)
    assert tmetrics["success_rate"] > 0.9
    want = assert_iteration_equal(tppo, tmetrics, jmetrics, jparams,
                                  metric_rtol=1e-4, weight_atol=5e-3)
    g = torch.Generator().manual_seed(0)
    obs = tppo.core.dense(tppo.core.reset(512, 1, generator=g))
    with torch.no_grad():
        got, _ = tppo.policy(obs)
        tppo.policy.module.load_state_dict(want)
        ref, _ = tppo.policy(obs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0.05)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    assert agree >= 0.99, agree


def test_probe_report_compares_arms_and_pairs_seeds(capsys):
    """The statistics of the probe's `stats` and `merge` modes: Welch and
    Mann-Whitney against the first arm (as scipy computes them), the
    paired differences of an arm that ran the same seeds, the blocks."""
    from scipy import stats

    rng = np.random.default_rng(0)
    a = rng.normal(0.6, 0.08, 48)
    b = rng.normal(0.65, 0.08, 48)
    ent = rng.normal(2.2, 0.2, 48)
    rows = [{"arm": "torch", "seed": i, "after": float(x), "entropy": e}
            for i, (x, e) in enumerate(zip(a, ent))]
    rows += [{"arm": "jax", "seed": i, "after": float(x), "entropy": e}
             for i, (x, e) in enumerate(zip(b, rng.normal(2.2, 0.2, 48)))]
    rows += [{"arm": "jax-draws", "seed": i, "after": float(x) + 1e-6 * i,
              "entropy": e + (i == 3)}
             for i, (x, e) in enumerate(zip(a[:24], ent))]
    summary = probe.report(rows, blocks=24)
    s = summary["jax"]["after"]
    w = stats.ttest_ind(b, a, equal_var=False)
    np.testing.assert_allclose([s["mean"], s["sd"], s["welch_t"],
                                s["welch_p"]],
                               [b.mean(), b.std(ddof=1), w.statistic,
                                w.pvalue], rtol=1e-12)
    np.testing.assert_allclose(
        s["mannwhitney_p"],
        stats.mannwhitneyu(b, a, alternative="two-sided").pvalue,
        rtol=1e-12)
    paired = summary["jax-draws"]
    assert paired["after"]["paired_equal"] == 24
    assert paired["entropy"]["paired_equal"] == 23
    assert "welch_t" not in summary["torch"]["after"]
    out = capsys.readouterr().out
    assert "seeds 0-23: after mean jax" in out
    assert "seeds 24-47: after mean jax " in out
    assert "seeds 24-47: after mean jax-draws" not in out
