"""The port's policy nets (`BasicPolicy`, `PolicyBundle`) against flax.

Weights go across with `params_from_jax`; observations are numpy-made 0/1
matrices. Tolerance: atol = rtol = 1e-5 in float32, for the different
summation order of the two matmul implementations."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.envs.synthesis import SYNTH_ENVS as JAX_ENVS
from qiskit_gym_tpu.models.policies import make_policy as jax_make_policy
from qiskit_gym_tpu.models.torch_io import load_torch_checkpoint as jax_load
from qiskit_gym_torch.models import (BasicPolicy, Conv1dPolicy,
                                     load_torch_checkpoint, make_policy,
                                     params_from_jax)
from qiskit_gym_torch.utils.serialization import load_params, save_params

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
ARTIFACTS = ["clifford_heavy_hex_27q", "perm_heavy_hex_27q", "perm_grid_3x3",
             "lf_5_line", "clifford_3q_line", "clifford_3q_custom"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _config(name):
    with open(os.path.join(MODELS, name + ".json")) as f:
        return json.load(f)


def _obs(shape, B, seed):
    return np.random.default_rng(seed).integers(0, 2, (B,) + tuple(shape),
                                                dtype=np.uint8)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ARTIFACTS)
def test_basic_policy_loads_shipped_pt_strict(name):
    full = _config(name)
    sd = load_torch_checkpoint(os.path.join(MODELS, name + ".pt"))
    obs_size = sd["embeddings.weight"].shape[1]
    num_actions = len(full["env"]["gateset"])
    pol = full["policy"]
    net = BasicPolicy(obs_size, num_actions,
                      embedding_size=pol.get("embedding_size", 512),
                      common_layers=pol.get("common_layers", (256,)),
                      policy_layers=pol.get("policy_layers", ()),
                      value_layers=pol.get("value_layers", ()))
    net.load_state_dict(sd, strict=True)
    logits, value = net(torch.zeros(3, obs_size))
    assert logits.shape == (3, num_actions) and value.shape == (3,)


@pytest.mark.parametrize("hidden", [((256,), (), ()), ((64, 32), (16,), (8,))])
def test_params_from_jax_matches_flax(hidden):
    """A random-init flax BasicPolicy and its weights carried across."""
    common, policy_l, value_l = hidden
    obs_shape, A = (6, 6), 8
    cfg = dict(embedding_size=48, common_layers=list(common),
               policy_layers=list(policy_l), value_layers=list(value_l))
    jb = jax_make_policy("BasicPolicy", obs_shape, A, cfg)
    params = jax.tree.map(np.asarray, jb.init(jax.random.key(3)))
    tb = make_policy("BasicPolicy", obs_shape, A, cfg)
    tb.module.load_state_dict(params_from_jax(params), strict=True)
    obs = _obs(obs_shape, 5, 1)
    want_l, want_v = jb.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        got_l, got_v = tb(torch.as_tensor(obs))
    _close(got_l, want_l)
    _close(got_v, want_v)


def test_params_from_jax_inverts_jax_checkpoint_import():
    """params_from_jax undoes the JAX package's `.pt` import exactly."""
    path = os.path.join(MODELS, "lf_5_line.pt")
    back = params_from_jax(jax_load(path))
    sd = load_torch_checkpoint(path)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


@pytest.mark.parametrize("name", ["perm_grid_3x3", "lf_5_line"])
def test_symmetry_average_matches_flax(name):
    """PolicyBundle over the coupling map's twists (8 on the 3x3 grid) with
    the shipped weights."""
    full = _config(name)
    env_cls = full["env_cls"].split(".")[-1]
    env = JAX_ENVS[env_cls].from_json(full["env"])
    obs_perms, act_perms = env.twists()
    obs_shape, A = tuple(env.obs_shape()), env.num_actions()
    jb = jax_make_policy(full["policy_cls"], obs_shape, A, full["policy"],
                         obs_perms=obs_perms, act_perms=act_perms)
    tb = make_policy(full["policy_cls"], obs_shape, A, full["policy"],
                     obs_perms=obs_perms, act_perms=act_perms)
    if name == "perm_grid_3x3":
        assert tb.num_perms == 8
    path = os.path.join(MODELS, name + ".pt")
    tb.module.load_state_dict(load_torch_checkpoint(path), strict=True)
    obs = _obs(obs_shape, 7, 2)
    want_l, want_v = jb.apply(jax_load(path), jnp.asarray(obs))
    with torch.no_grad():
        got_l, got_v = tb(torch.as_tensor(obs))
    _close(got_l, want_l)
    _close(got_v, want_v)


def test_pt_round_trip_and_other_formats(tmp_path):
    sd = load_params(os.path.join(MODELS, "clifford_3q_line.pt"))
    out = str(tmp_path / "p.pt")
    save_params(sd, out)
    back = load_params(out)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # flax msgpack and the torch.distributed.checkpoint directory
    for path in (str(tmp_path / "p.msgpack"), str(tmp_path / "ckpt.orbax")):
        save_params(sd, path)
        back = load_params(path)
        assert set(back) == set(sd)
        assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_conv1d_policy_not_ported_yet():
    """`make_policy` builds every policy class of the config schema, and
    still rejects a name it does not know."""
    bundle = make_policy("pkg.models.Conv1dPolicy", (4, 6), 3, {})
    assert isinstance(bundle.module, Conv1dPolicy)
    assert bundle.module.conv.weight.shape == (210, 4, 3)   # 1260 / 6 = 210
    with pytest.raises(ValueError, match="Unknown policy class"):
        make_policy("TransformerPolicy", (4, 4), 3, {})


@pytest.mark.parametrize("conv_dim", [0, 1])
def test_conv1d_policy_matches_flax(conv_dim):
    """A random-init flax Conv1dPolicy and its weights carried across
    (`conv.weight` [out, in, k] from the flax kernel [k, in, out]); the
    length 10 does not divide the embedding, so the channel count is
    rounded up."""
    obs_shape, A = (6, 10), 7
    cfg = dict(conv_dim=conv_dim, embedding_size=25, common_layers=[16],
               policy_layers=[8], value_layers=[4])
    jb = jax_make_policy("Conv1dPolicy", obs_shape, A, cfg)
    params = jax.tree.map(np.asarray, jb.init(jax.random.key(1)))
    tb = make_policy("Conv1dPolicy", obs_shape, A, cfg)
    sd = params_from_jax(params)
    length = obs_shape[conv_dim]
    assert sd["conv.weight"].shape == (-(-25 // length),
                                       obs_shape[1 - conv_dim], 3)
    tb.module.load_state_dict(sd, strict=True)
    obs = _obs(obs_shape, 5, 4)
    want_l, want_v = jb.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        got_l, got_v = tb(torch.as_tensor(obs))
    _close(got_l, want_l)
    _close(got_v, want_v)


def test_conv1d_pt_written_by_the_jax_package_loads(tmp_path):
    """The JAX package's own `.pt` export of a conv policy loads with
    `strict=True` and gives the same logits; a seeded re-draw of the net
    changes the conv weights too."""
    from qiskit_gym_tpu.models.torch_io import save_torch_checkpoint

    obs_shape, A = (6, 9), 5
    cfg = dict(conv_dim=1, embedding_size=18, common_layers=[8])
    jb = jax_make_policy("Conv1dPolicy", obs_shape, A, cfg)
    params = jb.init(jax.random.key(2))
    path = str(tmp_path / "conv.pt")
    save_torch_checkpoint(params, path)
    tb = make_policy("Conv1dPolicy", obs_shape, A, cfg)
    tb.module.load_state_dict(load_torch_checkpoint(path), strict=True)
    obs = _obs(obs_shape, 3, 5)
    with torch.no_grad():
        got_l, _ = tb(torch.as_tensor(obs))
    _close(got_l, jb.apply(params, jnp.asarray(obs))[0])
    before = tb.module.conv.weight.clone()
    tb.module.reset_parameters(torch.Generator().manual_seed(0))
    assert not torch.equal(before, tb.module.conv.weight)
