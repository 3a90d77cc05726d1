"""The port's action-head graft (`models/transfer.py`) against the JAX
package, on the CPU: the graft of the carried-across weights must equal the
carried-across JAX graft exactly, the grafted net must give the source's
logits on the shared actions and the source's value (1e-6 relative, as the
JAX package's own test), and the port must refuse what the JAX package
refuses, with the same messages."""

import jax
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.envs import CliffordGym as JaxCliffordGym
from qiskit_gym_tpu.models import graft_action_head as jax_graft
from qiskit_gym_tpu.models import make_policy as jax_make_policy
from qiskit_gym_tpu.rl import BasicPolicyConfig as JaxPolicyConfig
from qiskit_gym_torch.envs import CliffordGym
from qiskit_gym_torch.models import (graft_action_head, make_policy,
                                     params_from_jax)

LINE_3 = [(0, 1), (1, 0), (1, 2), (2, 1)]


def _jax_params(env, seed, embedding=32, layers=(16,), policy_layers=()):
    pol = jax_make_policy(
        "twisterl.nn.BasicPolicy", env.obs_shape(), env.num_actions(),
        JaxPolicyConfig(embedding_size=embedding, common_layers=list(layers),
                        policy_layers=list(policy_layers)).to_json())
    return jax.tree.map(np.asarray, pol.init(jax.random.PRNGKey(seed)))


def _port_policy(env, embedding=32, layers=(16,), policy_layers=()):
    obs_perms, act_perms = env.twists()
    return make_policy(
        "BasicPolicy", env.obs_shape(), env.num_actions(),
        {"embedding_size": embedding, "common_layers": list(layers),
         "policy_layers": list(policy_layers)},
        obs_perms=obs_perms, act_perms=act_perms)


def _envs(src_gates=("H", "CX"), dst_gates=None):
    kw = {} if dst_gates is None else {"basis_gates": dst_gates}
    return (JaxCliffordGym.from_coupling_map(LINE_3, basis_gates=src_gates),
            JaxCliffordGym.from_coupling_map(LINE_3, **kw),
            CliffordGym.from_coupling_map(LINE_3, basis_gates=src_gates,
                                          device="cpu"),
            CliffordGym.from_coupling_map(LINE_3, device="cpu", **kw))


@pytest.mark.parametrize("policy_layers", [(), (8,)])
def test_graft_equals_the_jax_graft(policy_layers):
    jsrc, jdst, tsrc, tdst = _envs()
    src = _jax_params(jsrc, 0, policy_layers=policy_layers)
    dst = _jax_params(jdst, 1, policy_layers=policy_layers)
    want = params_from_jax(jax.tree.map(
        np.asarray, jax_graft(dst, src, jsrc.gateset, jdst.gateset)))
    got = graft_action_head(params_from_jax(dst), params_from_jax(src),
                            tsrc.gateset, tdst.gateset)
    assert list(got) == list(params_from_jax(dst))
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_graft_preserves_source_behavior():
    _, _, tsrc, tdst = _envs()
    src_gs, dst_gs = tsrc.gateset, tdst.gateset
    assert set(src_gs) < set(dst_gs)
    src_pol, dst_pol = _port_policy(tsrc), _port_policy(tdst)
    g = torch.Generator().manual_seed(0)
    src_pol.module.reset_parameters(g)
    dst_pol.module.reset_parameters(g)
    dst_pol.module.load_state_dict(graft_action_head(
        dst_pol.module.state_dict(), src_pol.module.state_dict(), src_gs,
        dst_gs))
    obs = torch.from_numpy(
        (np.random.default_rng(3).random((4, *tsrc.obs_shape())) > 0.5)
        .astype(np.float32))
    with torch.no_grad():
        src_logits, src_value = src_pol(obs)
        dst_logits, dst_value = dst_pol(obs)
    cols = [dst_gs.index(gate) for gate in src_gs]
    np.testing.assert_allclose(dst_logits[:, cols].numpy(),
                               src_logits.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dst_value.numpy(), src_value.numpy(),
                               rtol=1e-6, atol=1e-7)
    new = [i for i in range(len(dst_gs)) if i not in cols]
    floor = dst_logits[:, new].numpy()
    assert np.allclose(floor, floor[:, :1], atol=1e-6)
    bias = src_pol.module.state_dict()["action.0.bias"].numpy()
    assert floor[0, 0] <= bias.min() + 1e-6


def test_graft_rejects_non_subset_and_mismatch():
    jsrc, jdst, tsrc, tdst = _envs(("H", "CX"), ("S", "CX"))
    src = params_from_jax(_jax_params(jsrc, 0))
    dst = params_from_jax(_jax_params(jdst, 1))
    with pytest.raises(ValueError, match="absent from destination"):
        graft_action_head(dst, src, tsrc.gateset, tdst.gateset)
    with pytest.raises(ValueError, match="outputs"):
        graft_action_head(dst, src, tsrc.gateset[:-1], tsrc.gateset[:-1])


def test_graft_rejects_trunk_shape_and_architecture_mismatch():
    jsrc, jdst, tsrc, tdst = _envs()
    src = params_from_jax(_jax_params(jsrc, 0))
    wide = params_from_jax(_jax_params(jdst, 1, embedding=64))
    with pytest.raises(ValueError, match="shape mismatch grafting"):
        graft_action_head(wide, src, tsrc.gateset, tdst.gateset)
    deeper = params_from_jax(_jax_params(jdst, 1, layers=(16, 16)))
    with pytest.raises(ValueError, match="modules absent from the source"):
        graft_action_head(deeper, src, tsrc.gateset, tdst.gateset)
