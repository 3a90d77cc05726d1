"""The port's checkpoint formats (`utils/serialization.py`,
`utils/flax_msgpack.py`, `rl/checkpoint.py`) against flax and the JAX
package, on the CPU.

msgpack must be bit-exact both ways: a file from flax read by the port, a
file from the port read by flax (and the bytes of the port's writer equal
flax's for the same tree), chunked arrays included (flax's and the port's
`MAX_CHUNK_SIZE` are patched down to a few KiB for that, at run time). A JAX
`train_state.msgpack` restored into the port continues with the JAX
package's Adam update within the tolerance of `tests/test_torch_ppo.py`
(1e-6). The torch.distributed.checkpoint directory round-trips bit-exact; a
directory that orbax wrote is refused with the documented error."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as flax_ser

import qiskit_gym_tpu.rl.checkpoint as jax_ckpt
import qiskit_gym_tpu.utils.serialization as jax_ser
from qiskit_gym_torch.models import make_policy, params_from_jax
from qiskit_gym_torch.utils import flax_msgpack
from qiskit_gym_torch.utils.serialization import (async_checkpointer,
                                                  load_params, save_params)

from test_torch_ppo import _np_traj, _pair, _trajs


def _tree(rng):
    return {
        "params": {
            "embeddings": {"kernel": rng.standard_normal((6, 5)).astype(
                np.float32), "bias": rng.standard_normal(5).astype(np.float32)},
            "nested": {"deeper": {"x": rng.integers(-9, 9, (2, 3)).astype(
                np.int32)}},
        },
        "u8": rng.integers(0, 256, (300,)).astype(np.uint8),
        "mask": rng.random((4, 2)) < 0.5,
        "f64": rng.standard_normal(3),
        "np_scalars": {"f": np.float32(1.25), "i": np.int32(-7),
                       "u": np.uint32(4000000000), "b": np.bool_(True)},
        "py": {"int": 3, "neg": -200, "big": 2 ** 40, "float": 0.1,
               "bool": False, "none": None, "str": "x" * 40, "c": 1 + 2j,
               "list": [1, 2.5, "a"]},
        "big_array": rng.standard_normal(3000).astype(np.float32),
        "empty": np.zeros((0, 3), np.float16),
    }


def _assert_trees_equal(want, got, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(params=[False, True], ids=["whole", "chunked"])
def chunking(request, monkeypatch):
    if request.param:  # every array above 4 KiB goes in chunks
        monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 4096)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
    return request.param


def test_flax_file_read_by_the_port(chunking):
    tree = _tree(np.random.default_rng(0))
    data = flax_ser.msgpack_serialize(tree)
    if chunking:
        assert b"__msgpack_chunked_array__" in data
    _assert_trees_equal(flax_ser.msgpack_restore(data),
                        flax_msgpack.unpackb(data))


def test_port_file_read_by_flax(chunking):
    tree = _tree(np.random.default_rng(1))
    data = flax_msgpack.packb(tree)
    assert data == flax_ser.msgpack_serialize(tree)
    _assert_trees_equal(flax_msgpack.unpackb(flax_ser.msgpack_serialize(tree)),
                        flax_ser.msgpack_restore(data))


def test_to_bytes_params_load_into_the_port(tmp_path):
    """A JAX package params file (`flax.serialization.to_bytes`, through its
    own save_params) loads as the same state dict, and the port's file loads
    back in the JAX package bit for bit."""
    from qiskit_gym_tpu.models import make_policy as jax_make_policy

    cfg = {"embedding_size": 16, "common_layers": [8], "policy_layers": [4]}
    jpol = jax_make_policy("BasicPolicy", (4, 4), 7, cfg)
    params = jax.tree.map(np.asarray, jpol.init(jax.random.key(0)))
    path = str(tmp_path / "p.msgpack")
    jax_ser.save_params(params, path)
    got = load_params(path)
    want = params_from_jax(params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    module = make_policy("BasicPolicy", (4, 4), 7, cfg).module
    module.load_state_dict(got)  # loadable as it is
    out = str(tmp_path / "q.msgpack")
    save_params(got, out)
    back = jax_ser.load_params(out)
    _assert_trees_equal(params, jax.tree.map(np.asarray, back))
    assert open(out, "rb").read() == flax_ser.msgpack_serialize(params)
    templ = load_params(out, template=module.state_dict())
    assert all(torch.equal(templ[k], got[k]) for k in got)
    with pytest.raises(ValueError, match="shape"):
        load_params(out, template={**module.state_dict(),
                                   "embeddings.bias": torch.zeros(3)})


def test_dcp_directory_round_trip(tmp_path):
    module = make_policy("BasicPolicy", (6, 6), 9,
                         {"embedding_size": 16, "common_layers": [8]}).module
    sd = module.state_dict()
    path = str(tmp_path / "params.orbax")
    save_params(sd, path)
    assert os.path.exists(os.path.join(path, ".metadata"))
    got = load_params(path)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    ckptr = async_checkpointer()
    path2 = str(tmp_path / "async") + os.sep
    ckptr.save(path2, sd)
    ckptr.wait_until_finished()
    got = load_params(path2, template=sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_orbax_directory_is_refused(tmp_path):
    import orbax.checkpoint as ocp

    path = str(tmp_path / "jax.orbax")
    ocp.PyTreeCheckpointer().save(
        path, {"params": {"a": {"kernel": np.ones((2, 3), np.float32)}}},
        force=True)
    with pytest.raises(ValueError, match="written by orbax"):
        load_params(path)


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """Two JAX Adam updates, the JAX snapshot written by the JAX package,
    restored into the port; then one more update on the same batch on both
    sides must agree (params, moments and step count carried across)."""
    jppo, tppo = _pair()
    rng = np.random.default_rng(5)
    T, B = 5, 8
    batches = []
    for _ in range(3):
        d = _np_traj(rng, T, B, (4, 4), jppo.core.num_actions)
        batches.append((d, rng.standard_normal((T, B)).astype(np.float32),
                        rng.standard_normal((T, B)).astype(np.float32)))

    def jax_update(batch):
        d, adv, ret = batch
        jt, _ = _trajs(d)
        (_, _), grads = jax.value_and_grad(jppo._loss, has_aux=True)(
            jppo.params, jt, jnp.asarray(adv), jnp.asarray(ret))
        updates, jppo.opt_state = jppo.tx.update(grads, jppo.opt_state,
                                                 jppo.params)
        jppo.params = optax.apply_updates(jppo.params, updates)

    jax_update(batches[0])
    jppo.best_params = jax.tree.map(lambda x: x, jppo.params)
    jppo.best_difficulty = 2
    jax_update(batches[1])
    jppo.iteration = 7
    jppo.env.difficulty = 3
    path = str(tmp_path / "train_state.msgpack")
    jax_ckpt.save_training_state(jppo, path)

    tppo.restore_training_state(path)
    assert (tppo.iteration, tppo.env.difficulty, tppo.best_difficulty) == (
        7, 3, 2)
    want = params_from_jax(jax.tree.map(np.asarray, jppo.params))
    for k, v in tppo.params.items():
        assert torch.equal(v, want[k]), k
    best = params_from_jax(jax.tree.map(np.asarray, jppo.best_params))
    for k, v in tppo.best_params.items():
        assert torch.equal(v, best[k]), k

    jax_update(batches[2])
    d, adv, ret = batches[2]
    _, tt = _trajs(d)
    tppo._update(tppo._loss, tt, torch.as_tensor(adv), torch.as_tensor(ret))
    want = params_from_jax(jax.tree.map(np.asarray, jppo.params))
    for name, p in tppo.policy.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    # the port's own snapshot stays train_state.pt and round-trips
    pt = str(tmp_path / "train_state.pt")
    tppo.save_training_state(pt)
    _, other = _pair()
    other.restore_training_state(pt)
    assert all(torch.equal(other.params[k], v)
               for k, v in tppo.params.items())
