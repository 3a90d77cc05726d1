"""The port's dense int8 matrix env (`bitpack=False`) against the JAX
package's dense core, bit for bit, on the CPU.

Small cores (4 qubits on a line, the three families, `add_inverts` on and
off). Scrambles, actions and flips are made with numpy seeds and injected on
both sides through `scramble_override` and `invert_override`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.ops.matrix_env import MatrixEnvCore as JaxCore
from qiskit_gym_torch.ops import fused_step as fs
from qiskit_gym_torch.ops.matrix_env import (MatrixEnvCore,
                                             state_from_arrays)

LINE_4 = [(0, 1), (1, 2), (2, 3)]
N = 4
GATESETS = {
    "clifford": ([(g, (q,)) for g in ("H", "S", "SX") for q in range(N)]
                 + [(g, e) for g in ("CX", "CZ", "SWAP") for e in LINE_4]),
    "linear": [(g, e) for g in ("CX", "SWAP") for e in LINE_4],
    "permutation": [("SWAP", e) for e in LINE_4],
}
CASES = [(k, inv) for k in GATESETS for inv in (True, False)]
# nonzero layer weights, so the step tracks the layer fields too
WEIGHTS = {"n_cnots": 0.01, "n_layers_cnots": 0.02, "n_layers": 0.03,
           "n_gates": 0.004}


def _cores(kind, add_inverts, weights=None):
    kw = dict(max_depth=24, add_inverts=add_inverts, metrics_weights=weights,
              bitpack=False)
    jc = JaxCore(N, GATESETS[kind], kind, **kw)
    tc = MatrixEnvCore(N, GATESETS[kind], kind, device="cpu", **kw)
    return jc, tc


def _assert_same(js, ts, where):
    assert js._fields == ts._fields
    for field in js._fields:
        j = np.asarray(getattr(js, field))
        t = getattr(ts, field).numpy()
        assert j.dtype == t.dtype, (field, where)
        assert j.shape == t.shape, (field, where)
        assert np.array_equal(j, t), (field, where)


def _scrambled(jc, tc, B, rng, K=6):
    scr = rng.integers(0, jc.num_actions + 2, (B, K))  # no-ops included
    js = jc.reset(jax.random.key(0), B, K,
                  scramble_override=jnp.asarray(scr, jnp.int32))
    ts = tc.reset(B, K, scramble_override=torch.as_tensor(scr))
    return js, ts


@pytest.mark.parametrize("kind,add_inverts", CASES)
def test_dense_reset_matches_jax(kind, add_inverts):
    jc, tc = _cores(kind, add_inverts)
    assert not tc.bitpack and tc.D == 8
    js, ts = _scrambled(jc, tc, 16, np.random.default_rng(1), K=9)
    assert ts.a.dtype == torch.int8 and ts.a.shape == (16, tc.D, tc.D)
    _assert_same(js, ts, "reset")


@pytest.mark.parametrize("kind,add_inverts", CASES)
@pytest.mark.parametrize("weights", [None, WEIGHTS], ids=["default", "layers"])
def test_dense_set_state_and_step_match_jax(kind, add_inverts, weights):
    jc, tc = _cores(kind, add_inverts, weights)
    assert tc.track_layers == (weights is not None)
    B = 12
    rng = np.random.default_rng(2)
    _, ts0 = _scrambled(jc, tc, B, rng)
    dense = tc.dense(ts0).numpy()
    js, ts = jc.set_state(dense), tc.set_state(dense)
    _assert_same(js, ts, "set_state")
    for t in range(6):
        act = rng.integers(0, jc.num_actions + 1, B)
        act[t % B] = jc.noop_action
        flip = rng.random(B) < 0.5
        js = jc.step(js, jnp.asarray(act, jnp.int32), jax.random.key(t),
                     invert_override=jnp.asarray(flip) if add_inverts
                     else None)
        ts = tc.step(ts, torch.as_tensor(act),
                     invert_override=torch.as_tensor(flip) if add_inverts
                     else None)
        _assert_same(js, ts, t)


@pytest.mark.parametrize("kind", list(GATESETS))
def test_dense_observation_matches_jax(kind):
    jc, tc = _cores(kind, True)
    js, ts = _scrambled(jc, tc, 8, np.random.default_rng(3))
    assert tc.dense(ts).dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(jc.dense(js)),
                                  tc.dense(ts).numpy())
    np.testing.assert_array_equal(np.asarray(jc.observe(js)),
                                  tc.observe(ts).numpy())
    np.testing.assert_array_equal(np.asarray(jc.masks(js)),
                                  tc.masks(ts).numpy())
    np.testing.assert_array_equal(np.asarray(jc.is_final(js)),
                                  tc.is_final(ts).numpy())


@pytest.mark.parametrize("kind", list(GATESETS))
def test_dense_state_equals_bitpacked_state(kind):
    """The two representations of the port walk through the same matrices."""
    _, dc = _cores(kind, True)
    pc = MatrixEnvCore(N, GATESETS[kind], kind, max_depth=24, device="cpu")
    rng = np.random.default_rng(4)
    scr = torch.as_tensor(rng.integers(0, dc.num_actions, (10, 5)))
    ds, ps = dc.reset(10, 5, scramble_override=scr), \
        pc.reset(10, 5, scramble_override=scr)
    for t in range(5):
        act = torch.as_tensor(rng.integers(0, dc.num_actions + 1, 10))
        flip = torch.as_tensor(rng.random(10) < 0.5)
        ds = dc.step(ds, act, invert_override=flip)
        ps = pc.step(ps, act, invert_override=flip)
        assert torch.equal(dc.dense(ds), pc.dense(ps)), t
        for f in ("depth", "success", "reward", "inverted", "n_cnots",
                  "n_gates"):
            assert torch.equal(getattr(ds, f), getattr(ps, f)), (f, t)


@pytest.mark.parametrize("difficulty", [5, "per_lane"])
def test_dense_random_reset_keeps_inverse_and_padding(difficulty):
    _, tc = _cores("clifford", True)
    B = 6
    d = (torch.arange(B, dtype=torch.int32) + 1 if difficulty == "per_lane"
         else difficulty)
    st = tc.reset(B, d, generator=torch.Generator().manual_seed(0))
    eye = torch.eye(tc.D, dtype=torch.long).expand(B, -1, -1)
    assert torch.equal((st.a.long() @ st.ainv.long()) % 2, eye)
    want = torch.clamp(2 * torch.as_tensor(d), max=tc.max_depth)
    assert torch.equal(st.depth, torch.broadcast_to(want, (B,)).int())


def test_padding_block_is_identity():
    """dim 5 pads to D = 8: rows and columns 5..7 stay identity."""
    gs = [("CX", (i, i + 1)) for i in range(4)]
    tc = MatrixEnvCore(5, gs, "linear", bitpack=False, device="cpu")
    assert (tc.dim, tc.D) == (5, 8)
    st = tc.reset(4, 7, generator=torch.Generator().manual_seed(1))
    pad = torch.eye(8, dtype=torch.int8)
    assert torch.equal(st.a[:, 5:, :], pad[5:].expand(4, -1, -1))
    assert torch.equal(st.a[:, :, 5:], pad[:, 5:].expand(4, -1, -1))


def test_fused_step_refuses_a_dense_core():
    _, tc = _cores("linear", True)
    st = tc.reset(2, 1, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="bitpack=True"):
        fs.fused_step(tc, st, torch.zeros(2, dtype=torch.int64),
                      torch.zeros(2, dtype=torch.bool))


@pytest.mark.parametrize("bitpack", [True, False])
def test_state_from_arrays_carries_a_jax_state_across(bitpack):
    """A JAX env state handed over as numpy arrays (packed uint32 or dense
    int8) continues identically in the port."""
    kind = "clifford"
    jc = JaxCore(N, GATESETS[kind], kind, max_depth=24, bitpack=bitpack)
    tc = MatrixEnvCore(N, GATESETS[kind], kind, max_depth=24,
                       bitpack=bitpack, device="cpu")
    rng = np.random.default_rng(5)
    scr = rng.integers(0, jc.num_actions, (7, 6))
    js = jc.reset(jax.random.key(0), 7, 6,
                  scramble_override=jnp.asarray(scr, jnp.int32))
    ts = state_from_arrays({f: np.asarray(getattr(js, f))
                            for f in js._fields}, device="cpu")
    assert ts.a.dtype == (torch.int32 if bitpack else torch.int8)
    act = rng.integers(0, jc.num_actions, 7)
    flip = rng.random(7) < 0.5
    js = jc.step(js, jnp.asarray(act, jnp.int32), jax.random.key(1),
                 invert_override=jnp.asarray(flip))
    ts = tc.step(ts, torch.as_tensor(act),
                 invert_override=torch.as_tensor(flip))
    for f in js._fields:
        j = np.asarray(getattr(js, f))
        j = j.view(np.int32) if j.dtype == np.uint32 else j
        np.testing.assert_array_equal(j, getattr(ts, f).numpy(), err_msg=f)
